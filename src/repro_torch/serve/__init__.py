from .prefix_dag import PrefixDAG, plan_batch
from .service import QueryService

__all__ = ["PrefixDAG", "plan_batch", "QueryService"]
