from .service import QueryService

__all__ = ["QueryService"]
