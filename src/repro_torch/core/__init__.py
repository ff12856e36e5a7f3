"""IDCluster — DAG-compressed XML keyword search (the paper's contribution).

Public API: :class:`KeywordSearchEngine`, plus the index/search building
blocks for power users (BaseIndex, IDClusterIndex, search algorithms).
"""
from . import io, search_base, search_vec
from .components import IDClusterIndex, build_indices
from .dag import compress
from .engine import KeywordSearchEngine, QueryStats
from .idlist import BaseIndex, IDList, build_containment
from .plan_cache import PlanCache
from .xml_tree import NodeSpec, Vocab, XMLTree, build_tree, parse

__all__ = [
    "KeywordSearchEngine",
    "QueryStats",
    "PlanCache",
    "io",
    "XMLTree",
    "NodeSpec",
    "Vocab",
    "build_tree",
    "parse",
    "BaseIndex",
    "IDList",
    "build_containment",
    "IDClusterIndex",
    "build_indices",
    "compress",
    "search_base",
    "search_vec",
]
