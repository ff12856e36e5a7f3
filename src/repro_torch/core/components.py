"""Pass 2 — redundancy components, dummy nodes, and the RCPM (paper §III-A).

A *redundancy component* (RC) is a maximal connected set of DAG nodes with
equal ``OccurrenceCount``.  Because ``occ(child) == occ(parent)`` forces the
child to have exactly one DAG parent, every RC is a tree fragment; RC ids are
assigned in discovery (preorder) order, so the RC holding the document root is
RC 0 (as the paper requires).

Where an edge crosses an occurrence boundary (occ differs), the parent RC's
IDLists receive a *dummy node* per keyword contained in the nested RC.  The
dummy's ID is the preorder id the nested root instance has inside the parent
RC's first occurrence (paper: "the same ID as the root node of the
represented nested redundancy component", shifted by the offset edge).  The
global RCPM maps dummy ID -> (nested RC id, offset); original result ids are
recovered as ``nested_result + offset``.

NOTE on the paper's figures: Fig. 4/5 key the RCPM by the *anchor* node
(the boundary parent, ids 4/11), while the prose defines dummies by the nested
root's instance id (ids 5/12 in the example).  Both produce identical final
results; we implement the prose variant because it supports multiple nested
RCs under one parent node (the anchor variant cannot key them apart).
DESIGN.md records this choice.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .dag import DagInfo, compress
from .idlist import BaseIndex, ContainmentTable, IDList, build_containment, make_pidpos
from .xml_tree import XMLTree


@dataclass
class RCPMEntry:
    rc: int
    offset: int


@dataclass
class RedundancyComponents:
    """Output of pass 2 (structural part of the IDCluster)."""

    num_rcs: int
    rc_of_node: np.ndarray  # int32[N]: RC id for canonical nodes, -1 otherwise
    rc_root: np.ndarray  # int32[num_rcs]: canonical node id of each RC root
    rc_occ: np.ndarray  # int64[num_rcs]: OccurrenceCount of the RC
    # dummies, one per boundary edge, sorted by dummy id
    dummy_ids: np.ndarray  # int32[D] instance id inside the parent RC
    dummy_parent_rc: np.ndarray  # int32[D] RC the dummy entry belongs to
    dummy_nested_rc: np.ndarray  # int32[D] RC the dummy points to
    dummy_offset: np.ndarray  # int64[D] id shift for splicing results
    rc_children: list[list[int]] = field(default_factory=list)  # RC DAG edges

    def rcpm_lookup(self, node_id: int) -> RCPMEntry | None:
        pos = np.searchsorted(self.dummy_ids, node_id)
        if pos < self.dummy_ids.shape[0] and self.dummy_ids[pos] == node_id:
            return RCPMEntry(
                rc=int(self.dummy_nested_rc[pos]), offset=int(self.dummy_offset[pos])
            )
        return None


def split_components(tree: XMLTree, dag: DagInfo) -> RedundancyComponents:
    n = tree.num_nodes
    canon = dag.canon
    occ = dag.occ
    children = tree.children_lists()

    rc_of_node = np.full(n, -1, dtype=np.int32)
    rc_root: list[int] = []
    rc_occ: list[int] = []
    rc_children: list[list[int]] = []

    dummy_ids: list[int] = []
    dummy_parent_rc: list[int] = []
    dummy_nested_rc: list[int] = []
    dummy_offset: list[int] = []

    # Discover RCs by walking the canonical DAG from the root, preorder.
    # A canonical node's RC region extends through children whose canonical
    # occurrence count matches; boundary edges spawn (or reference) nested RCs.
    rc_of_canon_root: dict[int, int] = {}

    def new_rc(root: int) -> int:
        rc = len(rc_root)
        rc_root.append(root)
        rc_occ.append(int(occ[root]))
        rc_children.append([])
        rc_of_canon_root[root] = rc
        return rc

    root_rc = new_rc(0)
    # stack holds (canonical_node, rc). Canonical nodes' original children are
    # traversed; a child occurrence inside an RC is always canonical itself
    # (proved in DESIGN.md §2: equal occ => 1:1 instances => first occurrence
    # lies under the parent's first occurrence).
    stack: list[tuple[int, int]] = [(0, root_rc)]
    rc_of_node[0] = root_rc
    while stack:
        u, rc = stack.pop()
        for c in children[u]:
            cc = int(canon[c])
            if occ[cc] == occ[u] and cc == c:
                # same-occurrence, first occurrence here: same RC
                rc_of_node[c] = rc
                stack.append((c, rc))
            else:
                # boundary edge: nested RC rooted at canonical cc
                nested = rc_of_canon_root.get(cc)
                if nested is None:
                    nested = new_rc(cc)
                    rc_of_node[cc] = nested
                    stack.append((cc, nested))
                if nested not in rc_children[rc]:
                    rc_children[rc].append(nested)
                # dummy id = instance id of the nested root under this parent
                dummy_ids.append(c)
                dummy_parent_rc.append(rc)
                dummy_nested_rc.append(nested)
                dummy_offset.append(int(c) - int(cc))

    order = np.argsort(np.asarray(dummy_ids, dtype=np.int64), kind="stable")
    return RedundancyComponents(
        num_rcs=len(rc_root),
        rc_of_node=rc_of_node,
        rc_root=np.asarray(rc_root, dtype=np.int32),
        rc_occ=np.asarray(rc_occ, dtype=np.int64),
        dummy_ids=np.asarray(dummy_ids, dtype=np.int32)[order],
        dummy_parent_rc=np.asarray(dummy_parent_rc, dtype=np.int32)[order],
        dummy_nested_rc=np.asarray(dummy_nested_rc, dtype=np.int32)[order],
        dummy_offset=np.asarray(dummy_offset, dtype=np.int64)[order],
        rc_children=rc_children,
    )


class IDClusterIndex:
    """The paper's index: per-RC IDLists + one global RCPM.

    Per-RC IDLists are *filtered views* of the base containment table: an
    entry of keyword k belongs to RC x's list iff its node is a member of x
    or a dummy of x.  (Dummy entries are exactly the base entries of the
    nested root instances — same ID, and NDesc = full direct-containment
    count of the instance subtree — so no new values need computing.)
    """

    def __init__(
        self,
        tree: XMLTree,
        containment: ContainmentTable | None = None,
        dag: DagInfo | None = None,
        rcs: RedundancyComponents | None = None,
    ):
        """``dag``/``rcs`` accept precomputed passes (artifact reload path)."""
        self.tree = tree
        self.containment = containment or build_containment(tree)
        self.dag = dag or compress(tree)
        self.rcs = rcs or split_components(tree, self.dag)
        # node id -> owning RC for *list membership*:
        #   members: rc_of_node; dummies: dummy_parent_rc (a node can be both
        #   a member of its own RC and a dummy inside a parent RC).
        self._member_rc = self.rcs.rc_of_node
        self._dummy_pos = {int(d): i for i, d in enumerate(self.rcs.dummy_ids)}
        self._cache: dict[tuple[int, int], IDList] = {}

    # ------------------------------------------------------------------ #
    @property
    def num_rcs(self) -> int:
        return self.rcs.num_rcs

    def rc_root_id(self, rc: int) -> int:
        return int(self.rcs.rc_root[rc])

    def rcpm_lookup(self, node_id: int) -> RCPMEntry | None:
        return self.rcs.rcpm_lookup(node_id)

    def idlist(self, rc: int, kw: int) -> IDList:
        """IDList of keyword ``kw`` inside redundancy component ``rc``."""
        key = (rc, kw)
        got = self._cache.get(key)
        if got is not None:
            return got
        empty = IDList(
            np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.int32)
        )
        if kw < 0 or kw + 1 >= self.containment.kw_starts.shape[0]:
            self._cache[key] = empty
            return empty
        nodes, counts = self.containment.slice_for(kw)
        member_mask = self._member_rc[nodes] == rc
        if self.rcs.dummy_ids.size:
            pos = np.searchsorted(self.rcs.dummy_ids, nodes)
            pos_c = np.clip(pos, 0, self.rcs.dummy_ids.size - 1)
            is_dummy = (self.rcs.dummy_ids[pos_c] == nodes) & (
                self.rcs.dummy_parent_rc[pos_c] == rc
            )
        else:
            is_dummy = np.zeros(nodes.shape, dtype=bool)
        keep = member_mask | is_dummy
        ids = nodes[keep]
        if ids.size == 0:
            self._cache[key] = empty
            return empty
        lst = IDList(
            ids=ids.astype(np.int32),
            pidpos=make_pidpos(ids, self.tree.parent),
            ndesc=counts[keep].astype(np.int32),
        )
        self._cache[key] = lst
        return lst

    def idlists(self, rc: int, kws: list[int]) -> list[IDList]:
        return [self.idlist(rc, k) for k in kws]

    # ------------------------------------------------------------------ #
    def num_entries(self) -> int:
        """Total entries across all per-RC IDLists (index-size experiment).

        = base entries restricted to first-occurrence members + one entry per
        (dummy, keyword contained in its nested RC).
        """
        nodes = self.containment.nodes
        member = self._member_rc[nodes] >= 0
        total = int(member.sum())
        if self.rcs.dummy_ids.size:
            pos = np.searchsorted(self.rcs.dummy_ids, nodes)
            pos_c = np.clip(pos, 0, self.rcs.dummy_ids.size - 1)
            is_dummy = self.rcs.dummy_ids[pos_c] == nodes
            total += int(is_dummy.sum())
        return total

    def rcpm_size(self) -> int:
        return int(self.rcs.dummy_ids.shape[0])


def build_indices(tree: XMLTree) -> tuple[BaseIndex, IDClusterIndex]:
    """Build the tree index and the DAG index sharing one containment pass."""
    containment = build_containment(tree)
    return BaseIndex(tree, containment), IDClusterIndex(tree, containment)
