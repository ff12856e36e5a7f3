"""XML document model: labeled ordered trees with preorder IDs.

The paper models XML as a conventional labeled ordered tree where every
element / attribute is a node, every node carries the multiset of keywords
directly contained in its name / text (tokenized at whitespace), and every
node is identified by its preorder traversal number.

We keep the whole tree in flat numpy arrays (struct-of-arrays):

  parent[i]        preorder id of i's parent (-1 for the root)
  subtree_size[i]  number of nodes in i's subtree, including i
  kw_offsets/kw_ids  CSR of the *direct* keyword ids per node (sorted, unique)

Node ids are 0-based preorder positions; the root is node 0.  (The paper's
figures are 1-based; tests account for the shift.)
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from collections.abc import Sequence
from xml.etree import ElementTree as ET

import numpy as np

_TOKEN_RE = re.compile(r"\S+")


def tokenize(text: str) -> list[str]:
    """Split a label or text value into keywords at whitespace (paper §II-A)."""
    if not text:
        return []
    return _TOKEN_RE.findall(text)


@dataclass
class Vocab:
    """Bidirectional keyword <-> id mapping."""

    word_to_id: dict[str, int] = field(default_factory=dict)
    id_to_word: list[str] = field(default_factory=list)

    def add(self, word: str) -> int:
        kid = self.word_to_id.get(word)
        if kid is None:
            kid = len(self.id_to_word)
            self.word_to_id[word] = kid
            self.id_to_word.append(word)
        return kid

    def get(self, word: str) -> int:
        """Return the keyword id, or -1 if the word was never indexed."""
        return self.word_to_id.get(word, -1)

    def __len__(self) -> int:
        return len(self.id_to_word)


class XMLTree:
    """Immutable labeled ordered tree in flat preorder arrays."""

    def __init__(
        self,
        parent: np.ndarray,
        subtree_size: np.ndarray,
        kw_offsets: np.ndarray,
        kw_ids: np.ndarray,
        vocab: Vocab,
    ):
        self.parent = np.asarray(parent, dtype=np.int32)
        self.subtree_size = np.asarray(subtree_size, dtype=np.int32)
        self.kw_offsets = np.asarray(kw_offsets, dtype=np.int64)
        self.kw_ids = np.asarray(kw_ids, dtype=np.int32)
        self.vocab = vocab
        n = self.parent.shape[0]
        if self.subtree_size.shape[0] != n or self.kw_offsets.shape[0] != n + 1:
            raise ValueError("inconsistent tree arrays")

    # ------------------------------------------------------------------ #
    @property
    def num_nodes(self) -> int:
        return int(self.parent.shape[0])

    def direct_keywords(self, node: int) -> np.ndarray:
        lo, hi = self.kw_offsets[node], self.kw_offsets[node + 1]
        return self.kw_ids[lo:hi]

    def children_lists(self) -> list[list[int]]:
        """Children of every node in document order (O(N))."""
        ch: list[list[int]] = [[] for _ in range(self.num_nodes)]
        for i in range(1, self.num_nodes):
            ch[self.parent[i]].append(i)
        return ch

    def depths(self) -> np.ndarray:
        d = np.zeros(self.num_nodes, dtype=np.int32)
        # preorder guarantees parent < child, so one forward pass suffices
        for i in range(1, self.num_nodes):
            d[i] = d[self.parent[i]] + 1
        return d

    def is_ancestor(self, a: int, d: int) -> bool:
        """True iff ``a`` is a proper ancestor of ``d`` (preorder interval test)."""
        return a < d < a + int(self.subtree_size[a])

    # ------------------------------------------------------------------ #
    def validate(self) -> None:
        """Cheap structural invariants (used by property tests)."""
        n = self.num_nodes
        assert self.parent[0] == -1
        assert np.all(self.parent[1:] < np.arange(1, n)), "not preorder"
        assert np.all(self.parent[1:] >= 0)
        sizes = np.ones(n, dtype=np.int64)
        for i in range(n - 1, 0, -1):
            sizes[self.parent[i]] += sizes[i]
        assert np.array_equal(sizes, self.subtree_size), "subtree sizes wrong"


# ---------------------------------------------------------------------- #
# Builders
# ---------------------------------------------------------------------- #


@dataclass
class NodeSpec:
    """Convenience builder node: label text + explicit text value + children."""

    label: str
    text: str = ""
    children: Sequence[NodeSpec] = ()


def build_tree(root: NodeSpec, vocab: Vocab | None = None) -> XMLTree:
    """Build an XMLTree from a nested NodeSpec structure (iterative preorder)."""
    vocab = vocab or Vocab()
    parent: list[int] = []
    kw_per_node: list[np.ndarray] = []
    # iterative preorder: stack of (spec, parent_id)
    stack: list[tuple[NodeSpec, int]] = [(root, -1)]
    while stack:
        spec, par = stack.pop()
        nid = len(parent)
        parent.append(par)
        kws = sorted({vocab.add(t) for t in tokenize(spec.label) + tokenize(spec.text)})
        kw_per_node.append(np.asarray(kws, dtype=np.int32))
        for child in reversed(list(spec.children)):
            stack.append((child, nid))
    return _finish(parent, kw_per_node, vocab)


def _finish(parent: list[int], kw_per_node: list[np.ndarray], vocab: Vocab) -> XMLTree:
    n = len(parent)
    parent_arr = np.asarray(parent, dtype=np.int32)
    sizes = np.ones(n, dtype=np.int32)
    for i in range(n - 1, 0, -1):
        sizes[parent_arr[i]] += sizes[i]
    lens = np.asarray([len(k) for k in kw_per_node], dtype=np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    kw_ids = (
        np.concatenate(kw_per_node) if offsets[-1] else np.zeros(0, dtype=np.int32)
    )
    return XMLTree(parent_arr, sizes, offsets, kw_ids.astype(np.int32), vocab)


def parse_xml_specs(source: str) -> NodeSpec:
    """Parse XML into NodeSpecs (attributes become leading child nodes)."""
    et_root = ET.fromstring(source)

    def conv(el: ET.Element) -> NodeSpec:
        children = [
            NodeSpec(label=name, text=value) for name, value in el.attrib.items()
        ]
        children += [conv(c) for c in el]
        return NodeSpec(label=el.tag, text=(el.text or "").strip(), children=children)

    return conv(et_root)


def parse(source: str, vocab: Vocab | None = None) -> XMLTree:
    """Canonical XML -> XMLTree entry point (attribute-safe)."""
    return build_tree(parse_xml_specs(source), vocab)
