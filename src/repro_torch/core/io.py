"""Index artifacts: build once, serve from N processes.

An engine's full state — tree, shared containment table, DAG compression,
redundancy components — serializes to a directory:

    <path>/manifest.json       format version + integrity counts (tiny, text)
    <path>/arrays-<token>.npz  every numpy array, *uncompressed*

Saves are atomic: arrays land in a fresh uniquely-named file and the
manifest (which names it) is swapped in with ``os.replace`` as the single
commit point, so a crash mid-save or a re-save over a live-served artifact
never tears the index — readers keep the old inode until they re-load.

Uncompressed npz members are raw ``.npy`` files at a fixed offset inside the
zip, so :func:`load_parts` memory-maps each member in place (``mmap=True``,
the default): N serving processes share one page cache copy of the index and
cold-start without re-parsing XML or re-running either index build.

Format policy (also in ROADMAP.md): ``FORMAT_VERSION`` bumps on any array
rename / dtype / semantic change; loaders reject any version mismatch
(older or newer) rather than misread the arrays.  Written by ``KeywordSearchEngine.save``; read by
``KeywordSearchEngine.load``.
"""
from __future__ import annotations

import json
import os
import warnings
import zipfile

import numpy as np

from .components import RedundancyComponents
from .dag import DagInfo
from .idlist import ContainmentTable
from .xml_tree import Vocab, XMLTree

FORMAT_VERSION = 1
_MANIFEST = "manifest.json"

# v2 (PR 3): every entry in ``shards`` carries a ``generation`` stamp,
# bumped per-shard by the rolling republish path.  v3 (PR 5): every entry
# carries an ``endpoint`` ("host:port" of a standalone shard server, or
# null to serve the shard locally).  v4 (PR 6): every entry carries
# ``replicas``, a list of extra read-replica endpoints the RemotePool
# hedges across.  v5 (rebalancer): the manifest carries a top-level
# ``layout_epoch``, bumped by every repartition (``repartition_publish``) —
# the cache-coherence signal that distinguishes "same shard count, new
# boundaries" from "same layout, new content" (which generations cover).
# Readers of older manifests would silently miss the fields, so the
# version gates them out loud; see :func:`migrate_cluster` for the
# in-place upgrade path.
CLUSTER_FORMAT_VERSION = 5
_CLUSTER_MANIFEST = "cluster.json"


def fsync_dir(dir_path: str) -> None:
    """Flush ``dir_path``'s directory entries to disk.

    Creating or renaming a file makes its *data* durable only after the
    containing directory's entry is fsynced too — every publish path calls
    this on the artifact directory after writing fresh files and before
    committing the manifest that names them.
    """
    dirfd = os.open(dir_path, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def commit_json(dir_path: str, name: str, obj: dict) -> None:
    """Atomically publish ``obj`` as ``<dir_path>/<name>``.

    The json lands in a temp file, is fsynced, and ``os.replace``d into place
    as the single commit point; the directory entry is fsynced afterwards so
    the rename itself is durable.  Readers always see either the previous
    complete document or the new one, never a torn write.
    """
    tmp = os.path.join(dir_path, f".{name}.tmp")
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(dir_path, name))
    fsync_dir(dir_path)


class _CSRLists:
    """Lazy list-of-lists view over CSR (offsets, flat) arrays.

    Reloaded ``rc_children`` stays in this form: queries never read it, so a
    serving process must not pay an O(num_rcs) materialization loop at cold
    start.  Duck-compatible with list[list[int]] for the consumers that do
    iterate (save_parts)."""

    def __init__(self, offsets: np.ndarray, flat: np.ndarray):
        self.offsets = offsets
        self.flat = flat

    def __len__(self) -> int:
        return int(self.offsets.shape[0]) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        return self.flat[self.offsets[i] : self.offsets[i + 1]]

    def __iter__(self):
        return (self[i] for i in range(len(self)))


# ---------------------------------------------------------------------- #
# Save
# ---------------------------------------------------------------------- #


def save_parts(
    path: str,
    tree: XMLTree,
    containment: ContainmentTable,
    dag: DagInfo | None,
    rcs: RedundancyComponents | None,
) -> None:
    """Write one index artifact directory (dag/rcs may be None: tree-only)."""
    os.makedirs(path, exist_ok=True)
    # vocabulary words come from whitespace tokenization, so "\n" never
    # appears inside a word and a joined blob is unambiguous
    blob = "\n".join(tree.vocab.id_to_word).encode()
    arrays: dict[str, np.ndarray] = {
        "tree_parent": tree.parent,
        "tree_subtree_size": tree.subtree_size,
        "tree_kw_offsets": tree.kw_offsets,
        "tree_kw_ids": tree.kw_ids,
        "vocab_blob": np.frombuffer(blob, dtype=np.uint8),
        "ct_kws": containment.kws,
        "ct_nodes": containment.nodes,
        "ct_counts": containment.counts,
        "ct_kw_starts": containment.kw_starts,
    }
    if dag is not None and rcs is not None:
        if isinstance(rcs.rc_children, _CSRLists):  # re-saving a loaded index
            child_offsets = np.asarray(rcs.rc_children.offsets, dtype=np.int64)
            child_flat = np.asarray(rcs.rc_children.flat, dtype=np.int32)
        else:
            child_lens = np.asarray(
                [len(c) for c in rcs.rc_children], dtype=np.int64
            )
            child_offsets = np.zeros(rcs.num_rcs + 1, dtype=np.int64)
            np.cumsum(child_lens, out=child_offsets[1:])
            child_flat = (
                np.concatenate(
                    [np.asarray(c, dtype=np.int32) for c in rcs.rc_children]
                )
                if child_offsets[-1]
                else np.zeros(0, dtype=np.int32)
            )
        arrays.update(
            dag_canon=dag.canon,
            dag_occ=dag.occ,
            rc_of_node=rcs.rc_of_node,
            rc_root=rcs.rc_root,
            rc_occ=rcs.rc_occ,
            rc_dummy_ids=rcs.dummy_ids,
            rc_dummy_parent_rc=rcs.dummy_parent_rc,
            rc_dummy_nested_rc=rcs.dummy_nested_rc,
            rc_dummy_offset=rcs.dummy_offset,
            rc_children_offsets=child_offsets,
            rc_children_flat=child_flat,
        )
    # Atomic publish: arrays go to a uniquely-named file, and the manifest —
    # the single commit point, since load reads it first to find the arrays —
    # is swapped in with os.replace.  Live readers keep their mmap of the old
    # inode; a crash at any point leaves the previous artifact fully intact.
    arrays_file = f"arrays-{os.urandom(4).hex()}.npz"
    np.savez(os.path.join(path, arrays_file), **arrays)
    with open(os.path.join(path, arrays_file), "rb") as f:
        os.fsync(f.fileno())  # data must be durable before the manifest commits
    prev_arrays = None
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            prev_arrays = json.load(f).get("arrays_file")
    except (OSError, ValueError):
        pass  # first save, or unreadable old manifest: nothing to clean up
    manifest = {
        "format_version": FORMAT_VERSION,
        "arrays_file": arrays_file,
        "has_dag": dag is not None and rcs is not None,
        "num_nodes": tree.num_nodes,
        "num_keywords": len(tree.vocab),
        "num_rcs": int(rcs.num_rcs) if rcs is not None else 0,
        "num_canonical": int(dag.num_canonical) if dag is not None else 0,
        "array_names": sorted(arrays),
    }
    commit_json(path, _MANIFEST, manifest)
    # unlink only the arrays file the *previous* manifest named (open mmaps
    # keep its inode alive); concurrent writers may orphan a file but can
    # never delete the committed one out from under the current manifest
    if prev_arrays and prev_arrays != arrays_file:
        try:
            os.unlink(os.path.join(path, prev_arrays))
        except OSError:
            pass


# ---------------------------------------------------------------------- #
# Load
# ---------------------------------------------------------------------- #


def _mmap_npz(npz_path: str) -> dict[str, np.ndarray]:
    """Memory-map every member of an *uncompressed* npz (read-only views)."""
    out: dict[str, np.ndarray] = {}
    with zipfile.ZipFile(npz_path) as zf, open(npz_path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{info.filename}: compressed member, cannot mmap")
            # local file header = 30 bytes + name + extra (central directory
            # lengths can differ from the local ones, so re-read them here)
            f.seek(info.header_offset)
            hdr = f.read(30)
            if hdr[:4] != b"PK\x03\x04":
                raise ValueError(f"{info.filename}: bad local header")
            name_len = int.from_bytes(hdr[26:28], "little")
            extra_len = int.from_bytes(hdr[28:30], "little")
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
            else:
                raise ValueError(f"{info.filename}: npy version {version}")
            if dtype.hasobject:
                raise ValueError(f"{info.filename}: object dtype")
            out[info.filename.removesuffix(".npy")] = np.memmap(
                npz_path,
                dtype=dtype,
                mode="r",
                offset=f.tell(),
                shape=shape,
                order="F" if fortran else "C",
            )
    return out


def load_arrays(npz_path: str, mmap: bool = True) -> dict[str, np.ndarray]:
    if mmap:
        try:
            return _mmap_npz(npz_path)
        except (ValueError, OSError) as e:
            # loud fallback: silently losing mmap turns one shared page-cache
            # copy into a private copy per serving process
            warnings.warn(
                f"{npz_path}: cannot memory-map ({e}); "
                "falling back to an in-memory load",
                RuntimeWarning,
                stacklevel=2,
            )
    with np.load(npz_path) as z:
        return {k: z[k] for k in z.files}


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    version = manifest.get("format_version")
    if version != FORMAT_VERSION:
        raise ValueError(
            f"index artifact {path}: format_version {version} "
            f"(this build reads {FORMAT_VERSION})"
        )
    return manifest


def load_parts(path: str, mmap: bool = True):
    """Read an artifact directory -> (tree, containment, dag, rcs, manifest).

    ``dag``/``rcs`` are None for tree-only artifacts.  With ``mmap=True``
    array payloads stay on disk until touched.
    """
    manifest = load_manifest(path)
    try:
        arrs = load_arrays(os.path.join(path, manifest["arrays_file"]), mmap=mmap)
    except FileNotFoundError:
        # a concurrent re-save replaced the manifest and unlinked the arrays
        # file between our manifest read and this open — one retry sees the
        # new, consistent pair
        manifest = load_manifest(path)
        arrs = load_arrays(os.path.join(path, manifest["arrays_file"]), mmap=mmap)
    return parts_from_arrays(arrs, manifest)


def parts_from_arrays(arrs: dict[str, np.ndarray], manifest: dict):
    """Index parts from the arrays dict that :func:`save_parts` writes.

    ``arrs`` holds the npz members by name (the very dict ``save_parts``
    builds, or what :func:`load_arrays` reads back); ``manifest`` supplies
    ``has_dag``, ``num_canonical`` and ``num_rcs``.  Returns
    (tree, containment, dag, rcs, manifest), as :func:`load_parts` does.
    """
    blob = bytes(np.asarray(arrs["vocab_blob"]))
    words = blob.decode("utf-8").split("\n") if blob else []
    vocab = Vocab(word_to_id={w: i for i, w in enumerate(words)}, id_to_word=words)
    tree = XMLTree(
        parent=arrs["tree_parent"],
        subtree_size=arrs["tree_subtree_size"],
        kw_offsets=arrs["tree_kw_offsets"],
        kw_ids=arrs["tree_kw_ids"],
        vocab=vocab,
    )
    containment = ContainmentTable(
        kws=arrs["ct_kws"],
        nodes=arrs["ct_nodes"],
        counts=arrs["ct_counts"],
        kw_starts=arrs["ct_kw_starts"],
    )
    if not manifest["has_dag"]:
        return tree, containment, None, None, manifest

    dag = DagInfo(
        canon=arrs["dag_canon"],
        occ=arrs["dag_occ"],
        num_canonical=manifest["num_canonical"],
    )
    rcs = RedundancyComponents(
        num_rcs=manifest["num_rcs"],
        rc_of_node=arrs["rc_of_node"],
        rc_root=arrs["rc_root"],
        rc_occ=arrs["rc_occ"],
        dummy_ids=arrs["rc_dummy_ids"],
        dummy_parent_rc=arrs["rc_dummy_parent_rc"],
        dummy_nested_rc=arrs["rc_dummy_nested_rc"],
        dummy_offset=arrs["rc_dummy_offset"],
        rc_children=_CSRLists(
            arrs["rc_children_offsets"], arrs["rc_children_flat"]
        ),
    )
    return tree, containment, dag, rcs, manifest


# ---------------------------------------------------------------------- #
# Cluster manifests
# ---------------------------------------------------------------------- #
#
# A *cluster* artifact is a directory of per-shard index artifacts plus one
# routing npz, all named by a top-level ``cluster.json``:
#
#     <path>/cluster.json               shard specs + file names (commit point)
#     <path>/routing-<token>.npz        keyword -> shard bitmap, vocab, root kws
#     <path>/shard-<token>-0000/ ...    ordinary index artifacts (per publish)
#
# Shard directories and the routing file carry a fresh per-publish token and
# are written first, then ``cluster.json`` is swapped in with
# :func:`commit_json` — no publish writes into files the committed manifest
# names, so a crash mid-(re)publish leaves the previous cluster fully
# readable.  The version policy mirrors the per-shard format: any change to
# the manifest keys, the routing array names, or their semantics bumps
# ``CLUSTER_FORMAT_VERSION``, and loaders reject mismatches.


def save_cluster_manifest(path: str, manifest: dict) -> None:
    """Atomically publish a cluster manifest (stamps the format version)."""
    os.makedirs(path, exist_ok=True)
    prev_routing = None
    try:
        with open(os.path.join(path, _CLUSTER_MANIFEST)) as f:
            prev_routing = json.load(f).get("routing_file")
    except (OSError, ValueError):
        pass  # first publish, or unreadable old manifest
    manifest = dict(manifest, cluster_format_version=CLUSTER_FORMAT_VERSION)
    commit_json(path, _CLUSTER_MANIFEST, manifest)
    # reclaim the routing file the previous manifest named (open mmaps keep
    # its inode alive), same policy as save_parts for arrays files
    if prev_routing and prev_routing != manifest.get("routing_file"):
        try:
            os.unlink(os.path.join(path, prev_routing))
        except OSError:
            pass


def load_cluster_manifest(path: str) -> dict:
    with open(os.path.join(path, _CLUSTER_MANIFEST)) as f:
        manifest = json.load(f)
    version = manifest.get("cluster_format_version")
    if version != CLUSTER_FORMAT_VERSION:
        hint = (
            " — repro_torch.core.io.migrate_cluster(path) upgrades old artifacts "
            "in place"
            if isinstance(version, int) and version < CLUSTER_FORMAT_VERSION
            else ""
        )
        raise ValueError(
            f"cluster artifact {path}: cluster_format_version {version} "
            f"(this build reads {CLUSTER_FORMAT_VERSION}){hint}"
        )
    return manifest


# Upgraders keyed by *source* version: each takes the manifest dict at
# version N and mutates it to satisfy version N+1.  Chained by
# :func:`migrate_cluster`, so writing v(N)->v(N+1) once is enough for every
# older artifact to reach the current format.
_CLUSTER_MIGRATIONS = {
    # v1 -> v2: per-shard generation stamps (rolling republish, PR 3)
    1: lambda m: [s.setdefault("generation", 0) for s in m["shards"]],
    # v2 -> v3: per-shard remote endpoints (remote transport, PR 5)
    2: lambda m: [s.setdefault("endpoint", None) for s in m["shards"]],
    # v3 -> v4: per-shard read-replica endpoint lists (hedged dispatch, PR 6)
    3: lambda m: [s.setdefault("replicas", []) for s in m["shards"]],
    # v4 -> v5: top-level layout_epoch (online rebalancer) — pre-v5 clusters
    # never repartitioned, so their layout is by definition epoch 0
    4: lambda m: m.setdefault("layout_epoch", 0),
}


def migrate_cluster(path: str) -> dict:
    """Upgrade ``<path>/cluster.json`` to the current format, in place.

    Chains the v(N)->v(N+1) upgraders and commits the result with the same
    atomic-manifest-swap discipline as any publish, so old cluster
    artifacts load after a format bump instead of demanding a rebuild.  A
    manifest already at the current version is returned untouched; a
    *newer* (or unrecognized) version still raises — downgrades cannot be
    synthesized.  Returns the committed (or already-current) manifest.
    """
    with open(os.path.join(path, _CLUSTER_MANIFEST)) as f:
        manifest = json.load(f)
    version = manifest.get("cluster_format_version")
    if version == CLUSTER_FORMAT_VERSION:
        return manifest
    if not isinstance(version, int) or version not in _CLUSTER_MIGRATIONS:
        raise ValueError(
            f"cluster artifact {path}: cannot migrate "
            f"cluster_format_version {version} to {CLUSTER_FORMAT_VERSION}"
        )
    while version < CLUSTER_FORMAT_VERSION:
        _CLUSTER_MIGRATIONS[version](manifest)
        version += 1
    # save_cluster_manifest stamps the current version and commits atomically
    save_cluster_manifest(path, manifest)
    return load_cluster_manifest(path)
