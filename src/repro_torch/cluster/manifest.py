"""Cluster artifacts: build once, route from anywhere.

Directory layout (published through :mod:`repro_torch.core.io`):

    <path>/cluster.json               shard specs + file names (commit point)
    <path>/routing-<token>.npz        keyword->shard bitmap + vocab + root kws
    <path>/shard-<token>-0000/ ...    one ordinary index artifact per shard

``build_cluster`` writes shard directories and the routing npz under
fresh *unique* (per-publish token) names, then swaps ``cluster.json`` in —
the same crash-safe publish discipline as single-index artifacts.  Because
no publish ever writes into a directory the committed manifest names, a
half-written republish is never observable: the old manifest keeps naming
only old, untouched files, and a re-publish over a live-served cluster never
tears it.  The previous publish is reclaimed only after the new commit.

Every shard entry carries a ``generation`` stamp (0 at first publish).
:func:`rolling_publish` republishes a cluster *shard-at-a-time*: each shard
gets a fresh artifact dir and a committed manifest with its generation
bumped before the next shard starts, so a crash mid-roll leaves a valid
mixed-generation cluster, and a live :class:`~repro_torch.cluster.router.
ClusterService` can hot-swap each shard as it lands (``reload_shard``)
without dropping in-flight queries.
"""
from __future__ import annotations

import os
import shutil
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import io as index_io
from repro_torch.core.engine import KeywordSearchEngine
from repro_torch.core.xml_tree import Vocab, XMLTree

from .partition import ShardSpec, routing_arrays, shard_tree, split_doc_ranges


@dataclass
class RoutingTable:
    """Keyword -> shard bitmap plus the corpus root's own keywords.

    ``masks[kid]`` bit ``s`` set iff shard ``s``'s documents contain keyword
    ``kid``; ``root_kw_ids`` are the corpus root's direct keywords (present
    in every shard's root replica, deliberately *not* in the bitmap).
    """

    vocab: Vocab
    masks: np.ndarray  # uint64[K]
    root_kw_ids: np.ndarray  # int32, sorted

    def kw_ids(self, keywords: list[str] | str) -> list[int]:
        if isinstance(keywords, str):
            keywords = keywords.split()
        return [self.vocab.get(w) for w in keywords]

    def fanout(self, kw_ids: list[int]) -> int:
        """Bitmask of shards whose documents contain *every* keyword."""
        mask = ~np.uint64(0)
        for k in kw_ids:
            mask &= self.masks[k]
        return int(mask)

    def doc_presence(self, kw_id: int) -> int:
        """Bitmask of shards whose documents contain the keyword at all."""
        return int(self.masks[kw_id])

    def at_root(self, kw_id: int) -> bool:
        i = int(np.searchsorted(self.root_kw_ids, kw_id))
        return i < self.root_kw_ids.size and int(self.root_kw_ids[i]) == kw_id


def _vocab_blob(vocab: Vocab) -> np.ndarray:
    blob = "\n".join(vocab.id_to_word).encode()
    return np.frombuffer(blob, dtype=np.uint8)


def _vocab_from_blob(arr: np.ndarray) -> Vocab:
    blob = bytes(np.asarray(arr))
    words = blob.decode("utf-8").split("\n") if blob else []
    return Vocab(word_to_id={w: i for i, w in enumerate(words)}, id_to_word=words)


def _write_routing(
    path: str, tree: XMLTree, specs: list[ShardSpec], token: str
) -> tuple[str, np.ndarray, np.ndarray]:
    """Write + fsync a fresh routing npz; returns (file name, masks, root)."""
    masks, root_kw_ids = routing_arrays(tree, specs)
    routing_file = f"routing-{token}.npz"
    np.savez(
        os.path.join(path, routing_file),
        vocab_blob=_vocab_blob(tree.vocab),
        masks=masks,
        root_kw_ids=root_kw_ids,
    )
    with open(os.path.join(path, routing_file), "rb") as f:
        os.fsync(f.fileno())
    return routing_file, masks, root_kw_ids


def write_layout_artifacts(
    path: str,
    tree: XMLTree,
    specs: list[ShardSpec],
    device: str | torch.device = "cuda",
) -> tuple[list[str], str]:
    """Index + write every shard dir and the routing npz for one layout.

    Shared by :func:`build_cluster` and
    :func:`repro_torch.cluster.rebalance.repartition_publish`: all files land
    under fresh token names and the *cluster directory entry* is fsynced
    before returning — the manifest that will name these files must never
    commit ahead of their directory entries (a crash in between would leave
    it referencing unlinked paths).  Returns (shard dir names, routing file
    name); nothing is committed.
    """
    token = os.urandom(4).hex()
    shard_dirs = [f"shard-{token}-{spec.index:04d}" for spec in specs]
    for spec, d in zip(specs, shard_dirs):
        engine = KeywordSearchEngine.from_tree(shard_tree(tree, spec), device=device)
        engine.save(os.path.join(path, d))
    routing_file, _, _ = _write_routing(path, tree, specs, token)
    index_io.fsync_dir(path)
    return shard_dirs, routing_file


def build_cluster(
    tree: XMLTree, num_shards: int, path: str, device: str | torch.device = "cuda"
) -> dict:
    """Partition ``tree``, index every shard, and publish a cluster artifact.

    Returns the manifest dict that was committed.  Every publish writes its
    shard directories and routing file under fresh unique names and commits
    them by swapping ``cluster.json`` — so a crash mid-republish leaves the
    previous cluster fully intact (its manifest still names only the old
    files), and live readers keep their mmaps of the old inodes.  The
    previous publish's shard directories are reclaimed only after the new
    manifest is durably committed.  ``device`` is where each shard engine is
    built (the artifact itself is device-free).
    """
    os.makedirs(path, exist_ok=True)
    prev_dirs: list[str] = []
    prev_epoch = -1
    try:
        prev = index_io.load_cluster_manifest(path)
        prev_dirs = [obj["dir"] for obj in prev["shards"]]
        prev_epoch = int(prev.get("layout_epoch", 0))
    except (OSError, ValueError, KeyError):
        pass  # first publish, or unreadable/old-format manifest
    specs = split_doc_ranges(tree, num_shards)
    shard_dirs, routing_file = write_layout_artifacts(path, tree, specs, device)
    manifest = {
        "num_shards": len(specs),
        "num_docs": int(specs[-1].doc_hi),
        "num_nodes": tree.num_nodes,
        "num_keywords": len(tree.vocab),
        "routing_file": routing_file,
        # a full republish over an existing cluster is a (degenerate)
        # repartition: edge caches keyed on the epoch must not trust
        # entries stamped under the previous layout
        "layout_epoch": prev_epoch + 1,
        "shards": [
            dict(spec.to_json(), dir=d, generation=0, endpoint=None, replicas=[])
            for spec, d in zip(specs, shard_dirs)
        ],
    }
    index_io.save_cluster_manifest(path, manifest)
    for d in prev_dirs:  # reclaim only what the *previous* manifest named
        if d not in shard_dirs:
            shutil.rmtree(os.path.join(path, d), ignore_errors=True)
    return manifest


def load_cluster_layout(
    path: str, mmap: bool = True
) -> tuple[dict, RoutingTable, list[tuple[ShardSpec, str]]]:
    """Open a cluster's *layout*: manifest, routing table, (spec, dir) pairs.

    No shard engine is loaded — this is what the process transport needs:
    the router keeps the routing table, each worker subprocess mmaps its own
    shard dir, and index pages are shared through the page cache.
    """
    manifest = index_io.load_cluster_manifest(path)
    arrs = index_io.load_arrays(
        os.path.join(path, manifest["routing_file"]), mmap=mmap
    )
    routing = RoutingTable(
        vocab=_vocab_from_blob(arrs["vocab_blob"]),
        masks=np.asarray(arrs["masks"]),
        root_kw_ids=np.asarray(arrs["root_kw_ids"]),
    )
    entries = [
        (ShardSpec.from_json(obj), os.path.join(path, obj["dir"]))
        for obj in manifest["shards"]
    ]
    return manifest, routing, entries


def manifest_endpoints(manifest: dict) -> list[str | list[str] | None]:
    """Per-shard remote endpoints from a cluster manifest (None = local).

    Every v3+ manifest carries an ``endpoint`` per shard entry —
    ``"host:port"`` of a standalone shard server
    (:mod:`repro_torch.cluster.workers.server`), or null for a shard served from
    its local artifact dir.  v4 adds ``replicas``: extra read-replica
    endpoints for the same shard.  A shard with replicas yields the full
    list (primary first) — exactly the per-shard shape
    :class:`~repro_torch.cluster.workers.pool.RemotePool` accepts.
    """
    out: list[str | list[str] | None] = []
    for obj in manifest["shards"]:
        primary = obj.get("endpoint")
        extras = [ep for ep in obj.get("replicas", []) if ep]
        if extras:
            out.append(([primary] if primary else []) + extras)
        else:
            out.append(primary)
    return out


def set_cluster_endpoints(
    path: str, endpoints: list[str | list[str] | None]
) -> dict:
    """Record where each shard's server(s) live, committing the manifest.

    ``endpoints[i]`` is ``"host:port"``, a list of them (first is the
    primary, the rest become the shard's read ``replicas``), or None
    (serve shard ``i`` locally).  This is deployment metadata, not
    content: generations, dirs, and the routing file are untouched, so it
    composes with a live ``rolling_publish``.  Returns the committed
    manifest.
    """
    manifest = index_io.load_cluster_manifest(path)
    if len(endpoints) != len(manifest["shards"]):
        raise ValueError(
            f"{len(manifest['shards'])} shards but {len(endpoints)} endpoints"
        )
    for obj, ep in zip(manifest["shards"], endpoints):
        if ep is None or isinstance(ep, str):
            obj["endpoint"], obj["replicas"] = ep, []
        else:
            eps = [str(x) for x in ep]
            obj["endpoint"] = eps[0] if eps else None
            obj["replicas"] = eps[1:]
    index_io.save_cluster_manifest(path, manifest)
    return manifest


def load_cluster(
    path: str, mmap: bool = True, device: str | torch.device = "cuda"
) -> tuple[list[tuple[ShardSpec, KeywordSearchEngine]], RoutingTable, dict]:
    """Open a cluster artifact: [(spec, engine)], routing table, manifest.

    Shard arrays stay memory-mapped (``mmap=True``), so N router processes
    share one page-cache copy of every shard index; each engine searches on
    ``device``.
    """
    manifest, routing, entries = load_cluster_layout(path, mmap=mmap)
    shards = [
        (spec, KeywordSearchEngine.load(shard_dir, mmap=mmap, device=device))
        for spec, shard_dir in entries
    ]
    return shards, routing, manifest


def rolling_publish(
    path: str,
    tree: XMLTree,
    *,
    service=None,
    device: str | torch.device = "cuda",
) -> dict:
    """Republish a live cluster shard-at-a-time, bumping generations.

    Re-indexes ``tree`` with the cluster's *existing* partition: the new
    tree must produce the same shard boundaries (document ranges and node
    ranges) as the committed manifest — document *content* may change, the
    layout may not.  Anything else is a repartition; use
    :func:`build_cluster`.  Per shard: build + write a fresh artifact dir,
    commit a manifest naming it with that shard's ``generation`` bumped,
    hot-swap the serving worker via ``service.reload_shard`` when a live
    service is given, then reclaim the old dir.  The routing arrays are
    recomputed from the new tree and committed (and swapped into the live
    service) with the *last* shard, so the finished publish is fully
    self-consistent even when keywords were added or removed; mid-roll, a
    mixed-generation cluster is served — inherent to rolling updates.  A
    crash between commits leaves a valid cluster; live readers and retired
    workers keep their mmaps of the old inodes.  ``device`` is where each
    shard engine is rebuilt, as in :func:`build_cluster`.
    """
    manifest = index_io.load_cluster_manifest(path)
    specs = [ShardSpec.from_json(obj) for obj in manifest["shards"]]
    fresh = split_doc_ranges(tree, len(specs))
    if fresh != specs:
        raise ValueError(
            "rolling_publish: the tree does not reproduce the cluster's "
            f"shard layout ({[s.to_json() for s in fresh]} vs manifest "
            f"{[s.to_json() for s in specs]}) — repartition with "
            "build_cluster instead"
        )
    token = os.urandom(4).hex()
    routing_file, masks, root_kw_ids = _write_routing(path, tree, specs, token)
    for i, spec in enumerate(specs):
        new_dir = f"shard-{token}-{spec.index:04d}"
        engine = KeywordSearchEngine.from_tree(shard_tree(tree, spec), device=device)
        engine.save(os.path.join(path, new_dir))
        # the new shard dir's (and, on the first pass, the routing npz's)
        # directory entries must be durable before the manifest names them:
        # the files are fsynced above, but a crash could still lose the
        # entries themselves and leave the committed manifest referencing
        # unlinked paths
        index_io.fsync_dir(path)
        old_dir = manifest["shards"][i]["dir"]
        manifest["shards"][i]["dir"] = new_dir
        manifest["shards"][i]["generation"] = (
            int(manifest["shards"][i].get("generation", 0)) + 1
        )
        last = i == len(specs) - 1
        if last:
            # every shard now carries the new content: name the new routing
            # (save_cluster_manifest reclaims the old npz on this commit)
            manifest["routing_file"] = routing_file
            manifest["num_nodes"] = tree.num_nodes
            manifest["num_keywords"] = len(tree.vocab)
        index_io.save_cluster_manifest(path, manifest)
        if service is not None:
            service.reload_shard(i, os.path.join(path, new_dir))
            if last:
                service.routing = RoutingTable(
                    vocab=tree.vocab, masks=masks, root_kw_ids=root_kw_ids
                )
        shutil.rmtree(os.path.join(path, old_dir), ignore_errors=True)
    return manifest
