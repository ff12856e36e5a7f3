"""Elastic rebalancing: online shard split / merge / move.

The paper's DAG-compressed shard indices are small and cheap to rebuild,
which is exactly what makes *online repartitioning* affordable — this
module is the actuator for the cluster's skew signal
(:meth:`ClusterService.load_report` / ``GET /debug/heat``).  Placement is
declarative config the runtime converges to (the Alpa idiom), never a
hand-run script:

:class:`PlacementPlan`
    The desired layout as plain data: contiguous document boundaries plus
    per-shard endpoint placement, validated against ``MAX_SHARDS``.

:func:`plan_rebalance`
    The planner: consumes a load report (per-shard qps, queue depth,
    doc-range heat, top-K keywords) and proposes split-hot / merge-cold /
    move-to-host actions, each annotated with a cost model (``cost`` =
    corpus fraction re-indexed, ``gain`` = expected load-share
    improvement), and the :class:`PlacementPlan` that applying them yields.

:func:`repartition_publish`
    The repartition-capable sibling of
    :func:`~repro_torch.cluster.manifest.rolling_publish`: builds fresh shard
    artifacts at the plan's boundaries, commits a manifest whose
    ``layout_epoch`` is bumped (the edge-cache coherence signal for
    boundary changes), and atomically converges a live
    :class:`~repro_torch.cluster.router.ClusterService` through its layout
    transaction (``apply_layout``) — zero dropped queries, in-flight
    gathers finish on the workers and routing snapshot they were pinned
    to.

:func:`move_shard`
    Launch a shard server on a target host, flip the manifest endpoint,
    and converge the live service (drain + retire the source worker).

Crash safety is inherited from the manifest discipline: every new file
lands under fresh token names, directory entries are fsynced, and the
manifest commit is the single atomic switch point — a crash mid-publish
leaves the previous layout fully intact.

Every actuator that builds or loads a shard engine takes ``device``,
``"cuda"`` unless the caller names the CPU; shard servers run the port's
backends (``"torch"`` by default; the reference's ``jax``, ``xla`` and
``pallas`` are refused before anything starts).
"""
from __future__ import annotations

import os
import shutil
import subprocess
from dataclasses import dataclass

import numpy as np

import torch

from repro_torch.api import validate_backend
from repro_torch.core import io as index_io
from repro_torch.core.xml_tree import XMLTree

from .manifest import write_layout_artifacts
from .partition import (
    MAX_SHARDS,
    balanced_bounds,
    doc_roots,
    heat_weighted_bounds,
    specs_from_bounds,
)

Endpoint = str | tuple[str, ...] | None


@dataclass(frozen=True)
class PlacementPlan:
    """A cluster layout as declarative data.

    ``doc_bounds`` is ``(0, c1, ..., n_docs)`` — strictly increasing
    document ordinals; shard ``s`` owns documents
    ``[doc_bounds[s], doc_bounds[s+1])``.  ``endpoints[s]`` is where shard
    ``s`` is served: None (local worker over the artifact dir), a
    ``"host:port"`` string, or a tuple of them (primary first, the rest
    read replicas).  An empty ``endpoints`` means "all local".
    """

    doc_bounds: tuple[int, ...]
    endpoints: tuple[Endpoint, ...] = ()

    @property
    def num_shards(self) -> int:
        return len(self.doc_bounds) - 1

    def shard_range(self, s: int) -> tuple[int, int]:
        return (self.doc_bounds[s], self.doc_bounds[s + 1])

    def endpoint(self, s: int) -> Endpoint:
        return self.endpoints[s] if self.endpoints else None

    def validate(self, n_docs: int | None = None) -> PlacementPlan:
        b = self.doc_bounds
        if len(b) < 2:
            raise ValueError(f"a plan needs >= 1 shard, got bounds {b!r}")
        if b[0] != 0 or any(x >= y for x, y in zip(b, b[1:])):
            raise ValueError(
                f"doc_bounds must be strictly increasing from 0, got {b!r}"
            )
        if self.num_shards > MAX_SHARDS:
            raise ValueError(
                f"{self.num_shards} shards exceeds MAX_SHARDS={MAX_SHARDS} "
                "(the routing bitmap is one uint64 wide)"
            )
        if n_docs is not None and b[-1] != int(n_docs):
            raise ValueError(
                f"plan covers {b[-1]} documents but the corpus has {n_docs}"
            )
        if self.endpoints and len(self.endpoints) != self.num_shards:
            raise ValueError(
                f"{self.num_shards} shards but {len(self.endpoints)} "
                "endpoint entries"
            )
        return self

    def to_json(self) -> dict:
        return {
            "doc_bounds": list(self.doc_bounds),
            "endpoints": [
                list(e) if isinstance(e, tuple) else e
                for e in self.endpoints
            ],
        }

    @classmethod
    def from_json(cls, obj: dict) -> PlacementPlan:
        return cls(
            doc_bounds=tuple(int(b) for b in obj["doc_bounds"]),
            endpoints=tuple(
                tuple(e) if isinstance(e, list) else e
                for e in obj.get("endpoints", [])
            ),
        )

    @classmethod
    def from_manifest(cls, manifest: dict) -> PlacementPlan:
        """The committed layout of a cluster manifest as a plan."""
        shards = manifest["shards"]
        bounds = [int(s["doc_lo"]) for s in shards] + [
            int(shards[-1]["doc_hi"])
        ]
        endpoints = []
        for s in shards:
            eps = ([s["endpoint"]] if s.get("endpoint") else []) + [
                e for e in s.get("replicas", []) if e
            ]
            if not eps:
                endpoints.append(None)
            elif len(eps) == 1:
                endpoints.append(eps[0])
            else:
                endpoints.append(tuple(eps))
        return cls(tuple(bounds), tuple(endpoints))

    @classmethod
    def balanced(cls, tree: XMLTree, num_shards: int) -> PlacementPlan:
        """Node-count-balanced boundaries (the build-time default)."""
        roots = doc_roots(tree)
        sizes = tree.subtree_size[roots].astype(np.int64)
        return cls(tuple(balanced_bounds(sizes, num_shards)))

    @classmethod
    def heat_balanced(
        cls,
        tree: XMLTree,
        num_shards: int,
        doc_heat: np.ndarray | list[float],
        *,
        smoothing: float = 1.0,
    ) -> PlacementPlan:
        """Boundaries balancing observed per-document query heat."""
        return cls(
            tuple(
                heat_weighted_bounds(
                    tree, num_shards, doc_heat, smoothing=smoothing
                )
            )
        )


# ---------------------------------------------------------------------- #
# Planner
# ---------------------------------------------------------------------- #


@dataclass(frozen=True)
class Action:
    """One proposed rebalance step, annotated with its cost model.

    ``cost`` is the fraction of the corpus whose shard artifacts must be
    rebuilt (or copied, for a move) to apply the action — cheap for
    DAG-compressed shards, but never free.  ``gain`` is the expected
    reduction of the hottest shard's load share (both in [0, 1], so
    ``gain - cost_weight * cost`` is the planner's net score).
    """

    kind: str  # "split" | "merge" | "move"
    shard: int  # index in the plan the action was proposed against
    cut_doc: int | None = None  # split: the new boundary ordinal
    endpoint: str | None = None  # move: target "host:port"
    gain: float = 0.0
    cost: float = 0.0
    reason: str = ""

    def to_json(self) -> dict:
        out = {
            "kind": self.kind,
            "shard": self.shard,
            "gain": round(self.gain, 4),
            "cost": round(self.cost, 4),
            "reason": self.reason,
        }
        if self.cut_doc is not None:
            out["cut_doc"] = self.cut_doc
        if self.endpoint is not None:
            out["endpoint"] = self.endpoint
        return out


def _shard_load(rows: list[dict]) -> list[float]:
    """One comparable load number per shard from a report's rows.

    QPS (delta over the report window) when any shard saw traffic in the
    window; otherwise lifetime heat-query counts, so a freshly started or
    long-idle cluster still yields a usable signal.
    """
    qps = [float(r.get("qps", 0.0)) for r in rows]
    if sum(qps) > 0:
        return qps
    return [float(r.get("heat_queries", r.get("queries", 0))) for r in rows]


def _split_fraction(doc_heat: list[float] | np.ndarray) -> float:
    """Where a shard's heat median sits, as a fraction of its span.

    The doc-range histogram buckets cover the shard's node-id span; the
    cut lands where cumulative heat reaches half, interpolated inside the
    median bucket and clamped away from the edges.  With no heat recorded
    the shard splits at its midpoint.
    """
    h = np.asarray(doc_heat, dtype=np.float64)
    total = float(h.sum())
    if h.size == 0 or total <= 0:
        return 0.5
    cum = np.cumsum(h)
    k = int(np.searchsorted(cum, total / 2))
    prev = float(cum[k - 1]) if k > 0 else 0.0
    within = ((total / 2) - prev) / float(h[k]) if h[k] > 0 else 0.5
    return float(min(max((k + within) / h.size, 0.05), 0.95))


def doc_heat_weights(
    tree: XMLTree, bounds: list[int] | tuple[int, ...], shard_doc_heat
) -> np.ndarray:
    """Expand per-shard doc-range histograms into per-document weights.

    ``shard_doc_heat[s]`` is shard ``s``'s ``doc_heat`` row from the load
    report: bucket counts over the shard's local node-id span.  Each
    bucket's heat is spread uniformly over the node ids it covers and
    integrated over every document's node range — the per-document weight
    vector :func:`~repro_torch.cluster.partition.heat_weighted_bounds` consumes.
    """
    roots = doc_roots(tree)
    n_docs = int(roots.size)
    specs = specs_from_bounds(tree, list(bounds))
    if len(shard_doc_heat) != len(specs):
        raise ValueError(
            f"{len(specs)} shards but {len(shard_doc_heat)} heat rows"
        )
    weights = np.zeros(n_docs, dtype=np.float64)
    for spec, counts in zip(specs, shard_doc_heat):
        h = np.asarray(counts, dtype=np.float64)
        if h.size == 0 or h.sum() <= 0:
            continue
        span = spec.node_end - spec.node_start + 1  # + the root replica
        edges = np.linspace(0.0, float(span), h.size + 1)
        cum = np.concatenate([[0.0], np.cumsum(h)])
        # shard-local node position of each document's first node, and one
        # past its last: integrate the piecewise-uniform heat in between
        starts = (roots[spec.doc_lo : spec.doc_hi] - spec.id_offset).astype(
            np.float64
        )
        ends = np.append(starts[1:], float(span))
        weights[spec.doc_lo : spec.doc_hi] += np.interp(
            ends, edges, cum
        ) - np.interp(starts, edges, cum)
    return weights


def plan_rebalance(
    report: dict,
    plan: PlacementPlan | None = None,
    *,
    split_factor: float = 1.5,
    merge_factor: float = 0.5,
    max_shards: int = MAX_SHARDS,
    cost_weight: float = 0.1,
    spare_endpoints: tuple[str, ...] = (),
) -> tuple[PlacementPlan | None, list[Action]]:
    """Propose rebalance actions from a load report.

    ``plan`` defaults to the layout the report itself carries
    (``report["layout"]["doc_bounds"]``).  Rules, each annotated with the
    cost model and filtered on net score ``gain - cost_weight * cost``:

    * **split-hot** — a shard whose load exceeds ``split_factor`` × the
      mean splits at its heat median (from the doc-range histogram),
      provided it has >= 2 documents and the cap allows another shard
      (note a shard's load tops out at ``n`` × mean, so the factor must
      stay below the shard count to ever fire — 1.5 works from 2 shards
      up);
    * **move-to-host** — a hot shard that *cannot* split (single document,
      or the shard cap is hit) moves to the next ``spare_endpoints`` host,
      dedicating hardware to it instead;
    * **merge-cold** — an adjacent pair whose combined load is below
      ``merge_factor`` × the mean merges into one shard.

    Returns ``(new_plan, actions)`` — the plan that applying the actions
    yields (via :func:`apply_actions`), or ``(None, [])`` when the layout
    is already acceptable.
    """
    rows = report.get("shards", [])
    if plan is None:
        layout = report.get("layout") or {}
        bounds = layout.get("doc_bounds") or ()
        if not bounds:
            raise ValueError(
                "no plan given and the report carries no layout.doc_bounds"
            )
        plan = PlacementPlan(tuple(int(b) for b in bounds))
    plan.validate()
    n = plan.num_shards
    if len(rows) != n:
        raise ValueError(
            f"report has {len(rows)} shard rows but the plan has {n} shards"
        )
    load = _shard_load(rows)
    total = sum(load)
    if total <= 0:
        return None, []  # no traffic, nothing to balance on
    mean = total / n
    docs = [hi - lo for lo, hi in zip(plan.doc_bounds, plan.doc_bounds[1:])]
    total_docs = plan.doc_bounds[-1]
    actions: list[Action] = []
    acted: set[int] = set()
    spare = list(spare_endpoints)
    shard_budget = max_shards - n

    # hottest first: the shard cap spends itself on the worst offenders
    for i in sorted(range(n), key=lambda s: -load[s]):
        if load[i] <= split_factor * mean:
            break
        share = load[i] / total
        if docs[i] >= 2 and shard_budget > 0:
            lo, hi = plan.shard_range(i)
            frac = _split_fraction(rows[i].get("doc_heat", []))
            cut = lo + min(max(round(frac * (hi - lo)), 1), hi - lo - 1)
            a = Action(
                "split", i, cut_doc=int(cut),
                gain=share / 2,  # halving the hot shard halves its share
                cost=docs[i] / total_docs,
                reason=(
                    f"load {load[i]:.1f} > {split_factor} x mean "
                    f"{mean:.1f}; heat median at {frac:.2f}"
                ),
            )
            if a.gain - cost_weight * a.cost > 0:
                actions.append(a)
                acted.add(i)
                shard_budget -= 1
        elif spare:
            a = Action(
                "move", i, endpoint=spare.pop(0),
                # a dedicated host takes the shard off the shared boxes
                gain=share,
                cost=docs[i] / total_docs,
                reason=(
                    f"load {load[i]:.1f} > {split_factor} x mean "
                    f"{mean:.1f} but unsplittable; dedicating a host"
                ),
            )
            if a.gain - cost_weight * a.cost > 0:
                actions.append(a)
                acted.add(i)

    # merge-cold: greedy left-to-right over untouched adjacent pairs
    j = 0
    remaining = n - sum(1 for a in actions if a.kind == "merge")
    while j < n - 1:
        if j in acted or j + 1 in acted:
            j += 1
            continue
        pair = load[j] + load[j + 1]
        if pair < merge_factor * mean and remaining > 1:
            a = Action(
                "merge", j,
                gain=(merge_factor * mean - pair) / total,
                cost=(docs[j] + docs[j + 1]) / total_docs,
                reason=(
                    f"combined load {pair:.1f} < {merge_factor} x mean "
                    f"{mean:.1f}"
                ),
            )
            if a.gain - cost_weight * a.cost > 0:
                actions.append(a)
                acted.update((j, j + 1))
                remaining -= 1
                j += 2
                continue
        j += 1

    if not actions:
        return None, []
    return apply_actions(plan, actions), actions


def apply_actions(plan: PlacementPlan, actions: list[Action]) -> PlacementPlan:
    """The layout that carrying out ``actions`` against ``plan`` yields.

    Splits insert their ``cut_doc`` boundary; merges remove the boundary
    between the pair; moves re-point a shard's endpoint.  Endpoint
    placement survives for every shard whose document range is unchanged;
    ranges created or resized by a split/merge start local (endpoint
    None) — fresh artifacts have no server yet, placement is a separate
    :func:`move_shard` step.
    """
    bounds = set(plan.doc_bounds)
    moves: dict[tuple[int, int], str] = {}
    for a in actions:
        if a.kind == "split":
            if a.cut_doc is None:
                raise ValueError(f"split action without cut_doc: {a}")
            bounds.add(int(a.cut_doc))
        elif a.kind == "merge":
            if not 0 <= a.shard < plan.num_shards - 1:
                raise ValueError(f"merge shard {a.shard} out of range")
            bounds.discard(plan.doc_bounds[a.shard + 1])
        elif a.kind == "move":
            if a.endpoint is None:
                raise ValueError(f"move action without endpoint: {a}")
            moves[plan.shard_range(a.shard)] = a.endpoint
        else:
            raise ValueError(f"unknown action kind {a.kind!r}")
    new_bounds = tuple(sorted(bounds))
    old_eps = {
        plan.shard_range(s): plan.endpoint(s) for s in range(plan.num_shards)
    }
    endpoints = tuple(
        moves.get(rng, old_eps.get(rng))
        for rng in zip(new_bounds, new_bounds[1:])
    )
    out = PlacementPlan(new_bounds, endpoints)
    return out.validate(n_docs=plan.doc_bounds[-1])


# ---------------------------------------------------------------------- #
# Actuators
# ---------------------------------------------------------------------- #


def repartition_publish(
    path: str,
    tree: XMLTree,
    plan: PlacementPlan,
    *,
    service=None,
    device: str | torch.device = "cuda",
) -> dict:
    """Republish the cluster at ``path`` under ``plan``'s layout.

    The repartition-capable sibling of :func:`~repro_torch.cluster.manifest.
    rolling_publish`: shard artifacts are built at the *plan's* boundaries
    (any valid boundary vector — split, merged, or completely re-cut),
    written under fresh token names with their directory entries fsynced,
    and committed by one atomic manifest swap carrying ``layout_epoch + 1``
    and generation-0 shard entries.  When a live service is given it is
    converged through its layout transaction
    (:meth:`~repro_torch.cluster.router.ClusterService.apply_layout`) — queries
    in flight finish on the old layout's pinned workers, everything after
    the swap runs on the new one, nothing is dropped.  The old layout's
    shard dirs are reclaimed only after the commit (open mmaps keep their
    inodes alive).  A crash anywhere before the commit leaves the previous
    cluster fully intact.  ``device`` is where each new shard is indexed
    (a host without CUDA raises before anything is written unless it is
    ``"cpu"``).  Returns the committed manifest.
    """
    manifest = index_io.load_cluster_manifest(path)
    n_docs = int(doc_roots(tree).size)
    plan.validate(n_docs=n_docs)
    specs = specs_from_bounds(tree, list(plan.doc_bounds))
    prev_dirs = [obj["dir"] for obj in manifest["shards"]]
    shard_dirs, routing_file = write_layout_artifacts(path, tree, specs, device)
    shards = []
    for spec, d in zip(specs, shard_dirs):
        ep = plan.endpoint(spec.index)
        eps = [ep] if isinstance(ep, str) else list(ep) if ep else []
        shards.append(
            dict(
                spec.to_json(),
                dir=d,
                generation=0,
                endpoint=eps[0] if eps else None,
                replicas=eps[1:],
            )
        )
    new_manifest = {
        "num_shards": len(specs),
        "num_docs": n_docs,
        "num_nodes": tree.num_nodes,
        "num_keywords": len(tree.vocab),
        "routing_file": routing_file,
        "layout_epoch": int(manifest.get("layout_epoch", 0)) + 1,
        "shards": shards,
    }
    index_io.save_cluster_manifest(path, new_manifest)  # the commit point
    if service is not None:
        service.apply_layout(path, new_manifest)
    for d in prev_dirs:  # reclaim only what the previous manifest named
        if d not in shard_dirs:
            shutil.rmtree(os.path.join(path, d), ignore_errors=True)
    return new_manifest


def move_shard(
    path: str,
    shard: int,
    *,
    host: str = "127.0.0.1",
    port: int = 0,
    service=None,
    backend: str = "torch",
    max_batch: int = 64,
    batch_window_ms: float = 2.0,
    ready_timeout: float = 300.0,
    device: str = "cuda",
) -> tuple[subprocess.Popen, str, dict]:
    """Move shard ``shard`` onto a (new) server at ``host``.

    Launches a standalone shard server over the shard's committed artifact
    dir (:mod:`repro_torch.cluster.workers.server`; ``host`` is the bind/advertise
    address — on a real target host this runs via its deployment channel),
    flips the manifest's ``endpoint`` for the shard, and, when a live
    service is given, converges it: the new endpoint is dialed and
    installed, and the source worker drains — it finishes its in-flight
    gathers and is closed after the last one, so the move drops nothing.
    Content is unchanged (same artifact, same generation), so edge caches
    stay valid.  The server searches on ``device``; one that cannot open
    it fails typed (:class:`~repro_torch.cluster.workers.base.WorkerDied`
    with the server's error) and the manifest is left as it was.  Returns
    ``(proc, endpoint, manifest)``; the caller owns ``proc``.
    """
    from .workers.server import launch_server

    validate_backend(backend)
    manifest = index_io.load_cluster_manifest(path)
    if not 0 <= shard < len(manifest["shards"]):
        raise IndexError(f"shard {shard} out of range")
    entry = manifest["shards"][shard]
    proc, endpoint = launch_server(
        os.path.join(path, entry["dir"]),
        shard=shard,
        backend=backend,
        max_batch=max_batch,
        batch_window_ms=batch_window_ms,
        host=host,
        port=port,
        ready_timeout=ready_timeout,
        device=device,
    )
    try:
        entry["endpoint"], entry["replicas"] = endpoint, []
        index_io.save_cluster_manifest(path, manifest)
        if service is not None:
            service.move_shard(shard, endpoint)
    except BaseException:
        proc.kill()
        raise
    return proc, endpoint, manifest


# referenced by __init__ re-exports; kept at the bottom for a clean
# reading order above
__all__ = [
    "Action",
    "PlacementPlan",
    "apply_actions",
    "doc_heat_weights",
    "move_shard",
    "plan_rebalance",
    "repartition_publish",
]
