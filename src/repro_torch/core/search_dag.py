"""DAG keyword search on the vectorized backend (frontier-batched RCs).

The paper searches redundancy components lazily and recursively.  A device
cannot recurse data-dependently, so we run *frontier rounds*: every RC
referenced by a dummy result of the previous round is packed (same bucket
shapes) and searched in one batched device call.  Memoisation matches the
paper (each RC searched at most once per query); splicing nested results by
RCPM offsets is host-side numpy (data movement, not compute).
"""
from __future__ import annotations

import time

import numpy as np

from .components import IDClusterIndex
from .plan_cache import PlanCache

_FALLBACK_PLAN: PlanCache | None = None


def _plan_or_default(plan: PlanCache | None) -> PlanCache:
    """Callers without an engine share one module-level PlanCache (on the
    default device, CUDA)."""
    global _FALLBACK_PLAN
    if plan is not None:
        return plan
    if _FALLBACK_PLAN is None:
        _FALLBACK_PLAN = PlanCache()
    return _FALLBACK_PLAN


def dag_search_vec(
    index: IDClusterIndex,
    kws: list[int],
    semantics: str = "slca",
    backend: str = "torch",
    stats: dict | None = None,
    plan: PlanCache | None = None,
    phases: list | None = None,
) -> np.ndarray:
    """Frontier-batched DAG search; returns sorted original node ids.

    ``phases`` (traced queries only) collects per-phase timing dicts from
    the plan cache's pack/launch steps, and from the per-RC chained loop,
    which runs outside the plan cache (on the plan's device).
    """
    plan = _plan_or_default(plan)
    launches0 = plan.launches
    chained_launches = 0
    memo: dict[int, np.ndarray] = {}
    frontier = [0]
    rounds = 0
    while frontier:
        rounds += 1
        if backend == "chained":
            from repro_torch.kernels import ops  # lazy: avoid cycle

            if phases is not None:
                w0, p0 = time.time() * 1e3, time.perf_counter()
            results = {
                rc: ops.run_query_chained(
                    index.idlists(rc, kws), semantics=semantics, device=plan.device
                )
                for rc in frontier
            }
            chained_launches += len(frontier)
            if phases is not None:
                phases.append({
                    "name": "kernel.chained_round",
                    "t0_ms": w0,
                    "dur_ms": (time.perf_counter() - p0) * 1e3,
                    "attrs": {"rcs": len(frontier), "round": rounds},
                })
        else:
            results = plan.run(
                [index.idlists(rc, kws) for rc in frontier],
                frontier,
                semantics=semantics,
                backend=backend,
                phases=phases,
            )
        nxt: list[int] = []
        for rc in frontier:
            res = results[rc]
            memo[rc] = res
            root = index.rc_root_id(rc)
            for x in res:
                if x == root:
                    continue
                e = index.rcpm_lookup(int(x))
                if e is not None and e.rc not in memo and e.rc not in nxt:
                    nxt.append(e.rc)
        frontier = nxt
    if stats is not None:
        stats["rounds"] = rounds
        stats["rcs_searched"] = len(memo)
        if backend == "chained":  # chained calls run per RC, outside the cache
            stats["launches"] = chained_launches
        else:
            stats.update(plan.snapshot())  # lifetime counters (plan_* keys)
            stats["launches"] = plan.launches - launches0  # this call only
    return _splice(index, memo, semantics)


def dag_search_vec_multi(
    index: IDClusterIndex,
    queries: list[list[int]],
    semantics: str = "slca",
    backend: str = "torch",
    stats: dict | None = None,
    plan: PlanCache | None = None,
    phases: list | None = None,
) -> list[np.ndarray]:
    """Serve a *batch* of queries: one device launch per frontier round.

    All (query, rc) work items of a round that share a keyword count are
    packed into one launch through the PlanCache — the cross-query batching
    that amortizes dispatch overhead — and the cache's R-bucketing keeps the
    set of packed shapes small across *calls*, not just rounds.  Memoisation
    is per query (different keyword sets ⇒ different RC results).

    ``backend`` picks the device path *inside* the shared batch search:
    "torch" runs ``search_vec.ca_search_batch``; "chained" runs it with the
    searchsorted kernel as its membership step (registered by importing
    :mod:`repro_torch.kernels.ops`); "fused" hands the whole packed batch to
    the hand-written CUDA kernel (:mod:`repro_torch.kernels.fused_search`).
    Either way every launch flows through the PlanCache, whose plan keys
    carry the backend name.
    """
    plan = _plan_or_default(plan)
    launches0 = plan.launches
    memos: list[dict[int, np.ndarray]] = [{} for _ in queries]
    frontier: list[tuple[int, int]] = [
        (qi, 0) for qi, kws in enumerate(queries) if all(k >= 0 for k in kws)
    ]
    rounds = 0
    while frontier:
        rounds += 1
        by_k: dict[int, list[tuple[int, int]]] = {}
        for qi, rc in frontier:
            by_k.setdefault(len(queries[qi]), []).append((qi, rc))
        nxt: list[tuple[int, int]] = []
        for _, items in by_k.items():
            per_item = [index.idlists(rc, queries[qi]) for qi, rc in items]
            results = plan.run(
                per_item, items, semantics=semantics, backend=backend,
                phases=phases,
            )
            for qi, rc in items:
                res = results[(qi, rc)]
                memos[qi][rc] = res
                root = index.rc_root_id(rc)
                for x in res:
                    if x == root:
                        continue
                    e = index.rcpm_lookup(int(x))
                    if e is not None and e.rc not in memos[qi]:
                        # claim with a placeholder so later items of this (and
                        # the next) round cannot re-enqueue the same RC; the
                        # claim is overwritten with the real result when its
                        # frontier round executes
                        memos[qi][e.rc] = None
                        nxt.append((qi, e.rc))
        frontier = nxt
    if stats is not None:
        stats["rounds"] = rounds
        stats.update(plan.snapshot())  # lifetime counters (plan_* keys)
        stats["launches"] = plan.launches - launches0  # this call only
    return [
        _splice(index, memos[qi], semantics)
        if all(k >= 0 for k in queries[qi])
        else np.zeros(0, dtype=np.int64)
        for qi in range(len(queries))
    ]


def _splice(
    index: IDClusterIndex, memo: dict[int, np.ndarray], semantics: str
) -> np.ndarray:
    """Resolve dummy results through the RCPM (host-side materialization).

    The RCPM probe is vectorized per RC (one searchsorted over all results);
    only actual dummies loop."""
    resolved: dict[int, np.ndarray] = {}
    rcs = index.rcs
    dummy_ids = rcs.dummy_ids

    def resolve(rc: int) -> np.ndarray:
        got = resolved.get(rc)
        if got is not None:
            return got
        root = index.rc_root_id(rc)
        res = memo.get(rc, np.zeros(0, dtype=np.int64))
        if dummy_ids.size and res.size:
            pos = np.searchsorted(dummy_ids, res)
            pos_c = np.clip(pos, 0, dummy_ids.size - 1)
            is_dummy = (dummy_ids[pos_c] == res) & (res != root)
        else:
            is_dummy = np.zeros(res.shape, dtype=bool)
        if not is_dummy.any():
            resolved[rc] = res
            return res
        parts = [res[~is_dummy]]
        for _x, p in zip(res[is_dummy], pos_c[is_dummy]):
            parts.append(resolve(int(rcs.dummy_nested_rc[p])) + int(rcs.dummy_offset[p]))
        out = np.concatenate(parts)
        resolved[rc] = out
        return out

    return np.sort(resolve(0))
