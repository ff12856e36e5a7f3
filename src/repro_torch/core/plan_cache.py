"""PlanCache — shared shape-bucket registry for batched device searches.

Every vectorized DAG search round packs a set of work items (one list-of-
IDLists each) into padded arrays and runs one batched search over them.
This module owns the shape policy in one place:

  * list lengths pad to power-of-two buckets, and
  * the leading work-item axis R also pads to a power-of-two bucket.

Padded rows carry ``n0 = 0`` (no valid entries), which every search maps to
an empty result, so R-padding is free of special cases.  PyTorch runs
eagerly, so a shape signature compiles nothing here; the hit/miss counters
keep the reference's meaning (how many distinct packed shapes a process
sees) and feed ``QueryStats`` unchanged.

The cache is engine-owned (each :class:`KeywordSearchEngine` carries one)
and runs on one device.  On CUDA, ``pack`` fills one pinned host buffer and
makes one non-blocking host-to-device copy per launch; the device-to-host
copy of the result is the round's only synchronisation.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.api import resolve_device
from repro_torch.kernels.fused_search import fused_search_batch

from .idlist import IDList
from .search_vec import INT_PAD, bucket, ca_search_batch

_EMPTY = np.zeros(0, dtype=np.int64)


@dataclass(frozen=True)
class PlanKey:
    """Static shape signature of one packed launch."""

    rows: int  # R bucket (work items)
    k: int  # keywords per item
    m0: int  # shortest-list bucket
    mo: int  # other-list bucket
    semantics: str
    backend: str


class PlanCache:
    """Packs work items to bucketed shapes and tracks shape reuse."""

    def __init__(
        self,
        backend: str = "torch",
        min_rows: int = 1,
        device: str | torch.device = "cuda",
    ):
        self.backend = backend
        self.min_rows = min_rows
        self.device = resolve_device(device)
        self.launches = 0  # device calls issued
        self.hits = 0  # launches whose shape signature was seen before
        self.misses = 0  # launches with a new shape signature
        self.rows_padded = 0  # wasted rows across all launches (R padding)
        # fused launches demoted to another path: the port has no shape cap
        # and never demotes, so this stays 0 (kept for the stats schema)
        self.fused_fallbacks = 0
        self._seen: set[tuple] = set()

    # ------------------------------------------------------------------ #
    @property
    def plans(self) -> int:
        """Distinct shape signatures this cache has launched."""
        return len(self._seen)

    def hit_rate(self) -> float:
        return self.hits / self.launches if self.launches else 0.0

    def snapshot(self) -> dict:
        return {
            "plan_launches_total": self.launches,
            "plan_hits": self.hits,
            "plan_misses": self.misses,
            "plans": self.plans,
            "plan_hit_rate": round(self.hit_rate(), 4),
            "rows_padded": self.rows_padded,
            "fused_fallbacks": self.fused_fallbacks,
        }

    def reset_counters(self) -> None:
        """Zero the counters but keep the seen-shape set."""
        self.launches = self.hits = self.misses = self.rows_padded = 0

    @staticmethod
    def executable_count() -> int:
        """Compiled executables behind the cache: -1, "unknown".

        PyTorch runs eagerly and keeps no per-shape executable cache to
        count; callers must treat -1 as "unknown", not "zero"."""
        return -1

    # ------------------------------------------------------------------ #
    def pack(
        self,
        per_item: list[list[IDList]],
        keys: list,
        semantics: str = "slca",
        backend: str = "torch",
    ):
        """Pad items' lists to shared buckets; stack along a bucketed R axis.

        Items with any empty list are dropped (their intersection is empty).
        Returns (batch dict of int32 tensors on the cache's device | None,
        kept_keys, plan_key | None).
        """
        keep = [i for i, ls in enumerate(per_item) if ls and all(len(l) for l in ls)]
        if not keep:
            return None, [], None
        keys = [keys[i] for i in keep]
        per_item = [per_item[i] for i in keep]
        k = len(per_item[0])
        m0 = bucket(max(min(len(l) for l in ls) for ls in per_item))
        mo = bucket(max(max(len(l) for l in ls) for ls in per_item))
        rows = bucket(len(keys), minimum=self.min_rows)
        self.rows_padded += rows - len(keys)

        shapes = {
            "ids0": (rows, m0),
            "pid0": (rows, m0),
            "ndesc0": (rows, m0),
            "other_ids": (rows, k - 1, mo),
            "other_ndesc": (rows, k - 1, mo),
            "n0": (rows,),
            "other_n": (rows, k - 1),
        }
        sizes = [int(np.prod(s)) for s in shapes.values()]
        # one host buffer (pinned on CUDA) holds every array, so the batch
        # reaches the device in a single copy
        host = torch.empty(
            sum(sizes), dtype=torch.int32,
            pin_memory=self.device.type == "cuda",
        )
        flat = host.numpy()
        views, off = {}, 0
        for (name, shape), size in zip(shapes.items(), sizes):
            views[name] = flat[off : off + size].reshape(shape)
            off += size
        ids0, pid0, nd0 = views["ids0"], views["pid0"], views["ndesc0"]
        oids, ond = views["other_ids"], views["other_ndesc"]
        n0, on = views["n0"], views["other_n"]
        ids0.fill(INT_PAD)
        pid0.fill(-1)
        nd0.fill(0)
        oids.fill(INT_PAD)
        ond.fill(0)
        n0.fill(0)
        on.fill(0)
        for r, ls in enumerate(per_item):
            order = np.argsort([len(l) for l in ls], kind="stable")
            ls = [ls[i] for i in order]
            l0 = ls[0]
            n = len(l0)
            ids0[r, :n] = l0.ids
            nd0[r, :n] = l0.ndesc
            pid0[r, :n] = np.where(
                l0.pidpos >= 0, l0.ids[np.clip(l0.pidpos, 0, n - 1)], -1
            )
            n0[r] = n
            for j, l in enumerate(ls[1:]):
                oids[r, j, : len(l)] = l.ids
                ond[r, j, : len(l)] = l.ndesc
                on[r, j] = len(l)
        dev = host.to(self.device, non_blocking=True)
        batch, off = {}, 0
        for (name, shape), size in zip(shapes.items(), sizes):
            batch[name] = dev[off : off + size].view(shape)
            off += size
        return batch, keys, PlanKey(rows, k, m0, mo, semantics, backend)

    # ------------------------------------------------------------------ #
    def run(
        self,
        per_item: list[list[IDList]],
        keys: list,
        semantics: str = "slca",
        backend: str | None = None,
        phases: list | None = None,
    ) -> dict:
        """Search every work item in one (bucketed) launch.

        Returns {key: sorted int64 result ids} for *every* input key; items
        dropped at packing (an empty list => empty intersection) map to the
        empty result.

        ``phases`` (when a traced query asks for timing) collects
        ``{"name", "t0_ms", "dur_ms", "attrs"}`` dicts for the pack step
        and the search launch — the per-phase spans the tracing layer
        attaches under the query's execute span.  ``None`` (every untraced
        call) skips all timing work.
        """
        backend = backend or self.backend
        out = {key: _EMPTY for key in keys}
        if phases is not None:
            w0, p0 = time.time() * 1e3, time.perf_counter()
        batch, kept, sig = self.pack(per_item, keys, semantics, backend)
        if batch is None:
            return out
        if sig in self._seen:
            self.hits += 1
            hit = True
        else:
            self._seen.add(sig)
            self.misses += 1
            hit = False
        self.launches += 1
        if phases is not None:
            p1 = time.perf_counter()
            phases.append({
                "name": "plan.pack", "t0_ms": w0, "dur_ms": (p1 - p0) * 1e3,
                "attrs": {
                    "rows": sig.rows, "k": sig.k, "m0": sig.m0, "mo": sig.mo,
                    "plan_hit": hit,
                },
            })
            w1 = time.time() * 1e3
        fused = backend == "fused"
        if fused:
            ids, mask = fused_search_batch(**batch, semantics=semantics)
        else:
            ids, mask = ca_search_batch(**batch, semantics=semantics, backend=backend)
        # the device-to-host copy is the round's only synchronisation
        ids = ids.cpu().numpy()
        mask = mask.cpu().numpy()
        if phases is not None:
            attrs = {"backend": backend, "semantics": semantics, "rows": sig.rows}
            if fused:
                attrs.update(k=sig.k, m0=sig.m0, mo=sig.mo)
            phases.append({
                "name": "kernel.fused_round" if fused else "kernel.ca_search",
                "t0_ms": w1, "dur_ms": (time.perf_counter() - p1) * 1e3,
                "attrs": attrs,
            })
        for r, key in enumerate(kept):
            out[key] = ids[r][mask[r]].astype(np.int64)
        return out
