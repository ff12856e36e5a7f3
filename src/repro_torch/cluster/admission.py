"""Admission control: bounded per-shard queues with typed load shedding.

The router admits a query only if *every* shard it fans out to has queue
room; otherwise the query is shed immediately with :class:`Overloaded`
(callers back off / retry elsewhere) instead of piling latency onto an
already-saturated shard.  All-or-nothing admission means a slow shard sheds
exactly the traffic that would have touched it — queries routed around it by
the keyword bitmap are unaffected.

Depth accounting is done here rather than by peeking at the per-shard drain
queues: a slot is held from admission until the *merged* result is delivered,
so in-flight scatter-gather work counts against the bound too, not just
undrained submissions.
"""
from __future__ import annotations

import threading


class Overloaded(RuntimeError):
    """Raised by the cluster router when a shard's admission queue is full."""

    def __init__(self, shard: int, depth: int, limit: int):
        self.shard = shard
        self.depth = depth
        self.limit = limit
        super().__init__(
            f"shard {shard} overloaded: {depth} queries in flight (limit {limit})"
        )


class AdmissionController:
    """All-or-nothing slot accounting across the shards of one fanout."""

    def __init__(self, num_shards: int, max_queue_per_shard: int):
        if max_queue_per_shard < 1:
            raise ValueError("max_queue_per_shard must be >= 1")
        self.limit = int(max_queue_per_shard)
        self._depth = [0] * num_shards
        self._shed = [0] * num_shards
        self._admitted = 0
        self._lock = threading.Lock()

    def acquire(self, shards: list[int]) -> None:
        """Take one slot on every shard, or shed (raise) taking none."""
        with self._lock:
            for s in shards:
                if self._depth[s] >= self.limit:
                    self._shed[s] += 1
                    raise Overloaded(s, self._depth[s], self.limit)
            for s in shards:
                self._depth[s] += 1
            self._admitted += 1

    def release(self, shards: list[int]) -> None:
        with self._lock:
            for s in shards:
                self._depth[s] -= 1

    def resized(self, num_shards: int) -> AdmissionController:
        """A fresh controller for a new shard count (layout transaction).

        Depths start empty — in-flight gathers release their slots into the
        controller that admitted them, never into this one.  The cumulative
        admitted/shed totals carry over so cluster-wide counters stay
        monotonic across a repartition; per-shard shed counts map
        positionally, with any truncated tail folded into the last shard
        (old boundaries have no exact image in the new layout).
        """
        out = AdmissionController(num_shards, self.limit)
        with self._lock:
            out._admitted = self._admitted
            n = min(len(self._shed), num_shards)
            out._shed[:n] = self._shed[:n]
            if len(self._shed) > num_shards and num_shards > 0:
                out._shed[-1] += sum(self._shed[num_shards:])
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "admitted": self._admitted,
                "shed": sum(self._shed),
                "shed_per_shard": list(self._shed),
                "queue_depth_per_shard": list(self._depth),
                "queue_depth_max": max(self._depth) if self._depth else 0,
            }
