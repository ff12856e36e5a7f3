"""Generation-stamped edge result cache.

The cluster's per-shard ``generation`` stamps (bumped by
``reload_shard`` during a rolling republish) double as a cache-coherence
signal: a cached result is valid exactly while every shard it *touched*
still serves the generation it was computed against.  The gateway stamps
each entry with (touched shards, generation vector captured **before**
submit) — if a reload lands mid-flight the stamp is older than what
actually served the query, so the entry dies on its first lookup after
the bump: over-invalidation, never staleness.

Generations cover *content* changes; the cluster's ``layout_epoch``
covers *boundary* changes.  A repartition resets every generation to 0,
so a same-shard-count repartition could alias a stale stamp — entries
are therefore additionally stamped with the epoch they were computed
under, and any epoch drift invalidates on lookup.

Keys are :attr:`repro_torch.api.Query.cache_key` (normalized keywords +
semantics + index — backend excluded, all backends must agree on ids).
LRU-bounded; plain dict+lock, no daemon.
"""
from __future__ import annotations

import threading
from collections import OrderedDict


class EdgeCache:
    """LRU of query results, invalidated by shard generation drift."""

    def __init__(self, max_entries: int = 1024):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        # key -> (value, touched shards, generation vector, layout epoch)
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.evictions = 0

    def get(self, key, generations: tuple[int, ...], epoch: int = 0):
        """The cached value, or None (miss / entry went stale).

        ``generations`` is the cluster's *current* vector and ``epoch``
        its current ``layout_epoch``; an entry whose touched shards
        drifted from their stamped generations, whose vector length
        changed, or whose layout epoch moved (a repartition — shard
        indices mean different document ranges now) is dropped on the
        spot.
        """
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            value, touched, stamped, stamped_epoch = ent
            stale = (
                int(epoch) != stamped_epoch
                or len(generations) != len(stamped)
                or any(generations[s] != stamped[s] for s in touched)
            )
            if stale:
                del self._entries[key]
                self.invalidations += 1
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return value

    def put(
        self, key, value, touched, generations: tuple[int, ...], epoch: int = 0
    ) -> None:
        """Stamp and store; ``generations``/``epoch`` must predate the
        execution (captured before submit, so a swap landing mid-flight
        invalidates rather than aliases)."""
        touched = tuple(int(s) for s in touched)
        if any(s >= len(generations) for s in touched):
            return  # stamp cannot cover the touched set: don't cache
        with self._lock:
            self._entries[key] = (value, touched, tuple(generations), int(epoch))
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def snapshot(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / lookups, 4) if lookups else 0.0,
                "invalidations": self.invalidations,
                "evictions": self.evictions,
            }
