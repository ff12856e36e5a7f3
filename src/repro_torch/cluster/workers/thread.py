"""ThreadWorker: the shard engine lives in-process.

One :class:`~repro_torch.serve.service.QueryService` drain thread per shard,
behind the :class:`~repro_torch.cluster.workers.base.Worker` seam the router
sees.  Every shard of a thread pool searches on the same device, and every
drain launches on that device's default stream (no drain sets a stream of
its own, and per-thread streams were not tried): the stream orders each
result copy after every earlier launch, so the drains need no device-wide
sync and do not overlap on the device.
"""
from __future__ import annotations

from concurrent.futures import Future

from repro_torch.core.engine import KeywordSearchEngine, QueryStats
from repro_torch.obs import TRACER
from repro_torch.serve.service import QueryService

from ..partition import ShardSpec, doc_roots
from .base import shard_doc_stats


class ThreadWorker:
    """One shard: engine + drain service + document-level query stats."""

    transport = "thread"

    def __init__(
        self,
        spec: ShardSpec,
        engine: KeywordSearchEngine,
        *,
        backend: str = "torch",
        max_batch: int = 64,
        batch_window_ms: float = 2.0,
    ):
        self.spec = spec
        self.engine = engine
        self.service = QueryService(
            engine,
            max_batch=max_batch,
            batch_window_ms=batch_window_ms,
            backend=backend,
            device=engine.device,
        )
        # local ids of this shard's document roots (children of the replica
        # root), ascending — the probe set for doc_stats
        self._doc_roots = doc_roots(engine.tree)

    def submit(self, keywords: list[str], semantics: str, trace=None) -> Future:
        return self.service.submit(keywords, semantics, trace=trace)

    def doc_stats(self, kw_ids: list[int], trace=None) -> Future:
        fut: Future = Future()
        span = TRACER.start(trace, "worker.doc_stats", shard=self.spec.index)
        try:
            fut.set_result(
                shard_doc_stats(
                    self.engine.base.containment, self._doc_roots, kw_ids
                )
            )
        except Exception as e:
            span.annotate(error=f"{type(e).__name__}: {e}")
            fut.set_exception(e)
        span.end()
        return fut

    def health(self) -> tuple[int, int]:
        return 1, 1 if self.service._thread.is_alive() else 0

    def stats(self) -> QueryStats:
        return self.service.stats()

    def drain(self, timeout: float = 30.0) -> None:
        # QueryService.close drains the queue and stops the thread; the
        # engine stays readable, so doc_stats/stats keep working — exactly
        # the "drained but answerable" phase the router's shutdown needs
        self.service.close(timeout)

    def close(self, timeout: float = 30.0) -> None:
        self.service.close(timeout)
