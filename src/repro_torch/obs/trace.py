"""Per-query distributed tracing: spans, contexts, and the process tracer.

Tracing is *opt-in per query*: a query carries a W3C-style ``traceparent``
(``00-<32hex trace id>-<16hex span id>-01``) and every layer it passes
through opens spans under that parent — gateway request, edge-cache probe,
router fanout, per-shard gather, hedged replica attempts, the worker RPC,
the service batch window, and the engine's plan/kernel phases.  A query
without a traceparent costs one ``None`` check per layer
(:data:`NULL_SPAN`'s methods are no-ops), which is what keeps tracing-on
serving within a few percent of tracing-off (see ``benchmarks/compare.py``).

Cross-process assembly mirrors how real collectors work, minus the
collector: each process records its spans locally in its own
:class:`Tracer` (a bounded LRU keyed by trace id), the worker RPC ships a
request's finished spans back in the reply header (``"spans"``, ignored by
old peers), and the client *adopts* them into its local store — so by the
time the gateway answers an HTTP request, its tracer holds the full span
tree across every process the query touched, under one trace id.

Span relationships are plain parent pointers (``parent_id``); nothing here
needs thread-local context propagation — contexts are passed explicitly
down the call path, which is cheaper and impossible to leak across the
drain/reader threads the serving stack runs on.
"""
from __future__ import annotations

import os
import random
import secrets
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass

# traceparent: version "00", 16-byte trace id, 8-byte span id, flags "01"
_TP_VERSION = "00"
_TP_FLAGS = "01"

# Trace ids come from ``secrets`` (they cross trust boundaries in HTTP
# headers); span ids only need uniqueness *within* one trace, so they use
# a cheap securely-seeded PRNG — ~3x faster per span, and span creation
# sits on the traced hot path (the <5% overhead budget compare.py gates).
_span_rng = random.Random(secrets.randbits(64))
if hasattr(os, "register_at_fork"):  # a fork duplicates the PRNG state
    os.register_at_fork(
        after_in_child=lambda: _span_rng.seed(secrets.randbits(64))
    )


def new_trace_id() -> str:
    return secrets.token_hex(16)


def new_span_id() -> str:
    return f"{_span_rng.getrandbits(64):016x}"


@dataclass(frozen=True)
class TraceContext:
    """(trace id, span id) — the parent coordinates a child span needs."""

    trace_id: str
    span_id: str

    @property
    def traceparent(self) -> str:
        return f"{_TP_VERSION}-{self.trace_id}-{self.span_id}-{_TP_FLAGS}"


def make_traceparent(trace_id: str, span_id: str) -> str:
    return f"{_TP_VERSION}-{trace_id}-{span_id}-{_TP_FLAGS}"


def parse_traceparent(tp) -> TraceContext | None:
    """A :class:`TraceContext`, or None for anything malformed.

    Lenient on purpose: a bad header from an untrusted client means "not
    traced", never a 4xx — tracing must not be able to fail a query.
    """
    if isinstance(tp, TraceContext):
        return tp
    if not isinstance(tp, str):
        return None
    parts = tp.split("-")
    if len(parts) != 4:
        return None
    _ver, trace_id, span_id, _flags = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id)


class Span:
    """One timed operation in a trace; record into the tracer via ``end``.

    A plain ``__slots__`` class, not a dataclass: span construction sits
    on the traced hot path (dozens per fanned-out query), and the slotted
    hand-rolled ``__init__`` is measurably cheaper.
    """

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "attrs",
        "t0_ms", "dur_ms", "_t0_perf", "_tracer",
    )

    def __init__(
        self,
        trace_id: str,
        span_id: str,
        parent_id: str | None,
        name: str,
        attrs: dict | None = None,
        _tracer: "Tracer | None" = None,
    ):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.attrs = attrs if attrs is not None else {}
        self.t0_ms = time.time() * 1e3  # wall clock, epoch ms
        self.dur_ms: float | None = None
        self._t0_perf = time.perf_counter()
        self._tracer = _tracer

    @property
    def ctx(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def annotate(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self, **attrs) -> "Span":
        if self.dur_ms is None:  # idempotent: first end wins
            if attrs:
                self.attrs.update(attrs)
            self.dur_ms = (time.perf_counter() - self._t0_perf) * 1e3
            if self._tracer is not None:
                self._tracer.record(self)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, etype, exc, tb) -> None:
        if exc is not None:
            self.annotate(error=f"{etype.__name__}: {exc}")
        self.end()

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "t0_ms": round(self.t0_ms, 3),
            "dur_ms": round(self.dur_ms, 3) if self.dur_ms is not None else None,
            "attrs": dict(self.attrs),
        }


class _NullSpan:
    """The no-op span untraced queries get; every method is free."""

    __slots__ = ()
    ctx = None
    trace_id = None

    def annotate(self, **attrs) -> "_NullSpan":
        return self

    def end(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Process-local span store, bounded LRU by trace id.

    ``start`` opens a live span under a parent (a :class:`TraceContext`, a
    ``traceparent`` string, or None → :data:`NULL_SPAN`); ``emit`` records
    an already-timed span (the engine's phase timings); ``adopt`` ingests
    spans a remote worker shipped back; ``collect`` pops a trace's spans
    for assembly.  All operations are O(1) amortized and lock-protected —
    spans arrive from drain threads, reader threads, and timer threads.
    """

    def __init__(self, max_traces: int = 2048):
        self.enabled = True
        self.max_traces = int(max_traces)
        self._lock = threading.Lock()
        self._spans: OrderedDict[str, list[dict]] = OrderedDict()

    # ------------------------------------------------------------------ #
    def start(self, parent, name: str, **attrs):
        """A live child span under ``parent``, or NULL_SPAN when untraced."""
        if not self.enabled:
            return NULL_SPAN
        ctx = parse_traceparent(parent)
        if ctx is None:
            return NULL_SPAN
        return Span(
            trace_id=ctx.trace_id,
            span_id=new_span_id(),
            parent_id=ctx.span_id,
            name=name,
            attrs=attrs,  # **kwargs: a fresh dict we own
            _tracer=self,
        )

    def root(self, name: str, traceparent: str | None = None, **attrs):
        """A root span: a fresh trace, or a child of an incoming header."""
        if not self.enabled:
            return NULL_SPAN
        ctx = parse_traceparent(traceparent)
        return Span(
            trace_id=ctx.trace_id if ctx is not None else new_trace_id(),
            span_id=new_span_id(),
            parent_id=ctx.span_id if ctx is not None else None,
            name=name,
            attrs=attrs,  # **kwargs: a fresh dict we own
            _tracer=self,
        )

    def emit(
        self, parent, name: str, t0_ms: float, dur_ms: float, **attrs
    ) -> TraceContext | None:
        """Record a completed span directly; returns its ctx (for nesting)."""
        if not self.enabled:
            return None
        ctx = parse_traceparent(parent)
        if ctx is None:
            return None
        span_id = new_span_id()
        self._store(
            ctx.trace_id,
            {
                "trace_id": ctx.trace_id,
                "span_id": span_id,
                "parent_id": ctx.span_id,
                "name": name,
                "t0_ms": round(float(t0_ms), 3),
                "dur_ms": round(float(dur_ms), 3),
                "attrs": dict(attrs),
            },
        )
        return TraceContext(ctx.trace_id, span_id)

    def emit_many(self, parent, spans: list[dict]) -> None:
        """Record many completed child spans of ``parent`` at once.

        ``spans`` are ``{"name", "t0_ms", "dur_ms", "attrs"?}`` dicts (the
        engine's phase timings).  One id/parse pass and one lock trip for
        the whole list — a traced batch emits its phase spans per item, so
        this path is measurably hotter than one-off ``emit`` calls.
        """
        if not self.enabled or not spans:
            return
        ctx = parse_traceparent(parent)
        if ctx is None:
            return
        tid, pid = ctx.trace_id, ctx.span_id
        rows = [
            {
                "trace_id": tid,
                "span_id": new_span_id(),
                "parent_id": pid,
                "name": s["name"],
                "t0_ms": round(float(s["t0_ms"]), 3),
                "dur_ms": round(float(s["dur_ms"]), 3),
                "attrs": s.get("attrs", {}),
            }
            for s in spans
        ]
        with self._lock:
            bucket = self._spans.get(tid)
            if bucket is None:
                bucket = self._spans[tid] = []
            else:
                self._spans.move_to_end(tid)
            bucket.extend(rows)
            while len(self._spans) > self.max_traces:
                self._spans.popitem(last=False)

    def record(self, span: Span) -> None:
        # the live Span object is stored as-is; serialization to a dict is
        # deferred to ``collect`` — a span that is never collected (LRU
        # eviction, nobody asked for the trace) never pays for it
        self._store(span.trace_id, span)

    def adopt(self, spans) -> None:
        """Ingest spans shipped from another process (RPC reply headers)."""
        if not self.enabled or not spans:
            return
        for s in spans:
            if isinstance(s, dict) and s.get("trace_id"):
                self._store(s["trace_id"], s)

    def _store(self, trace_id: str, span: "dict | Span") -> None:
        with self._lock:
            bucket = self._spans.get(trace_id)
            if bucket is None:
                bucket = self._spans[trace_id] = []
            else:
                self._spans.move_to_end(trace_id)
            bucket.append(span)
            while len(self._spans) > self.max_traces:
                self._spans.popitem(last=False)

    # ------------------------------------------------------------------ #
    def collect(self, trace_id: str, pop: bool = True) -> list[dict]:
        """Every recorded span of one trace (popped from the store)."""
        with self._lock:
            if pop:
                bucket = self._spans.pop(trace_id, [])
            else:
                bucket = list(self._spans.get(trace_id, []))
        return [s if isinstance(s, dict) else s.to_dict() for s in bucket]

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    @staticmethod
    def build_tree(spans: list[dict]) -> list[dict]:
        """Nest spans by parent pointers: a list of root span trees.

        Spans whose parent is absent from the set (the caller's side of a
        cross-process hop that was never shipped back) surface as roots —
        a partial trace renders as a forest instead of vanishing.
        """
        by_id = {s["span_id"]: dict(s, children=[]) for s in spans}
        roots: list[dict] = []
        for node in by_id.values():
            parent = by_id.get(node.get("parent_id"))
            if parent is None:
                roots.append(node)
            else:
                parent["children"].append(node)
        for node in by_id.values():
            node["children"].sort(key=lambda c: c.get("t0_ms") or 0.0)
        roots.sort(key=lambda c: c.get("t0_ms") or 0.0)
        return roots


#: the process-wide tracer every serving layer records into
TRACER = Tracer()


def emit_phases(parent, phases: list[dict]) -> None:
    """Record the engine's per-phase timings as child spans of ``parent``.

    Phases are the ``{"name", "t0_ms", "dur_ms", "attrs"}`` dicts the plan
    cache / DAG search append when asked to time themselves (they know
    nothing about tracing, only wall-clock timing).
    """
    TRACER.emit_many(parent, phases)


class TraceSampler:
    """Head rate-limiting + tail retention, so tracing survives load.

    Two decisions per request:

      * :meth:`head` — should this request propagate trace context
        downstream?  A token bucket refilled at ``max_per_s`` (burst =
        2s of budget); ``max_per_s <= 0`` means unlimited (the default —
        every request fully traced, exactly the pre-sampler behavior).
        Under load the bucket empties and excess requests run with only
        their cheap root span.
      * :meth:`keep` — should the finished trace be retained (slow-log
        entry, span tree)?  **Slow and errored traces are always kept**,
        even when head sampling suppressed their downstream spans — the
        tail-based half: the requests worth debugging never vanish because
        the system was busy.

    Env knobs (read by the gateway): ``XKS_TRACE_MAX_PER_S`` (default 0 =
    unlimited) and ``XKS_TRACE_SLOW_MS`` (default 100).
    """

    def __init__(self, max_per_s: float = 0.0, slow_ms: float = 100.0):
        self.max_per_s = float(max_per_s)
        self.slow_ms = float(slow_ms)
        self._lock = threading.Lock()
        self._burst = max(self.max_per_s, 1.0) * 2.0
        self._tokens = self._burst
        self._t_last = time.monotonic()
        self.sampled = 0
        self.suppressed = 0

    def head(self) -> bool:
        """True = trace this request end to end (token available)."""
        if self.max_per_s <= 0:
            with self._lock:
                self.sampled += 1
            return True
        now = time.monotonic()
        with self._lock:
            self._tokens = min(
                self._burst,
                self._tokens + (now - self._t_last) * self.max_per_s,
            )
            self._t_last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.sampled += 1
                return True
            self.suppressed += 1
            return False

    def keep(
        self, latency_ms: float, error: bool = False, sampled: bool = True
    ) -> bool:
        """True = retain the finished trace (always for slow/error)."""
        return bool(error) or float(latency_ms) >= self.slow_ms or bool(sampled)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "max_per_s": self.max_per_s,
                "slow_ms": self.slow_ms,
                "sampled": self.sampled,
                "suppressed": self.suppressed,
            }


class SlowQueryLog:
    """Bounded ring of the slowest recent queries, with their span trees."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._entries: deque = deque(maxlen=self.max_entries)

    def add(self, record: dict) -> None:
        with self._lock:
            self._entries.append(record)

    def worst(self, n: int = 10) -> list[dict]:
        with self._lock:
            entries = list(self._entries)
        entries.sort(key=lambda r: r.get("latency_ms", 0.0), reverse=True)
        return entries[: max(int(n), 0)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
