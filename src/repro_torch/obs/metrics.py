"""Counters, gauges, and fixed-bucket histograms with Prometheus exposition.

The :class:`LatencyHistogram` is the latency store that replaces
``QueryStats``' unbounded ``latencies_ms`` list: O(#buckets) memory however
long the service lives, O(1) ``observe``, percentile estimates by linear
interpolation inside the hit bucket (so ``p50 <= p99`` always, and the old
half-trim recency bias is gone — every sample since startup weighs in), and
merge-by-bucket-sum across workers (the property ``np.percentile`` over
concatenated sample lists never had: it silently re-weighted whichever
worker kept more samples).

:class:`MetricsRegistry` is the gateway's scrape surface: named counters /
gauges / histograms rendered in the Prometheus text exposition format
(``GET /metrics``).  Metric names are sanitized to the Prometheus charset;
histograms render cumulative ``le`` buckets plus ``_sum``/``_count``.
"""
from __future__ import annotations

import re
import threading
import time

import numpy as np

# log-spaced latency bucket upper bounds, 0.1ms .. 10s — wide enough for a
# cold first-launch compile, fine enough near the serving sweet spot for a
# usable p50/p99 estimate.  Merging histograms requires identical edges, so
# every QueryStats across every process uses this one default.
DEFAULT_BUCKETS_MS: tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_FIX = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str) -> str:
    """Coerce an arbitrary key into a legal Prometheus metric name."""
    name = _NAME_FIX.sub("_", str(name))
    if not name or not _NAME_OK.match(name):
        name = "_" + name
    return name


class BucketMismatchError(ValueError):
    """Merging histograms with different bucket edges would misaccount.

    Every process is supposed to share :data:`DEFAULT_BUCKETS_MS`; a
    mismatch means a peer on a diverged build, and silently re-binning its
    mass would corrupt the percentile estimates on both sides.  Callers
    that roll up across versions (``QueryStats.merge``) catch this, count
    it, and fold the peer's raw sample window instead.
    """

    def __init__(self, expected: tuple[float, ...], got: tuple[float, ...]):
        self.expected = tuple(expected)
        self.got = tuple(got)
        super().__init__(
            f"histogram bucket edges mismatch: expected {len(self.expected)} "
            f"edges {self.expected[:3]}..., got {len(self.got)} edges "
            f"{self.got[:3]}..."
        )


class LatencyHistogram:
    """Fixed-bucket histogram of latencies (milliseconds).

    Not self-locking: every holder (QueryStats under a service lock, a
    Histogram under the registry lock) already serializes its mutations,
    exactly as the list it replaces did.
    """

    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: tuple[float, ...] = DEFAULT_BUCKETS_MS):
        self.edges = tuple(float(e) for e in edges)
        # counts[i] <= edges[i]; counts[-1] is the +Inf overflow bucket
        self.counts = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0

    # ------------------------------------------------------------------ #
    def observe(self, ms: float) -> int:
        """Record one sample; returns the index of the bucket it landed in
        (callers that keep per-bucket exemplars reuse it)."""
        ms = float(ms)
        i = int(np.searchsorted(self.edges, ms, side="left"))
        self.counts[i] += 1
        self.sum += ms
        self.count += 1
        return i

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        if other.edges != self.edges:
            # a peer on a diverged build: refuse loudly instead of silently
            # re-binning its mass into the wrong buckets
            raise BucketMismatchError(self.edges, other.edges)
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count
        return self

    def percentile(self, p: float) -> float:
        """Latency estimate at percentile ``p`` by in-bucket interpolation.

        Monotone in ``p`` and strictly positive for any observed sample
        (the estimate interpolates up from the bucket's lower edge).  The
        overflow bucket reports its lower edge — beyond the largest edge
        the histogram deliberately has no resolution.
        """
        if self.count == 0:
            return 0.0
        target = max(float(p), 0.0) / 100.0 * self.count
        target = min(max(target, 1e-9), float(self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.edges[i - 1] if i > 0 else 0.0
                if i >= len(self.edges):
                    return float(self.edges[-1])
                hi = self.edges[i]
                frac = (target - cum) / c
                return float(lo + frac * (hi - lo))
            cum += c
        return float(self.edges[-1])

    # ------------------------------------------------------------------ #
    def copy(self) -> "LatencyHistogram":
        out = LatencyHistogram(self.edges)
        out.counts = list(self.counts)
        out.sum = self.sum
        out.count = self.count
        return out

    def to_dict(self) -> dict:
        return {
            "edges": list(self.edges),
            "counts": list(self.counts),
            "sum": round(self.sum, 3),
            "count": self.count,
        }

    @classmethod
    def from_dict(cls, obj: dict) -> "LatencyHistogram":
        out = cls(tuple(obj.get("edges", DEFAULT_BUCKETS_MS)))
        counts = [int(c) for c in obj.get("counts", [])]
        if len(counts) == len(out.counts):
            out.counts = counts
        out.sum = float(obj.get("sum", 0.0))
        out.count = int(obj.get("count", 0))
        return out

    @classmethod
    def from_samples(cls, samples) -> "LatencyHistogram":
        out = cls()
        for s in samples:
            out.observe(float(s))
        return out


# ---------------------------------------------------------------------- #
# Registry metric wrappers
# ---------------------------------------------------------------------- #


class Counter:
    """Monotonically increasing named value."""

    kind = "counter"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def set(self, v: float) -> None:
        """Snap to an externally tracked monotonic total (scrape-time sync)."""
        with self._lock:
            self.value = float(v)

    def expose(self, openmetrics: bool = False) -> list[str]:
        v = self.value
        return [f"{self.name} {_fmt(v)}"]


class Gauge:
    """Point-in-time named value."""

    kind = "gauge"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def expose(self, openmetrics: bool = False) -> list[str]:
        return [f"{self.name} {_fmt(self.value)}"]


class Histogram:
    """Registry-held latency histogram (Prometheus ``histogram`` type).

    Each bucket retains its most recent **exemplar** — ``(value, trace
    id, unix ts)`` of the last observation that landed there — rendered in
    the OpenMetrics exposition so a scrape links a p99-bucket spike
    straight to one trace in ``GET /debug/slow``.
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        lock: threading.Lock,
        edges: tuple[float, ...] = DEFAULT_BUCKETS_MS,
    ):
        self.name = name
        self.help = help
        self._lock = lock
        self.hist = LatencyHistogram(edges)
        # exemplars[i] mirrors counts[i]: (value_ms, trace_id, unix_ts)
        self._exemplars: list[tuple[float, str, float] | None] = [None] * (
            len(self.hist.edges) + 1
        )

    def observe(self, ms: float, exemplar: str | None = None) -> None:
        with self._lock:
            i = self.hist.observe(ms)
            if exemplar:
                self._exemplars[i] = (float(ms), str(exemplar), time.time())

    def replace(self, hist: LatencyHistogram) -> None:
        """Adopt an externally maintained histogram (scrape-time sync)."""
        with self._lock:
            self.hist = hist.copy()
            if len(self._exemplars) != len(self.hist.counts):
                self._exemplars = [None] * len(self.hist.counts)

    def percentile(self, p: float) -> float:
        with self._lock:
            return self.hist.percentile(p)

    def exemplars(self) -> list[tuple[float, str, float] | None]:
        with self._lock:
            return list(self._exemplars)

    def expose(self, openmetrics: bool = False) -> list[str]:
        with self._lock:
            h = self.hist.copy()
            ex = list(self._exemplars) if openmetrics else None
        lines = []
        cum = 0
        for i, (edge, c) in enumerate(zip(h.edges, h.counts)):
            cum += c
            lines.append(
                f'{self.name}_bucket{{le="{_fmt(edge)}"}} {cum}'
                + _exemplar_suffix(ex, i)
            )
        lines.append(
            f'{self.name}_bucket{{le="+Inf"}} {h.count}'
            + _exemplar_suffix(ex, len(h.edges))
        )
        lines.append(f"{self.name}_sum {_fmt(h.sum)}")
        lines.append(f"{self.name}_count {h.count}")
        return lines


def _exemplar_suffix(exemplars, i: int) -> str:
    """OpenMetrics exemplar clause: `` # {trace_id="..."} value ts``."""
    if not exemplars or exemplars[i] is None:
        return ""
    value, trace_id, ts = exemplars[i]
    return f' # {{trace_id="{trace_id}"}} {_fmt(value)} {ts:.3f}'


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class MetricsRegistry:
    """Named metrics + the Prometheus text exposition of all of them.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent per
    name); a name registered as one kind cannot be re-registered as
    another.  ``expose()`` renders every metric with ``# HELP``/``# TYPE``
    preambles — the exact format a Prometheus scraper parses.
    """

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw):
        name = sanitize_metric_name(self.prefix + name)
        with self._lock:
            got = self._metrics.get(name)
            if got is not None:
                if not isinstance(got, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {got.kind}"
                    )
                return got
            m = cls(name, help, threading.Lock(), **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self,
        name: str,
        help: str = "",
        edges: tuple[float, ...] = DEFAULT_BUCKETS_MS,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, edges=edges)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def samples(self) -> list[tuple[str, str, float]]:
        """Flat ``(name, kind, value)`` rows for time-series sampling.

        Histograms contribute two counter-shaped components
        (``<name>_count`` and ``<name>_sum``) so their rates are
        plottable alongside plain counters.
        """
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        rows: list[tuple[str, str, float]] = []
        for m in metrics:
            if isinstance(m, Histogram):
                with m._lock:
                    count, total = m.hist.count, m.hist.sum
                rows.append((f"{m.name}_count", "counter", float(count)))
                rows.append((f"{m.name}_sum", "counter", float(total)))
            else:
                rows.append((m.name, m.kind, float(m.value)))
        return rows

    def expose(self, openmetrics: bool = False) -> str:
        """The text exposition: Prometheus classic, or OpenMetrics when
        ``openmetrics=True`` (histogram bucket exemplars + ``# EOF``)."""
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        lines: list[str] = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.expose(openmetrics=openmetrics))
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"
