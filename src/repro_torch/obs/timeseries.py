"""Bounded ring-buffer time series over a :class:`MetricsRegistry`.

``GET /metrics`` is a point-in-time scrape; diagnosing a qps collapse or a
queue-depth ramp needs *history*.  :class:`TimeSeriesStore` samples every
registry metric on a daemon thread at a fixed interval and keeps, per
series, a bounded ring of ``(ts, value)`` points:

  * counters (and histogram ``_count``/``_sum`` components) record the
    **delta** since the previous tick — rate-shaped, ready to plot;
  * gauges record their sampled value.

All series of one tick share the same timestamp, so ``snapshot()`` returns
aligned series a dashboard can overlay without interpolation.  The ring is
a ``deque(maxlen=capacity)``: wraparound drops the oldest points, memory is
``O(series * capacity)`` forever.  ``sample_once()`` is public so tests
and callers can tick deterministically without the thread.

Env knobs (read by the gateway): ``XKS_TS_INTERVAL_S`` (default 5.0,
``<= 0`` disables the sampler thread) and ``XKS_TS_CAPACITY`` (default
720 — one hour of history at the default interval).
"""
from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["TimeSeriesStore"]


class TimeSeriesStore:
    """Sample a registry into per-metric rings on a daemon thread.

    ``registry`` must expose ``samples() -> [(name, kind, value), ...]``
    (see :meth:`repro_torch.obs.metrics.MetricsRegistry.samples`).  An optional
    ``pre_sample`` callback runs before each tick — the gateway uses it to
    sync service-rollup gauges into the registry so sampled series cover
    the whole cluster, not just gateway-local counters.  ``pre_sample``
    failures are swallowed: sampling must never die because one scrape
    target hiccuped.
    """

    def __init__(
        self,
        registry,
        interval_s: float = 5.0,
        capacity: int = 720,
        pre_sample=None,
        clock=time.time,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.registry = registry
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self.pre_sample = pre_sample
        self._clock = clock
        self._lock = threading.Lock()
        self._series: dict[str, dict] = {}  # name -> {"kind", "ring"}
        self._prev: dict[str, float] = {}  # cumulative values, for deltas
        self.ticks = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ #
    # Sampling
    # ------------------------------------------------------------------ #
    def sample_once(self, now: float | None = None) -> float:
        """Take one aligned sample of every registry metric; returns its ts."""
        if self.pre_sample is not None:
            try:
                self.pre_sample()
            except Exception:
                pass  # a failed sync still samples what the registry holds
        ts = round(float(self._clock() if now is None else now), 3)
        rows = self.registry.samples()
        with self._lock:
            for name, kind, value in rows:
                s = self._series.get(name)
                if s is None:
                    s = self._series[name] = {
                        "kind": kind,
                        "ring": deque(maxlen=self.capacity),
                    }
                if kind == "gauge":
                    point = float(value)
                else:  # counter-shaped: per-tick delta
                    point = float(value) - self._prev.get(name, 0.0)
                    if point < 0:  # counter reset (process restart)
                        point = float(value)
                    self._prev[name] = float(value)
                s["ring"].append((ts, round(point, 6)))
            self.ticks += 1
        return ts

    # ------------------------------------------------------------------ #
    # Reads
    # ------------------------------------------------------------------ #
    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def series(self, name: str) -> list[tuple[float, float]]:
        """Aligned ``(ts, value)`` points for one metric, oldest first."""
        with self._lock:
            s = self._series.get(name)
            return list(s["ring"]) if s is not None else []

    def snapshot(self, name: str | None = None, last: int | None = None) -> dict:
        """Versioned JSON form of every (or one filtered) series.

        ``name`` is a substring filter; ``last`` keeps only the most
        recent N points per series.
        """
        with self._lock:
            out = {}
            for key, s in sorted(self._series.items()):
                if name and name not in key:
                    continue
                points = list(s["ring"])
                if last is not None and last >= 0:
                    points = points[-last:]
                out[key] = {
                    "kind": s["kind"],
                    "points": [[ts, v] for ts, v in points],
                }
            return {
                "version": 1,
                "kind": "xks-timeseries",
                "interval_s": self.interval_s,
                "capacity": self.capacity,
                "ticks": self.ticks,
                "series": out,
            }

    # ------------------------------------------------------------------ #
    # Lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> "TimeSeriesStore":
        """Launch the daemon sampler (no-op if disabled or already running)."""
        if self.interval_s <= 0 or self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="timeseries-sampler", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                pass  # one bad tick must not kill the sampler

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout)
