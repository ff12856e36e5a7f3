"""The asyncio HTTP/1.1 gateway server (stdlib only, no web framework).

Routes:

  * ``POST /query``  — body is a :class:`repro_torch.api.Query` JSON object
    (``{"keywords": "vinyl reissue", "semantics": "slca"}``); the
    response is the :class:`repro_torch.api.QueryResult` shape plus a
    ``cached`` flag (and a ``trace_id`` when the request was traced)::

        {"ids": [...], "stats": {...}, "generations": [...], "cached": false}

  * ``GET /stats``   — the cluster rollup in the one
    :meth:`~repro_torch.core.engine.QueryStats.to_dict` schema under
    ``service``, gateway counters + cache snapshot under ``gateway``;
  * ``GET /healthz`` — readiness: shard count, generation vector, and
    (when the service reports ``shard_health``) per-shard replica
    liveness — 503 while any shard has zero live replicas;
  * ``GET /metrics`` — the gateway's :class:`~repro_torch.obs.MetricsRegistry`
    in the OpenMetrics text exposition format (request/query/error
    counters, cache gauges, latency histograms with per-bucket trace-id
    exemplars, service rollup, plan-cache hit/miss/launch counters);
  * ``GET /debug/slow?n=10`` — the ``n`` slowest recent queries with
    their assembled span trees (see :mod:`repro_torch.obs.trace`), plus the
    worker-side slow entries shipped home on the stats wire;
  * ``GET /debug/heat?top=10`` — ``ClusterService.load_report()``: the
    versioned per-shard skew report (qps, queue depth, heavy-hitter
    keywords, doc-range heat, replica health);
  * ``GET /debug/timeseries?name=&last=`` — the bounded ring-buffer
    metric history sampled by :class:`~repro_torch.obs.TimeSeriesStore`.

Tracing: every ``POST /query`` opens a root span when tracing is on
(honoring an incoming W3C-style ``traceparent`` header), propagates the
context through the service via :meth:`repro_torch.api.Query.with_trace`, and —
once the result future resolves — collects the whole span tree (local
layers plus the spans remote workers shipped back over the RPC) into the
slow-query log.  The response carries ``trace_id`` so a client can
correlate.

Error mapping: bad JSON / unknown fields / bad semantics / a backend
that is not the port's (the reference's ``jax`` included) → 400 (the
``Query.from_dict`` validation path), admission shed
(:class:`~repro_torch.cluster.admission.Overloaded`) → 429, a shard lost with
every replica (:class:`~repro_torch.cluster.workers.WorkerDied`) → 503, a
gather deadline → 504.  With replicated shards, a single replica kill or
stall never reaches this mapping — the
:class:`~repro_torch.cluster.workers.replica.ReplicaSet` hedges or fails over
below the router.

The event loop runs on one daemon thread; ``ClusterService.submit`` is
called inline (it only routes + enqueues) and its
``concurrent.futures.Future`` is bridged with ``asyncio.wrap_future``,
so many HTTP requests ride the scatter-gather concurrently.  Blocking
surfaces (``service.stats()``'s per-worker RPCs) go through the loop's
executor.  The loop never waits on the card: the shard drains launch their
kernels from their own threads (or processes) and hand back host ids.
"""
from __future__ import annotations

import asyncio
import json
import os
import threading
import time
from urllib.parse import parse_qs

from repro_torch.api import Query
from repro_torch.cluster.admission import Overloaded
from repro_torch.cluster.rebalance import plan_rebalance
from repro_torch.cluster.workers import WorkerDied
from repro_torch.obs import (
    NULL_SPAN,
    TRACER,
    MetricsRegistry,
    SlowQueryLog,
    TimeSeriesStore,
    TraceSampler,
)

from .cache import EdgeCache

MAX_BODY_BYTES = 1 << 20  # a keyword query has no business being >1MiB


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    429: "Too Many Requests", 500: "Internal Server Error",
    503: "Service Unavailable", 504: "Gateway Timeout",
}


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        self.status = status
        self.message = message
        super().__init__(f"{status}: {message}")


class _TextResponse:
    """A text body with an explicit content type (``/metrics``)."""

    __slots__ = ("text", "ctype")

    def __init__(self, text: str, ctype: str):
        self.text = text
        self.ctype = ctype


class Gateway:
    """HTTP front door over one ClusterService (or anything shaped like it).

    ``service`` must provide ``submit(Query) -> Future[QueryResult]``,
    ``generation_vector()``, ``touched(keywords)``, ``stats()``, and
    ``num_shards`` — i.e. a :class:`~repro_torch.cluster.router.ClusterService`.
    ``own_service=True`` makes :meth:`close` also close the service (the
    CLI entrypoint's mode).
    """

    def __init__(
        self,
        service,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        cache_entries: int = 1024,
        request_timeout: float | None = None,
        own_service: bool = False,
        trace: bool = True,
        slow_log_entries: int = 256,
        trace_max_per_s: float | None = None,
        trace_slow_ms: float | None = None,
        ts_interval_s: float | None = None,
        ts_capacity: int | None = None,
    ):
        self.service = service
        self.cache = EdgeCache(cache_entries)
        self.host = host
        self.port = int(port)  # rewritten with the bound port by start()
        self.request_timeout = (
            request_timeout
            if request_timeout is not None
            else getattr(service, "op_timeout", None)
        )
        self._own_service = own_service
        self._lock = threading.Lock()
        self.counters = {"requests": 0, "queries": 0, "errors": 0}
        # per-query tracing at this gateway (workers honor whatever context
        # actually arrives, so this is the one switch that matters end to end)
        self.trace = bool(trace)
        self.slow_log = SlowQueryLog(slow_log_entries)
        # head sampling caps trace volume under load (default unlimited);
        # tail retention still keeps slow/error requests in the slow log
        self.sampler = TraceSampler(
            max_per_s=(
                trace_max_per_s
                if trace_max_per_s is not None
                else _env_float("XKS_TRACE_MAX_PER_S", 0.0)
            ),
            slow_ms=(
                trace_slow_ms
                if trace_slow_ms is not None
                else _env_float("XKS_TRACE_SLOW_MS", 100.0)
            ),
        )
        self.registry = MetricsRegistry(prefix="xks_")
        self.timeseries = TimeSeriesStore(
            self.registry,
            interval_s=(
                ts_interval_s
                if ts_interval_s is not None
                else _env_float("XKS_TS_INTERVAL_S", 5.0)
            ),
            capacity=(
                int(ts_capacity)
                if ts_capacity is not None
                else int(_env_float("XKS_TS_CAPACITY", 720))
            ),
            pre_sample=self._pre_sample,
        )
        self._metric_counters = {
            k: self.registry.counter(
                f"gateway_{k}_total", f"gateway {k} since startup"
            )
            for k in self.counters
        }
        self._m_latency = self.registry.histogram(
            "gateway_request_latency_ms",
            "end-to-end POST /query latency at the gateway (ms)",
        )
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.AbstractServer | None = None
        self._thread: threading.Thread | None = None
        self._closed = False

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    # ------------------------------------------------------------------ #
    # Lifecycle
    # ------------------------------------------------------------------ #
    def start(self, timeout: float = 30.0) -> Gateway:
        """Bind + serve on a daemon thread; returns once the port is bound."""
        started = threading.Event()
        boot_err: list[BaseException] = []

        def run() -> None:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop

            async def boot():
                self._server = await asyncio.start_server(
                    self._handle, self.host, self.port
                )
                self.port = self._server.sockets[0].getsockname()[1]

            try:
                loop.run_until_complete(boot())
            except BaseException as e:
                boot_err.append(e)
                started.set()
                loop.close()
                return
            started.set()
            try:
                loop.run_forever()
            finally:
                self._server.close()
                loop.run_until_complete(self._server.wait_closed())
                # keep-alive handlers still parked on a read must be
                # cancelled and allowed to unwind, or loop.close()
                # destroys them pending
                tasks = [t for t in asyncio.all_tasks(loop) if not t.done()]
                for t in tasks:
                    t.cancel()
                if tasks:
                    loop.run_until_complete(
                        asyncio.gather(*tasks, return_exceptions=True)
                    )
                loop.close()

        self._thread = threading.Thread(
            target=run, name="gateway-http", daemon=True
        )
        self._thread.start()
        started.wait(timeout)
        if boot_err:
            raise boot_err[0]
        if self._server is None:
            raise RuntimeError(f"gateway did not bind within {timeout}s")
        self.timeseries.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.timeseries.stop()
        if self._loop is not None and self._loop.is_running():
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout)
        if self._own_service:
            self.service.close()

    def __enter__(self) -> Gateway:
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    # HTTP plumbing
    # ------------------------------------------------------------------ #
    async def _handle(self, reader, writer) -> None:
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break  # client closed between requests
                method, path, headers, body = req
                keep = headers.get("connection", "").lower() != "close"
                self._count("requests")
                try:
                    status, obj = await self._route(method, path, headers, body)
                except HttpError as e:
                    self._count("errors")
                    status, obj = e.status, {"error": e.message}
                except Exception as e:  # one bad request, not the server
                    self._count("errors")
                    status, obj = 500, {
                        "error": str(e), "etype": type(e).__name__
                    }
                await self._respond(writer, status, obj, keep)
                if not keep:
                    break
        except (
            asyncio.IncompleteReadError, ConnectionError, asyncio.TimeoutError
        ):
            pass  # client vanished mid-request; nothing to answer
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_request(self, reader):
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin-1").strip().split()
        if len(parts) != 3:
            raise HttpError(400, "malformed request line")
        method, path, _version = parts
        headers: dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        try:
            n = int(headers.get("content-length", "0") or "0")
        except ValueError as e:
            raise HttpError(400, "bad Content-Length") from e
        if n > MAX_BODY_BYTES:
            raise HttpError(413, f"body over {MAX_BODY_BYTES} bytes")
        body = await reader.readexactly(n) if n > 0 else b""
        return method, path, headers, body

    async def _respond(self, writer, status: int, obj, keep: bool):
        if isinstance(obj, _TextResponse):  # /metrics: OpenMetrics text
            body = obj.text.encode()
            ctype = obj.ctype
        elif isinstance(obj, str):  # plain Prometheus text exposition
            body = obj.encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        else:
            body = json.dumps(obj).encode()
            ctype = "application/json"
        head = (
            f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: {'keep-alive' if keep else 'close'}\r\n"
            "\r\n"
        )
        writer.write(head.encode("latin-1") + body)
        await writer.drain()

    # ------------------------------------------------------------------ #
    # Routes
    # ------------------------------------------------------------------ #
    async def _route(self, method: str, path: str, headers: dict, body: bytes):
        path, _, qs = path.partition("?")
        if path == "/query":
            if method != "POST":
                raise HttpError(405, "POST /query")
            return await self._query(headers, body)
        if path == "/stats":
            if method != "GET":
                raise HttpError(405, "GET /stats")
            return await self._stats()
        if path == "/metrics":
            if method != "GET":
                raise HttpError(405, "GET /metrics")
            return await self._metrics()
        if path == "/debug/slow":
            if method != "GET":
                raise HttpError(405, "GET /debug/slow")
            try:
                n = int(parse_qs(qs).get("n", ["10"])[0])
            except (ValueError, IndexError):
                n = 10
            return await self._debug_slow(n)
        if path == "/debug/heat":
            if method != "GET":
                raise HttpError(405, "GET /debug/heat")
            try:
                top = int(parse_qs(qs).get("top", ["10"])[0])
            except (ValueError, IndexError):
                top = 10
            return await self._debug_heat(top)
        if path == "/debug/timeseries":
            if method != "GET":
                raise HttpError(405, "GET /debug/timeseries")
            params = parse_qs(qs)
            name = params.get("name", [None])[0]
            try:
                last_raw = params.get("last", [None])[0]
                last = int(last_raw) if last_raw is not None else None
            except ValueError:
                last = None
            return 200, self.timeseries.snapshot(name=name, last=last)
        if path == "/healthz":
            if method != "GET":
                raise HttpError(405, "GET /healthz")
            return self._healthz()
        raise HttpError(404, f"no route {path!r}")

    async def _debug_slow(self, n: int):
        """Gateway-local slow queries + worker-side entries off the wire."""
        out = {
            "entries": len(self.slow_log),
            "slowest": self.slow_log.worst(n),
            "sampler": self.sampler.snapshot(),
        }
        stats = getattr(self.service, "stats", None)
        if callable(stats):
            try:
                snap = await asyncio.get_running_loop().run_in_executor(
                    None, stats
                )
                out["workers"] = list(getattr(snap, "slow", ()) or ())[:n]
            except Exception as e:  # a debug read never 500s the gateway
                out["workers_error"] = str(e)
        return 200, out

    async def _debug_heat(self, top: int):
        lr = getattr(self.service, "load_report", None)
        if not callable(lr):
            raise HttpError(404, "service does not expose load_report")
        report = await asyncio.get_running_loop().run_in_executor(
            None, lr, top
        )
        # what the rebalance planner would do about the observed skew —
        # advisory only; applying it is repartition_publish's job
        try:
            new_plan, actions = plan_rebalance(report)
            report["proposal"] = {
                "actions": [a.to_json() for a in actions],
                "plan": new_plan.to_json() if new_plan is not None else None,
            }
        except Exception as e:  # a debug read never 500s the gateway
            report["proposal_error"] = str(e)
        return 200, report

    def _healthz(self):
        out = {
            "ok": True,
            "shards": self.service.num_shards,
            "generations": list(self.service.generation_vector()),
            "layout_epoch": int(getattr(self.service, "layout_epoch", 0)),
        }
        health = getattr(self.service, "shard_health", None)
        if callable(health):
            rows = health()
            out["replicas"] = rows
            down = [r for r in rows if r.get("replicas_live", 0) <= 0]
            if down:
                # a shard with zero live replicas cannot answer: not ready
                out["ok"] = False
                out["down_shards"] = [r["shard"] for r in down]
                return 503, out
        return 200, out

    async def _query(self, headers: dict, body: bytes):
        try:
            obj = json.loads(body.decode() or "null")
        except (ValueError, UnicodeDecodeError) as e:
            raise HttpError(400, f"invalid JSON body: {e}") from e
        try:
            q = Query.from_dict(obj)
        except ValueError as e:
            raise HttpError(400, str(e)) from e
        self._count("queries")
        t0 = time.perf_counter()
        # root span: a fresh trace, or a child of the client's traceparent
        # header (or of the one already on the query body).  The head
        # sampler may veto under load; tail retention in _finish_request
        # still records slow requests the head pass dropped.
        span = (
            TRACER.root(
                "gateway.request",
                traceparent=headers.get("traceparent") or q.traceparent,
                semantics=q.semantics,
            )
            if self.trace and self.sampler.head()
            else NULL_SPAN
        )
        if span.ctx is not None:
            q = q.with_trace(span.ctx.traceparent)
        # generation + epoch stamp BEFORE submit: a reload or repartition
        # landing mid-flight makes the stamp conservative (entry
        # invalidates early, never serves stale) — see cache.py
        gens = self.service.generation_vector()
        epoch = int(getattr(self.service, "layout_epoch", 0))
        csp = TRACER.start(span.ctx, "gateway.cache")
        hit = self.cache.get(q.cache_key, gens, epoch)
        csp.end(hit=hit is not None)
        if hit is not None:
            out = dict(hit, cached=True)
            self._finish_request(span, out, t0, q, cached=True)
            return 200, out
        touched = self.service.touched(list(q.keywords))
        try:
            fut = self.service.submit(q)
        except Overloaded as e:
            self._abort_trace(span, "Overloaded", q, t0)
            raise HttpError(429, str(e)) from e
        except ValueError as e:
            self._abort_trace(span, f"ValueError: {e}", q, t0)
            raise HttpError(400, str(e)) from e
        try:
            res = await asyncio.wait_for(
                asyncio.wrap_future(fut), self.request_timeout
            )
        except WorkerDied as e:
            self._abort_trace(span, f"WorkerDied: {e}", q, t0)
            raise HttpError(503, str(e)) from e
        except asyncio.TimeoutError as e:
            self._abort_trace(span, "timeout", q, t0)
            raise HttpError(
                504, f"query exceeded {self.request_timeout}s"
            ) from e
        payload = res.to_dict()
        self.cache.put(q.cache_key, payload, touched, gens, epoch)
        out = dict(payload, cached=False)
        self._finish_request(span, out, t0, q, cached=False)
        return 200, out

    def _finish_request(self, span, out: dict, t0: float, q: Query,
                        cached: bool) -> None:
        """Close the request span, assemble its tree, log + measure.

        Every layer below recorded its spans before the result future
        resolved (and remote spans were adopted from the RPC reply), so
        collecting here sees the complete cross-process tree.
        """
        lat = (time.perf_counter() - t0) * 1e3
        # the histogram bucket keeps the trace id as its OpenMetrics
        # exemplar, so a /metrics scrape links a bucket to /debug/slow
        self._m_latency.observe(
            lat, exemplar=span.trace_id if span.ctx is not None else None
        )
        if span.ctx is None:
            # tail retention: head sampling dropped the trace, but a slow
            # request still earns a (span-less) slow-log entry
            if self.trace and self.sampler.keep(lat, sampled=False):
                self.slow_log.add(
                    {
                        "trace_id": None,
                        "latency_ms": round(lat, 3),
                        "keywords": list(q.keywords),
                        "semantics": q.semantics,
                        "cached": cached,
                        "spans": [],
                    }
                )
            return
        span.end(cached=cached)
        spans = TRACER.collect(span.trace_id)
        out["trace_id"] = span.trace_id
        self.slow_log.add(
            {
                "trace_id": span.trace_id,
                "latency_ms": round(lat, 3),
                "keywords": list(q.keywords),
                "semantics": q.semantics,
                "cached": cached,
                "spans": TRACER.build_tree(spans),
            }
        )

    def _abort_trace(self, span, error: str, q: Query | None = None,
                     t0: float | None = None) -> None:
        """End a failed request's trace; errored traces are always retained."""
        if span.ctx is None:
            return
        span.end(error=error)
        spans = TRACER.collect(span.trace_id)  # pop: keep the store tidy
        lat = (time.perf_counter() - t0) * 1e3 if t0 is not None else 0.0
        if self.sampler.keep(lat, error=True):
            self.slow_log.add(
                {
                    "trace_id": span.trace_id,
                    "latency_ms": round(lat, 3),
                    "error": error,
                    "keywords": list(q.keywords) if q is not None else [],
                    "semantics": q.semantics if q is not None else None,
                    "cached": False,
                    "spans": TRACER.build_tree(spans),
                }
            )

    async def _stats(self):
        # per-worker stats collection blocks on RPC round-trips: keep the
        # event loop free while it runs
        snap = await asyncio.get_running_loop().run_in_executor(
            None, self.service.stats
        )
        with self._lock:
            gw = dict(self.counters)
        gw["cache"] = self.cache.snapshot()
        return 200, {
            "service": snap.to_dict(),
            "gateway": gw,
            "generations": list(self.service.generation_vector()),
        }

    async def _metrics(self):
        snap = await asyncio.get_running_loop().run_in_executor(
            None, self.service.stats
        )
        self._sync_registry(snap)
        return 200, _TextResponse(
            self.registry.expose(openmetrics=True),
            "application/openmetrics-text; version=1.0.0; charset=utf-8",
        )

    def _pre_sample(self) -> None:
        """TimeSeriesStore tick hook: pull the cluster rollup into the
        registry so sampled series cover service counters, not just
        gateway-local ones (failures are swallowed by the store)."""
        self._sync_registry(self.service.stats())

    def _sync_registry(self, snap) -> None:
        """Mirror scrape-time state into the registry (gauges + rollups).

        Counters the gateway increments live in the registry already; the
        edge cache and the service rollup are snapshotted at scrape, and
        the service's latency histogram is adopted wholesale — same bucket
        edges end to end, so Prometheus sees true cumulative buckets.
        """
        for k, v in self.cache.snapshot().items():
            self.registry.gauge(
                f"gateway_cache_{k}", f"edge cache {k}"
            ).set(float(v))
        for k, v in snap.data.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue  # transport names, generation vectors, ...
            self.registry.gauge(
                f"cluster_{k}", f"service rollup counter {k}"
            ).set(float(v))
        # monotonic engine counters exposed with proper counter typing:
        # the plan cache's hit/miss/launch totals and the fused-kernel
        # fallback count, summed over shards by the rollup
        for key, metric in (
            ("plan_hits", "plan_cache_hits_total"),
            ("plan_misses", "plan_cache_misses_total"),
            ("plan_launches_total", "plan_cache_launches_total"),
            ("fused_fallbacks", "fused_fallbacks_total"),
        ):
            self.registry.counter(
                metric, f"engine {key} summed over shards"
            ).set(float(snap.data.get(key, 0)))
        hist = getattr(snap, "hist", None)
        if hist is not None:
            self.registry.histogram(
                "cluster_query_latency_ms",
                "routed query latency as recorded by the service (ms)",
            ).replace(hist)

    def _count(self, key: str) -> None:
        with self._lock:
            self.counters[key] += 1
        m = self._metric_counters.get(key)
        if m is not None:
            m.inc()
