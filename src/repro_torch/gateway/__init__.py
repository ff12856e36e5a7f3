"""HTTP/JSON front door over a :class:`~repro_torch.cluster.router.ClusterService`.

    gateway = Gateway(ClusterService.from_dir(path)).start()
    curl -s localhost:PORT/query -d '{"keywords": "vinyl reissue"}'

One asyncio server thread speaks HTTP/1.1 (stdlib only — no web
framework); every ``POST /query`` parses into a
:class:`repro_torch.api.Query`, runs through the cluster's scatter-gather, and
returns the :class:`repro_torch.api.QueryResult` JSON shape: result ids, the
per-request stats dict, and the serving generation vector.  A
generation-stamped edge cache (:class:`~repro_torch.gateway.cache.EdgeCache`)
short-circuits repeated queries and self-invalidates when a
``rolling_publish`` bumps any touched shard's generation (and, on a
``repartition_publish``, the layout epoch).  The service's shards search
on the card unless it was built with ``device="cpu"``.

See :mod:`repro_torch.gateway.http` for the server, :mod:`repro_torch.gateway.cache`
for the cache, and :mod:`repro_torch.gateway.server` for the CLI entrypoint
(``python -m repro_torch.gateway``) plus :func:`~repro_torch.gateway.server.
launch_gateway` for supervised local spawns.
"""
from .cache import EdgeCache
from .http import Gateway
from .server import launch_gateway

__all__ = ["EdgeCache", "Gateway", "launch_gateway"]
