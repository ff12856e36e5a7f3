"""The full front door on the PyTorch/CUDA port: replicated shards + hedged dispatch + HTTP gateway.

    PYTHONPATH=src python examples/torch_serve_gateway.py [n_releases] [num_shards] [replicas] [--device cpu]

The counterpart of ``examples/serve_gateway.py`` on ``repro_torch``, every
shard process searching on ``--device`` with the fused kernel.

Publishes the synthetic catalog as a cluster artifact, serves it through
per-shard replica sets (process transport), and puts the HTTP/JSON
gateway in front.  Then exercises everything a deployment cares about,
over real HTTP:

  * POST /query — ids byte-identical to a monolithic engine;
  * the edge cache — a repeated query returns ``cached: true`` without
    touching the cluster;
  * SIGSTOP one replica — hedged dispatch keeps answering fast while the
    replica is stalled (the tail stays near the hedge delay);
  * SIGKILL one replica — queries fail over with zero client errors and
    the slot respawns;
  * a rolling republish — shard generations bump and the edge cache
    invalidates itself (the repeat recomputes, then re-caches).
"""
import argparse
import http.client
import json
import os
import signal
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.api import Query  # noqa: E402
from repro_torch.cluster import (  # noqa: E402
    ClusterService,
    build_cluster,
    rolling_publish,
)
from repro_torch.core import KeywordSearchEngine  # noqa: E402
from repro_torch.data import QUERIES, generate_discogs_tree  # noqa: E402
from repro_torch.gateway import Gateway  # noqa: E402


def post_query(host: str, port: int, body: dict) -> dict:
    conn = http.client.HTTPConnection(host, port, timeout=120)
    try:
        conn.request("POST", "/query", body=json.dumps(body))
        resp = conn.getresponse()
        obj = json.loads(resp.read().decode())
        if resp.status != 200:
            raise RuntimeError(f"{resp.status}: {obj.get('error')}")
        return obj
    finally:
        conn.close()


def get(host: str, port: int, path: str) -> dict:
    conn = http.client.HTTPConnection(host, port, timeout=120)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read().decode())
    finally:
        conn.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_releases", type=int, nargs="?", default=120)
    ap.add_argument("num_shards", type=int, nargs="?", default=2)
    ap.add_argument("replicas", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    n_releases, num_shards, replicas = args.n_releases, args.num_shards, args.replicas

    print(f"generating catalog: {n_releases} releases ...")
    tree = generate_discogs_tree(n_releases=n_releases, seed=0)
    mono = KeywordSearchEngine(tree, device=args.device)

    with tempfile.TemporaryDirectory() as path:
        build_cluster(tree, num_shards, path, device=args.device)
        svc = ClusterService.from_dir(
            path, transport="process", replicas=replicas, backends="fused",
            batch_window_ms=1.0, device=args.device,
        )
        with Gateway(svc, own_service=True).start() as gw:
            print(
                f"gateway at http://{gw.endpoint} over {num_shards} shards "
                f"x {replicas} replicas ({svc.pool.locality})"
            )
            print(f"  try: curl -s {gw.endpoint}/query "
                  "-d '{\"keywords\": \"vinyl reissue\"}'")

            # 1. exactness over HTTP
            for name, (_cat, kws) in list(QUERIES.items())[:4]:
                obj = post_query(gw.host, gw.port, {"keywords": kws})
                want = mono.query(kws, backend="scalar")
                tag = "==" if np.array_equal(
                    np.asarray(obj["ids"], dtype=np.int64), want
                ) else "!!"
                print(f"  {name} slca {tag} {len(obj['ids'])} results "
                      f"({obj['stats']['latency_ms']}ms)")

            # 2. edge cache
            body = Query.make("vinyl reissue").to_dict()
            a = post_query(gw.host, gw.port, body)
            b = post_query(gw.host, gw.port, body)
            print(f"\nedge cache: first cached={a['cached']}, "
                  f"repeat cached={b['cached']}")

            # 3. hedging over a stalled replica
            rs = svc.pool.workers[0]
            pid = rs.replicas[0]._proc.pid
            os.kill(pid, signal.SIGSTOP)
            t0 = time.perf_counter()
            post_query(gw.host, gw.port, {"keywords": "limited vinyl"})
            stalled_ms = (time.perf_counter() - t0) * 1e3
            os.kill(pid, signal.SIGCONT)
            s = svc.stats().data
            print(f"stalled replica: answered in {stalled_ms:.0f}ms "
                  f"(hedges_fired={s.get('hedges_fired', 0)})")

            # 4. kill a replica mid-traffic: failover, then respawn
            os.kill(pid, signal.SIGKILL)
            errors = 0
            for _ in range(10):
                try:
                    post_query(gw.host, gw.port, {"keywords": "japan cd"})
                except RuntimeError:
                    errors += 1
            print(f"killed replica: {errors} client-visible errors in 10 "
                  "queries (failover)")

            # 5. rolling republish invalidates the cache
            rolling_publish(path, tree, service=svc, device=args.device)
            c = post_query(gw.host, gw.port, body)
            d = post_query(gw.host, gw.port, body)
            health = get(gw.host, gw.port, "/healthz")
            print(f"rolling republish: generations={health['generations']}, "
                  f"repeat cached={c['cached']} -> re-cached={d['cached']}")

            stats = get(gw.host, gw.port, "/stats")
            print("\ngateway counters:", stats["gateway"])


if __name__ == "__main__":
    main()
