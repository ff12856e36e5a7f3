"""Build, publish, and serve a sharded cluster over the synthetic catalog, on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_serve_cluster.py [n_releases] [num_shards] [transport] [--device cpu]

The counterpart of ``examples/serve_cluster.py`` on ``repro_torch``: partition
the corpus into per-shard DAG indices, publish them as a cluster artifact
(atomic manifest swap), reopen the artifact through the chosen worker
transport (``thread``: in-process engines; ``process``: one subprocess per
shard over the mmap'd artifact; ``remote``: standalone shard servers on
localhost sockets, their endpoints recorded in ``cluster.json`` as a
multi-host deployment would), scatter-gather queries through admission
control, then perform a rolling republish against the live service (remote
shards hot-swap through the server's ``reload`` op) and print the rolled-up
cluster stats.  Every shard searches on ``--device`` with the fused kernel.
"""
import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.cluster import (  # noqa: E402
    ClusterService,
    build_cluster,
    rolling_publish,
    set_cluster_endpoints,
)
from repro_torch.cluster.workers.server import launch_cluster_servers  # noqa: E402
from repro_torch.core import KeywordSearchEngine  # noqa: E402
from repro_torch.data import QUERIES, generate_discogs_tree  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_releases", type=int, nargs="?", default=200)
    ap.add_argument("num_shards", type=int, nargs="?", default=4)
    ap.add_argument("transport", nargs="?", default="thread",
                    choices=["thread", "process", "remote"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    print(f"generating catalog: {args.n_releases} releases ...")
    tree = generate_discogs_tree(n_releases=args.n_releases, seed=0)

    with tempfile.TemporaryDirectory() as path:
        manifest = build_cluster(tree, args.num_shards, path, device=args.device)
        print(
            f"published cluster: {manifest['num_shards']} shards, "
            f"{manifest['num_docs']} docs, {manifest['num_nodes']} nodes -> {path}"
        )

        servers = []
        try:
            if args.transport == "remote":
                # one standalone shard server per shard (here all on localhost;
                # in production each runs on its shard's host).  Recording the
                # endpoints in cluster.json is all the router needs: from_dir
                # picks them up without an endpoints argument.
                servers, endpoints = launch_cluster_servers(
                    path, manifest, backends="fused", batch_window_ms=2.0,
                    device=args.device,
                )
                for i, ep in enumerate(endpoints):
                    print(f"  shard {i} server listening at {ep}")
                set_cluster_endpoints(path, endpoints)

            mono = KeywordSearchEngine(tree, device=args.device)  # equivalence witness
            _serve(path, args, mono, tree)
        finally:
            for proc in servers:
                proc.terminate()
            for proc in servers:
                proc.wait(timeout=30)


def _serve(path: str, args, mono, tree) -> None:
    with ClusterService.from_dir(
        path, transport=args.transport, backends="fused", batch_window_ms=2.0,
        device=args.device,
    ) as svc:
        print(f"serving via {args.transport} workers ({svc.pool.locality})")
        for name, (_cat, kws) in QUERIES.items():
            for sem in ("slca", "elca"):
                got = svc.query(kws, semantics=sem)
                want = mono.query(kws, semantics=sem, backend="scalar")
                tag = "==" if np.array_equal(got, want) else "!!"
                print(f"  {name} {sem:4s} {tag} {got.size} results")
        # a hot-query burst: identical in-flight queries coalesce into
        # one scatter-gather execution (see `coalesced` in the stats)
        futs = [svc.submit(QUERIES["Q4"][1]) for _ in range(20)]
        for f in futs:
            f.result()
        # rolling republish against the live service: every shard is
        # re-indexed and hot-swapped, generations bump, zero queries drop
        # (remote shards reload through their server's `reload` op)
        m = rolling_publish(path, tree, service=svc, device=args.device)
        gens = [s["generation"] for s in m["shards"]]
        got = svc.query(QUERIES["Q4"][1])
        want = mono.query(QUERIES["Q4"][1], backend="scalar")
        tag = "==" if np.array_equal(got, want) else "!!"
        print(f"\nrolling republish: generations={gens}, post-swap {tag}")
        print("\ncluster stats:")
        for key, val in sorted(svc.stats().summary().items()):
            print(f"  {key}: {val}")


if __name__ == "__main__":
    main()
