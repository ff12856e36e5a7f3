"""End-to-end search on the PyTorch/CUDA port: build the IDCluster
over a discogs-like catalog and run the paper's nine queries on base vs DAG
indices with timings.

    PYTHONPATH=src python examples/torch_search_discogs.py --releases 2000 [--device cpu]

The counterpart of ``examples/search_discogs.py`` on ``repro_torch``.  Each
query runs on both indices through the ``fused`` and ``chained`` backends
(the port's kernels on the card), and every result must equal the paper's
host algorithms (``scalar``); the timings are of ``fused``.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import KeywordSearchEngine  # noqa: E402
from repro_torch.data import QUERIES, generate_discogs_tree  # noqa: E402

CHECKED = ("fused", "chained")
TIMED = "fused"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--releases", type=int, default=2000)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--semantics", default="slca", choices=["slca", "elca"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    t0 = time.time()
    tree = generate_discogs_tree(n_releases=args.releases, seed=0)
    print(f"corpus: {tree.num_nodes} nodes ({time.time()-t0:.1f}s)")
    t0 = time.time()
    eng = KeywordSearchEngine(tree, device=args.device)
    s = eng.index_sizes()
    print(
        f"index: {s['tree_entries']} tree entries -> {s['dag_entries']} DAG entries "
        f"({s['num_rcs']} RCs, {time.time()-t0:.1f}s build)"
    )

    print(f"\n{'query':34s} {'cat':>3s} {'results':>8s} {'base µs':>10s} "
          f"{'DAG µs':>10s} {'speedup':>8s}")
    for q, (cat, kws) in QUERIES.items():
        res = eng.query(kws, semantics=args.semantics, index="tree")
        dag_res = eng.query(kws, semantics=args.semantics, index="dag")
        assert np.array_equal(res, dag_res), "DAG results must match tree results"
        for index in ("tree", "dag"):
            for backend in CHECKED:
                got = eng.query(kws, semantics=args.semantics, index=index, backend=backend)
                if not np.array_equal(got, res):
                    raise SystemExit(f"{q} {index} {backend}: {got.tolist()} != scalar "
                                     f"{res.tolist()}")

        def bench(index):
            eng.query(kws, semantics=args.semantics, index=index, backend=TIMED)
            t = time.time()
            for _ in range(args.repeats):
                eng.query(kws, semantics=args.semantics, index=index, backend=TIMED)
            return (time.time() - t) / args.repeats * 1e6

        b, d = bench("tree"), bench("dag")
        print(f"{q} {' '.join(kws):27s} {cat:3d} {len(res):8d} "
              f"{b:10.0f} {d:10.0f} {b/d:7.2f}x")
    print(f"\n{' and '.join(CHECKED)} == scalar on both indices for all "
          f"{len(QUERIES)} queries (timings: {TIMED}, {args.device})")


if __name__ == "__main__":
    main()
