"""Index-artifact workflow end to end on the PyTorch/CUDA port: build -> save -> reload -> serve.

    PYTHONPATH=src python examples/torch_serve_index.py [--releases 200] [--device cpu]

The counterpart of ``examples/serve_index.py`` on ``repro_torch``: builds the
synthetic discogs corpus, saves the index artifact (the reference's format),
reloads it the way a serving process would (memory-mapped, no rebuild),
then serves the paper's 9 queries twice through a QueryService; the second
pass shows the PlanCache serving every launch from packed plans it holds.
The service searches with the fused kernel (``backend="fused"``).
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import KeywordSearchEngine  # noqa: E402
from repro_torch.data import QUERIES, generate_discogs_tree  # noqa: E402
from repro_torch.serve import QueryService  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--releases", type=int, default=200)
    ap.add_argument("--artifact", default=None, help="default: a temp dir")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="idx-") as tmp:
        artifact = args.artifact or tmp

        t0 = time.perf_counter()
        tree = generate_discogs_tree(n_releases=args.releases, seed=0)
        engine = KeywordSearchEngine(tree, device=args.device)
        print(f"built {tree.num_nodes} nodes in {time.perf_counter() - t0:.2f}s")
        print(f"index sizes: {engine.index_sizes()}")

        t0 = time.perf_counter()
        engine.save(artifact)
        print(f"saved artifact -> {artifact} in {time.perf_counter() - t0:.2f}s")

        t0 = time.perf_counter()
        served = KeywordSearchEngine.load(artifact, device=args.device)  # mmap: no rebuild
        print(f"reloaded (mmap) in {time.perf_counter() - t0:.3f}s")

        queries = [kws for _, kws in QUERIES.values()]
        with QueryService(served, max_batch=32, batch_window_ms=2.0, backend="fused",
                          device=args.device) as svc:
            for label in ("cold", "warm"):
                t0 = time.perf_counter()
                results = svc.map(queries, semantics="slca")
                dt = (time.perf_counter() - t0) * 1e3
                hits = svc.stats().data["plan_hit_rate"]
                print(
                    f"{label}: {len(results)} queries in {dt:.1f}ms, "
                    f"plan hit-rate {hits:.2f}"
                )
            for (name, (_, kws)), res in zip(QUERIES.items(), results):
                print(f"  {name} {kws} -> {len(res)} results")
            print("service stats:", svc.stats().summary())


if __name__ == "__main__":
    main()
