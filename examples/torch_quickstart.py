"""Quickstart on the PyTorch/CUDA port: DAG-compressed XML keyword search in five lines.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The counterpart of ``examples/quickstart.py`` on ``repro_torch``: the same
document and query through every backend of the port (``fused`` and
``chained`` launch its CUDA kernels on the card).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.api import BACKENDS  # noqa: E402
from repro_torch.core import KeywordSearchEngine  # noqa: E402

XML = """
<bib>
  <release>
    <title>Thriller</title>
    <versions>
      <details><format>Vinyl</format><country>USA</country><language>English</language></details>
    </versions>
    <note>USA</note><note2>English</note2>
  </release>
  <release2>
    <details><format>Vinyl</format><country>USA</country><language>English</language></details>
  </release2>
</bib>
"""


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    engine = KeywordSearchEngine.from_xml(XML, device=args.device)

    print("query: USA English")
    for semantics in ("slca", "elca"):
        for index in ("tree", "dag"):
            for backend in BACKENDS:
                ids = engine.query(["USA", "English"], semantics=semantics,
                                   index=index, backend=backend)
                print(f"  {semantics:4s} {index:4s} {backend:7s} -> nodes {ids.tolist()}")

    sizes = engine.index_sizes()
    print(f"tree nodes: {sizes['tree_nodes']}, DAG nodes: {sizes['dag_nodes']}, "
          f"redundancy components: {sizes['num_rcs']}, RCPM entries: {sizes['rcpm_entries']}")


if __name__ == "__main__":
    main()
