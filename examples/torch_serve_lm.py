"""Batched LM serving with prefix-DAG KV dedup (the paper's insight on LMs), on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_serve_lm.py [--reduced] [--device cpu]

The counterpart of ``examples/serve_lm.py`` on ``repro_torch``: SmolLM-135M
with seeded random weights serves 8 requests that share a 48-token prefix,
once through the prefix DAG, and prints the prefill time, the decode rate
and a sample continuation.  At its published widths unless ``--reduced``;
every decode step runs the port's ``decode_attention`` kernel on the card.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import main as serve_main  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return serve_main(
        ["--arch", "smollm-135m", *(["--reduced"] if args.reduced else []),
         "--requests", "8", "--prompt-len", "64", "--shared-prefix", "48", "--gen", "12",
         "--prefix-dag", "--device", args.device]
    )


if __name__ == "__main__":
    sys.exit(main())
