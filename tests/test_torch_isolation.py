"""The port stands alone: no jax, no reference package, no quiet CPU fallback."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

_IMPORT_CHILD = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not loaded, loaded
assert sys.modules.get("jax") is None
print(len(names))
"""


def test_every_port_module_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_CHILD],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20  # every module was visited


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|from\s+repro(\.|\s))",
    re.MULTILINE,
)


def test_no_jax_or_reference_imports_in_port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)}: {hits}"


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.core import KeywordSearchEngine, PlanCache
    from repro_torch.data import generate_discogs_tree

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = generate_discogs_tree(n_releases=2, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KeywordSearchEngine(tree)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PlanCache()
    engine = KeywordSearchEngine(tree, device="cpu")  # naming the CPU works
    assert engine.device.type == "cpu"
