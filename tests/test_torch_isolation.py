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
assert {"repro_torch.models.moe", "repro_torch.models.ssm"} <= set(names), names
assert {"repro_torch.launch.dryrun", "repro_torch.launch.hillclimb",
        "repro_torch.roofline.profile"} <= set(names), names
print(len(names), sum(n.startswith("repro_torch.cluster") for n in names))
"""


def test_every_port_module_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_CHILD],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    visited, cluster = (int(x) for x in proc.stdout.split()[-2:])
    assert visited >= 93  # every module was visited (dist, roofline, mesh, train, moe, ssm among them)
    assert cluster >= 15  # repro_torch.cluster and its 14 modules among them


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


def test_lm_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_cache, init_params, prefill
    from repro_torch.models.convert import params_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced", "--requests", "1", "--prompt-len", "4", "--gen", "2"])
    model = init_params(0, cfg, device="cpu")  # naming the CPU works
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    last, _ = prefill(model, cfg, tokens, init_cache(cfg, 1, 8, device="cpu"))
    assert last.shape == (1, cfg.vocab) and last.device.type == "cpu"
