"""The fused search CUDA kernel == its plain PyTorch version, on the card.

Runs only where a CUDA device is present (the kernel has no CPU mode); on a
host without one every test here skips.  Imports nothing of the JAX
package, so it runs on a card host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_fused_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.idlist import IDList, make_pidpos
from repro_torch.core.plan_cache import PlanCache
from repro_torch.kernels import fused_search
from repro_torch.kernels.fused_search import (
    fused_search_batch,
    fused_search_batch_plain,
)


def _random_item(rng, k):
    """k ancestor-closed IDLists over one random tree (parents have lower ids)."""
    n = int(rng.integers(5, 400))
    par = np.full(n, -1, np.int64)
    for i in range(1, n):
        par[i] = int(rng.integers(max(0, i - 8), i))
    lists = []
    for _ in range(k):
        nd: dict[int, int] = {}
        for d in rng.choice(n, size=int(rng.integers(1, max(2, n // 2))), replace=False):
            v = int(d)
            while v >= 0:
                nd[v] = nd.get(v, 0) + 1
                v = int(par[v])
        ids = np.array(sorted(nd), dtype=np.int32)
        ndesc = np.array([nd[i] for i in sorted(nd)], dtype=np.int32)
        lists.append(IDList(ids=ids, pidpos=make_pidpos(ids, par), ndesc=ndesc))
    return lists


@pytest.fixture
def cuda_plan():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused search kernel has no CPU mode")
    return PlanCache(backend="fused", min_rows=8, device="cuda")


@pytest.mark.parametrize("semantics", ["slca", "elca", "ca"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_kernel_matches_plain(cuda_plan, semantics, k):
    rng = np.random.default_rng(k * 31 + len(semantics))
    items = [_random_item(rng, k) for _ in range(5)]  # rows 8: 3 all-pad rows
    batch, kept, _ = cuda_plan.pack(items, list(range(5)), semantics, "fused")
    launches = fused_search.LAUNCHES
    ids, mask = fused_search_batch(**batch, semantics=semantics)
    torch.cuda.synchronize()
    assert fused_search.LAUNCHES == launches + 1
    plain = {n: v for n, v in batch.items() if n != "other_n"}
    want_ids, want_mask = fused_search_batch_plain(**plain, semantics=semantics)
    assert torch.equal(ids, want_ids)
    assert torch.equal(mask, want_mask)
    assert not mask[len(kept):].any()
