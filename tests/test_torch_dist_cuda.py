"""The distributed search on the card: every rank's answer == ``scalar``.

Two layouts, as the process group allows them: 4 ranks that share one card
over gloo (meshes (1, 4) and (2, 2); each rank's kernels run on the card,
the collectives go through gloo), and one rank a card over NCCL (NCCL
refuses two ranks on one card).  Under ``backend="chained"`` each rank's
membership launches the searchsorted kernel (its own count > 0); under
``"torch"`` it launches none.  ``make_distributed_search`` on the 4 ranks
equals the single-device ``ca_search_batch`` on the card.

Runs only where a CUDA device is present; on a host without one every test
here skips.  Imports nothing of the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_dist_cuda.py
"""
import numpy as np
import pytest
import torch
from test_torch_dist import (
    BACKENDS,
    SEMS,
    batch_arrays,
    batch_job,
    corpus_lists,
    query_job,
    run_ranks,
)

import repro_torch.kernels.ops  # noqa: F401  (registers the "chained" membership backend)
from repro_torch.core.search_vec import INT_PAD, ca_search_batch


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks' kernels and collectives run on the card")
    from repro_torch.kernels import _build, searchsorted

    _build.build(searchsorted._SOURCE)  # once, before the ranks load it
    return corpus_lists()


def _check_queries(results, models, want):
    for rank, res in enumerate(results):
        for model in models:
            for backend in BACKENDS:
                for (name, sem), ids in want.items():
                    np.testing.assert_array_equal(
                        res["answers"][(model, backend, name, sem)], ids,
                        err_msg=f"rank {rank} mesh model={model} {backend} {name} {sem}")
            assert res["launches"][(model, "chained")] > 0, (rank, model)
            assert res["launches"][(model, "torch")] == 0, (rank, model)


def test_four_ranks_share_the_card_over_gloo(card, tmp_path):
    lists, want = card
    results = run_ranks(4, "gloo", query_job, ((4, 2), lists, BACKENDS, "cuda"), tmp_path)
    _check_queries(results, (4, 2), want)


def test_one_rank_a_card_over_nccl(card, tmp_path):
    lists, want = card
    world = torch.cuda.device_count()
    results = run_ranks(world, "nccl", query_job, ((world,), lists, BACKENDS, "cuda"),
                        tmp_path)
    _check_queries(results, (world,), want)


def test_make_distributed_search_equals_one_device(card, tmp_path):
    arrays = batch_arrays()
    results = run_ranks(4, "gloo", batch_job, ((4, 2), arrays, "chained", "cuda"), tmp_path)
    for k, a in arrays.items():
        ids, pid, nd = (torch.from_numpy(a[n]).cuda() for n in ("ids", "pid", "ndesc"))
        n_valid = (ids < INT_PAD).sum(dim=-1, dtype=torch.int32)
        for sem in SEMS:
            want_ids, want_mask = ca_search_batch(
                ids[:, 0], pid[:, 0], nd[:, 0], ids[:, 1:].contiguous(),
                nd[:, 1:].contiguous(), n_valid[:, 0], n_valid[:, 1:].contiguous(),
                semantics=sem, backend="chained")
            for rank, res in enumerate(results):
                for model in (4, 2):
                    got_ids, got_mask = res["results"][(model, k, sem)]
                    np.testing.assert_array_equal(got_ids, want_ids.cpu().numpy(),
                                                  err_msg=f"rank {rank} {model} {k} {sem}")
                    np.testing.assert_array_equal(got_mask, want_mask.cpu().numpy())
