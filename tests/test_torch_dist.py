"""The port's distributed search == the reference's, and == ``scalar``, on every rank.

Ranks are processes started by ``torch.multiprocessing`` (spawn) and joined
by a gloo group on the CPU (``device_type="cpu"``): 4 ranks on the meshes
(1, 4) and (2, 2), and 3 ranks on (1, 3), whose model axis divides no
bucket, so every list stays whole on every rank.  Each rank writes what it
got to a file and the tests read every rank's.  No tolerance: ids are
integers.

The reference runs in a subprocess with 8 fake CPU devices (``XLA_FLAGS``
must be set before jax loads; this process's jax has one device):
``distributed_query`` on ``jax.make_mesh((1, 8))``, and
``make_distributed_search`` on a 4-device ``jax.sharding.Mesh``, whose axes
are Auto (its ``with_sharding_constraint`` refuses ``jax.make_mesh``'s
Explicit axes).  The corpus is the reference test's
(``tests/test_distributed.py``: 60 releases, seed 11).

``run_ranks`` and the rank jobs are shared with ``test_torch_dist_cuda.py``.
"""
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import KeywordSearchEngine
from repro_torch.data import QUERIES, generate_discogs_tree
from repro_torch.kernels.shapes import INT_PAD

ROOT = Path(__file__).resolve().parent.parent
SEMS = ("slca", "elca")
BACKENDS = ("torch", "chained")
BATCH_K = (2, 3)
BATCH_Q, BATCH_WIDTH = 4, 64  # [Q, k, M * SEG] with M * SEG = 64
RANK_TIMEOUT = timedelta(seconds=60)  # a hung rank fails its collective


# --------------------------------------------------------------------------- #
# Ranks (module-level functions: spawn pickles them by name)
# --------------------------------------------------------------------------- #


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank, world, port, pg_backend, job, args, out_dir):
    dist.init_process_group(pg_backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=RANK_TIMEOUT)
    try:
        result = job(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(world: int, pg_backend: str, job, args, out_dir) -> list:
    """``job(*args)`` on ``world`` spawned ranks of one process group; the
    result of every rank, in rank order.  A failing rank raises here."""
    os.makedirs(out_dir, exist_ok=True)
    mp.spawn(_rank_entry, args=(world, free_port(), pg_backend, job, args, str(out_dir)),
             nprocs=world, join=True)
    out = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def query_job(models, lists_by_query, backends, device_type):
    """``distributed_query`` on a mesh for each model-axis size in
    ``models``: every query x semantics x backend, with this rank's
    searchsorted launches per (model, backend)."""
    from repro_torch.dist.search_shard import distributed_query
    from repro_torch.kernels import searchsorted
    from repro_torch.launch.mesh import make_host_mesh

    out = {"meshes": {}, "answers": {}, "launches": {}}
    for model in models:
        mesh = make_host_mesh(model, device_type=device_type)
        out["meshes"][model] = (tuple(mesh.shape), mesh.mesh_dim_names)
        for backend in backends:
            searchsorted.LAUNCHES = 0
            for name, lists in lists_by_query.items():
                for sem in SEMS:
                    out["answers"][(model, backend, name, sem)] = distributed_query(
                        lists, mesh, sem, backend=backend)
            out["launches"][(model, backend)] = searchsorted.LAUNCHES
    return out


def batch_job(models, arrays_by_k, backend, device_type):
    """``make_distributed_search`` on a mesh for each model-axis size: this
    rank's segment of each k's ``[Q, k, M, SEG]`` arrays, each semantics;
    and the message of the ValueError for a wrong k."""
    from repro_torch.dist.search_shard import make_distributed_search
    from repro_torch.launch.mesh import make_host_mesh, rank_device

    out = {"results": {}}
    for model in models:
        mesh = make_host_mesh(model, device_type=device_type)
        m, r = mesh.size(1), mesh.get_local_rank("model")
        dev = rank_device(device_type)
        for k, arrays in arrays_by_k.items():
            q, kk, width = arrays["ids"].shape
            ids, pid, nd = (torch.from_numpy(arrays[n].reshape(q, kk, m, width // m)[:, :, r])
                            .contiguous().to(dev) for n in ("ids", "pid", "ndesc"))
            for sem in SEMS:
                res_ids, mask = make_distributed_search(mesh, k, sem, backend=backend)(
                    ids, pid, nd)
                out["results"][(model, k, sem)] = (res_ids.cpu().numpy(), mask.cpu().numpy())
            try:
                make_distributed_search(mesh, k + 1, "slca", backend=backend)(ids, pid, nd)
            except ValueError as e:
                out["wrong_k"] = str(e)
    return out


# --------------------------------------------------------------------------- #
# Inputs
# --------------------------------------------------------------------------- #


def corpus_lists(n_releases: int = 60, seed: int = 11):
    """(lists per paper query, {(query, semantics): scalar ids}) of the tree
    index on the CPU: what every rank gets, and what it must answer."""
    eng = KeywordSearchEngine(generate_discogs_tree(n_releases=n_releases, seed=seed),
                              device="cpu")
    lists, want = {}, {}
    for name, (_cat, kws) in QUERIES.items():
        lists[name] = eng.base.idlists(eng.keyword_ids(kws))
        for sem in SEMS:
            want[(name, sem)] = eng.query(kws, semantics=sem, index="tree", backend="scalar")
    return lists, want


def batch_arrays(seed: int = 0) -> dict:
    """Seeded ``[Q, k, M * SEG]`` int32 inputs per k: each list's ids
    ascending with an INT_PAD tail, L0's parents among its own earlier ids
    (or -1), NDesc 1..4 (0 at pads); drawn from 96 ids so that lists meet."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in BATCH_K:
        ids = np.full((BATCH_Q, k, BATCH_WIDTH), INT_PAD, np.int32)
        pid = np.full_like(ids, -1)
        for q in range(BATCH_Q):
            for j in range(k):
                n = int(rng.integers(0, BATCH_WIDTH + 1))
                ids[q, j, :n] = np.sort(rng.choice(96, n, replace=False))
                par = rng.integers(-1, np.maximum(np.arange(n), 1))
                pid[q, j, :n] = np.where((par >= 0) & (np.arange(n) > 0),
                                         ids[q, j, np.maximum(par, 0)], -1)
        nd = np.where(ids < INT_PAD, rng.integers(1, 5, ids.shape), 0).astype(np.int32)
        out[k] = {"ids": ids, "pid": pid, "ndesc": nd}
    return out


_REFERENCE = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    sys.path.insert(0, %(src)r)
    import numpy as np, jax

    from repro.core import KeywordSearchEngine
    from repro.data import QUERIES, generate_discogs_tree
    from repro.dist.search_shard import distributed_query, make_distributed_search

    out = {"answers": {}, "batch": {}}
    eng = KeywordSearchEngine(generate_discogs_tree(n_releases=60, seed=11))
    mesh = jax.make_mesh((1, 8), ("data", "model"))
    for name, (_cat, kws) in QUERIES.items():
        lists = eng.base.idlists(eng.keyword_ids(kws))
        for sem in ("slca", "elca"):
            got = distributed_query(lists, mesh, semantics=sem)
            out["answers"][name + " " + sem] = got.tolist()

    arrays = np.load(%(arrays)r)
    auto = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    for k in %(ks)r:
        q, kk, width = arrays[f"ids{k}"].shape
        args = [arrays[f"{n}{k}"].reshape(q, kk, 4, width // 4) for n in ("ids", "pid", "ndesc")]
        for sem in ("slca", "elca"):
            with auto:
                ids, mask = jax.jit(make_distributed_search(auto, k, sem))(*args)
            out["batch"][f"{k} {sem}"] = [np.asarray(ids).tolist(), np.asarray(mask).tolist()]
        try:
            with auto:
                jax.jit(make_distributed_search(auto, k + 1, "slca"))(*args)
        except ValueError as e:
            out["wrong_k"] = str(e)
    print(json.dumps(out))
    """
)


# --------------------------------------------------------------------------- #
# Fixtures: one spawn per world size, one reference subprocess
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def corpus():
    return corpus_lists()


@pytest.fixture(scope="module")
def arrays():
    return batch_arrays()


@pytest.fixture(scope="module")
def reference(arrays, tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "arrays.npz"
    np.savez(path, **{f"{n}{k}": a[n] for k, a in arrays.items() for n in a})
    script = _REFERENCE % {"src": str(ROOT / "src"), "arrays": str(path), "ks": BATCH_K}
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ranks4(corpus, arrays, tmp_path_factory):
    lists, _ = corpus
    out = tmp_path_factory.mktemp("ranks4")
    return run_ranks(4, "gloo", _both_jobs, ((4, 2), lists, arrays), out)


@pytest.fixture(scope="module")
def ranks3(corpus, tmp_path_factory):
    lists, _ = corpus
    out = tmp_path_factory.mktemp("ranks3")
    return run_ranks(3, "gloo", query_job, ((3,), lists, BACKENDS, "cpu"), out)


def _both_jobs(models, lists, arrays):
    return {**query_job(models, lists, BACKENDS, "cpu"),
            **batch_job(models, arrays, "chained", "cpu")}


def _ranks(ranks4, ranks3, model):
    return ranks3 if model == 3 else ranks4


# --------------------------------------------------------------------------- #
# Tests
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("model", [4, 2, 3])
def test_distributed_query_equals_scalar_and_reference(
    ranks4, ranks3, corpus, reference, model, backend
):
    _lists, want = corpus
    results = _ranks(ranks4, ranks3, model)
    for rank, res in enumerate(results):
        for (name, sem), ids in want.items():
            got = res["answers"][(model, backend, name, sem)]
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, ids, err_msg=f"rank {rank} {name} {sem}")
            np.testing.assert_array_equal(
                got, reference["answers"][f"{name} {sem}"], err_msg=f"rank {rank} {name}")
        # CPU tensors run the searchsorted kernel's plain version: no launch
        assert res["launches"][(model, backend)] == 0
    assert len(want) == 18


@pytest.mark.parametrize("sem", SEMS)
@pytest.mark.parametrize("k", BATCH_K)
@pytest.mark.parametrize("model", [4, 2])
def test_make_distributed_search_equals_reference(ranks4, reference, model, k, sem):
    want_ids, want_mask = (np.array(x) for x in reference["batch"][f"{k} {sem}"])
    assert want_mask.any()  # the seeded lists meet
    for rank, res in enumerate(ranks4):
        ids, mask = res["results"][(model, k, sem)]
        np.testing.assert_array_equal(ids, want_ids, err_msg=f"rank {rank}")
        np.testing.assert_array_equal(mask, want_mask, err_msg=f"rank {rank}")


def test_wrong_k_raises_as_the_reference_does(ranks4, reference):
    want = reference["wrong_k"]
    assert want == "built for k=4 keyword lists, got inputs with 3"
    assert {res["wrong_k"] for res in ranks4} == {want}


def test_make_host_mesh_shapes(ranks4, ranks3):
    names = ("data", "model")
    for res in ranks4:
        assert res["meshes"] == {4: ((1, 4), names), 2: ((2, 2), names)}
    for res in ranks3:
        assert res["meshes"] == {3: ((1, 3), names)}


def test_mesh_defaults_to_the_card(monkeypatch):
    from repro_torch.launch.mesh import make_host_mesh, rank_device

    assert not dist.is_initialized()  # importing touched no process group
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rank_device()
    assert rank_device("cpu") == torch.device("cpu")
