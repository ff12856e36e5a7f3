"""The port's dry-run (``repro_torch.launch.dryrun``) against the reference's
pieces, and its own mechanism.

Parity with the JAX package, for every arch and shape of the registry:
``input_specs_for`` (leaf shapes and dtypes against the reference's
``ShapeDtypeStruct``s; the same refusals with the same reason), the
parameter counts (``count_params_analytic`` in both modes,
``active_param_count``), ``model_flops_for``, ``cell_applicable`` and
``all_cells``.

The trace (on fake tensors, over torch's ``"fake"`` process group, at
reduced widths and small shapes): its FLOPs equal ``FlopCounterMode``'s
over a real CPU run of the same step (the trace on fake ``"cpu"`` tensors,
so that both take one route); per-device matmul FLOPs on a (4, 1) mesh are
a quarter of one device's; collective bytes are 0 on (1, 1) and not on (2,
2); ``argument_bytes`` are the local shards ``dist/sharding.py`` gives;
``account_cell``'s extrapolation equals a full-depth trace exactly, at 1
and 2 microbatches; two microbatches keep the per-device FLOPs of one,
and trace as two steps over their rows; the
search's collectives are the same under both membership backends; the CLI
at full width (in a subprocess, fake tensors over 256 ranks);
``hillclimb.measure``; the production meshes over 512 fake ranks.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Shard
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as jreg
import repro.roofline.analysis as janalysis
from repro.models.model import count_params_analytic as jax_count
from repro_torch.configs import (
    CONFIGS,
    SHAPES,
    all_cells,
    cell_applicable,
    get_config,
    input_specs,
    input_specs_for,
)
from repro_torch.configs.registry import ShapeCell
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun, hillclimb
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.models.model import count_params_analytic
from repro_torch.roofline.analysis import model_flops_for
from repro_torch.roofline.profile import biggest_ops, traffic_by_op
from repro_torch.train.optimizer import pick_optimizer
from repro_torch.train.train_step import make_train_step

ROOT = Path(__file__).resolve().parent.parent
ARCHS = sorted(CONFIGS)
KINDS_KEPT = {  # deepseek's MLA + MoE pattern at reduced widths
    "smollm-135m": {},
    "deepseek-v2-lite-16b": dict(n_layers=2, scan_period=2,
                                 layer_pattern=(("mla", "swiglu"), ("mla", "moe"))),
}
TINY = {  # small cells for traces at reduced widths
    "tiny_train": ShapeCell("tiny_train", 32, 8, "train"),
    "tiny_train_256": ShapeCell("tiny_train_256", 32, 32, "train"),  # a batch the data dim (16) divides
    "tiny_prefill": ShapeCell("tiny_prefill", 32, 8, "prefill"),
    "tiny_decode": ShapeCell("tiny_decode", 32, 8, "decode"),
}


@pytest.fixture
def tiny_cells(monkeypatch):
    for name, cell in TINY.items():
        monkeypatch.setitem(SHAPES, name, cell)


@pytest.fixture
def fake_world():
    """``fake_world(n)`` starts torch's fake process group with n ranks; the
    group is gone after the test."""
    yield dryrun.fake_group
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(shape, device="cpu"):
    return DeviceMesh(device, torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=("data", "model"))


# --------------------------------------------------------------------------- #
# Parity with the reference: specs, parameter counts, model FLOPs, cells
# --------------------------------------------------------------------------- #


def _leaf(x) -> tuple:
    """(shape, dtype name) of a reference ShapeDtypeStruct or a port tensor."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    return tuple(x.shape), str(np.dtype(x.dtype))


def _same_cache(got: list, want: list, cfg, length: int):
    """The port's cache (a dict per layer, the mixer's keys plus ``"ffn"``)
    against the reference's (per position of a scan unit, ``{"mixer",
    "ffn"}`` stacked over the scan steps)."""
    assert len(got) == cfg.n_layers
    for i, layer in enumerate(got):
        step, u = divmod(i, cfg.scan_period)
        ref = want[u]
        mixer = {k: v for k, v in layer.items() if k != "ffn"}
        assert set(mixer) == set(ref["mixer"]), (i, set(mixer), set(ref["mixer"]))
        for key, t in mixer.items():
            r = ref["mixer"][key]
            if key == "len":
                assert isinstance(t, int) and t == length
                assert _leaf(r) == ((cfg.num_scan_steps,), "int32")
                continue
            shape, dtype = _leaf(r)
            assert _leaf(t) == (shape[1:], dtype), (i, key)
        if "ffn" in layer or ref.get("ffn") is not None:
            for key, t in layer["ffn"].items():
                shape, dtype = _leaf(ref["ffn"][key])
                assert _leaf(t) == (shape[1:], dtype), (i, "ffn", key)


@pytest.mark.parametrize("shape", list(jreg.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jreg.get_config(arch)
    ok = cell_applicable(cfg, shape)
    assert ok == jreg.cell_applicable(jcfg, shape)
    if not ok[0]:
        with pytest.raises(ValueError) as got:
            input_specs_for(cfg, shape)
        with pytest.raises(ValueError) as want:
            jreg.input_specs_for(jcfg, shape)
        assert str(got.value) == str(want.value)
        return
    got, want = input_specs(arch, shape), jreg.input_specs(arch, shape)
    assert set(got) == set(want)
    seq = SHAPES[shape].seq_len
    for key, value in got.items():
        if key == "cache":
            _same_cache(value, want[key], cfg, seq - 1 if "token" in got else 0)
        elif key == "step_position":
            assert value == seq - 1 and _leaf(want[key]) == ((), "int32")
        elif key == "batch":
            assert {k: _leaf(v) for k, v in value.items()} == {
                k: _leaf(v) for k, v in want[key].items()}
        else:
            assert _leaf(value) == _leaf(want[key]), key
            assert value.device.type == "meta"


class _Active:
    """A config as ``model_flops_for`` reads it: its active parameter count."""

    def __init__(self, n: int):
        self.n = n

    def active_param_count(self) -> int:
        return self.n


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_match_the_reference(arch):
    """Totals are held against the reference in ``test_torch_lm.py``; the
    active count differs from the total only under an MoE, where it is held
    here; ``model_flops_for`` is the reference's on the same active count."""
    cfg, jcfg = get_config(arch), jreg.get_config(arch)
    total, active = count_params_analytic(cfg), count_params_analytic(cfg, active_only=True)
    assert total == cfg.param_count()
    assert active == cfg.active_param_count()
    if cfg.moe is None:
        assert active == total
    else:
        assert active == jax_count(jcfg, active_only=True) < total
    for shape, cell in SHAPES.items():
        if cell_applicable(cfg, shape)[0]:
            train = cell.kind == "train"
            assert model_flops_for(cfg, cell, train) == janalysis.model_flops_for(
                _Active(active), jreg.SHAPES[shape], train)


def test_cells_match_the_reference():
    assert all_cells() == jreg.all_cells()
    assert [(s, c.seq_len, c.global_batch, c.kind) for s, c in SHAPES.items()] == [
        (s, c.seq_len, c.global_batch, c.kind) for s, c in jreg.SHAPES.items()]


# --------------------------------------------------------------------------- #
# The trace: FLOPs equal a real run's, per device below DTensor
# --------------------------------------------------------------------------- #


def _real_flops(cfg, shape: str) -> float:
    """FlopCounterMode over a real CPU run of the step ``dryrun`` traces."""
    cell = SHAPES[shape]
    b, s = cell.global_batch, cell.seq_len
    model = init_params(0, cfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(b, s), dtype=np.int32))
    if cell.kind == "train":
        init_state, train_step = make_train_step(cfg, optimizer=pick_optimizer(cfg))
        state = init_state(model)
        with FlopCounterMode(display=False) as fc:
            train_step(state, {"tokens": tokens})
        return fc.get_total_flops()
    cache = init_cache(cfg, b, s, "cpu")
    if cell.kind == "prefill":
        with FlopCounterMode(display=False) as fc:
            prefill(model, cfg, tokens, cache)
        return fc.get_total_flops()
    for layer in cache:
        if "len" in layer:
            layer["len"] = s - 1
    with FlopCounterMode(display=False) as fc:
        decode_step(model, cfg, tokens[:, :1], cache, s - 1)
    return fc.get_total_flops()


@pytest.mark.parametrize("shape", ["tiny_train", "tiny_prefill", "tiny_decode"])
@pytest.mark.parametrize("arch", list(KINDS_KEPT))
def test_traced_flops_equal_a_real_run(tiny_cells, arch, shape):
    cfg = get_config(arch).reduced(**KINDS_KEPT[arch])
    trace = dryrun.lower_step(cfg, shape, None, 1, device="cpu")
    assert trace.costs["flops"] == _real_flops(cfg, shape) > 0
    assert trace.costs["collective_bytes"] == 0
    assert trace.memory["temp_bytes"] > 0
    if shape == "tiny_decode":
        # the attention of every GQA layer is the registered op, never its plain version
        ops = trace.counter.table
        gqa = sum(m == "gqa" for m, _ in cfg.layer_pattern)
        assert ops.get("repro_torch.decode_attention", {}).get("calls", 0) == gqa
        assert "aten.amax" not in ops and "aten.masked_fill" not in ops
        # the op table read as the reference read HLO text
        traffic = traffic_by_op(ops, top=len(ops))
        assert [b for _, b in traffic] == sorted((b for _, b in traffic), reverse=True)
        assert sorted(traffic) == sorted((op, r["result_bytes"]) for op, r in ops.items())
        (size, op, shapes), = biggest_ops(ops, top=1)
        assert size == max(r["max_result_bytes"] for r in ops.values()) > 0
        assert op in ops and "[" in shapes


def _matmul_flops(trace) -> int:
    return sum(trace.counter.table.get(op, {}).get("flops", 0)
               for op in ("aten.mm", "aten.bmm", "aten.addmm"))


def test_per_device_matmul_flops_on_four_ranks_are_a_quarter(tiny_cells, fake_world):
    cfg = get_config("smollm-135m").reduced()
    one = dryrun.lower_step(cfg, "tiny_prefill", None, 1, device="cpu")
    fake_world(4)
    four = dryrun.lower_step(cfg, "tiny_prefill", _mesh((4, 1)), 1, device="cpu")
    assert _matmul_flops(one) > 0
    assert 4 * _matmul_flops(four) == _matmul_flops(one)


def test_collective_bytes_by_kind_on_one_and_four_ranks(tiny_cells, fake_world):
    cfg = get_config("smollm-135m").reduced()
    fake_world(1)
    alone = dryrun.lower_step(cfg, "tiny_prefill", _mesh((1, 1)), 1, device="cpu").costs
    assert alone["collective_bytes"] == 0 and alone["collectives"]["total"] == 0
    fake_world(4)
    four = dryrun.lower_step(cfg, "tiny_prefill", _mesh((2, 2)), 1, device="cpu").costs
    kinds = four["collectives"]
    assert set(kinds) == {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                          "collective-permute", "total"}
    assert four["collective_bytes"] == kinds["total"] == sum(
        v for k, v in kinds.items() if k != "total") > 0


def _local_bytes(tree, specs, mesh) -> int:
    """Bytes of rank 0's pieces of ``tree`` under ``specs`` (placements per
    mesh dim; a sharded axis split evenly, rank 0 taking the first piece)."""
    if isinstance(tree, dict):
        return sum(_local_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, list):
        return sum(_local_bytes(v, s, mesh) for v, s in zip(tree, specs))
    if not isinstance(tree, torch.Tensor):
        return 0
    shape = list(tree.shape)
    for n, p in zip(mesh.shape, specs):
        if isinstance(p, Shard):
            shape[p.dim] = -(-shape[p.dim] // n)
    return math.prod(shape) * tree.element_size()


def test_argument_bytes_are_the_local_shards(tiny_cells, fake_world):
    cfg = get_config("smollm-135m").reduced()
    fake_world(4)
    mesh = _mesh((2, 2))
    trace = dryrun.lower_step(cfg, "tiny_decode", mesh, 1, device="cpu")
    specs = input_specs_for(cfg, "tiny_decode")
    params = shd.tensor_tree(dryrun.Model(cfg, "meta"))
    want = (_local_bytes(params, shd.param_specs(params, mesh), mesh)
            + _local_bytes(specs["token"], shd.data_specs(specs["token"], mesh), mesh)
            + _local_bytes(specs["cache"], shd.cache_specs(specs["cache"], mesh), mesh))
    assert trace.memory["argument_bytes"] == want > 0


@pytest.mark.parametrize("shape,mb,mesh_shape", [("tiny_prefill", 1, (2, 2)),
                                                 ("tiny_train", 2, (4, 1))])
def test_accounting_extrapolation_equals_the_full_depth_trace(tiny_cells, fake_world,
                                                              shape, mb, mesh_shape):
    cfg = get_config("smollm-135m").reduced(n_layers=3)
    assert cfg.num_scan_steps == 3
    fake_world(4)
    mesh = _mesh(mesh_shape)
    full = dryrun.lower_step(cfg, shape, mesh, mb, device="cpu").costs
    acct = dryrun.account_cell(cfg, shape, mesh, mb, device="cpu")
    for key in dryrun.COST_KEYS:
        assert acct[key] == full[key] > 0, key
        assert acct["per_unit"][key] > 0, key


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_microbatches_keep_the_per_device_flops(tiny_cells, fake_world, mesh_shape):
    """Two microbatches of a batch do the FLOPs of one step over it (the
    accumulation's adds and casts count no FLOPs), a quarter of one
    device's products on four ranks."""
    cfg = get_config("smollm-135m").reduced(n_layers=1)
    alone = dryrun.lower_step(cfg, "tiny_train", None, 1, device="cpu")
    fake_world(4)
    mesh = _mesh(mesh_shape)
    one = dryrun.lower_step(cfg, "tiny_train", mesh, 1, device="cpu")
    two = dryrun.lower_step(cfg, "tiny_train", mesh, 2, device="cpu")
    assert two.costs["flops"] == one.costs["flops"] > 0
    assert {op: r["flops"] for op, r in two.counter.table.items() if r["flops"]} == {
        op: r["flops"] for op, r in one.counter.table.items() if r["flops"]}
    assert 4 * _matmul_flops(two) == _matmul_flops(alone)


def test_a_microbatch_traces_as_a_step_over_its_rows(monkeypatch, fake_world):
    """On (2, 4) a batch of 8 in two microbatches does, per device, twice the
    work of one step over 4 rows, op by op: what a rank computes follows
    the rows it holds in one product, which is where DTensor's choices
    differ from a step over all 8 (ROADMAP §3)."""
    monkeypatch.setitem(SHAPES, "rows_8", ShapeCell("rows_8", 32, 8, "train"))
    monkeypatch.setitem(SHAPES, "rows_4", ShapeCell("rows_4", 32, 4, "train"))
    cfg = get_config("smollm-135m").reduced(n_layers=1)
    fake_world(8)
    mesh = _mesh((2, 4))
    two = dryrun.lower_step(cfg, "rows_8", mesh, 2, device="cpu").counter.table
    half = dryrun.lower_step(cfg, "rows_4", mesh, 1, device="cpu").counter.table
    products = ("aten.mm", "aten.bmm")
    assert {op: two[op]["flops"] for op in products} == {
        op: 2 * half[op]["flops"] for op in products}
    assert all(two[op]["calls"] == 2 * half[op]["calls"] for op in products)


def test_search_collectives_are_the_same_under_both_backends(fake_world):
    torch_rec = dryrun.lower_search(False, verbose=False, backend="torch", device="cpu")
    chained = dryrun.lower_search(False, verbose=False, backend="chained", device="cpu")
    assert torch_rec["mesh"] == "16x16" and torch_rec["chips"] == 256
    assert torch_rec["trace_costs"]["collectives"] == chained["trace_costs"]["collectives"]
    assert chained["trace_costs"]["collective_bytes"] > 0
    assert chained["ops"]["repro_torch.searchsorted"]["calls"] == 1
    assert "repro_torch.searchsorted" not in torch_rec["ops"]


def test_hillclimb_measures_a_reduced_cell(tiny_cells, fake_world):
    cfg = get_config("smollm-135m").reduced(n_layers=1)  # one clone to trace
    res = hillclimb.measure(cfg, "tiny_train_256", 1)
    assert res["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    assert res["flops"] > 0 and res["bytes"] > 0 and res["collective_bytes"] > 0
    assert 0 < res["hw_fraction"] <= 1


# --------------------------------------------------------------------------- #
# Full width, in subprocesses: the production meshes and the CLI
# --------------------------------------------------------------------------- #


def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=timeout)


_MESH_CHILD = """
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_production_mesh

def fake_group(world):
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)

fake_group(512)
for multi_pod in (False, True):
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
    except ValueError as e:
        print("refused", multi_pod, e)
        continue
    print(tuple(mesh.shape), mesh.mesh_dim_names, mesh.device_type)
fake_group(256)
mesh = make_production_mesh()
print(tuple(mesh.shape), mesh.mesh_dim_names, mesh.device_type)
"""


def test_production_meshes_over_a_fake_group():
    proc = _run(["-c", _MESH_CHILD])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("refused False")  # (16, 16) needs 256 ranks, not 512
    assert lines[1:] == ["(2, 16, 16) ('pod', 'data', 'model') cuda",
                         "(16, 16) ('data', 'model') cuda"]


def test_cli_at_full_width(tmp_path):
    out = tmp_path / "rec.json"
    proc = _run(["-m", "repro_torch.launch.dryrun", "--arch", "smollm-135m",
                 "--shape", "decode_32k", "--no-accounting", "--out", str(out)])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "smollm-135m × decode_32k × 16x16: OK" in proc.stdout
    (rec,) = json.loads(out.read_text())
    assert rec["ok"] and rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["device"] == dryrun.trace_device() and rec["memory"]["argument_bytes"] > 0
    # 30 GQA layers: the registered op once each, no plain version's ops
    assert rec["ops"]["repro_torch.decode_attention"]["calls"] == 30
    assert "aten.amax" not in rec["ops"]
    skip = _run(["-m", "repro_torch.launch.dryrun", "--arch", "hubert-xlarge",
                 "--shape", "decode_32k"])
    assert skip.returncode == 0, skip.stderr
    assert "hubert-xlarge × decode_32k: SKIP (encoder-only" in skip.stdout
