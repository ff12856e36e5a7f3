"""The scan kernels' CUDA sources, run on the CPU through an emulation of CUDA, == their plain versions.

``csrc/mamba_scan.cu`` and ``csrc/rwkv6_wkv.cu`` run on the card only (there
is no nvcc here).  So that their index arithmetic, lane layouts, reductions
and cp.async pipelines are tested on every tier-1 run too, this compiles the
same sources with g++ against ``tests/cuda_emu/`` (one std::thread per CUDA
thread, barriers for ``__syncthreads`` and the shuffles, cp.async copies that
land only when waited for, shared memory filled with NaNs) and runs them
through the ops' CUDA launch path (``_mamba_launch`` and the rest, padding
and workspace included) on CPU tensors, with the kernel entries replaced by
the emulated module's functions.  The translation is textual: a launch
``k<<<g, b, m, s>>>(args)`` becomes ``emu::launch(g, b, m, s, [&] {
k(args); })``, and scan.cuh's host branches of cp.async call the emulator.

Tolerances as on the card (``test_torch_ssm_scan_cuda.py``): float32 within
1e-4 of each output's largest value, a bfloat16 gradient within 1e-2; two
backward calls give the same bits.  The emulated ``ex2`` is exp2f, not the
card's ex2.approx, so this holds the algorithm, not the card's rounding.
"""
import re
import shutil
import subprocess
import sysconfig
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ssm_scan

EMU = Path(__file__).parent / "cuda_emu"
# scan.cuh's host branches -> the emulator's cp.async
HOOKS = (
    ("memcpy(smem, gmem, 16);", "emu::cp_async(smem, gmem);"),
    ('asm volatile("cp.async.commit_group;\\n" ::);\n#endif',
     'asm volatile("cp.async.commit_group;\\n" ::);\n#else\n  emu::cp_commit();\n#endif'),
    ('"memory");\n#endif', '"memory");\n#else\n  emu::cp_wait(N);\n#endif'),
)
LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)


def _translate(text: str) -> str:
    text = text.replace("extern __shared__ __align__(16) unsigned char smem[];",
                        "unsigned char* smem = emu::dynamic_smem;")
    for old, new in HOOKS:
        text = text.replace(old, new)
    return LAUNCH.sub(lambda m: f"emu::launch({m[2]}, [&]() {{ {m[1]}({m[3]}); }});", text)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """{kind: the kernel module built from its source for the emulator}."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    out = tmp_path_factory.mktemp("cuda_emu")
    for header in ("scan.cuh", "pyentry.cuh"):
        (out / header).write_text(_translate((_build.CSRC / header).read_text()))
    scan_text = (out / "scan.cuh").read_text()
    assert all(new in scan_text for _old, new in HOOKS[1:]), "scan.cuh's cp.async branches moved"
    mods = {}
    for kind, source in (("mamba", ssm_scan._MAMBA_SOURCE), ("rwkv6", ssm_scan._RWKV_SOURCE)):
        cpp = out / f"{source.stem}.cpp"
        cpp.write_text(_translate(source.read_text()))
        lib = out / f"{source.stem}.so"
        cmd = ["g++", "-std=c++17", "-O1", "-pthread", "-shared", "-fPIC", "-I", str(EMU),
               "-I", sysconfig.get_paths()["include"], "-include", "cuda_emu.h", str(cpp),
               str(EMU / "emu.cpp"), "-o", str(lib)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        mods[kind] = _build.import_extension(source.stem, lib)
    return mods


@pytest.fixture
def kernels(emulated, monkeypatch):
    """The ops' kernel entries pointed at the emulated modules."""
    def entry(mod, name):
        fn = getattr(mod, name)

        def call(index, *args):
            err = fn(*args, 0)
            if err:
                raise RuntimeError(f"{name} failed: {err}")
        return call

    for dt, suffix in ssm_scan._SUFFIX.items():
        for table, mod, name in ((ssm_scan._MAMBA, "mamba", "mamba_scan"),
                                 (ssm_scan._MAMBA_BWD, "mamba", "mamba_scan_bwd"),
                                 (ssm_scan._RWKV, "rwkv6", "rwkv6_wkv"),
                                 (ssm_scan._RWKV_BWD, "rwkv6", "rwkv6_wkv_bwd")):
            monkeypatch.setitem(table, dt, entry(emulated[mod], f"{name}_{suffix}"))


def _inputs(kind, shape, dtype, seed):
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    if kind == "mamba":
        b, s, e, n = shape
        return (t((b, e, n)), (t((b, s, e), 0.1).abs() + 0.001).to(dtype), t((b, s, n)).to(dtype),
                t((b, s, n)).to(dtype), t((b, s, e)).to(dtype), -(t((e, n)).abs() + 0.1))
    b, s, h, hd = shape
    return (t((b, h, hd, hd)), *(t((b, s, h, hd), 0.5).to(dtype) for _ in range(3)),
            torch.exp(-torch.exp(t((b, s, h, hd), 0.5) - 2.0)), t((h, hd), 0.5))


def _close(got, want, what):
    tol = 1e-4 if want.dtype == torch.float32 else 1e-2
    assert got.dtype == want.dtype and got.shape == want.shape, what
    err = float((got.float() - want.float()).abs().max())
    scale = max(float(want.float().abs().max()), 1e-30)
    assert err <= tol * scale, f"{what}: max abs err {err} over {tol} x {scale}"


CASES = [  # at the kernels' edges: S one off a tile or chunk, E off a block, padded sizes
    ("mamba", (2, 9, 70, 16)),   # S a chunk and one; E one forward block, two backward
    ("mamba", (1, 17, 130, 8)),  # S a forward tile and one; E rows not 16-byte aligned
    ("mamba", (1, 33, 64, 12)),  # past the backward's ring; N padded to 16
    ("mamba", (2, 1, 5, 4)),     # a decode step; N padded to 8
    ("rwkv6", (2, 9, 2, 64)),    # S a chunk and one
    ("rwkv6", (1, 33, 1, 32)),   # S a forward tile and one; past the ring
    ("rwkv6", (1, 7, 3, 48)),    # S one below a chunk; hd padded to 64
    ("rwkv6", (2, 1, 2, 16)),    # a decode step; hd padded to 32
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,shape", CASES)
def test_emulated_kernels_equal_plain(kernels, kind, shape, dtype):
    args = _inputs(kind, shape, dtype, seed=sum(shape))
    if kind == "mamba":
        launch, bwd_launch = ssm_scan._mamba_launch, ssm_scan._mamba_bwd_launch
        plain, bwd_plain = ssm_scan.mamba_scan_plain, ssm_scan.mamba_scan_backward_plain
        names = ("dh0", "ddt", "dB", "dC", "dx", "da")
    else:
        launch, bwd_launch = ssm_scan._rwkv_launch, ssm_scan._rwkv_bwd_launch
        plain, bwd_plain = ssm_scan.rwkv6_wkv_plain, ssm_scan.rwkv6_wkv_backward_plain
        names = ("ds0", "dr", "dk", "dv", "dw", "du")
    got = launch(*args)
    for name, g, w in zip(("y", "state"), got, plain(*args)):
        _close(g, w, name)
    gen = torch.Generator().manual_seed(1)
    grads = [torch.randn(o.shape, generator=gen) for o in got]
    back = bwd_launch(*grads, *args)
    for name, g, w in zip(names, back, bwd_plain(*grads, *args)):
        _close(g, w, name)
    again = bwd_launch(*grads, *args)
    assert all(torch.equal(a, b) for a, b in zip(back, again)), "two backward calls differ"
