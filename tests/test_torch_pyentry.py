"""The kernels' Python binding (``csrc/pyentry.cuh``) on the CPU.

The header needs no CUDA: each test compiles it with g++ around a host C
function shaped like a kernel entry point, imports the result with the
port's loader (``_build.import_extension``) and calls it as a kernel wrapper
does.  The kernel sources themselves need nvcc and a card
(``tests/test_torch_*_cuda.py``); here it is checked that every entry a
wrapper binds is exported by its source, and that a build without nvcc or
``Python.h`` raises naming the path it looked for.
"""
import re
import shutil
import subprocess
import sysconfig
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import (
    _build,
    decode_attention,
    elca_segsum,
    fused_search,
    intersect,
    searchsorted,
)

PROBE = r"""
#include "pyentry.cuh"

#include <cstring>

// out[0] = ptr, out[1] = n, out[2] = the bits of (double) x, out[3] = stream;
// returns -n for small negative n, like an entry point returning an error code
extern "C" int probe(long long* out, const void* ptr, int n, float x, void* stream) {
  out[0] = reinterpret_cast<long long>(ptr);
  out[1] = n;
  const double wide = x;
  std::memcpy(out + 2, &wide, sizeof wide);
  out[3] = reinterpret_cast<long long>(stream);
  return n < 0 && n > -100000 ? -n : 0;
}

extern "C" int nothing(void* stream) { return stream == nullptr ? 7 : 0; }

PYENTRY_MODULE(probe_entry, PYENTRY_FN(probe), PYENTRY_FN(nothing))
"""

WRAPPERS = {  # kernel module -> the entries it binds
    "searchsorted": [searchsorted._LAUNCH],
    "elca_segsum": [elca_segsum._LAUNCH],
    "intersect": [intersect._LAUNCH, intersect._LISTS],
    "fused_search": [fused_search._LAUNCH],
    "decode_attention": list(decode_attention._LAUNCH.values()),
}


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """The probe module, compiled with g++ against this Python's headers."""
    gxx = shutil.which("g++")
    include = sysconfig.get_paths()["include"]
    if gxx is None or not Path(include, "Python.h").exists():
        pytest.skip("needs g++ and Python.h to compile the binding header")
    out = tmp_path_factory.mktemp("pyentry")
    src = out / "probe.cc"
    src.write_text(PROBE)
    lib = out / "probe_entry.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-Wall", "-Werror",
         "-I", str(_build.CSRC), "-I", include, "-o", str(lib), str(src)],
        check=True, capture_output=True, text=True,
    )
    return _build.import_extension("probe_entry", lib)


def call(probe, *args):
    """(return value, [ptr, n, x, stream] as the C function saw them)."""
    out = np.zeros(4, np.int64)
    rc = probe.probe(out.ctypes.data, *args)
    return rc, [int(out[0]), int(out[1]), float(out[2:3].view(np.float64)[0]), int(out[3])]


@pytest.mark.parametrize("ptr", [0, 1, 0x7FFF_1234_5678_9ABC, 0xFFFF_FFFF_0000_0010],
                         ids=["null", "one", "high", "top-bit"])
def test_pointer_arrives_uncut(probe, ptr):
    rc, (got, n, _, stream) = call(probe, ptr, 3, 0.5, 0xDEAD_BEEF_0000)
    assert rc == 0 and n == 3
    assert got & (2**64 - 1) == ptr  # all 64 bits, the top one too
    assert stream == 0xDEAD_BEEF_0000


@pytest.mark.parametrize("n", [2**31 - 1, -(2**31)], ids=["max", "min"])
def test_int_at_its_limits_arrives(probe, n):
    rc, (_, got, _, _) = call(probe, 0, n, 0.0, 0)
    assert got == n and rc == 0


@pytest.mark.parametrize("n", [2**31, -(2**31) - 1, 2**70], ids=["max+1", "min-1", "2^70"])
def test_int_out_of_range_raises_overflow(probe, n):
    with pytest.raises(OverflowError):
        call(probe, 0, n, 0.0, 0)


@pytest.mark.parametrize("x,want", [(0.25, 0.25), (3, 3.0), (1e-3, float(np.float32(1e-3)))],
                         ids=["float", "int", "rounded"])
def test_float_arrives_as_float(probe, x, want):
    _, (_, _, got, _) = call(probe, 0, 1, x, 0)
    assert got == want


@pytest.mark.parametrize("args", [(0, 1, 0.5), (0, 1, 0.5, 0, 9), ()],
                         ids=["one-short", "one-over", "none"])
def test_wrong_count_raises_type_error(probe, args):
    out = np.zeros(4, np.int64)
    with pytest.raises(TypeError, match="takes 5 arguments"):
        probe.probe(out.ctypes.data, *args)


@pytest.mark.parametrize("bad", [None, "0", 1.5], ids=["none", "str", "float"])
def test_pointer_or_int_of_another_type_raises_type_error(probe, bad):
    with pytest.raises(TypeError):
        call(probe, bad, 1, 0.5, 0)
    with pytest.raises(TypeError):
        call(probe, 0, bad, 0.5, 0)


def test_nonzero_return_comes_back(probe):
    rc, _ = call(probe, 0, -719, 0.0, 0)
    assert rc == 719 and isinstance(rc, int)
    assert probe.nothing(0) == 7 and probe.nothing(8) == 0


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_every_bound_entry_is_exported_by_its_source(name):
    """The source's module is named after the file and lists each entry a
    wrapper binds (an entry missing there would fail only on the card)."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    module = re.search(r"PYENTRY_MODULE\((\w+),(.*?)\)\s*$", text, re.S)
    assert module and module.group(1) == name
    exported = set(re.findall(r"PYENTRY_FN\((\w+)\)", module.group(2)))
    for entry in WRAPPERS[name]:
        assert entry.source == _build.CSRC / f"{name}.cu"
        assert entry.name in exported
        assert re.search(rf'extern "C" int {entry.name}\(', text)


def test_build_without_nvcc_names_the_path(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found") as err:
        _build.build(searchsorted._SOURCE)
    assert str(tmp_path / "cuda" / "bin" / "nvcc") in str(err.value)


def test_build_without_python_h_names_the_path(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(sysconfig, "get_paths", lambda: {"include": str(tmp_path)})
    with pytest.raises(RuntimeError, match="Python.h not found") as err:
        _build.build(elca_segsum._SOURCE)
    assert str(tmp_path / "Python.h") in str(err.value)
    assert not list(tmp_path.iterdir())  # nothing was built
