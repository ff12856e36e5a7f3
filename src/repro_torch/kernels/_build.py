"""Build, load and feed the port's CUDA C++ kernels (nvcc + ctypes).

Every kernel source in ``csrc/`` is compiled on its own into a shared
library with a plain C entry point, at first use on a CUDA tensor, and
loaded with ``ctypes``.  The library is named by a hash of the source, the
shared headers beside it and the flags, written to a temporary name and
renamed into place, so concurrent builders never load a half-written file
and an edited source is rebuilt.  Nothing here runs when a module is
imported: a host without ``nvcc`` imports every kernel module and runs its
plain PyTorch version on CPU tensors.

:class:`Entry` is the launch path the kernel wrappers share: each C entry
point is bound once and then called with plain ints, on the caller's
current stream.  :func:`int32_device` is the search wrappers' input check:
a kernel reads raw int32 pointers, so anything else must be refused before
launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"


def _build_dir() -> Path:
    """``build/repro_torch_kernels`` in a source checkout (``src/`` beside
    ``build/``); for an installed package, the user's cache directory."""
    if _PACKAGE.parent.name == "src":
        return _PACKAGE.parents[1] / "build" / "repro_torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch_kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[Path, ctypes.CDLL] = {}
_INT32 = torch.int32
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(source: Path) -> Path:
    """Compile ``source`` once per content hash; return the shared library."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source.name} ({proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load(source: Path) -> ctypes.CDLL:
    """The library built from ``source``, loaded once per process into
    ``_LIBS``."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = _LIBS[source] = ctypes.CDLL(str(build(source)))
        return lib


# The launch path's two private torch calls, bound once here.  The public
# forms cost more than the launch they feed (chip_smoke.py's host
# breakdown, PERF.md); tests/test_torch_chained_cuda.py pins each to its
# public form, on the default stream and on a side stream.  A build of torch
# without CUDA has neither (None here): only CUDA tensors reach them.

#: ``current_stream_ptr(index)``: the raw ``cudaStream_t`` of device
#: ``index``'s current stream, ``torch._C._cuda_getCurrentRawStream``, the
#: call behind ``torch.cuda.current_stream(index).cuda_stream`` (which also
#: builds a ``torch.cuda.Stream`` object).
current_stream_ptr = getattr(torch._C, "_cuda_getCurrentRawStream", None)

#: ``current_device_index()``: the current CUDA device,
#: ``torch._C._cuda_getDevice``, the call behind
#: ``torch.cuda.current_device()`` (which also checks lazy init first; a
#: caller here already holds a CUDA tensor).
current_device_index = getattr(torch._C, "_cuda_getDevice", None)


class Entry:
    """One C entry point of a kernel library, bound at its first call.

    ``argtypes`` are the ctypes types of its arguments before the stream,
    which always comes last; it returns an ``int``, the first
    ``cudaError_t`` it saw.  The first call builds and loads the library
    and binds the function; later calls reach the bound ctypes function
    with no lock, table lookup or ``getattr``.  A binding holds while
    ``_LIBS`` is the table it was loaded into: a new table (a fresh start,
    as the no-library tests make) unbinds every entry.
    """

    __slots__ = ("source", "name", "argtypes", "_fn", "_libs")

    def __init__(self, source: Path, name: str, argtypes: list):
        self.source, self.name, self.argtypes = source, name, argtypes
        self._fn = self._libs = None

    def _bind(self):
        fn = getattr(load(self.source), self.name)
        fn.argtypes = [*self.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self._fn, self._libs = fn, _LIBS
        return fn

    def __call__(self, index: int, *args) -> None:
        """Launch on the current stream of CUDA device ``index``, without
        synchronising.

        ``args`` are plain ints and floats (pointers as ``data_ptr()``).  A
        device guard is entered only when ``index`` is not the current
        device.  Raises on the CUDA error the entry point returns.
        """
        fn = self._fn if self._libs is _LIBS else self._bind()
        if index == current_device_index():
            err = fn(*args, current_stream_ptr(index))
        else:
            with torch.cuda.device(index):
                err = fn(*args, current_stream_ptr(index))
        if err:
            raise RuntimeError(f"{self.name} failed: cudaError {err}")


def int32_device(*tensors: torch.Tensor) -> int:
    """Every tensor int32, contiguous and on the first one's device; return
    that device's CUDA index, -1 on the CPU.

    Plain attribute compares (``get_device``, ``is`` on the dtype), since a
    chained call is host-bound; a fault raises ``ValueError`` naming the
    input.
    """
    first = tensors[0]
    index = first.get_device()
    for i, t in enumerate(tensors):
        if t.dtype is not _INT32:
            raise ValueError(f"input {i} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"input {i} must be contiguous")
        if t.get_device() != index or (index < 0 and t.device != first.device):
            raise ValueError(f"input {i} is on {t.device}, input 0 on {first.device}")
    if index < 0 and not first.is_cpu:
        raise ValueError(f"the kernels run on cpu or cuda, not {first.device}")
    return index
