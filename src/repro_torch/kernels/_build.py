"""Build, load and feed the port's CUDA C++ kernels (nvcc + ctypes).

Every kernel source in ``csrc/`` is compiled on its own into a shared
library with a plain C entry point, at first use on a CUDA tensor, and
loaded with ``ctypes``.  The library is named by a hash of the source, the
shared headers beside it and the flags, written to a temporary name and
renamed into place, so concurrent builders never load a half-written file
and an edited source is rebuilt.  Nothing here runs when a module is
imported: a host without ``nvcc`` imports every kernel module and runs its
plain PyTorch version on CPU tensors.

:func:`launch` is the launch sequence the kernel wrappers share, and
:func:`check_int32` their input check: a kernel reads raw int32 pointers,
so anything else must be refused before launch.
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


def load(source: Path, functions: dict[str, list]) -> ctypes.CDLL:
    """The library built from ``source``, loaded once per process.

    ``functions`` maps each C entry point to its ctypes argument types; every
    entry point returns an ``int`` (the first ``cudaError_t`` it saw).
    """
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            for name, argtypes in functions.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[source] = lib
        return lib


def launch(
    source: Path, functions: dict[str, list], entry: str, dev: torch.device,
    *args,
) -> None:
    """Call the C entry point ``entry`` of ``source``'s library on ``dev``.

    Tensors in ``args`` pass as their data pointers, other values as they
    are; the current stream of ``dev`` goes last.  The kernel runs on that
    stream, without synchronising.  Raises on the CUDA error it returns.
    """
    lib = load(source, functions)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError {err}")


def check_int32(**tensors: torch.Tensor) -> torch.device:
    """Every tensor int32, contiguous and on one device; return that device."""
    device = None
    for name, t in tensors.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name} is on {t.device}, the others on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cpu or cuda, not {device}")
    return device
