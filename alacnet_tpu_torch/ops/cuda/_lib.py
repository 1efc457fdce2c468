"""Build, load and route the port's hand-written CUDA kernels.

All ``csrc/*.cu`` files compile in ONE ``nvcc`` call into one shared
library with a plain C interface under ``alacnet_tpu_torch/_build/``,
named by a hash of the sources and flags, at first use (so a fresh
checkout builds it on its first launch).  It is loaded with ctypes: no
PyTorch headers, so the build takes seconds.  Each C entry launches on
the stream it is given and returns ``cudaGetLastError()``.

Routing (``kernel`` argument of every wrapper, ``DecodeConfig.kernel``):
``"auto"`` launches the kernel for a CUDA tensor and runs the plain
torch version for a CPU tensor; ``"cuda"`` demands the kernel;
``"torch"`` forces the plain version (on either device), which exists so
that a run on the card can compare the two.  There is no fallback: a
CUDA tensor under ``auto`` launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
import time

import torch

KERNEL_CHOICES = ("auto", "cuda", "torch")

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: Largest grid y dimension: the per-element kernels put lanes on x and
#: 256-wide chunks of a row on y.
MAX_GRID_Y = 65535
#: Launches per kernel since the last reset: each wrapper adds one where
#: it launches its kernel, and nowhere else.
LAUNCHES: collections.Counter = collections.Counter()
#: Seconds the last build took (0.0 when the library was already built)
#: and the compiler's register/spill report, for chip_smoke.py.
BUILD_INFO: dict = {}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures: every pointer and the stream as c_void_p, ints as c_int.
_SIGNATURES = {
    "alac_pack_rows": [_P, _I, _P, _P, _I, _I, _P, _P],
    "alac_rice_lpc": [_P, _I, _I] + [_P] * 10 + [_I, _I, _P, _P, _P],
    "alac_bulk_bits": [_P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P],
}


def reset_launches() -> None:
    LAUNCHES.clear()


def use_kernel(t: torch.Tensor, kernel: str) -> bool:
    """True when the wrapper must launch its CUDA kernel for ``t``."""
    if kernel not in KERNEL_CHOICES:
        raise ValueError(f"kernel must be one of {KERNEL_CHOICES}, got {kernel!r}")
    if kernel == "torch":
        return False
    if t.is_cuda:
        return True
    if kernel == "cuda":
        raise ValueError("kernel='cuda' needs CUDA tensors")
    return False


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build() -> pathlib.Path:
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode() + s.read_bytes())
    out = BUILD_DIR / f"libalackernels-{h.hexdigest()[:16]}.so"
    log = out.with_suffix(".log")
    if out.exists():
        BUILD_INFO.update(seconds=0.0, log=log.read_text() if log.exists() else "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    log.write_text(res.stdout + res.stderr)
    tmp.replace(out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, log=res.stdout + res.stderr)
    return out


def get_lib() -> ctypes.CDLL:
    """The kernel library, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call C entry ``name`` on the current stream; raise on a refused
    launch.  Does not synchronise."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(get_lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    LAUNCHES[name.removeprefix("alac_")] += 1


def check_i32(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    """Validate a kernel argument: int32, contiguous, on ``device``."""
    if t.dtype != torch.int32 or t.device != device:
        raise ValueError(f"{name}: expected int32 on {device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
