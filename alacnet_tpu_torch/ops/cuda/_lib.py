"""Build, load and route the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file compiles to an object in its own ``nvcc``
process, all started together, and one more ``nvcc`` call links them
into one shared library with a plain C interface under
``alacnet_tpu_torch/_build/``, named by a hash of the sources, the
headers they include (``csrc/*.cuh``) and the flags,
at first use (so a fresh checkout builds it on its first launch).  It is
loaded with ctypes: no PyTorch headers, so the build takes seconds.
Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` gives it the current stream of
the device the tensors live on, whatever the calling thread's current
device is.

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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: Largest grid y dimension: the per-element kernels put lanes on x and
#: fixed-width chunks of a row on y.
MAX_GRID_Y = 65535
#: Launches per kernel since the last reset: each wrapper adds one where
#: it launches its kernel, and nowhere else (under a lock: a decode
#: session's readahead thread launches too).
LAUNCHES: collections.Counter = collections.Counter()
_count_lock = threading.Lock()
#: Seconds the last build took (0.0 when the library was already built)
#: and the compiler's register/spill report, for chip_smoke.py.
BUILD_INFO: dict = {}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: C signatures: every pointer and the stream as c_void_p, ints as c_int,
#: element strides and word counts as c_longlong.
_SIGNATURES = {
    "alac_pack_rows": [_P, _I, _P, _P, _I, _I, _I, _P, _P],
    "alac_rice_lpc": [_P, _I, _I] + [_P] * 10 + [_I, _I, _I, _P, _P, _P],
    "alac_bulk_bits": [_P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P],
    "alac_enc_pred": [_P, _I, _I] + [_P] * 5 + [_I, _I, _P, _P],
    "alac_enc_rice": [_P, _P, _I, _I] + [_P] * 6 + [_P] * 6 + [_P],
    "alac_rice_emit": [_P, _P, _I, _I] + [_P] * 6 + [_P] * 4 + [_P],
    "alac_dec_epilogue": [_P, _P, _I, _I] + [_P] * 4 + [_P] * 7 + [_I] * 4 + [_P, _P, _P],
    "alac_zero_runs": [_P, _P, _I, _I, _I, _P, _P],
    "alac_pair_merge": [_P] * 4 + [_L] * 4 + [_I] * 3 + [_P] * 9 + [_P],
    "alac_blob_words": [_P, _L, _I, _L, _P, _P],
    "alac_enc_prologue": [_P, _P] + [_I] * 6 + [_P, _P],
    "alac_elem_head": [_P, _I, _I] + [_P] * 5 + [_I] * 6 + [_P] * 4,
}


def reset_launches() -> None:
    with _count_lock:
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
    for s in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
        h.update(s.name.encode() + s.read_bytes())
    out = BUILD_DIR / f"libalackernels-{h.hexdigest()[:16]}.so"
    log = out.with_suffix(".log")
    if out.exists():
        BUILD_INFO.update(seconds=0.0, log=log.read_text() if log.exists() else "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = out.with_suffix(f".{tag}.so")
    objs = [out.with_suffix(f".{s.stem}.{tag}.o") for s in sources]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # One compiler process per source, all at once; then one link.
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for s, o in zip(sources, objs)
    ]
    logs, failed = [], []
    try:
        for s, p in zip(sources, procs):
            text = p.communicate(timeout=900)[0]
            logs.append(f"== {s.name}\n{text}")
            if p.returncode != 0:
                failed.append(s.name)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    try:
        if not failed:
            res = subprocess.run(
                [nvcc, *NVCC_FLAGS[:4], "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True, timeout=300,
            )
            logs.append(f"== link\n{res.stdout}{res.stderr}")
            if res.returncode != 0:
                failed.append("link")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    text = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{text}")
    log.write_text(text)
    tmp.replace(out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, log=text)
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


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry ``name`` on ``device`` (the device of its tensors),
    on that device's current stream; raise on a refused launch.  Does
    not synchronise."""
    # A call moves a few microseconds of work for the smallest kernels,
    # so the host path stays short: the raw stream handle without a
    # Stream object (the accessor PyTorch's own compiled kernels use),
    # and a device switch only where the thread's current device is
    # another.
    fn = getattr(_lib if _lib is not None else get_lib(), name)
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    with _count_lock:
        LAUNCHES[name.removeprefix("alac_")] += 1


def check_i32(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    """Validate a kernel argument: int32, contiguous, on ``device``."""
    # One expression for the common case: the wrappers of the smallest
    # kernels make several checks a call (microseconds each otherwise).
    if (t.dtype == torch.int32 and t.device == device and t.shape == shape
            and t.is_contiguous()):
        return
    if t.dtype != torch.int32 or t.device != device:
        raise ValueError(f"{name}: expected int32 on {device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
