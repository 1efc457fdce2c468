"""ctypes loader for the native host tier: header parse and word packing.

The C++ source is the JAX package's ``alacnet_tpu/_native/host.cpp``,
compiled here by file path (reading a source file imports nothing, so
the port still never imports JAX) with the same g++ flags, into the
port's own ``_build/`` directory under a name that carries a hash of the
source and flags.  Only ``alac_parse_headers`` and ``alac_pack_frames``
are bound: the decode path needs nothing else.  This is host code, not
the device path.  Without a compiler, or with ``DecodeConfig.native``
off, the NumPy parser runs instead (bit-identical, slower).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_SRC = (
    pathlib.Path(__file__).resolve().parent.parent
    / "alacnet_tpu" / "_native" / "host.cpp"
)
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
#: ABI revision of host.cpp this binding matches.
ABI_VERSION = 5
#: -fwrapv: the codec core relies on wrapping int32 arithmetic.
_BASE_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-fwrapv"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U32P = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: ``-march=native`` binaries are only
    valid on a CPU that has them, so they are part of the build tag."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def _build() -> pathlib.Path | None:
    if not _SRC.exists():
        return None
    tag = hashlib.sha256(
        _SRC.read_bytes() + " ".join(_BASE_FLAGS).encode() + _cpu_flags()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"libalachost-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    # The same flag ladder as the JAX package's loader: the widest ISA
    # and OpenMP where the toolchain has them.
    for flags in (
        ["-march=native", "-fopenmp"], ["-fopenmp"], ["-march=native"], [],
    ):
        cmd = ["g++", *_BASE_FLAGS, *flags, str(_SRC), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=180)
        except (subprocess.SubprocessError, OSError):
            continue
        tmp.replace(out)
        return out
    return None


def get_lib() -> ctypes.CDLL | None:
    """The loaded native library, or None when it cannot be built."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.alac_native_abi_version.restype = ctypes.c_int32
        if lib.alac_native_abi_version() != ABI_VERSION:
            return None
        lib.alac_pack_frames.argtypes = [
            _U8P, ctypes.c_int64, _I64P, _I64P,
            ctypes.c_int64, ctypes.c_int64, _U32P,
        ]
        lib.alac_pack_frames.restype = None
        lib.alac_parse_headers.argtypes = (
            [_U8P, ctypes.c_int64, _I64P, _I64P, ctypes.c_int64]
            + [_I32P] * 5
            + [_U8P, _U8P] + [_I32P] * 15
        )
        lib.alac_parse_headers.restype = ctypes.c_int64
        _lib = lib
        return _lib


def pack_frames_native(
    lib: ctypes.CDLL, blob: np.ndarray, offsets: np.ndarray,
    sizes: np.ndarray, nwords: int,
) -> np.ndarray:
    """Ragged frames -> (B, nwords) big-endian-packed uint32."""
    B = len(offsets)
    words = np.empty((B, nwords), dtype=np.uint32)
    lib.alac_pack_frames(
        np.ascontiguousarray(blob, np.uint8),
        np.int64(blob.size),
        np.ascontiguousarray(offsets, np.int64),
        np.ascontiguousarray(sizes, np.int64),
        np.int64(B),
        np.int64(nwords),
        words,
    )
    return words


def parse_headers_native(
    lib: ctypes.CDLL,
    blob: np.ndarray,
    offsets: np.ndarray,
    sizes: np.ndarray,
    sample_size: np.ndarray,
    kmod: np.ndarray,
    init_history: np.ndarray,
    hist_mult4: np.ndarray,
    max_samples: np.ndarray,
) -> dict:
    """Parse all headers in C++: a dict of arrays + status + first_bad."""
    B = len(offsets)
    i32 = lambda shape: np.zeros(shape, np.int32)  # noqa: E731
    out = dict(
        is_stereo=np.zeros(B, np.uint8),
        is_compressed=np.zeros(B, np.uint8),
        n_samples=i32(B), ub=i32(B), rss=i32(B),
        interlacing_shift=i32(B), interlacing_leftweight=i32(B),
        payload_pos=i32(B), entropy_pos=i32(B),
        order=i32((B, 2)), quant=i32((B, 2)), rice_mult=i32((B, 2)),
        rc=i32((B, 2, 32)),
        kmod=i32(B), init_history=i32(B), kmask=i32(B),
        status=i32(B),
    )
    ret = lib.alac_parse_headers(
        np.ascontiguousarray(blob, np.uint8),
        np.int64(blob.size),
        np.ascontiguousarray(offsets, np.int64),
        np.ascontiguousarray(sizes, np.int64),
        np.int64(B),
        np.ascontiguousarray(sample_size, np.int32),
        np.ascontiguousarray(kmod, np.int32),
        np.ascontiguousarray(init_history, np.int32),
        np.ascontiguousarray(hist_mult4, np.int32),
        np.ascontiguousarray(max_samples, np.int32),
        out["is_stereo"], out["is_compressed"], out["n_samples"],
        out["ub"], out["rss"],
        out["interlacing_shift"], out["interlacing_leftweight"],
        out["payload_pos"], out["entropy_pos"],
        out["order"].reshape(-1), out["quant"].reshape(-1),
        out["rice_mult"].reshape(-1), out["rc"].reshape(-1),
        out["kmod"], out["init_history"], out["kmask"],
        out["status"],
    )
    out["first_bad"] = int(ret) - 1 if ret else -1
    return out
