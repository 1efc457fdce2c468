"""ctypes loader for the native host tier.

The C++ source is the port's own ``_native/host.cpp``, a byte-for-byte
copy of the JAX package's host tier (``tests/test_torch_isolation.py``
holds the two equal), compiled with the same g++ flags into the port's
``_build/`` directory under a name that carries a hash of the source and
flags.  The port reads no file of the JAX package.  This is host code,
not the device path.

Decode binds ``alac_parse_headers`` and ``alac_pack_frames`` (the
wrappers take the library as their first argument); without a compiler,
or with ``DecodeConfig.native`` off, the NumPy parser runs instead
(bit-identical, slower).  The encoder's entries — the host
``AlacEncoder`` core, the Levinson window and autocorrelation, the
frame packers of the batch path and the symbol-plane packer of the
``rice_emit`` route — keep the JAX package's signatures
(``alacnet_tpu/native.py``): each returns None when the library cannot
be built, and its caller then takes its NumPy or Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent
_SRC = _PKG / "_native" / "host.cpp"
BUILD_DIR = _PKG / "_build"
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
_U16P = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_I8P = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64
_i32 = ctypes.c_int32


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
        _bind_encoder(lib)
        _lib = lib
        return _lib


def _bind_encoder(lib: ctypes.CDLL) -> None:
    """Declare the encoder entries' C signatures (host.cpp, ABI 5)."""
    pair_args = [
        _U32P, _U8P, _I64P, _U32P, _U8P, _U32P, _U32P, _U32P, _I8P,
        _I32P, _U8P, _i64, _i64, _i64, _U8P, _i64, _I64P,
    ]
    sigs = {
        "alac_pack_bits": ([_U32P, _U8P, _i64, _U8P, _i64], _i64),
        "alac_rice_encode": (
            [_I32P, _i64, _i32, _i32, _i32, _i32, _i32, _U8P, _i64], _i64,
        ),
        "alac_predictor_errors": (
            [_I32P, _i64, _I32P, _i32, _i32, _i32, _I32P], None,
        ),
        "alac_pack_symbol_frames": (
            [_U32P, _U8P, _I64P, _U16P, _U32P, _I8P,
             _I32P, _U8P, _i64, _i64, _U8P, _i64, _I64P], None,
        ),
        "alac_pack_chunk_frames": (
            [_U32P, _U8P, _I64P, _U32P, _U8P, _U32P, _U32P, _U32P, _I8P,
             _I32P, _U8P, _i64, _i64, _U8P, _i64, _I64P], None,
        ),
        "alac_pack_pair_frames": (pair_args, None),
        "alac_pack_pair_frames8": (pair_args, None),
        "alac_pack_simd_width": ([], _i64),
        "alac_decorr_window": (
            [_I32P, _i64, _i64, _i64, _i32, _i32, _i32, _U8P, _i32, _I32P],
            None,
        ),
        "alac_autocorr": ([_I32P, _i64, _i64, _i32, _F64P], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


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


# -- encoder-side wrappers (the JAX package's signatures) ----------------


def available() -> bool:
    return get_lib() is not None


def pack_bits_native(vals, widths, out, bitpos: int) -> int | None:
    lib = get_lib()
    if lib is None:
        return None
    return int(
        lib.alac_pack_bits(
            np.ascontiguousarray(vals, np.uint32),
            np.ascontiguousarray(widths, np.uint8),
            np.int64(len(vals)),
            out,
            np.int64(bitpos),
        )
    )


def rice_encode_native(
    vals, rss, init_hist, kmod, mult, kmask, out, bitpos: int
) -> int | None:
    lib = get_lib()
    if lib is None:
        return None
    return int(
        lib.alac_rice_encode(
            np.ascontiguousarray(vals, np.int32),
            np.int64(len(vals)),
            np.int32(rss), np.int32(init_hist), np.int32(kmod),
            np.int32(mult), np.int32(kmask),
            out,
            np.int64(bitpos),
        )
    )


def predictor_errors_native(sig, coefs, order, quant, rss):
    """Returns errs (n,) int32 and mutates coefs in place, or None."""
    lib = get_lib()
    if lib is None:
        return None
    sig = np.ascontiguousarray(sig, np.int32)
    errs = np.empty_like(sig)
    lib.alac_predictor_errors(
        sig, np.int64(len(sig)), coefs,
        np.int32(order), np.int32(quant), np.int32(rss), errs,
    )
    return errs


#: Shape-keyed row-buffer recycler for the frame packers (opt-in via
#: reuse=True): a fresh np.empty((F, out_stride)) per chunk would fault
#: its pages in inside the timed pack.  Rows returned from a reuse=True
#: call are invalidated by the NEXT reuse=True call with the same shape
#: on the same thread; the callers (codec/encoder_device._pack_host*)
#: copy payloads out before returning.  Thread-local, so the encode
#: pipeline's pack worker and any caller thread never alias.
_row_cache = threading.local()


def _rows_for(F: int, out_stride: int, reuse: bool):
    if not reuse:
        return np.empty((F, out_stride), np.uint8), np.zeros(F, np.int64)
    cache = getattr(_row_cache, "bufs", None)
    if cache is None:
        cache = _row_cache.bufs = {}
    key = (F, out_stride)
    hit = cache.get(key)
    if hit is None:
        if len(cache) >= 8:  # bound what a pathological shape mix pins
            cache.clear()
        hit = cache[key] = (
            np.empty((F, out_stride), np.uint8), np.zeros(F, np.int64),
        )
    hit[1][:] = 0
    return hit


def pack_symbol_frames_native(
    hv, hw, h_off, v16, v32, wid, n, stereo, out_stride: int
):
    """Assemble coded frames from unmerged symbol planes
    (ops/encode.rice_symbols, or the ``rice_emit`` kernel), or None when
    the native tier is unavailable.  No extra-bits plane: ``ub = 0``.

    Returns (out (F, out_stride) uint8, end_bits (F,) int64).
    """
    lib = get_lib()
    if lib is None:
        return None
    F = len(n)
    # The writer stores every byte below each frame's end position
    # exactly once, so the rows need no pre-zeroing.
    out = np.empty((F, out_stride), np.uint8)
    end_bits = np.zeros(F, np.int64)
    lib.alac_pack_symbol_frames(
        np.ascontiguousarray(hv, np.uint32),
        np.ascontiguousarray(hw, np.uint8),
        np.ascontiguousarray(h_off, np.int64),
        np.ascontiguousarray(v16, np.uint16),
        np.ascontiguousarray(v32, np.uint32),
        np.ascontiguousarray(wid, np.int8),
        np.ascontiguousarray(n, np.int32),
        np.ascontiguousarray(stereo, np.uint8),
        np.int64(F),
        np.int64(v16.shape[1]),
        out,
        np.int64(out_stride),
        end_bits,
    )
    return out, end_bits


def pack_chunk_frames_native(
    hv, hw, h_off, extra, extra_w, c0, c1, c2, ws, n, stereo,
    out_stride: int, reuse: bool = False,
):
    """Assemble coded frames from merged 96-bit chunk planes, or None
    when the native tier is unavailable.

    ``extra``: optional (F, S) uint32 extra-bits plane (interleaved
    channel fields per sample); ``extra_w``: (F,) uint8 per-frame field
    width in bits (0 = frame has no extra section).  Returns
    (out (F, out_stride) uint8, end_bits (F,) int64); with
    ``reuse=True`` the rows come from the thread-local recycler.
    """
    lib = get_lib()
    if lib is None:
        return None
    F = len(n)
    # The writer stores every byte below each frame's end position
    # exactly once, so the rows need no pre-zeroing.
    out, end_bits = _rows_for(F, out_stride, reuse)
    if extra is None:
        extra = np.zeros(1, np.uint32)
        extra_w = np.zeros(F, np.uint8)
    lib.alac_pack_chunk_frames(
        np.ascontiguousarray(hv, np.uint32),
        np.ascontiguousarray(hw, np.uint8),
        np.ascontiguousarray(h_off, np.int64),
        np.ascontiguousarray(extra, np.uint32),
        np.ascontiguousarray(extra_w, np.uint8),
        np.ascontiguousarray(c0, np.uint32),
        np.ascontiguousarray(c1, np.uint32),
        np.ascontiguousarray(c2, np.uint32),
        np.ascontiguousarray(ws, np.int8),
        np.ascontiguousarray(n, np.int32),
        np.ascontiguousarray(stereo, np.uint8),
        np.int64(F),
        np.int64(c0.shape[1]),
        out,
        np.int64(out_stride),
        end_bits,
    )
    return out, end_bits


def pack_pair_frames_native(
    hv, hw, h_off, extra, extra_w, ph, pm, pl, pws, n, stereo,
    num_samples: int, out_stride: int, reuse: bool = False,
):
    """Assemble coded frames from merged PAIR planes
    (ops/encode.merge_pair_chunks: one <=96-bit field per two samples),
    or None when the native tier is unavailable.

    Every pws value must be in [-1, 96] (-1 is a no-op field): a batch
    whose ``fat`` flag is set takes the classic chunk path instead.
    ``num_samples`` is the per-frame sample capacity S (the extra-bits
    plane stays per-sample, (F, S)); the pair planes are
    (2F, ceil(S/2)).  The AVX-512 eight-lane writer runs where the
    library was built with it (``alac_pack_simd_width() == 8``), the
    two-writer scalar one elsewhere; their output is byte-identical.
    Returns (out (F, out_stride) uint8, end_bits (F,) int64).
    """
    lib = get_lib()
    if lib is None:
        return None
    F = len(n)
    out, end_bits = _rows_for(F, out_stride, reuse)
    if extra is None:
        extra = np.zeros(1, np.uint32)
        extra_w = np.zeros(F, np.uint8)
    fn = (
        lib.alac_pack_pair_frames8 if lib.alac_pack_simd_width() == 8
        else lib.alac_pack_pair_frames
    )
    fn(
        np.ascontiguousarray(hv, np.uint32),
        np.ascontiguousarray(hw, np.uint8),
        np.ascontiguousarray(h_off, np.int64),
        np.ascontiguousarray(extra, np.uint32),
        np.ascontiguousarray(extra_w, np.uint8),
        np.ascontiguousarray(ph, np.uint32),
        np.ascontiguousarray(pm, np.uint32),
        np.ascontiguousarray(pl, np.uint32),
        np.ascontiguousarray(pws, np.int8),
        np.ascontiguousarray(n, np.int32),
        np.ascontiguousarray(stereo, np.uint8),
        np.int64(F),
        np.int64(num_samples),
        np.int64(ph.shape[1]),
        out,
        np.int64(out_stride),
        end_bits,
    )
    return out, end_bits


def decorr_window_native(
    pcm_i32: np.ndarray, w: int, ub8: int, lw: int, sh: int,
    stereo_f: np.ndarray, wide: bool,
) -> np.ndarray | None:
    """Fused Levinson-window decorrelation: (F, S, 2) int32 PCM ->
    (2F, w) int32 signal lanes [A of all frames, B of all frames], or
    None when the native tier is unavailable (bit-identical to the
    NumPy fallback in codec/encoder_device._prep)."""
    lib = get_lib()
    if lib is None:
        return None
    pcm_i32 = np.ascontiguousarray(pcm_i32, np.int32)
    F, S, _ = pcm_i32.shape
    sig = np.empty((2 * F, w), np.int32)
    lib.alac_decorr_window(
        pcm_i32, np.int64(F), np.int64(S), np.int64(w),
        np.int32(ub8), np.int32(lw), np.int32(sh),
        np.ascontiguousarray(stereo_f, np.uint8), np.int32(bool(wide)),
        sig,
    )
    return sig


def autocorr_native(x, order: int):
    """(order+1, B) float64 lag autocorrelation of (B, S) int32 lanes,
    or None when the native tier is unavailable.  Its summation order
    differs from the einsum fallback's (codec/encoder.
    levinson_coefs_batch); the host and the batch encoder both choose
    coefficients through that one function, so their bytes agree."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.int32)
    B, S = x.shape
    r = np.empty((order + 1, B), np.float64)
    lib.alac_autocorr(x, np.int64(B), np.int64(S), np.int32(order), r)
    return r
