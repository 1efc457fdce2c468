"""Batch ALAC encoding with the sequential stages on a torch device.

The counterpart of ``alacnet_tpu/codec/encoder_tpu.py``.  Encoding
splits the way decoding does:

  host   — batch prep: batched Levinson coefficients over a window-
           sized decorrelation (codec/encoder.levinson_coefs_batch), the
           extra-bits side-channel plane, the header and coefficient bit
           fields;
  device — extra-bits strip, stereo decorrelation and channel fold
           (elementwise torch, ops/encode.encode_stages_pcm), then the
           two per-sample automatons, frame-per-lane with stereo
           channels folded into extra lanes (the ``enc_pred`` and
           ``enc_rice`` CUDA kernels on a card, their plain torch
           versions on the CPU), the pair merge and, with ``quads``, the
           quad merge (the ``pair_merge`` kernel on a card, lane-major
           planes; ops/encode.merge_pair_chunks and merge_quad_chunks on
           the CPU);
  host   — whole-batch packing (the native two-frame pair packer; the
           classic chunk packer or a Python BitWriter otherwise), or,
           with ``pack="scatter"``/``"gather"``, the frame bodies packed
           on the device (ops/encode.pack_frames_device*) and only the
           header fields ORed in on the host.

Large batches run as a bounded pipeline: the host preps and dispatches
chunk k+1 while the device runs chunk k and a worker thread packs chunk
k-1, with at most two chunks queued for the worker.  On a card the PCM
goes up through pinned memory with ``non_blocking=True``, and the
planes the route packs first come back into pinned buffers behind a
CUDA event per chunk; the worker waits on that event before it reads
them.  Device work the worker itself queues (the quad or pair planes
after the flags, the fat frames' rows, the device pack) runs on a side
stream that waits for the chunk's stages (``_Planes.side``).

Output payloads are byte-identical to ``codec/encoder.AlacEncoder`` given
the same configuration, and to the JAX package's ``encode_frames_tpu``
(tests/test_torch_encoder.py).

Routes (:func:`resolve_routes`): an argument left at None reads the JAX
package's variable, else takes the default — ``ALAC_ENC_KERNEL``
(auto, fused, xla), ``ALAC_ENC_PAIR`` (auto, 0, 1),
``ALAC_ENC_DEVICE_PACK=1`` with ``ALAC_ENC_PACK_IMPL`` (scatter,
gather), ``ALAC_ENC_QUAD`` (auto, 0, 1; only 1 turns quads on).  With
none set: the kernels under ``auto``, the native pair packer on the
host, no quads.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time

import numpy as np
import torch

from .. import native
from ..config import KERNEL_ALIASES, env_choice
from ..ops.lpc import MAX_ORDER, LpcParams, reverse_coefs
from ..utils.transfer import d2h_async, h2d
from .cookie import CodecParams
from .encoder import AlacEncoder, EncoderConfig, levinson_coefs_batch

#: Frames per device batch in the pipelined path (2*chunk lanes on the
#: device; 4096-sample frames at 2048 lanes stage ~300 MB of planes).
CHUNK_FRAMES = 1024
#: Who packs the payload bytes (``encode_frames_device(pack=)``).
PACK_CHOICES = ("host", "scatter", "gather")


def resolve_pairs(pairs: bool | None = None) -> bool:
    """Whether the host packs pair planes: ``pairs``, else
    ``ALAC_ENC_PAIR`` (``0`` off, ``1`` on, ``auto``, the default, on
    where the native tier is available).  On needs the native tier: the
    pair packer has no Python version, so without it an explicit
    ``True`` or ``ALAC_ENC_PAIR=1`` raises."""
    if pairs is None:
        mode = env_choice("ALAC_ENC_PAIR", "auto", ("auto", "0", "1"))
        if mode == "0":
            return False
        pairs = True if mode == "1" else native.available()
    if pairs and not native.available():
        raise RuntimeError("the pair packer needs the native host tier "
                           "(it has no Python version)")
    return pairs


def resolve_routes(kernel: str | None = None, pack: str | None = None,
                   quads: bool | None = None, pairs: bool | None = None) -> dict:
    """The encode route of the arguments, each left at None read from
    its variable (the module docstring), else the default.  Returns
    ``{"kernel", "pack", "quads", "pairs"}``; ``pairs`` is on only where
    ``pack`` is "host", as in the JAX package, whose device pack turns
    the pair planes off."""
    if kernel is None:
        kernel = env_choice("ALAC_ENC_KERNEL", "auto", ("auto", "fused", "xla"),
                            KERNEL_ALIASES)
    if pack is None:
        pack = "host"
        if os.environ.get("ALAC_ENC_DEVICE_PACK", "0") == "1":
            pack = env_choice("ALAC_ENC_PACK_IMPL", "scatter", ("scatter", "gather"))
    if pack not in PACK_CHOICES:
        raise ValueError(f"pack={pack!r}: expected one of {PACK_CHOICES}")
    if quads is None:
        quads = env_choice("ALAC_ENC_QUAD", "0", ("auto", "0", "1")) == "1"
    pairs = resolve_pairs(pairs) and pack == "host"
    return {"kernel": kernel, "pack": pack, "quads": bool(quads), "pairs": pairs}


def check_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device without a usable card
    raises instead of moving to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"encoding on device={str(device)!r} needs a CUDA device, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain torch versions, or device=None for the host encoder"
        )
    return dev


def _header_bits(enc: AlacEncoder, n: int, nch: int, ub: int,
                 coefs_per_ch: list[list[int]]) -> tuple[list[int], list[int]]:
    """All bit fields preceding the extra-bits/entropy sections."""
    vals, widths = enc._header_fields(n, nch, ub, 0)
    if nch == 2:
        vals += [enc.config.interlacing_shift, enc.config.interlacing_leftweight]
        widths += [8, 8]
    else:
        vals += [0]  # mono filler bits (AlacFile.cs:457-459)
        widths += [16]
    for coefs in coefs_per_ch:
        pv, pw = enc._prediction_fields(coefs, enc.config.order)
        vals += pv
        widths += pw
    return vals, widths


def _normalize_frames(frames, S: int):
    """-> (padded (F, S, 2) int, ns_f (F,), stereo_f (F,) bool).

    ``frames`` may be a single (F, S, ch) array (a reshaped view of
    contiguous PCM) or a list of per-frame (n, ch) arrays with mixed
    lengths/channel counts.
    """
    if isinstance(frames, np.ndarray):
        if frames.ndim != 3:
            raise ValueError("array input must be (F, S, channels)")
        F, n, nch = frames.shape
        if n > S:
            raise ValueError(f"frames of {n} samples exceed {S}")
        if nch not in (1, 2):
            raise ValueError(f"1 or 2 channels, got {nch}")
        ns_f = np.full(F, n, np.int32)
        stereo_f = np.full(F, nch == 2)
        if n == S and nch == 2:
            return frames, ns_f, stereo_f
        padded = np.zeros((F, S, 2), frames.dtype)
        padded[:, :n, :nch] = frames
        return padded, ns_f, stereo_f
    F = len(frames)
    ns_f = np.zeros(F, np.int32)
    stereo_f = np.zeros(F, bool)
    shapes = {np.asarray(f).shape for f in frames}
    if len(shapes) == 1:
        a = np.asarray(frames)
        if a.ndim == 2:
            a = a[:, :, None]
        return _normalize_frames(a, S)
    padded = np.zeros((F, S, 2), np.int64)
    for f, pcm in enumerate(frames):
        pcm = np.asarray(pcm)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        n, nch = pcm.shape
        if nch not in (1, 2):
            raise ValueError(f"1 or 2 channels, got {nch}")
        if n > S:
            raise ValueError(f"frame of {n} samples exceeds {S}")
        ns_f[f] = n
        stereo_f[f] = nch == 2
        padded[f, :n, :nch] = pcm
    return padded, ns_f, stereo_f


def _prep(frames, params: CodecParams, cfg: EncoderConfig, enc: AlacEncoder):
    """Host prep: windowed decorrelation, batched Levinson, header
    fields, the extra-bits plane.

    Returns a dict with everything the dispatch and pack stages need.
    """
    S = params.max_samples_per_frame
    ub = cfg.uncompressed_bytes
    order = cfg.order
    padded, ns_f, stereo_f = _normalize_frames(frames, S)
    F = len(ns_f)
    B = 2 * F  # channel-folded lanes: [A of all frames, B of all frames]

    # The full-frame extra-bits strip / stereo decorrelation / channel
    # fold run on the device (ops/encode.encode_stages_pcm).  The host
    # keeps only (a) the extra-bits side-channel plane (packed on the
    # host) and (b) a Levinson-window-sized decorrelation for the
    # coefficient choice.
    ub8 = 8 * ub
    pcm_i32 = np.ascontiguousarray(padded, np.int32)  # <=24-bit always fits
    extra_pl = (pcm_i32 & ((1 << ub8) - 1)).astype(np.uint32) if ub else None
    sh, lw = cfg.interlacing_shift, cfg.interlacing_leftweight
    # Product domain: |cb| * leftweight can pass 2^31 only when the
    # post-strip width exceeds 16 bits (24-bit no-extra-bits content).
    wide = params.sample_size - ub8 > 16
    ns = np.concatenate([ns_f, np.where(stereo_f, ns_f, 0)]).astype(np.int32)
    rss_l = np.concatenate(
        [params.sample_size - 8 * ub + stereo_f.astype(np.int32)] * 2
    ).astype(np.int32)

    # ---- batched coefficient choice (identical to _choose_coefs by
    # construction: both go through levinson_coefs_batch) ----
    if order in (0, 0x1F) or not cfg.adaptive_coefs:
        seed = enc._seed_coefs(order)
        ncoef = len(seed)
        coef_mat = np.tile(np.asarray(seed, np.int32), (B, 1))
    else:
        ncoef = order
        w = min(cfg.levinson_window or S, S)
        # Levinson reads just the first w samples of each lane, and the
        # decorrelation is per sample, so the windowed fold equals the
        # full fold's prefix.
        sig_w = native.decorr_window_native(
            pcm_i32, w, ub8, lw, sh, stereo_f, wide
        )
        if sig_w is None:
            work_dtype = np.int64 if wide else np.int32
            hiw = pcm_i32[:, :w].astype(work_dtype)
            if ub8:
                hiw >>= ub8
            if lw != 0:
                cbw = hiw[:, :, 0] - hiw[:, :, 1]
                caw = hiw[:, :, 1] + ((cbw * lw) >> sh)
            else:
                caw, cbw = hiw[:, :, 0], hiw[:, :, 1]
            stw = stereo_f[:, None]
            sig_w = np.empty((B, w), np.int32)
            np.copyto(sig_w[:F], np.where(stw, caw, hiw[:, :, 0]))
            np.copyto(sig_w[F:], np.where(stw, cbw, 0))
        coef_mat = levinson_coefs_batch(
            sig_w, np.minimum(ns, w), order, cfg.quant
        )
    coef_mat = np.where(ns[:, None] > 0, coef_mat, 0)

    # ---- header/coef bit fields ----
    uniform = (
        ns_f.size > 0
        and (ns_f == ns_f[0]).all()
        and (stereo_f == stereo_f[0]).all()
    )
    # Emitted coef-field count per channel (order 31 emits all 31; order
    # 0 emits none — _prediction_fields, AlacFile.cs:577-596 mirrored).
    emitted = 31 if order == 0x1F else order
    if uniform:
        nch = 2 if stereo_f[0] else 1
        coefs0 = [[0] * ncoef] * nch
        tv, tw = _header_bits(enc, int(ns_f[0]), nch, ub, coefs0)
        H = len(tv)
        hw_row = np.asarray(tw, np.uint8)
        hv_mat = np.tile(np.asarray(tv, np.uint32), (F, 1))
        # coef fields sit at the tail of each channel's prediction block
        if emitted:
            a_end = H - (4 + emitted) * (nch - 1)
            hv_mat[:, a_end - emitted : a_end] = (
                coef_mat[:F, :emitted] & 0xFFFF
            )
            if nch == 2:
                hv_mat[:, H - emitted : H] = coef_mat[F:, :emitted] & 0xFFFF
        hv_all = hv_mat.reshape(-1)
        hw_all = np.tile(hw_row, F)
        h_off = np.arange(F + 1, dtype=np.int64) * H
        hbits = np.full(F, int(hw_row.astype(np.int64).sum()), np.int64)
    else:
        hv_parts, hw_parts = [], []
        h_off = np.zeros(F + 1, np.int64)
        hbits = np.zeros(F, np.int64)
        for f in range(F):
            nch = 2 if stereo_f[f] else 1
            coefs_per_ch = [coef_mat[f, :ncoef].tolist()]
            if nch == 2:
                coefs_per_ch.append(coef_mat[F + f, :ncoef].tolist())
            hv, hw = _header_bits(enc, int(ns_f[f]), nch, ub, coefs_per_ch)
            hv_parts.append(np.asarray(hv, np.uint32))
            hw_parts.append(np.asarray(hw, np.uint8))
            h_off[f + 1] = h_off[f] + len(hv)
            hbits[f] = sum(hw)
        hv_all = np.concatenate(hv_parts) if F else np.zeros(0, np.uint32)
        hw_all = np.concatenate(hw_parts) if F else np.zeros(0, np.uint8)

    # ---- extra-bits side-channel plane (A:B interleaved per sample) ----
    if ub:
        ea = extra_pl[:, :, 0]
        eb = extra_pl[:, :, 1]
        extra_plane = np.where(stereo_f[:, None], (ea << ub8) | eb, ea)
        extra_w = np.where(stereo_f, 2 * ub8, ub8).astype(np.uint8)
        extra_bits = extra_w.astype(np.int64) * ns_f
    else:
        extra_plane = None
        extra_w = None
        extra_bits = 0

    return {
        "F": F, "S": S, "B": B, "order": order, "ncoef": ncoef,
        "pcm": pcm_i32, "lw": lw, "sh": sh, "ub8": ub8, "wide": wide,
        "ns": ns, "ns_f": ns_f, "stereo_f": stereo_f,
        "rss_l": rss_l, "coef_mat": coef_mat,
        "hv": hv_all, "hw": hw_all, "h_off": h_off,
        "hbits": hbits + extra_bits,
        "extra_plane": extra_plane, "extra_w": extra_w,
    }


class _Planes:
    """A dispatch's planes, still on the device, and their copies back.

    ``planes[i]`` is a device tensor, or under a mesh a ``Sharded`` of
    (2, f, ...) shards.  The planes in ``eager`` start back to the host
    at dispatch, on the dispatch's stream, right behind the stages; any
    other plane crosses only when :meth:`get` first asks for it, so a
    route copies back only the plane set it packs.  :meth:`get` gives
    planes in the packers' flat (2F, ...) lane layout (int32 bit
    patterns as uint32), each copied at most once; calling the object
    gives every plane.  ``d2h_bytes`` counts every byte copied back.
    """

    def __init__(self, planes, device: torch.device | None, eager):
        self.planes = tuple(planes)
        self.device = device  # None under a mesh
        self.d2h_bytes = 0
        self._waits: dict = {}
        self._host: dict = {}
        self._stream = None
        self._ready = None
        if device is not None and device.type == "cuda":
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(device))
        self._queue(eager)

    @contextlib.contextmanager
    def side(self):
        """Run the block on the dispatch's device, on a side stream that
        first waits for the dispatch's stages (a no-op on the CPU and
        under a mesh, whose shards keep their own streams): the pack
        worker's device work overlaps the next chunk's stages."""
        if self._ready is None:
            yield self.device
            return
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
                self._stream.wait_event(self._ready)
                for p in self.planes:  # freed only after the side stream's reads
                    p.record_stream(self._stream)
            with torch.cuda.stream(self._stream):
                yield self.device

    def _queue(self, idx) -> None:
        idx = [i for i in idx if i not in self._waits]
        if not idx:
            return
        if self.device is None:
            for i in idx:
                self._waits[i] = self.planes[i].fetch()
            return
        wait = d2h_async(*(self.planes[i] for i in idx))
        for k, i in enumerate(idx):
            self._waits[i] = lambda wait=wait, k=k: wait()[k]

    def get(self, *idx) -> list:
        """Planes ``idx`` as host arrays, copying back the ones not yet
        queued (on the side stream)."""
        if any(i not in self._waits for i in idx):
            with self.side():
                self._queue(idx)
        for i in idx:
            if i not in self._host:
                self._host[i] = self._lane_major(self._waits.pop(i)())
                self.d2h_bytes += self._host[i].nbytes
        return [self._host[i] for i in idx]

    def __call__(self) -> list:
        return self.get(*range(len(self.planes)))

    def _lane_major(self, a: np.ndarray) -> np.ndarray:
        if self.device is None:  # (2, F, ...) channel-major -> (2F, ...)
            a = a.reshape(-1, *a.shape[2:])
        a = np.ascontiguousarray(a)
        return a.view(np.uint32) if a.dtype == np.int32 else a

    def copy_back(self, *tensors) -> list:
        """Tensors made on the side stream (one device), as host arrays."""
        with self.side():
            out = list(d2h_async(*tensors)())
        self.d2h_bytes += sum(a.nbytes for a in out)
        return out

    def rows(self, which, frames: np.ndarray) -> list:
        """Planes ``which`` at the lanes of ``frames`` (every frame's
        channel-A row, then every frame's channel-B row), gathered on the
        device (one ``index_select`` per plane, or per shard under a
        mesh) before they cross."""
        if self.device is None:
            out = [self._lane_major(self.planes[i].select(frames).numpy())
                   for i in which]
            self.d2h_bytes += sum(a.nbytes for a in out)
            return out
        F = self.planes[0].shape[0] // 2
        lanes = np.concatenate([frames, F + frames])
        with self.side() as dev:
            sel = torch.from_numpy(lanes).to(dev)
            gathered = [self.planes[i].index_select(0, sel) for i in which]
        return [self._lane_major(a) for a in self.copy_back(*gathered)]


def _dispatch(prep, params: CodecParams, cfg: EncoderConfig, device: torch.device,
              kernel: str = "auto", pairs: bool | None = None, mesh=None,
              pack: str = "host", quads: bool = False) -> _Planes:
    """Upload the prepped batch, queue the device stages and the D2H of
    the planes the route packs first, and return them as a
    :class:`_Planes`.

    ``pairs`` (default: :func:`resolve_pairs`, where ``pack`` is
    "host") selects the pair-merged planes; a batch with a non-fitting
    pair re-dispatches the classic per-sample planes through
    ``prep["_classic_dispatch"]`` (see
    :func:`_pack_host_pairs`).  ``quads`` adds the quad planes on the
    pair path, for batches without an extra-bits plane (the packer
    counts that plane per SAMPLE): only the flags cross at dispatch.
    ``pack`` "scatter" or "gather" packs the classic planes on the
    device (:func:`_pack_device`) where the batch has no extra-bits
    plane and there is no mesh, as the JAX package does; other batches
    take the host packer.  ``mesh`` (``parallel/mesh.Mesh``; ``device``
    is then unused): the frames split over its shards
    (``mesh.encode_stages_pcm_spmd``), and the host joins the shards'
    (2, f, ...) planes along the frames.
    """
    from ..ops.encode import RiceEncParams, encode_stages_pcm

    if pairs is None:
        pairs = resolve_pairs() and pack == "host"
    prep["pairs"] = pairs
    quads = prep["quads"] = bool(quads and pairs and prep["extra_plane"] is None)
    prep["device_pack"] = (
        pack if pack != "host" and not pairs and prep["extra_plane"] is None
        and mesh is None else None
    )
    if pairs:
        prep["_classic_dispatch"] = lambda: _dispatch(
            prep, params, cfg, device, kernel, pairs=False, mesh=mesh
        )

    B, S, order = prep["B"], prep["S"], prep["order"]
    coef_tab = np.zeros((B, MAX_ORDER), np.int32)
    coef_tab[:, : prep["ncoef"]] = prep["coef_mat"][:, :MAX_ORDER]
    rc = reverse_coefs(coef_tab, np.full(B, order, np.int32))

    def lanes(value) -> np.ndarray:
        return np.full(B, value, np.int32)

    # One upload for every per-lane parameter and the lane counts.
    cols = np.stack([
        lanes(order), lanes(cfg.quant), prep["rss_l"],
        lanes(params.rice_kmodifier), lanes(params.rice_initial_history),
        lanes(params.rice_history_mult_for(cfg.rice_modifier)),
        lanes(params.rice_kmodifier_mask), prep["ns"],
    ]).astype(np.int32)
    max_order = 0 if order in (0, 31) else order
    stage_args = dict(max_order=max_order, lw=prep["lw"], sh=prep["sh"],
                      ub8=prep["ub8"], wide=prep["wide"], kernel=kernel, pairs=pairs,
                      quads=quads)
    # What crosses at dispatch: the quad route's flags (bits, bad, fat,
    # qfat), the device pack's (bits, bad), every plane otherwise.
    eager = (4, 5, 6, 11) if quads else (4, 5) if prep["device_pack"] else range(7 if pairs else 6)
    if mesh is not None:
        from ..parallel.mesh import encode_stages_pcm_spmd

        order_h, quant_h, rss_h, kmod_h, ihist_h, mult_h, kmask_h, ns_h = cols
        planes = encode_stages_pcm_spmd(
            prep["pcm"], prep["stereo_f"], ns_h,
            LpcParams(order=order_h, quant=quant_h, rc=rc, rss=rss_h),
            RiceEncParams(rss=rss_h, kmod=kmod_h, init_history=ihist_h,
                          mult=mult_h, kmask=kmask_h),
            mesh, S, **stage_args,
        )
        return _Planes(planes, None, eager)
    cols_d = h2d(cols, device)
    order_d, quant_d, rss_d, kmod_d, ihist_d, mult_d, kmask_d, ns_d = cols_d
    lp = LpcParams(order=order_d, quant=quant_d, rc=h2d(rc, device), rss=rss_d)
    rp = RiceEncParams(
        rss=rss_d, kmod=kmod_d, init_history=ihist_d, mult=mult_d, kmask=kmask_d
    )
    planes = encode_stages_pcm(
        h2d(prep["pcm"], device),
        h2d(prep["stereo_f"].astype(np.uint8), device).to(torch.bool),
        ns_d, lp, rp, S, **stage_args,
    )
    return _Planes(planes, device, eager)


def _pack(prep, fetch, timings: dict | None):
    """Assemble payload bytes from a dispatch's planes."""
    if prep.get("pairs"):
        return _pack_host_pairs(prep, fetch, timings)
    if prep.get("device_pack"):
        return _pack_device(prep, fetch, timings)
    return _pack_host(prep, fetch, timings)


def _fetch_lane_major(fetch):
    """Wait for a dispatch's planes and return them as host arrays in the
    packers' flat (2F, ...) lane layout: int32 bit patterns as uint32,
    every plane contiguous."""
    out = []
    for a in fetch():
        a = np.ascontiguousarray(a)
        out.append(a.view(np.uint32) if a.dtype == np.int32 else a)
    return out


def _add_timings(timings, t0, t1, nbytes, fetch=None, **counts):
    """Add a chunk's waits, pack time, plane bytes, the bytes its
    :class:`_Planes` copied back (``d2h_bytes``) and ``counts``."""
    if timings is not None:
        timings["emit_wait_s"] = timings.get("emit_wait_s", 0.0) + t1 - t0
        timings["plane_bytes"] = timings.get("plane_bytes", 0) + nbytes
        timings["pack_s"] = timings.get("pack_s", 0.0) + time.perf_counter() - t1
        counts["d2h_bytes"] = getattr(fetch, "d2h_bytes", 0)
        for k, v in counts.items():
            timings[k] = timings.get(k, 0) + v


def _pack_host_pairs(prep, fetch, timings: dict | None):
    """Read back the pair planes (merge_pair_chunks layout) and assemble
    payload bytes with the native two-frame pair packer.

    A set ``fat`` flag (some pair's combined width exceeds 96 bits —
    unreachable for real content, but the packer's 3-word field cannot
    represent it) re-dispatches the batch on the classic per-sample
    chunk planes and packs those instead: correctness never depends on
    the pair layout fitting.

    Under ``prep["quads"]`` only the flags have crossed so far.  When at
    most half the frames are quad-fat (a quad past 96 bits: adjacent
    escape symbols), the quad planes cross and the SAME native packer
    packs them, handed ceil(n/2) as each frame's count (one field per
    FOUR samples); the quad-fat frames are then repacked from their
    pair-plane rows (:func:`_repack_fat_frames`).  Otherwise the pair
    planes cross and pack as without quads.
    """
    t0 = time.perf_counter()
    quads = prep.get("quads")
    if quads:
        bits, bad, fat, qfat = fetch.get(4, 5, 6, 11)
    else:
        ph, pm, pl, pws, bits, bad, fat = _fetch_lane_major(fetch)
    if bool(fat.any()):
        prep["pairs"] = False
        return _pack_host(prep, prep["_classic_dispatch"](), timings)
    if bool(bad.any()):
        raise RuntimeError("encoder state desync: raw < 0")
    F = prep["F"]
    frame_fat = np.zeros(F, bool)
    use_quads = False
    if quads:
        frame_fat = qfat[:F] | qfat[F:]
        # Quads pay only when most frames ride them; a majority-fat
        # batch (24-bit-like content) packs pairs wholesale.
        use_quads = int(frame_fat.sum()) <= F // 2
        ph, pm, pl, pws = fetch.get(*((7, 8, 9, 10) if use_quads else (0, 1, 2, 3)))
    t1 = time.perf_counter()
    bits = bits.view(np.int32).astype(np.int64)
    total_bits = prep["hbits"] + bits[:F] + bits[F:]
    out_stride = int(total_bits.max()) // 8 + 8 if F else 8
    # The pair packer's only use of a frame's count is fields =
    # ceil(count / 2), so ceil(n / 2) packs ceil(n / 4) quad fields.  A
    # quad-fat frame's row holds -1 widths, which the packer skips: its
    # bytes are wrong and are replaced by the repack below.
    ns_eff = (prep["ns_f"] + 1) // 2 if use_quads else prep["ns_f"]
    packed = native.pack_pair_frames_native(
        prep["hv"], prep["hw"], prep["h_off"],
        prep["extra_plane"], prep["extra_w"],
        ph, pm, pl, pws, ns_eff, prep["stereo_f"].astype(np.uint8),
        prep["S"], out_stride,
        # Recycled rows: the payload slices below copy out of them
        # before this function returns.
        reuse=True,
    )
    if packed is None:
        raise RuntimeError("the native pair packer is unavailable")
    out, end_bits = packed
    idx = np.flatnonzero(frame_fat) if use_quads else np.zeros(0, np.int64)
    if idx.size:
        out[idx], end_bits[idx] = _repack_fat_frames(prep, idx, fetch, out_stride)
    payloads = [out[f, : -(-int(end_bits[f]) // 8)].tobytes() for f in range(F)]
    _add_timings(timings, t0, t1, ph.nbytes + pm.nbytes + pl.nbytes + pws.nbytes,
                 fetch, quad_chunks=int(use_quads), repacked_frames=int(idx.size))
    return payloads


def _repack_fat_frames(prep, idx: np.ndarray, fetch: _Planes, out_stride: int):
    """Repack the quad-fat frames ``idx`` from their PAIR-plane rows.

    Only those frames' lanes (channel A and B rows) are gathered on the
    device and cross, so for the typical few fat frames the extra D2H
    stays small.  The repack is also what keeps the native packer's
    -1-width lanes harmless: their rows are overwritten here.  Returns
    (out (K, out_stride) uint8, end_bits (K,) int64).
    """
    ph, pm, pl, pws = fetch.rows((0, 1, 2, 3), idx)
    h_off = prep["h_off"]
    hv_parts = [prep["hv"][h_off[f] : h_off[f + 1]] for f in idx]
    hw_parts = [prep["hw"][h_off[f] : h_off[f + 1]] for f in idx]
    h_off2 = np.zeros(idx.size + 1, np.int64)
    np.cumsum([len(p) for p in hv_parts], out=h_off2[1:])
    packed = native.pack_pair_frames_native(
        np.concatenate(hv_parts), np.concatenate(hw_parts), h_off2, None, None,
        ph, pm, pl, pws, prep["ns_f"][idx], prep["stereo_f"][idx].astype(np.uint8),
        prep["S"], out_stride,
    )
    if packed is None:
        raise RuntimeError("the native pair packer is unavailable")
    return packed


#: Device-packed rows are bucketed to multiples of this many 32-bit
#: words, as the JAX package buckets them: the row shapes, and so the
#: allocator's blocks, repeat across chunks.
_PACK_STRIDE_STEP = 256


def _pack_stride(prep, bits: np.ndarray) -> int:
    """Words a device-packed row needs for the chunk's longest frame
    (``bits``: the lanes' entropy bit totals, as copied back), rounded
    up to ``_PACK_STRIDE_STEP``."""
    F = prep["F"]
    bits = bits.view(np.int32).astype(np.int64)
    need = int((prep["hbits"] + bits[:F] + bits[F:]).max()) // 32 + 2 if F else 2
    return -(-need // _PACK_STRIDE_STEP) * _PACK_STRIDE_STEP


def _or_header(row, hv_f, hw_f) -> None:
    """OR a frame's ragged header fields into its row's zeroed prefix
    (the device-packed body starts at bit hbits, so header and body bit
    ranges are disjoint; native ``alac_pack_bits`` and the BitWriter
    fallback both OR rather than overwrite)."""
    if native.pack_bits_native(hv_f, hw_f, row, 0) is None:
        from .bitwriter import BitWriter

        w = BitWriter()
        for v, wd in zip(hv_f.tolist(), hw_f.tolist()):
            w.write(int(v), int(wd))
        hb = np.frombuffer(w.getvalue(), np.uint8)
        row[: hb.size] |= hb


def _pack_device(prep, fetch: _Planes, timings: dict | None):
    """Device-pack variant of :func:`_pack_host`: the classic planes stay
    on the device, ``ops/encode.pack_frames_device_scatter`` (``pack=
    "scatter"``) or ``pack_frames_device`` ("gather") assembles the
    frame bodies on the pack worker's side stream, only the rows and
    their end bits cross, and the host ORs the ragged header fields into
    each row's zeroed prefix and slices the payloads."""
    from ..ops.encode import pack_frames_device, pack_frames_device_scatter

    t0 = time.perf_counter()
    bits, bad = fetch.get(4, 5)
    if bool(bad.any()):
        raise RuntimeError("encoder state desync: raw < 0")
    stride_words = _pack_stride(prep, bits)
    packer = (pack_frames_device_scatter if prep["device_pack"] == "scatter"
              else pack_frames_device)
    with fetch.side() as dev:
        ns, st, hb = h2d(
            np.stack([prep["ns_f"], prep["stereo_f"], prep["hbits"]]).astype(np.int32),
            dev,
        )
        rows_d, end_d = packer(*fetch.planes[:4], ns, st != 0, hb,
                               stride_words=stride_words)
    rows, end_bits = fetch.copy_back(rows_d, end_d)
    t1 = time.perf_counter()
    hv, hw, h_off = prep["hv"], prep["hw"], prep["h_off"]
    payloads = []
    for f in range(prep["F"]):
        _or_header(rows[f], hv[h_off[f] : h_off[f + 1]], hw[h_off[f] : h_off[f + 1]])
        payloads.append(rows[f, : -(-int(end_bits[f]) // 8)].tobytes())
    _add_timings(timings, t0, t1, rows.nbytes, fetch, device_pack_chunks=1)
    return payloads


def _pack_host(prep, fetch, timings: dict | None):
    """Read back the classic chunk planes and assemble payload bytes."""
    t0 = time.perf_counter()
    c0, c1, c2, ws, bits, bad = _fetch_lane_major(fetch)
    if bool(bad.any()):
        raise RuntimeError("encoder state desync: raw < 0")
    t1 = time.perf_counter()
    F = prep["F"]
    bits = bits.view(np.int32).astype(np.int64)
    total_bits = prep["hbits"] + bits[:F] + bits[F:]
    out_stride = int(total_bits.max()) // 8 + 8 if F else 8
    packed = native.pack_chunk_frames_native(
        prep["hv"], prep["hw"], prep["h_off"],
        prep["extra_plane"], prep["extra_w"],
        c0, c1, c2, ws, prep["ns_f"], prep["stereo_f"].astype(np.uint8),
        out_stride,
        reuse=True,  # the payload slices below copy out before return
    )
    if packed is not None:
        out, end_bits = packed
        payloads = [
            out[f, : -(-int(end_bits[f]) // 8)].tobytes() for f in range(F)
        ]
    else:
        payloads = _pack_py(prep, c0, c1, c2, ws)
    _add_timings(timings, t0, t1, c0.nbytes + c1.nbytes + c2.nbytes + ws.nbytes, fetch)
    return payloads


def pack_symbol_planes(prep, vals16, vals32, widths) -> list[bytes]:
    """Payload bytes of a prepped chunk from its unmerged symbol planes
    (ops/encode.rice_symbols or the ``rice_emit`` kernel, lanes as
    :func:`_dispatch` folds them) with the native symbol packer.

    The symbol-plane route: no encoder runs it (the production path
    packs the merged pair planes), and the symbol packer has no
    extra-bits plane, so the chunk must have ``uncompressed_bytes == 0``.
    """
    if prep["extra_plane"] is not None:
        raise ValueError("the symbol packer takes no extra-bits plane")
    F = prep["F"]
    widths = np.ascontiguousarray(widths)
    lane_bits = widths.astype(np.int64).sum(axis=(1, 2))
    total_bits = prep["hbits"] + lane_bits[:F] + lane_bits[F:]
    out_stride = int(total_bits.max()) // 8 + 8 if F else 8
    packed = native.pack_symbol_frames_native(
        prep["hv"], prep["hw"], prep["h_off"],
        np.ascontiguousarray(vals16).view(np.uint16),
        np.ascontiguousarray(vals32).view(np.uint32), widths,
        prep["ns_f"], prep["stereo_f"].astype(np.uint8), out_stride,
    )
    if packed is None:
        raise RuntimeError("the native symbol packer is unavailable")
    out, end_bits = packed
    return [out[f, : -(-int(end_bits[f]) // 8)].tobytes() for f in range(F)]


def _pack_py(prep, c0, c1, c2, ws):
    """Pure-Python packing (no native library)."""
    from .bitwriter import BitWriter

    F = prep["F"]
    hv, hw, h_off = prep["hv"], prep["hw"], prep["h_off"]
    extra_plane, extra_w = prep["extra_plane"], prep["extra_w"]
    payloads = []
    for f in range(F):
        w = BitWriter()
        for v, wd in zip(
            hv[h_off[f] : h_off[f + 1]].tolist(),
            hw[h_off[f] : h_off[f + 1]].tolist(),
        ):
            w.write(int(v), int(wd))
        n = int(prep["ns_f"][f])
        if extra_plane is not None and extra_w[f]:
            eb = int(extra_w[f])
            for i in range(n):
                w.write(int(extra_plane[f, i]), eb)
        lanes = [f, F + f] if prep["stereo_f"][f] else [f]
        for lane in lanes:
            for i in range(n):
                b = int(ws[lane, i])
                if b <= 32:
                    w.write(int(c2[lane, i]), b)
                elif b <= 64:
                    w.write(int(c1[lane, i]), b - 32)
                    w.write(int(c2[lane, i]), 32)
                else:
                    w.write(int(c0[lane, i]), b - 64)
                    w.write(int(c1[lane, i]), 32)
                    w.write(int(c2[lane, i]), 32)
        payloads.append(w.getvalue())
    return payloads


def encode_frames_device(
    frames,
    params: CodecParams,
    config: EncoderConfig | None = None,
    timings: dict | None = None,
    chunk_frames: int | None = None,
    device="cuda",
    kernel: str | None = None,
    mesh=None,
    pack: str | None = None,
    quads: bool | None = None,
    pairs: bool | None = None,
) -> list[bytes]:
    """Encode PCM frames in device batches.

    ``frames``: list of (n, ch) int arrays (mixed lengths/channels), or
    a single (F, S, ch) array (uniform full frames, e.g. a reshaped view
    of contiguous PCM).  Compressed path only (``force_uncompressed``
    frames have no sequential stage: use AlacEncoder).

    ``device``: torch device of the automatons (``"cuda"`` raises without
    a card; ``"cpu"`` runs their plain torch versions).  ``kernel``:
    "auto" | "cuda" | "torch" (ops/cuda/_lib.py).  ``kernel``, ``pack``,
    ``quads`` and ``pairs`` left at None take their variables or their
    defaults (:func:`resolve_routes`).  Batches larger than
    ``chunk_frames`` (default CHUNK_FRAMES) run as the bounded pipeline
    of the module docstring.

    ``timings``: optional dict receiving per-stage wall times summed over
    chunks — ``prep_s`` (host prep and the device dispatch, which does
    not wait for the device), ``emit_wait_s`` (waiting for the planes),
    ``plane_bytes`` (their size), ``pack_s``.

    ``mesh`` (``parallel/mesh.Mesh``; overrides ``device``): each chunk's
    frames split over the mesh's shards, each encoded on its own stream
    (``mesh.encode_stages_pcm_spmd``).  The chunk grows with the shard
    count; a chunk whose frames do not split evenly is padded with
    silent full frames, whose payloads are dropped.

    ``pack`` (one of ``PACK_CHOICES``) chooses who assembles the payload
    bytes: "host" (the native pair packer), or the device, "scatter" or
    "gather" (``ops/encode.pack_frames_device*``; only the coded rows
    cross back), for chunks without an extra-bits plane and without a
    mesh; other chunks take the host's classic packer, as in the JAX
    package.  ``quads``: on the host pair path, fold adjacent pairs once
    more and pack one field per four samples where at most half a
    chunk's frames are quad-fat (those are repacked from their pair
    rows).  ``pairs=False`` packs the classic per-sample planes on the
    host.  Every route's bytes are the same.  ``timings`` then also
    counts ``d2h_bytes`` (everything copied back), ``quad_chunks``,
    ``repacked_frames`` and ``device_pack_chunks``.
    """
    route = resolve_routes(kernel, pack, quads, pairs)
    cfg = config or EncoderConfig()
    if cfg.force_uncompressed:
        raise ValueError("device encoder handles the compressed path only")
    if cfg.uncompressed_bytes > 2:
        # The combined per-sample extra-bits field (A:B interleaved) must
        # fit one u32 plane value; the host AlacEncoder covers ub=3.
        raise ValueError("device encoder supports uncompressed_bytes <= 2")
    dev = None if mesh is not None else check_device(device)
    if dev is not None and dev.type == "cuda" and dev.index is None:
        # The pack worker enters this device: name the caller's current one.
        dev = torch.device("cuda", torch.cuda.current_device())
    enc = AlacEncoder(params, cfg)  # validates params/config like the host
    F = len(frames)
    if F == 0:
        return []
    n_shards = 1 if mesh is None else mesh.size
    step = chunk_frames or CHUNK_FRAMES * n_shards
    S = params.max_samples_per_frame
    payloads: list[bytes] = []

    # Pack runs on a worker thread: the native packer (ctypes) and the
    # waits on the device release the GIL, so packing chunk k-1 overlaps
    # the prep of chunk k+1 while the device runs chunk k.  The 2-deep
    # queue bounds the chunks in flight; one worker and a FIFO queue keep
    # the payloads in order.
    q: queue.Queue = queue.Queue(maxsize=2)
    failure: list[BaseException] = []

    def pack_worker():
        # Device work from this thread (late copies back, the fat frames'
        # gather, the device pack, a classic re-dispatch) runs on the
        # dispatch's device, not on this thread's default one.
        on_dev = (torch.cuda.device(dev) if dev is not None and dev.type == "cuda"
                  else contextlib.nullcontext())
        with on_dev:
            while True:
                item = q.get()
                if item is None:
                    return
                try:
                    got = _pack(item[0], item[1], timings)
                    payloads.extend(got[: item[0]["real_frames"]])
                except BaseException as e:  # re-raised by the dispatch loop
                    failure.append(e)
                    return

    def enqueue(item):
        while True:
            if failure:
                raise failure[0]
            try:
                q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    worker = threading.Thread(target=pack_worker, daemon=True)
    worker.start()
    try:
        for lo in range(0, F, step):
            t0 = time.perf_counter()
            chunk = frames[lo : lo + step]
            real = len(chunk)
            if real % n_shards:
                fill = [np.zeros((S, 2), np.int32)] * (n_shards - real % n_shards)
                chunk = [np.asarray(fr) for fr in chunk] + fill
            prep = _prep(chunk, params, cfg, enc)
            prep["real_frames"] = real
            fetch = _dispatch(prep, params, cfg, dev, mesh=mesh, **route)  # async
            if timings is not None:
                timings["prep_s"] = (
                    timings.get("prep_s", 0.0) + time.perf_counter() - t0
                )
            enqueue((prep, fetch))
    finally:
        # Stop the worker on every exit (a failed worker has returned).
        while worker.is_alive():
            try:
                q.put(None, timeout=0.2)
                break
            except queue.Full:
                continue
        worker.join()
    if failure:
        raise failure[0]
    return payloads
