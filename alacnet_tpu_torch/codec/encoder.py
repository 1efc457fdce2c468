"""ALAC encoder.

A copy of ``alacnet_tpu/codec/encoder.py`` (the port never imports the
JAX package).  Only the device wiring differs: ``encode_m4a`` and
``encode_files`` take a torch device (``"cuda"``, ``"cpu"``) and run the
batch path of ``codec/encoder_device.py``; ``None`` or ``False`` selects
the host ``AlacEncoder``.

The reference is decode-only; this encoder exists (a) as a first-class
framework capability and (b) to synthesize the differential-test corpus
(SURVEY.md §4: "synthesize .m4a corpus") in an environment with no ffmpeg.

Losslessness is *by construction*: the encoder runs the exact mirror of
the decoder's state machines — the Rice history/zero-run automaton
(AlacFile.cs:214-252) and the adaptive-FIR coefficient update
(AlacFile.cs:297-334) — choosing at every step the unique bitstream symbols
that make the decoder reproduce the input.  Any residual that doesn't fit
``readsamplesize`` bits is centered mod 2^rss, which the decoder's
sign-extension folds back exactly (AlacFile.cs:309-310).
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO, Sequence

import numpy as np

from ..container.mux import write_m4a
from .bitwriter import BitWriter
from .cookie import RICE_THRESHOLD, CodecParams, default_cookie
from .scalar import clz32, i32, trunc_div


def _center(value: int, bits: int) -> int:
    """Reduce mod 2^bits into [-2^(bits-1), 2^(bits-1))."""
    m = 1 << bits
    value &= m - 1
    return value - m if value >= (m >> 1) else value


def _zigzag(x: int) -> int:
    """Inverse of the decoder's (dv+1)/2-with-sign map (AlacFile.cs:225-226)."""
    if x > 0:
        return 2 * x
    if x < 0:
        return -2 * x - 1
    return 0


class _RiceEncoder:
    """Mirror of EntropyRiceDecode's state machine (AlacFile.cs:214-252)."""

    def __init__(
        self,
        writer: BitWriter,
        readsamplesize: int,
        initial_history: int,
        kmodifier: int,
        history_mult: int,
        kmodifier_mask: int,
    ):
        self.w = writer
        self.rss = readsamplesize
        self.kmod = kmodifier
        self.mult = history_mult
        self.kmask = kmodifier_mask
        self.history = initial_history
        self.sign_modifier = 0

    def _emit_value(self, raw: int, rss: int, k: int, mask: int) -> None:
        """Emit one entropy symbol such that entropy_decode_value(rss, k,
        mask) returns ``raw`` (mirror of AlacFile.cs:193-212)."""
        assert raw >= 0
        if k == 1:
            if raw <= RICE_THRESHOLD:
                self.w.write_unary(raw)
            else:
                self.w.write((1 << (RICE_THRESHOLD + 1)) - 1, RICE_THRESHOLD + 1)
                self.w.write(raw, rss)
            return
        m = ((1 << k) - 1) & mask
        if m > 0:
            q, r = divmod(raw, m)
        else:
            q, r = RICE_THRESHOLD + 1, 0  # force escape; degenerate mask
        if q > RICE_THRESHOLD:
            # Escape: 9 one-bits then a raw rss-bit value (AlacFile.cs:196-202).
            self.w.write((1 << (RICE_THRESHOLD + 1)) - 1, RICE_THRESHOLD + 1)
            self.w.write(raw, rss)
            return
        self.w.write_unary(q)
        if r == 0:
            # Decoder reads k bits, sees extra<=1, rewinds 1: emit k-1 zeros
            # (AlacFile.cs:205-210).
            self.w.write(0, k - 1)
        else:
            self.w.write(r + 1, k)

    def encode(self, values: Sequence[int]) -> None:
        """Encode the full error sequence for one channel."""
        n = len(values)
        i = 0
        while i < n:
            x = int(values[i])
            dv = _zigzag(x)
            raw = dv - self.sign_modifier
            if raw < 0:
                # Only possible if x == 0 right after a zero-run, which the
                # run-length construction below excludes (runs are never
                # clamped: frames are capped at 65536 samples).
                raise RuntimeError("encoder state desync: raw < 0")
            initial_k = 31 - self.kmod - clz32(i32((self.history >> 9) + 3))
            k = initial_k + self.kmod if initial_k < 0 else self.kmod
            self._emit_value(raw, self.rss, k, 0xFFFFFFFF)
            self.sign_modifier = 0
            if dv > 0xFFFF:
                self.history = 0xFFFF
            else:
                self.history = i32(
                    self.history
                    + i32(dv * self.mult)
                    - (i32(self.history * self.mult) >> 9)
                )
            if self.history < 128 and i + 1 < n:
                # Decoder unconditionally decodes a block size here
                # (AlacFile.cs:231-249): emit the length of the zero run
                # that follows (possibly 0).
                self.sign_modifier = 1
                kz = clz32(self.history) + trunc_div(self.history + 16, 64) - 24
                run = 0
                while i + 1 + run < n and values[i + 1 + run] == 0:
                    run += 1
                if run > 0xFFFF:
                    run = 0xFFFF
                self._emit_value(run, 16, kz, self.kmask)
                i += run
                self.history = 0
            i += 1


def _predictor_errors(
    signal: np.ndarray, rss: int, coefs: list[int], order: int, quant: int
) -> list[int]:
    """Forward adaptive-FIR: residuals whose decode reproduces ``signal``.

    Runs the decoder's reconstruction (AlacFile.cs:256-336) in lockstep,
    solving for each error term instead of applying it. ``coefs`` is
    mutated exactly as the decoder will mutate its table.
    """
    n = len(signal)
    sig = [int(v) for v in signal]
    err = [0] * n
    if n == 0:
        return err
    err[0] = sig[0]
    if order == 0:
        return sig
    if order == 0x1F:
        for i in range(1, n):
            err[i] = _center(sig[i] - sig[i - 1], rss)
        return err
    for i in range(min(order, n - 1)):
        err[i + 1] = _center(sig[i + 1] - sig[i], rss)
    base = 0
    for i in range(order + 1, n):
        total = 0
        for j in range(order):
            total = i32(total + i32((sig[base + order - j] - sig[base]) * coefs[j]))
        pred = i32((1 << (quant - 1)) + total) >> quant
        error_val = _center(sig[i] - pred - sig[base], rss)
        err[i] = error_val
        # Mirror the adaptive update (AlacFile.cs:312-332).
        if error_val > 0:
            pn = order - 1
            ev = error_val
            while pn >= 0 and ev > 0:
                val = i32(sig[base] - sig[base + order - pn])
                sign = (val > 0) - (val < 0)
                coefs[pn] = i32(coefs[pn] - sign)
                val = i32(val * sign)
                ev = i32(ev - (val >> quant) * (order - pn))
                pn -= 1
        elif error_val < 0:
            pn = order - 1
            ev = error_val
            while pn >= 0 and ev < 0:
                val = i32(sig[base] - sig[base + order - pn])
                sign = -((val > 0) - (val < 0))
                coefs[pn] = i32(coefs[pn] - sign)
                val = i32(val * sign)
                ev = i32(ev - (val >> quant) * (order - pn))
                pn -= 1
        base += 1
    return err


def levinson_coefs_batch(
    sig: np.ndarray, ns: np.ndarray, order: int, quant: int
) -> np.ndarray:
    """LPC coefficients for a whole lane batch via Levinson-Durbin.

    ``sig``: (B, S) int-like, each lane zero-padded past its ``ns[b]``
    valid samples; returns (B, order) int32 quantized coefficients.

    Maps the standard predictor  x[i] ~ sum_k a_k x[i-k]  onto the
    decoder's differential form
    base + (sum_j coef[j]*(x[i-1-j]-base)) >> quant (AlacFile.cs:297-308)
    by coef[j] = round(a_{j+1} * 2^quant) — exact when sum a_k = 1, a
    good approximation for correlated audio.  Any coefficients are
    lossless; this only improves compression.

    This batch form is the ONLY implementation (``levinson_coefs`` is a
    B=1 wrapper), so the single-frame host encoder and the batch device
    encoder choose identical coefficients by construction: the
    autocorrelation reduction (einsum over the sample axis) and the
    recursion (elementwise over lanes) are per-lane deterministic
    regardless of batch shape.
    """
    B, S = np.asarray(sig).shape
    ns = np.asarray(ns, np.int64)
    if order == 0:
        return np.zeros((B, 0), np.int32)
    # Zero-padding past ns makes the lag-k products vanish for
    # s >= ns-k, so the padded full-width reduction equals the exact
    # per-lane windowed autocorrelation.  Native tier: one pass per
    # lane over an L1-resident buffer instead of order+1 full-batch
    # sweeps (~4x on the bench host); summation order differs from the
    # einsum fallback, which only perturbs coefficient rounding — any
    # coefficients are lossless, and host/device byte-identity holds
    # because both choose through this same function in-process.
    from .. import native

    r = (
        native.autocorr_native(sig, order)
        if np.issubdtype(np.asarray(sig).dtype, np.integer)
        else None
    )
    if r is None:
        x = np.ascontiguousarray(sig, np.float64)
        r = np.empty((order + 1, B))
        for k in range(order + 1):
            if k >= S:
                r[k] = 0.0
            else:
                r[k] = np.einsum("bs,bs->b", x[:, : S - k], x[:, k:])
    dead = (ns <= order + 1) | (r[0] <= 0)
    r[0] = np.where(r[0] <= 0, 1.0, r[0] * (1.0 + 1e-9))  # ridge
    a = np.zeros((order + 1, B))
    a[0] = 1.0
    err = r[0].copy()
    live = np.ones(B, bool)
    for m in range(1, order + 1):
        acc = r[m] + np.einsum("kb,kb->b", a[1:m], r[1:m][::-1])
        k = np.where(live, -acc / np.where(live, err, 1.0), 0.0)
        a[1:m] = np.where(live, a[1:m] + k * a[m - 1 : 0 : -1], a[1:m])
        a[m] = k
        err = err * (1.0 - k * k)
        live = live & (err > 0)
    coefs = np.round(-a[1 : order + 1].T * (1 << quant))
    coefs = np.clip(coefs, -32768, 32767).astype(np.int32)
    return np.where(dead[:, None], np.zeros_like(coefs), coefs)


def levinson_coefs(signal: np.ndarray, order: int, quant: int) -> np.ndarray:
    """Per-frame LPC coefficients (B=1 view of levinson_coefs_batch)."""
    x = np.asarray(signal)
    return levinson_coefs_batch(x[None], np.array([x.size]), order, quant)[0]


#: Seed coefficient tables per order (quant=9 domain). Arbitrary but sane
#: smooth-signal predictors; the adaptive update tunes them per frame.
_SEED_COEFS = {
    1: [512],
    2: [1024, -512],
    4: [1536, -768, 256, -64],
    6: [1536, -768, 384, -192, 96, -48],
    8: [1280, -640, 320, -160, 80, -40, 20, -10],
}
_DEFAULT_QUANT = 9
MAX_COEFS = 31


@dataclasses.dataclass
class EncoderConfig:
    """Encoding knobs (compression tuning only; output is always lossless)."""

    order: int = 6  # 0=passthrough, 31=delta, else adaptive FIR
    quant: int = _DEFAULT_QUANT
    rice_modifier: int = 4  # per-channel modifier, 3-bit field
    adaptive_coefs: bool = True  # per-frame Levinson-Durbin coefficients
    interlacing_shift: int = 1  # stereo mid/side-ish decorrelation
    interlacing_leftweight: int = 1  # 0 disables decorrelation
    force_uncompressed: bool = False
    uncompressed_bytes: int = 0  # extra-bits side channel (24-bit: 0 or 1)
    #: Coefficient-estimation window (samples): the autocorrelation is
    #: taken over the frame's first ``levinson_window`` samples (0 =
    #: whole frame).  1024 costs ~0.3% compression on musical content
    #: and quarters the host prep cost of batch encoding.
    levinson_window: int = 1024


class AlacEncoder:
    """Frame-level ALAC encoder producing reference-decodable payloads."""

    def __init__(self, params: CodecParams, config: EncoderConfig | None = None):
        self.params = params
        self.config = config or EncoderConfig()
        if params.sample_size not in (16, 24):
            raise ValueError("encoder supports 16/24-bit (like the decoder)")
        if self.config.uncompressed_bytes and params.sample_size != 24:
            raise ValueError("extra-bits side channel requires 24-bit")
        if params.max_samples_per_frame > 65536:
            # Zero runs longer than 0xFFFF cannot always be represented by
            # the 16-bit-domain block-size symbol with the standard rice
            # parameters (AlacFile.cs:235-247); keeping frames <= 65536
            # samples guarantees representability and losslessness.
            raise ValueError(
                "encoder supports max_samples_per_frame <= 65536 "
                f"(got {params.max_samples_per_frame})"
            )

    # -- frame encoding ------------------------------------------------------

    def encode_frame(self, samples: np.ndarray) -> bytes:
        """Encode one frame. ``samples`` is (n, channels) int32.

        Uses the native C++ encoder core (predictor mirror + Rice emitter
        + bulk bit packing, _native/host.cpp) when available; the Python
        path below is the portable fallback and differential oracle
        (tests/test_encoder_native.py).
        """
        from .. import native

        if native.available():
            return self._encode_frame_native(samples)
        return self._encode_frame_py(samples)

    def _header_fields(self, n: int, nch: int, ub: int, isnotcompressed: int):
        """(values, widths) for the common frame header."""
        p = self.params
        hassize = 1 if n != p.max_samples_per_frame else 0
        vals = [0 if nch == 1 else 1, 0, 0, hassize, ub, isnotcompressed]
        widths = [3, 4, 12, 1, 2, 1]
        if hassize:
            vals.append(n)
            widths.append(32)
        return vals, widths

    def _prediction_fields(self, coefs: list[int], order: int):
        cfg = self.config
        vals = [0, cfg.quant, cfg.rice_modifier, order]
        widths = [4, 4, 3, 5]
        count = 31 if order == 0x1F else order
        for c in coefs[:count]:
            vals.append(int(c) & 0xFFFF)
            widths.append(16)
        return vals, widths

    def _encode_frame_native(self, samples: np.ndarray) -> bytes:
        from .. import native

        p, cfg = self.params, self.config
        n, nch = samples.shape
        if nch not in (1, 2):
            raise ValueError(f"1 or 2 channels, got {nch}")
        ub = 0 if cfg.force_uncompressed else cfg.uncompressed_bytes
        isnotcompressed = 1 if cfg.force_uncompressed else 0
        rss = p.sample_size - 8 * ub + (1 if nch == 2 else 0)
        # Worst case: escapes everywhere + zero-run fields + extras + header.
        cap_bits = n * nch * (9 + rss + 25 + 8 * ub + p.sample_size) + 4096
        buf = np.zeros(cap_bits // 8 + 8, np.uint8)

        vals, widths = self._header_fields(n, nch, ub, isnotcompressed)
        if isnotcompressed:
            # Raw PCM body as one bulk pack (AlacFile.cs:498-526,663-700).
            ss = p.sample_size
            flat = samples.astype(np.int64).reshape(-1)
            u = (flat & ((1 << ss) - 1)).astype(np.uint32)
            if ss <= 16:
                body_v, body_w = u, np.full(u.size, ss, np.uint8)
            else:
                body_v = np.empty(u.size * 2, np.uint32)
                body_v[0::2] = u >> (ss - 16)
                body_v[1::2] = u & ((1 << (ss - 16)) - 1)
                body_w = np.empty(u.size * 2, np.uint8)
                body_w[0::2] = 16
                body_w[1::2] = ss - 16
            allv = np.concatenate([np.asarray(vals, np.uint32), body_v])
            allw = np.concatenate([np.asarray(widths, np.uint8), body_w])
            pos = native.pack_bits_native(allv, allw, buf, 0)
            return buf[: -(-pos // 8)].tobytes()

        # Compressed path: split channels, decorrelate, predict, pack.
        if nch == 1:
            hi, extra = self._split_extra(samples[:, 0].astype(np.int64), ub)
            chans = [hi]
            extras = [extra]
            sh = lw = 0
        else:
            left = samples[:, 0].astype(np.int64)
            right = samples[:, 1].astype(np.int64)
            hi_l, extra_l = self._split_extra(left, ub)
            hi_r, extra_r = self._split_extra(right, ub)
            sh, lw = cfg.interlacing_shift, cfg.interlacing_leftweight
            if lw != 0:
                chan_b = hi_l - hi_r
                chan_a = hi_r + ((chan_b * lw) >> sh)
            else:
                chan_a, chan_b = hi_l, hi_r
            chans = [chan_a, chan_b]
            extras = [extra_l, extra_r]
        order = cfg.order
        vals += [0, 0] if nch == 1 else [sh, lw]
        widths += [8, 8]
        coef_arrays = []
        for chan in chans:
            coefs = np.zeros(MAX_COEFS, np.int32)
            seed = self._choose_coefs(chan, order)
            coefs[: len(seed)] = seed
            coef_arrays.append(coefs)
            pv, pw = self._prediction_fields(list(coefs), order)
            vals += pv
            widths += pw
        if ub:
            # Interleaved extra-bits, A,B per sample (AlacFile.cs:634-641).
            ev = np.stack(extras, axis=1).astype(np.uint32).reshape(-1)
            vals_arr = np.concatenate([np.asarray(vals, np.uint32), ev])
            widths_arr = np.concatenate(
                [np.asarray(widths, np.uint8), np.full(ev.size, 8 * ub, np.uint8)]
            )
        else:
            vals_arr = np.asarray(vals, np.uint32)
            widths_arr = np.asarray(widths, np.uint8)
        pos = native.pack_bits_native(vals_arr, widths_arr, buf, 0)
        mult = p.rice_history_mult_for(cfg.rice_modifier)
        for chan, coefs in zip(chans, coef_arrays):
            errs = native.predictor_errors_native(
                np.asarray(chan, np.int32), coefs, order, cfg.quant, rss
            )
            pos = native.rice_encode_native(
                errs, rss, p.rice_initial_history, p.rice_kmodifier,
                mult, p.rice_kmodifier_mask, buf, pos,
            )
        return buf[: -(-pos // 8)].tobytes()

    def _encode_frame_py(self, samples: np.ndarray) -> bytes:
        """Pure-Python encoding path (fallback + oracle)."""
        p = self.params
        cfg = self.config
        n, nch = samples.shape
        if nch not in (1, 2):
            raise ValueError(f"1 or 2 channels, got {nch}")
        w = BitWriter()
        w.write(0 if nch == 1 else 1, 3)  # element tag (AlacFile.cs:435)
        w.write(0, 4)
        w.write(0, 12)
        hassize = 1 if n != p.max_samples_per_frame else 0
        w.write(hassize, 1)
        ub = cfg.uncompressed_bytes
        isnotcompressed = 1 if cfg.force_uncompressed else 0
        if isnotcompressed:
            ub = 0
        w.write(ub, 2)
        w.write(isnotcompressed, 1)
        if hassize:
            w.write(n, 32)
        if isnotcompressed:
            self._write_uncompressed(w, samples)
        elif nch == 1:
            self._write_mono_compressed(w, samples[:, 0], ub)
        else:
            self._write_stereo_compressed(w, samples, ub)
        return w.getvalue()

    def _split_extra(self, chan: np.ndarray, ub: int) -> tuple[np.ndarray, np.ndarray]:
        """Split off the uncompressed low bytes (extra-bits side channel)."""
        if ub == 0:
            return chan, np.zeros_like(chan)
        shift = 8 * ub
        return chan >> shift, chan & ((1 << shift) - 1)

    def _write_prediction_header(self, w: BitWriter, coefs: list[int], order: int) -> None:
        """predtype/quant/ricemod/order + coef table (AlacFile.cs:461-475)."""
        cfg = self.config
        w.write(0, 4)  # prediction type 0 (the only decodable type)
        w.write(cfg.quant, 4)
        w.write(cfg.rice_modifier, 3)
        w.write(order, 5)
        for c in coefs[:order] if order != 0x1F else coefs[:31]:
            w.write(c & 0xFFFF, 16)

    def _seed_coefs(self, order: int) -> list[int]:
        if order in (0, 0x1F):
            return [0] * 31
        if order in _SEED_COEFS:
            return list(_SEED_COEFS[order])
        return [512] + [0] * (order - 1)

    def _choose_coefs(self, chan: np.ndarray, order: int) -> list[int]:
        """Per-frame coefficients: Levinson-Durbin or static seeds."""
        if order in (0, 0x1F) or not self.config.adaptive_coefs:
            return self._seed_coefs(order)
        w = self.config.levinson_window
        if w:
            chan = chan[:w]
        return [int(c) for c in levinson_coefs(chan, order, self.config.quant)]

    def _rice(self, w: BitWriter, rss: int) -> _RiceEncoder:
        p = self.params
        return _RiceEncoder(
            w,
            rss,
            p.rice_initial_history,
            p.rice_kmodifier,
            p.rice_history_mult_for(self.config.rice_modifier),
            p.rice_kmodifier_mask,
        )

    def _write_mono_compressed(self, w: BitWriter, chan: np.ndarray, ub: int) -> None:
        p, cfg = self.params, self.config
        rss = p.sample_size - 8 * ub
        hi, extra = self._split_extra(chan.astype(np.int64), ub)
        w.write(0, 8)
        w.write(0, 8)
        order = cfg.order
        coefs = self._choose_coefs(hi, order)
        self._write_prediction_header(w, coefs, order)
        if ub:
            for e in extra:
                w.write(int(e), 8 * ub)
        errs = _predictor_errors(hi, rss, coefs, order, cfg.quant)
        self._rice(w, rss).encode(errs)

    def _write_stereo_compressed(self, w: BitWriter, samples: np.ndarray, ub: int) -> None:
        p, cfg = self.params, self.config
        rss = p.sample_size - 8 * ub + 1
        left = samples[:, 0].astype(np.int64)
        right = samples[:, 1].astype(np.int64)
        hi_l, extra_l = self._split_extra(left, ub)
        hi_r, extra_r = self._split_extra(right, ub)
        sh, lw = cfg.interlacing_shift, cfg.interlacing_leftweight
        if lw != 0:
            # Inverse of Deinterlace16/24 (AlacFile.cs:344-355,375-389):
            # B = left - right; A = right + ((B*lw) >> sh).
            chan_b = hi_l - hi_r
            chan_a = hi_r + ((chan_b * lw) >> sh)
        else:
            chan_a, chan_b = hi_l, hi_r
        w.write(sh, 8)
        w.write(lw, 8)
        order = cfg.order
        coefs_a = self._choose_coefs(chan_a, order)
        coefs_b = self._choose_coefs(chan_b, order)
        self._write_prediction_header(w, coefs_a, order)
        self._write_prediction_header(w, coefs_b, order)
        if ub:
            # Interleaved A,B per sample (AlacFile.cs:634-641).
            for ea, eb in zip(extra_l, extra_r):
                w.write(int(ea), 8 * ub)
                w.write(int(eb), 8 * ub)
        errs_a = _predictor_errors(chan_a, rss, coefs_a, order, cfg.quant)
        errs_b = _predictor_errors(chan_b, rss, coefs_b, order, cfg.quant)
        self._rice(w, rss).encode(errs_a)
        self._rice(w, rss).encode(errs_b)

    def _write_uncompressed(self, w: BitWriter, samples: np.ndarray) -> None:
        """Raw-PCM frame body (AlacFile.cs:498-526,663-700)."""
        ss = self.params.sample_size
        flat = samples.astype(np.int64)
        if ss <= 16:
            for row in flat:
                for v in row:
                    w.write(int(v) & ((1 << ss) - 1), ss)
        else:
            for row in flat:
                for v in row:
                    u = int(v) & ((1 << ss) - 1)
                    w.write(u >> (ss - 16), 16)
                    w.write(u & ((1 << (ss - 16)) - 1), ss - 16)


def _host_only(device, config: EncoderConfig | None, mesh=None) -> bool:
    """True when a call encodes on the host: no device or mesh was
    named, or the frames are raw PCM, which the device pipeline does not
    carry."""
    no_device = (device is None or device is False) and mesh is None
    return no_device or bool(config and config.force_uncompressed)


def encode_m4a(
    out: BinaryIO,
    pcm: np.ndarray,
    sample_rate: int,
    sample_size: int = 16,
    config: EncoderConfig | None = None,
    max_samples_per_frame: int = 4096,
    device=None,
    kernel: str = "auto",
    mesh=None,
    pack: str = "host",
    quads: bool = False,
    **mux_kwargs,
) -> CodecParams:
    """Encode a PCM array (num_samples, channels) into a complete .m4a.

    ``device`` (a torch device such as ``"cuda"``) runs the sequential
    encode stages frame-parallel there (codec/encoder_device.py) —
    byte-identical output; ``None`` or ``False`` (the default) encodes
    on the host.  ``kernel`` routes the device stages ("auto", "cuda",
    "torch"; ops/cuda/_lib.py).  ``mesh`` (``parallel/mesh.Mesh``;
    implies the device path and overrides ``device``) splits the frames
    over its shards.  ``pack`` ("host", "scatter", "gather") and
    ``quads`` choose the device path's packing route
    (``encoder_device.encode_frames_device``); the bytes are the same.
    """
    pcm = np.asarray(pcm)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    nsamples, nch = pcm.shape
    params = default_cookie(
        sample_rate=sample_rate,
        sample_size=sample_size,
        num_channels=nch,
        max_samples_per_frame=max_samples_per_frame,
    )
    chunks = [
        pcm[s : s + max_samples_per_frame]
        for s in range(0, nsamples, max_samples_per_frame)
    ]
    durations = [len(c) for c in chunks]
    if not _host_only(device, config, mesh):
        from .encoder_device import encode_frames_device

        frames = encode_frames_device(
            chunks, params, config, device=device, kernel=kernel, mesh=mesh,
            pack=pack, quads=quads,
        )
    else:
        enc = AlacEncoder(params, config)
        frames = [enc.encode_frame(c) for c in chunks]
    write_m4a(out, params, frames, durations, **mux_kwargs)
    return params


def encode_files(
    pcms: "Sequence[np.ndarray]",
    outs: "Sequence[BinaryIO | str | os.PathLike]",
    sample_rates: "int | Sequence[int]",
    sample_sizes: "int | Sequence[int]" = 16,
    config: EncoderConfig | None = None,
    max_samples_per_frame: int = 4096,
    device="cuda",
    kernel: str = "auto",
    mesh=None,
    pack: str = "host",
    quads: bool = False,
    **mux_kwargs,
) -> "list[CodecParams]":
    """Encode many PCM arrays into .m4a files in POOLED device batches —
    the encode mirror of batch.decode_files.

    Frames from every same-format file are pooled into one
    encode_frames_device run (the <=2-in-flight chunked pipeline), so a
    library of short files amortizes dispatch/compile overhead exactly
    like decode's pooled spans; payloads are split back per file and
    muxed individually.  Mixed formats (rate/bits/channels) are grouped
    by format and run group-by-group.

    ``pcms``: per-file (num_samples, channels) int arrays (1-D = mono);
    ``outs``: matching writable file objects or paths;
    ``sample_rates``/``sample_sizes``: scalar or per-file.  ``device``
    (default ``"cuda"``, which raises without a card) is the torch device
    of the batch path; ``None`` or ``False`` encodes with the host
    AlacEncoder per frame (also taken for ``config.force_uncompressed``,
    which the device pipeline does not carry).  ``kernel`` routes the
    device stages.  ``mesh`` (``parallel/mesh.Mesh``; implies the device
    path and overrides ``device``) splits each chunk's frames over its
    shards.  ``pack`` ("host", "scatter", "gather") and ``quads`` choose
    the device path's packing route (``encode_frames_device``); the
    bytes are the same.  Returns the per-file CodecParams.
    """
    import os

    pcms = [np.asarray(p) for p in pcms]
    pcms = [p[:, None] if p.ndim == 1 else p for p in pcms]
    nf = len(pcms)
    if len(outs) != nf:
        raise ValueError(f"{nf} pcm arrays but {len(outs)} outputs")

    def per_file(v):
        if isinstance(v, (int, np.integer)):
            return [int(v)] * nf
        v = [int(x) for x in v]
        if len(v) != nf:
            raise ValueError("per-file parameter length mismatch")
        return v

    rates = per_file(sample_rates)
    sizes = per_file(sample_sizes)
    results: list[CodecParams | None] = [None] * nf

    groups: dict[tuple, list[int]] = {}
    for i, p in enumerate(pcms):
        groups.setdefault((rates[i], sizes[i], p.shape[1]), []).append(i)

    use_host = _host_only(device, config, mesh)
    if not use_host and mesh is None:
        from .encoder_device import check_device

        check_device(device)
    for (rate, bits, nch), idxs in groups.items():
        params = default_cookie(
            sample_rate=rate,
            sample_size=bits,
            num_channels=nch,
            max_samples_per_frame=max_samples_per_frame,
        )
        chunks: list[np.ndarray] = []
        counts: list[int] = []
        durations: list[list[int]] = []
        for i in idxs:
            fc = [
                pcms[i][s : s + max_samples_per_frame]
                for s in range(0, pcms[i].shape[0], max_samples_per_frame)
            ]
            chunks.extend(fc)
            counts.append(len(fc))
            durations.append([len(c) for c in fc])
        if use_host:
            enc = AlacEncoder(params, config)
            frames = [enc.encode_frame(c) for c in chunks]
        else:
            from .encoder_device import encode_frames_device

            frames = encode_frames_device(
                chunks, params, config, device=device, kernel=kernel, mesh=mesh,
                pack=pack, quads=quads,
            )
        pos = 0
        for j, i in enumerate(idxs):
            sub = frames[pos : pos + counts[j]]
            pos += counts[j]
            o = outs[i]
            if hasattr(o, "write"):
                write_m4a(o, params, sub, durations[j], **mux_kwargs)
            else:
                with open(os.fspath(o), "wb") as f:
                    write_m4a(f, params, sub, durations[j], **mux_kwargs)
            results[i] = params
    return results  # type: ignore[return-value]
