"""Host->device decode orchestration: planning, padding, dispatch.

The counterpart of ``alacnet_tpu/parallel/pipeline.py`` for one torch
device or a mesh of them (``parallel/mesh.py``).  Stage 1 parses
headers and plans lanes on the host (``plan_blob_batches``: NumPy plus
the native C++ tier), stage 2 decodes on the device
(``ops/frame_decode.py``: kernels 1-3 and an elementwise epilogue),
each shard of a mesh in turn (a decode without a mesh is a mesh of one
shard, on its device's current stream), stage 3 unsorts the PCM on the
host.  At most two batches are in flight: the host parses batch k+1
while the card decodes batch k.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from ..codec.cookie import CodecParams
from ..codec.framemeta import FrameBatch
from ..codec.framemeta_vec import (
    parse_frame_headers_blob, parse_frame_headers_vec, words_width,
)
from ..config import DecodeConfig, resolve
from ..errors import UnsupportedFormatError
from ..ops.bitreader import WINDOW_PAD, pack_frames_to_words
from ..ops.cuda.pack_rows import blob_words_uploader, host_row_params
from ..ops.frame_decode import FrameMetaArrays
from ..utils.observability import (
    GLOBAL_STATS, PARSE_SPAN, RESULT_WAIT_SPAN, trace_span,
)
from .mesh import Mesh, Sharded, _decode_shards

#: Lane-count buckets (powers of two up to 4096 frames in flight).
BATCH_BUCKETS = (8, 64, 256, 1024, 2048, 3072, 4096)
#: Word-width rounding (uint32 words; 256 words = 1 KiB payload).
WORD_BUCKET = 256
#: Lane-planning constants kept from the JAX package so that the lane
#: order and span split stay as they are there: the eligibility bands
#: (frame sizes that fit the TPU kernel's word table whole, that stream
#: through it, or neither), the 1024-lane block at which spans split
#: where the order bucket changes, and the order ladder.  They no longer
#: select kernels: the CUDA kernels take any B and W.  Whether the
#: planning still pays off on the H100 is an open measurement.
FUSED_MIN_BATCH = 1024
FUSED_MAX_WORDS = 11776
FUSED_MAX_WORDS_STREAM = 24576
_ORDER_BUCKETS = (0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 30)
#: Order 31 = pure integration: no FIR window, no adaptive walk.
MAX_ORDER_SENTINEL = 31


def _round_batch(b: int) -> int:
    for s in BATCH_BUCKETS:
        if b <= s:
            return s
    return -(-b // BATCH_BUCKETS[-1]) * BATCH_BUCKETS[-1]


def _pad_axis0(a: np.ndarray, b: int) -> np.ndarray:
    if a.shape[0] == b:
        return a
    pad = [(0, b - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def pad_frame_batch(fb: FrameBatch, batch: int | None = None) -> FrameBatch:
    """Pad lanes to a bucketed batch size; padded lanes have n_samples=0."""
    b = _round_batch(fb.batch) if batch is None else batch
    w = -(-fb.words.shape[1] // WORD_BUCKET) * WORD_BUCKET
    if b == fb.batch and w == fb.words.shape[1]:
        return fb
    words = np.zeros((b, w), dtype=np.uint32)
    words[: fb.batch, : fb.words.shape[1]] = fb.words
    fields = {"words": words}
    for f in dataclasses.fields(fb):
        if f.name == "words":
            continue
        fields[f.name] = _pad_axis0(getattr(fb, f.name), b)
    return FrameBatch(**fields)


class StagedBatch(NamedTuple):
    """The host half of one batch's dispatch (:func:`stage_frame_batch`)."""

    #: (B, W) uint32 host word rows, or None when the device cuts them.
    words: np.ndarray | None
    #: (2, B) int32 per-lane (word offset, byte count) for ``pack_rows``.
    rows: np.ndarray | None
    W: int
    #: (B, 83) int32 ``FrameMetaArrays.pack_host`` matrix ((B, 87) with
    #: the chain columns of frames of 3-8 channels).
    meta: np.ndarray
    emit16: bool
    orig_b: int


def stage_frame_batch(
    fb: FrameBatch, config: DecodeConfig, device_rows=None, n_shards: int = 1,
    real_lanes16: bool = False,
) -> StagedBatch:
    """Host half of :func:`dispatch_frame_batch`: pad the lanes (to a
    bucket, then to a multiple of ``n_shards``), pick the output dtype,
    pack the metadata and (``device_rows = (ow, nbytes, W)``) the row
    parameters.

    With ``config.emit16`` the batch decodes to int16 where every lane
    is 16-bit: every lane of the padded batch, as the JAX package picks,
    or with ``real_lanes16`` only the ``orig_b`` real ones.  Pad lanes
    (sample size 0, no samples) then decode to int16 too; a caller that
    asks for it cuts them off before the PCM reaches the host."""
    orig_b = fb.batch
    fb = pad_frame_batch(fb)
    if fb.batch % n_shards:
        fb = pad_frame_batch(fb, -(-fb.batch // n_shards) * n_shards)
    lanes = fb.sample_size[:orig_b] if real_lanes16 else fb.sample_size
    emit16 = config.emit16 and bool((lanes == 16).all())
    meta = FrameMetaArrays.pack_host(fb)
    if device_rows is None:
        return StagedBatch(fb.words, None, fb.words.shape[1], meta, emit16, orig_b)
    ow, nbytes, W = device_rows
    rows = np.stack([_pad_axis0(ow, fb.batch), _pad_axis0(nbytes, fb.batch)])
    return StagedBatch(None, rows, W, meta, emit16, orig_b)


def _device_mesh(mesh, config: DecodeConfig | None, sink=None, **overrides):
    """The mesh a decode runs on, the config it runs with
    (``config.resolve`` with ``overrides``) and its ``sink``: ``mesh``,
    whose first device then stands in for ``config.device``, or else a
    mesh of one shard on ``config.device``, with the sink given that
    shard's tensors, as a call without a mesh promises.  The one place a
    decode tells the two apart."""
    if mesh is not None:
        return mesh, resolve(config, device=str(mesh.devices[0]), **overrides), sink
    config = resolve(config, **overrides)
    plain = sink and (lambda out, n, orig_b: sink(out.parts[0], n.parts[0], orig_b))
    return Mesh([config.torch_device]), config, plain


def launch_frame_batch(
    staged: StagedBatch, max_samples: int, config: DecodeConfig, bwords, mesh: Mesh,
) -> tuple[Sharded, Sharded]:
    """Device half of :func:`dispatch_frame_batch`: each shard of the
    ``mesh`` (``parallel/mesh.py``) uploads its slice of the staged
    batch, cuts its rows from its copy of the blob words when the batch
    has row parameters (kernel 1; ``bwords`` is the per-shard tuple of
    ``Mesh.replicated``), and queues its decode.  Returns (out, n) as
    ``mesh.Sharded`` without synchronising."""
    return _decode_shards(
        mesh, staged.meta, max_samples, staged.emit16, config.kernel,
        words=staged.words, rows=staged.rows, bwords=bwords, W=staged.W,
    )


def dispatch_frame_batch(
    fb: FrameBatch, max_samples: int, config: DecodeConfig, device_rows=None,
    mesh=None, real_lanes16: bool = False,
):
    """Queue one batch's decode; returns (out, n, orig_b), (out, n) as
    ``mesh.Sharded``, without synchronising.

    ``device_rows``: ``(bwords, ow, nbytes, W)`` from
    ``span_batch(idx, device_rows=True)`` plus the device-resident
    blob words, one copy a shard (``Mesh.replicated``): the word rows
    are then cut on the device (kernel 1) instead of shipped from the
    host; fb carries an empty (B, 0) words placeholder.  ``mesh``: shard
    the lanes over it (default one shard on ``config.device``;
    :func:`launch_frame_batch`).  ``real_lanes16``: pick the output
    dtype over the first ``orig_b`` lanes (:func:`stage_frame_batch`).
    """
    mesh, config, _ = _device_mesh(mesh, config)
    bwords = None
    if device_rows is not None:
        bwords, device_rows = device_rows[0], device_rows[1:]
    staged = stage_frame_batch(fb, config, device_rows, mesh.size, real_lanes16)
    out, n = launch_frame_batch(staged, max_samples, config, bwords, mesh)
    return out, n, staged.orig_b


def decode_frame_batch(
    fb: FrameBatch, max_samples: int, config: DecodeConfig
) -> tuple[np.ndarray, np.ndarray]:
    """Decode a parsed FrameBatch -> (samples (B, S, C), n (B,)): C is 2
    or the batch's widest frames' channel count, and n is -status where
    the element chain refused a frame of 3-8 channels."""
    out, n, orig_b = dispatch_frame_batch(fb, max_samples, config)
    return _fetch_sharded(out, n, orig_b)()


def plan_blob_batches(
    blob: np.ndarray,
    offsets: np.ndarray,
    sizes: np.ndarray,
    params: list[CodecParams] | CodecParams,
    batch_limit: int,
    strict: bool,
    native: bool = True,
):
    """Batch planning for blob decode: header pre-pass + lane ordering.

    Parses every frame's header once, then orders lanes by eligibility
    band, bit depth (16-bit spans keep int16 output), coded size and,
    within equal sizes, LPC order — the JAX package's default plan.
    Spans split at ``batch_limit`` lanes (one 1024-lane block in the
    big-frame band) and further at 1024-lane blocks where the order
    bucket changes.

    Returns (perm, inv, spans, span_batch) where ``spans`` are [lo, hi)
    index ranges into ``perm`` and ``span_batch(perm[lo:hi])`` assembles
    that batch.  Callers unsort outputs with ``inv``.
    """
    F = len(offsets)
    offsets = np.asarray(offsets)
    sizes = np.asarray(sizes)
    hdr = parse_frame_headers_blob(
        blob, offsets, sizes, params, strict=strict, pack_words=False,
        native=native,
    )
    cap_w = (FUSED_MAX_WORDS // WORD_BUCKET) * WORD_BUCKET
    cap_bytes = (cap_w - WINDOW_PAD) * 4
    cap2_w = (FUSED_MAX_WORDS_STREAM // WORD_BUCKET) * WORD_BUCKET
    cap2_bytes = (cap2_w - WINDOW_PAD) * 4
    elig = np.where(
        sizes <= cap_bytes, 0, np.where(sizes <= cap2_bytes, 1, 2)
    ).astype(np.int8)
    is_wide = hdr.sample_size != 16
    okey = np.where(hdr.order == MAX_ORDER_SENTINEL, 0, hdr.order).max(axis=1)
    perm = np.lexsort((okey, sizes, is_wide, elig))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(F)
    group = elig[perm] * 2 + is_wide[perm].astype(np.int8)
    boundaries = sorted(
        {0, F} | set((np.flatnonzero(np.diff(group)) + 1).tolist())
    )

    def _bucket(o: int) -> int:
        return next(b for b in _ORDER_BUCKETS if b >= o)

    ok_p = okey[perm]
    el_p = elig[perm]
    spans = []
    for b_lo, b_hi in zip(boundaries[:-1], boundaries[1:]):
        limit = min(batch_limit, FUSED_MIN_BATCH) if el_p[b_lo] == 1 else batch_limit
        for lo in range(b_lo, b_hi, limit):
            hi = min(lo + limit, b_hi)
            sub, cur = lo, None
            for blk in range(lo, hi, FUSED_MIN_BATCH):
                bk = _bucket(
                    int(ok_p[blk : min(blk + FUSED_MIN_BATCH, hi)].max())
                )
                if cur is None:
                    cur = bk
                elif bk != cur and hi - blk >= FUSED_MIN_BATCH:
                    spans.append((sub, blk))
                    sub, cur = blk, bk
            spans.append((sub, hi))
    hdr_fields = [
        f.name for f in dataclasses.fields(FrameBatch) if f.name != "words"
    ]

    def span_batch(idx: np.ndarray, device_rows: bool = False):
        """Assemble one batch: sliced pre-parsed headers + packed words.

        ``device_rows=True`` skips host word packing and returns
        ``(fb, ow, nbytes, W)`` for the device row assembler: fb.words
        is an empty (B, 0) placeholder, and the parsed bit positions are
        bumped by the frame's sub-word byte shift.
        """
        from .. import native as native_tier

        offs = np.ascontiguousarray(offsets[idx])
        szs = np.ascontiguousarray(sizes[idx])
        if device_rows:
            ow, nbytes, bump = host_row_params(offs, szs)
            W = words_width(
                int(nbytes.max()) if len(nbytes) else 0, WORD_BUCKET
            )
            fields = {f: getattr(hdr, f)[idx] for f in hdr_fields}
            fields["payload_pos"] = fields["payload_pos"] + bump
            fields["entropy_pos"] = fields["entropy_pos"] + bump
            fb = FrameBatch(
                words=np.zeros((len(idx), 0), np.uint32), **fields
            )
            return fb, ow, nbytes, W
        nwords = words_width(int(szs.max()) if len(szs) else 0, WORD_BUCKET)
        lib = native_tier.get_lib() if native else None
        if lib is not None:
            words = native_tier.pack_frames_native(lib, blob, offs, szs, nwords)
        else:
            words = pack_frames_to_words(
                [blob[o : o + s].tobytes() for o, s in zip(offs, szs)]
            )
            words = np.pad(words, ((0, 0), (0, nwords - words.shape[1])))
        return FrameBatch(
            words=words, **{f: getattr(hdr, f)[idx] for f in hdr_fields}
        )

    return perm, inv, spans, span_batch


def blob_spans(blob, offsets, sizes, params, batch_limit: int, config: DecodeConfig):
    """The host stage of :func:`decode_blob`: parse and plan the blob's
    frames (:func:`plan_blob_batches`), then assemble each span on demand.

    Returns ``(inv, max_w, spans)``: the plan's inverse permutation; with
    ``config.device_pack``, the widest row any span will gather (else
    None: the host packs the rows); and a lazy iterator of ``(idx, fb,
    rows)`` — a span's frame indices, its FrameBatch and, with
    ``max_w``, its device row parameters ``(ow, nbytes, W)`` (else None).
    """
    sizes = np.asarray(sizes)
    with trace_span(PARSE_SPAN):
        perm, inv, spans, span_batch = plan_blob_batches(
            blob, offsets, sizes, params, batch_limit, config.strict,
            native=config.native,
        )
    max_w = None
    if config.device_pack:
        # Widest row any span will gather: the fattest frame's bytes
        # plus its <=3-byte sub-word shift.  Sizing the blob padding to
        # it keeps every tail-frame window in bounds.
        max_w = words_width(
            int(sizes.max()) + 3 if len(sizes) else 0, WORD_BUCKET
        )

    def assemble():
        for lo, hi in spans:
            idx = perm[lo:hi]
            with trace_span(PARSE_SPAN):
                if max_w is not None:
                    fb, ow, nb, W = span_batch(idx, device_rows=True)
                    rows = (ow, nb, W)
                else:
                    fb, rows = span_batch(idx), None
            yield idx, fb, rows

    return inv, max_w, assemble()


def decode_blob(
    blob: np.ndarray,
    offsets: np.ndarray,
    sizes: np.ndarray,
    params: list[CodecParams] | CodecParams,
    max_samples: int,
    batch_limit: int | None = None,
    strict: bool | None = None,
    sink=None,
    config: DecodeConfig | None = None,
    mesh=None,
    real_lanes16: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode frames addressed as (offset, size) into a raw byte blob.

    Returns (samples (F, S, C), n (F,), status (F,)) in the frames'
    original order, where C is 2 or the widest frame's channel count
    and ``status`` flags per-frame parse failures in
    lenient mode: the host parse's, and the element chain's of frames of
    3-8 channels (``ops/frame_decode._element_chain``), read back with
    the samples (strict mode raises ``UnsupportedFormatError`` for
    either).  ``config`` (default ``DecodeConfig()``) names the
    device and kernel route; ``batch_limit``/``strict`` default to its
    fields.

    ``sink``: optional device-side consumer ``sink(out, n, orig_b)``
    called with each batch's *device* tensors (padded, planner order)
    instead of copying PCM to the host.  With a sink the returned
    samples/n are empty; ``status`` is still per-frame in original
    order, the host parse's alone (the sink's n holds the element
    chain's, as -status).

    ``mesh`` (``parallel/mesh.Mesh``; overrides ``config.device``):
    every batch's lanes split over the mesh's shards, each decoded on
    its own stream, the blob words replicated once per distinct device.
    A sink then gets ``mesh.Sharded`` (out, n), each part ready on its
    shard's stream.  Without a mesh the decode runs on a mesh of one
    shard on ``config.device`` (its current stream), and a sink gets
    that shard's tensors.

    ``real_lanes16``: a batch whose real lanes are all 16-bit comes back
    int16 even when it is padded (:func:`stage_frame_batch`), so the
    returned samples' dtype is no longer the JAX package's: for callers
    that choose each file's dtype themselves (``batch.decode_streams``).
    """
    mesh, config, sink = _device_mesh(mesh, config, sink, strict=strict)
    if batch_limit is None:
        batch_limit = config.batch_limit
    sizes = np.asarray(sizes)
    inv, max_w, spans = blob_spans(blob, offsets, sizes, params, batch_limit, config)
    bwords = None
    if max_w is not None:
        with trace_span("alac.host.h2d"):
            # one host staging of the blob; each distinct card uploads from it
            bwords = mesh.replicated(
                blob_words_uploader(np.asarray(blob), max_w, config.kernel))
    outs, ns, sts = [], [], []
    pending: list = []

    def drain_one():
        wait, orig_b, frames, nbytes, status = pending.pop(0)
        if sink is not None:
            GLOBAL_STATS.record(frames=frames, coded_bytes=nbytes)
            sts.append(status)
            return
        with trace_span(RESULT_WAIT_SPAN):
            out, n = wait()
        refused = n < 0  # the element chain's status, as -status
        if refused.any():
            if config.strict:
                raise UnsupportedFormatError(
                    f"{int(refused.sum())} frame(s) of 3-8 channels refused by the "
                    f"element chain (status {int(-n[refused][0])}: 1 a wrong or "
                    "missing element tag or sample count, 2 a prediction type "
                    "other than 0)")
            status = np.where(refused[: len(status)], -n[: len(status)], status)
            n = np.where(refused, 0, n)
        GLOBAL_STATS.record(
            frames=frames, samples=int(n.sum()), coded_bytes=nbytes,
            pcm_bytes=out.nbytes, int16=out.dtype == np.int16,
        )
        outs.append(out)
        ns.append(n)
        sts.append(status)

    for idx, fb, rows in spans:
        with trace_span("alac.host.enqueue"):
            out_d, n_d, orig_b = dispatch_frame_batch(
                fb, max_samples, config,
                device_rows=None if rows is None else (bwords, *rows), mesh=mesh,
                real_lanes16=real_lanes16,
            )
            wait = None if sink is not None else _fetch_sharded(out_d, n_d, orig_b)
        if sink is not None:
            sink(out_d, n_d, orig_b)
        pending.append(
            (wait, orig_b, len(idx), int(sizes[idx].sum()), fb.status[: len(idx)])
        )
        if len(pending) >= 2:
            drain_one()
    while pending:
        drain_one()
    with trace_span("alac.host.unsort"):
        status = np.concatenate(sts)[inv] if sts else np.zeros(0, np.int32)
        if not outs:  # a sink took the PCM, or there were no frames
            return (
                np.zeros((0, max_samples, 2), np.int32),
                np.zeros(0, np.int32),
                status,
            )
        return _concat_channels(outs)[inv], np.concatenate(ns)[inv], status


def _concat_channels(outs: list) -> np.ndarray:
    """The batches' (B, S, C) samples as one array: a batch of frames of
    3-8 channels has the channels of its widest, so in a pool that mixes
    them with narrower ones each batch is widened (zeros) to the widest."""
    C = max(o.shape[2] for o in outs)
    if any(o.shape[2] != C for o in outs):
        outs = [o if o.shape[2] == C else np.pad(o, ((0, 0), (0, 0), (0, C - o.shape[2])))
                for o in outs]
    return np.concatenate(outs)


def _fetch_sharded(out: Sharded, n: Sharded, orig_b: int):
    """Start copying a batch's first ``orig_b`` lanes of (out, n) to the
    host; returns a callable that waits for them (``Sharded.fetch``)."""
    wo, wn = out.fetch(orig_b), n.fetch(orig_b)
    return lambda: (wo(), wn())


def decode_payloads(
    payloads: list[bytes],
    params: list[CodecParams] | CodecParams,
    max_samples: int,
    batch_limit: int = BATCH_BUCKETS[-1],
    config: DecodeConfig | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Parse + decode coded frame payloads in bucketed device batches.

    Returns (samples (F, S, C), n (F,) int32) across all frames, C as
    for :func:`decode_blob`.
    """
    config = resolve(config)
    outs, ns = [], []
    for lo in range(0, len(payloads), batch_limit):
        chunk = payloads[lo : lo + batch_limit]
        p = params if isinstance(params, CodecParams) else params[lo : lo + batch_limit]
        fb = parse_frame_headers_vec(chunk, p)
        out, n = decode_frame_batch(fb, max_samples, config)
        outs.append(out)
        ns.append(n)
    if not outs:
        return np.zeros((0, max_samples, 2), np.int32), np.zeros(0, np.int32)
    return _concat_channels(outs), np.concatenate(ns)
