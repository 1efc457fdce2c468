"""Data parallelism over frames: a 1-D mesh of torch devices.

The counterpart of ``alacnet_tpu/parallel/mesh.py``.  ALAC frames are
independent (all decoder state is re-read from the bitstream per frame),
so the lane axis of a frame batch splits into contiguous equal shards,
one per mesh entry, and each shard runs the single-device decode or
encode on its own device.  Torch has no ``jax.sharding``: a
:class:`Mesh` is a tuple of devices, repeats allowed, with one CUDA
stream per shard, so two shards on one card run side by side.  A
shard's uploads, kernels and copies back are queued on its stream;
each stream first waits for whatever the device's current stream
queued before (the replicated blob).  The only reductions are the
accounting scalars (:func:`_decode_and_account`).

Results come back as :class:`Sharded`: one tensor per shard, in lane
order, with :meth:`Sharded.fetch` to copy them into one host array.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..ops.cuda.pack_rows import pack_rows
from ..ops.encode import RiceEncParams, encode_stages_pcm
from ..ops.frame_decode import FrameMetaArrays, decode_frames_packed
from ..ops.lpc import LpcParams
from ..utils.transfer import d2h_async, h2d

FRAME_AXIS = "frames"


class Mesh:
    """A 1-D frame-parallel mesh: one shard per entry of ``devices``.

    Devices may repeat (``["cuda:0", "cuda:0"]``: two shards, two
    streams on one card; ``["cpu"] * 8`` on a machine without one).
    All entries share one device type.  ``streams[i]`` is shard i's CUDA
    stream, or None on the CPU.
    """

    axis_names = (FRAME_AXIS,)

    def __init__(self, devices):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        f"a mesh over {d} needs a CUDA device, and "
                        "torch.cuda.is_available() is False"
                    )
                if d.index is None:
                    d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"a mesh spans one device type, got {devs}")
        self.devices = tuple(devs)
        self.streams = tuple(
            torch.cuda.Stream(device=d) if d.type == "cuda" else None
            for d in devs
        )

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    @contextlib.contextmanager
    def shard(self, i: int):
        """Run the block on shard ``i``: on CUDA, on its stream, after
        the work queued so far on its device's current stream."""
        s = self.streams[i]
        if s is None:
            yield self.devices[i]
            return
        s.wait_stream(torch.cuda.current_stream(self.devices[i]))
        with torch.cuda.stream(s):
            yield self.devices[i]

    def replicated(self, make) -> tuple:
        """``make(device)`` once per distinct device, on that device's
        current stream; one entry per shard.  Each copy is marked as in
        use by the shards' streams, so its memory outlives their work."""
        made: dict = {}
        for d in self.devices:
            if d not in made:
                made[d] = make(d)
        out = tuple(made[d] for d in self.devices)
        for t, s in zip(out, self.streams):
            if s is not None:
                t.record_stream(s)
        return out

    def lanes(self, batch: int) -> int:
        """Lanes per shard of a ``batch``-lane array; raises unless the
        shards are equal."""
        if batch % self.size:
            raise ValueError(
                f"{batch} lanes do not split into {self.size} equal shards "
                "(pad with parallel.pipeline.pad_frame_batch)"
            )
        return batch // self.size


def make_mesh(devices=None) -> Mesh:
    """A mesh over ``devices``, by default every visible CUDA device.

    Without a card the default raises: a mesh never moves to the CPU on
    its own (pass ``["cpu"] * k`` for that).
    """
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError(
                "make_mesh() spans every visible CUDA device, and there is "
                "none; pass devices=['cpu', ...] to shard over the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(devices)


class Sharded(NamedTuple):
    """A lane-sharded array: ``parts[i]`` lies on shard i's device and is
    ready on ``streams[i]`` (None on the CPU); concatenated in order
    along ``axis`` they are the global array."""

    parts: tuple
    streams: tuple
    axis: int = 0

    @property
    def shape(self) -> tuple:
        shape = list(self.parts[0].shape)
        shape[self.axis] = sum(p.shape[self.axis] for p in self.parts)
        return tuple(shape)

    def fetch(self, limit: int | None = None):
        """Start copying the first ``limit`` lanes (default all) to the
        host, each shard on its own stream straight into its own slice of
        one (pinned, on CUDA) host array; returns a callable that waits
        for every shard's copy and only then gives that NumPy array."""
        shape = list(self.shape)
        if limit is not None:
            shape[self.axis] = min(shape[self.axis], limit)
        cuda = self.parts[0].is_cuda
        host = torch.empty(shape, dtype=self.parts[0].dtype,
                           pin_memory=cuda and 0 not in shape)
        done, lo = [], 0
        for part, s in zip(self.parts, self.streams):
            keep = min(part.shape[self.axis], shape[self.axis] - lo)
            if keep <= 0:
                break
            with _on(s):
                _copy_into(host.narrow(self.axis, lo, keep),
                           part.narrow(self.axis, 0, keep))
                if cuda:
                    done.append(torch.cuda.Event())
                    done[-1].record()
            lo += keep

        def wait():
            for e in done:
                e.synchronize()
            return host.numpy()

        return wait

    def numpy(self, limit: int | None = None) -> np.ndarray:
        """The first ``limit`` lanes (default all) as one host array."""
        return self.fetch(limit)()


def _on(stream):
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def _copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, asynchronous from a CUDA ``src`` into pinned
    ``dst``: a strided ``dst`` (a shard's slice of a later axis) is
    copied one contiguous leading-axis row at a time."""
    if dst.is_contiguous():
        dst.copy_(src, non_blocking=src.is_cuda)
        return
    for d, s in zip(dst.unbind(0), src.unbind(0)):
        _copy_into(d, s)


def _shard_rows(rows: np.ndarray, mesh: Mesh) -> Sharded:
    """Upload each shard's slice of a (B, ...) host array on its stream."""
    b = mesh.lanes(rows.shape[0])
    parts = []
    for i in range(mesh.size):
        with mesh.shard(i) as dev:
            parts.append(h2d(rows[i * b : (i + 1) * b], dev))
    return Sharded(tuple(parts), mesh.streams)


def shard_frame_batch(fb, mesh: Mesh) -> tuple[Sharded, np.ndarray]:
    """Place a padded FrameBatch's word rows onto the mesh, lane axis
    sharded; returns (words, packed_meta).

    The metadata stays one host (B, 83) matrix
    (``FrameMetaArrays.pack_host``): each shard's decode uploads its
    slice and reads its host copy to pick the stages it runs.
    ``fb.batch`` must divide by the mesh size.
    """
    words = _shard_rows(np.ascontiguousarray(fb.words).view(np.int32), mesh)
    return words, FrameMetaArrays.pack_host(fb)


def decode_frames_spmd(
    words: Sharded, packed_meta: np.ndarray, mesh: Mesh, num_samples: int,
    emit16: bool = False, kernel: str = "auto",
) -> tuple[Sharded, Sharded]:
    """``decode_frames_packed`` on each shard: its rows from ``words``
    (:func:`shard_frame_batch`), its lanes of the host ``packed_meta``.
    Returns (out, n), sharded on the frame axis."""
    b = mesh.lanes(packed_meta.shape[0])
    outs, ns = [], []
    for i in range(mesh.size):
        with mesh.shard(i):
            out, n = decode_frames_packed(
                words.parts[i], packed_meta[i * b : (i + 1) * b], num_samples,
                emit16=emit16, kernel=kernel,
            )
        outs.append(out)
        ns.append(n)
    return Sharded(tuple(outs), mesh.streams), Sharded(tuple(ns), mesh.streams)


def decode_frames_spmd_rows(
    bwords, ow: np.ndarray, nbytes: np.ndarray, W: int, packed_meta: np.ndarray,
    mesh: Mesh, num_samples: int, emit16: bool = False, kernel: str = "auto",
) -> tuple[Sharded, Sharded]:
    """Sharded decode with the word rows cut on the devices
    (``config.device_pack``).

    ``bwords``: the (Nq, 128) blob words (``pack_rows.blob_words``) as
    the per-shard tuple of :meth:`Mesh.replicated` (one copy per
    distinct device).  Each shard uploads its lanes' (ow, nbytes) and
    metadata, cuts its own rows (``pack_rows``, kernel 1) and decodes
    them.  ``ow``/``nbytes``/``packed_meta`` are host arrays padded to
    the global lane count.
    """
    b = mesh.lanes(packed_meta.shape[0])
    rows = np.stack([ow, nbytes]).astype(np.int32)
    outs, ns = [], []
    for i in range(mesh.size):
        lo, hi = i * b, (i + 1) * b
        with mesh.shard(i) as dev:
            r = h2d(rows[:, lo:hi], dev)
            words = pack_rows(bwords[i], r[0], r[1], W, kernel=kernel)
            out, n = decode_frames_packed(
                words, packed_meta[lo:hi], num_samples, emit16=emit16,
                kernel=kernel,
            )
        outs.append(out)
        ns.append(n)
    return Sharded(tuple(outs), mesh.streams), Sharded(tuple(ns), mesh.streams)


def wrap_int32(x: int) -> int:
    """``x`` mod 2^32 as a signed int32, the value of JAX's wrapping
    int32 sum."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def local_accounting(out: Sharded, n: Sharded) -> tuple[int, int]:
    """(sum of n, sum of out mod 2^32) over this mesh's shards: each
    shard reduces on its stream in int64, the host adds the shards."""
    waits = []
    for o, m, s in zip(out.parts, n.parts, out.streams):
        with _on(s):
            waits.append(d2h_async(torch.stack([
                m.sum(dtype=torch.int64), o.sum(dtype=torch.int64),
            ])))
    sums = np.stack([w()[0] for w in waits]).sum(axis=0) if waits else (0, 0)
    return int(sums[0]), int(sums[1]) & 0xFFFFFFFF


def _decode_and_account(words: Sharded, packed_meta: np.ndarray, mesh: Mesh,
                        num_samples: int, kernel: str = "auto"):
    """Sharded decode plus the accounting reductions.

    Returns (out, n, total_samples, checksum): ``checksum`` is the int32
    sum of the padded output, wrapping mod 2^32 as the JAX package's
    does.  Synchronises: the scalars are read back.
    """
    out, n = decode_frames_spmd(words, packed_meta, mesh, num_samples, kernel=kernel)
    total, checksum = local_accounting(out, n)
    return out, n, total, wrap_int32(checksum)


def decode_frames_sharded(fb, mesh: Mesh, num_samples: int, kernel: str = "auto"):
    """Decode a FrameBatch across every shard of the mesh.

    Returns (samples (B, S, 2) and n (B,), each :class:`Sharded` on the
    frame axis, total_samples, checksum).  ``fb.batch`` must divide by
    the mesh size (use parallel.pipeline.pad_frame_batch).
    """
    words, meta = shard_frame_batch(fb, mesh)
    return _decode_and_account(words, meta, mesh, num_samples, kernel)


def encode_stages_pcm_spmd(
    pcm, stereo, n, lp: LpcParams, rp: RiceEncParams, mesh: Mesh,
    num_samples: int, max_order: int, lw: int, sh: int, ub8: int, wide: bool,
    kernel: str = "auto", pairs: bool = False,
) -> tuple[Sharded, ...]:
    """``ops/encode.encode_stages_pcm`` over a frame-sharded mesh.

    All inputs are host arrays: ``pcm`` (F, S, 2) int32, ``stereo``
    (F,), and ``n``, ``lp`` and ``rp`` in the flat (2F,) lane layout
    [channel A of every frame, channel B of every frame].  Each shard
    takes frames [i*f, (i+1)*f) and folds only its own channels, so its
    lane parameters travel as the (2, f) channel-major slice and its
    outputs come back as (2, f, ...).  Returns each output of
    ``encode_stages_pcm`` (six, or seven under ``pairs``) as a
    :class:`Sharded` on axis 1: concatenated, the global (2, F, ...)
    array, which reshapes for free to the packers' (2F, ...) layout.
    """
    F = pcm.shape[0]
    f = mesh.lanes(F)

    def two(x):
        x = np.asarray(x)
        return x.reshape(2, F, *x.shape[1:])

    lane_rows = [n, lp.order, lp.quant, lp.rss, rp.rss, rp.kmod,
                 rp.init_history, rp.mult, rp.kmask]
    cols = np.stack([two(x) for x in lane_rows]).astype(np.int32)  # (9, 2, F)
    rc = two(lp.rc).astype(np.int32)
    pcm = np.ascontiguousarray(pcm, np.int32)
    st = np.asarray(stereo).astype(np.uint8)
    outs = []
    for i in range(mesh.size):
        lo, hi = i * f, (i + 1) * f
        with mesh.shard(i) as dev:
            c = h2d(cols[:, :, lo:hi].reshape(len(lane_rows), 2 * f), dev)
            n_d, order, quant, rss, rrss, kmod, ihist, mult, kmask = c
            planes = encode_stages_pcm(
                h2d(pcm[lo:hi], dev), h2d(st[lo:hi], dev).to(torch.bool), n_d,
                LpcParams(order=order, quant=quant,
                          rc=h2d(rc[:, lo:hi].reshape(2 * f, -1), dev), rss=rss),
                RiceEncParams(rss=rrss, kmod=kmod, init_history=ihist,
                              mult=mult, kmask=kmask),
                num_samples, max_order=max_order, lw=lw, sh=sh, ub8=ub8,
                wide=wide, kernel=kernel, pairs=pairs,
            )
            outs.append([p.reshape(2, f, *p.shape[1:]) for p in planes])
    return tuple(
        Sharded(tuple(o[j] for o in outs), mesh.streams, axis=1)
        for j in range(len(outs[0]))
    )


def _tiny_corpus(num_frames: int, frame_samples: int):
    """The JAX package's dry-run corpus (``__graft_entry__._tiny_batch``):
    a tone in noise, its frames encoded by the host encoder."""
    from ..codec.cookie import default_cookie
    from ..codec.encoder import AlacEncoder, EncoderConfig

    params = default_cookie(44100, 16, 2, max_samples_per_frame=frame_samples)
    enc = AlacEncoder(params, EncoderConfig(order=4))
    rng = np.random.default_rng(7)
    t = np.arange(num_frames * frame_samples)
    pcm = np.stack(
        [
            np.clip(3000 * np.sin(t * 0.05) + rng.normal(0, 40, t.size), -32768, 32767),
            np.clip(2500 * np.sin(t * 0.067 + 1) + rng.normal(0, 40, t.size), -32768, 32767),
        ],
        axis=1,
    ).astype(np.int32)
    payloads = [
        enc.encode_frame(pcm[i * frame_samples : (i + 1) * frame_samples])
        for i in range(num_frames)
    ]
    return params, enc, pcm, payloads


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The JAX package's multi-chip dry run on the port, over an
    ``n_devices``-shard mesh (default: the first ``n_devices`` visible
    CUDA devices; ``["cpu"] * n`` or ``["cuda:0"] * n`` to repeat one).

    Three legs, each held to the host encoder's PCM or bytes:
    :func:`decode_frames_sharded` of 2n frames (PCM, total, checksum),
    ``decode_blob(mesh=)`` of the same frames, and
    ``encode_frames_device(mesh=)`` of 2n + 1 frames (a ragged chunk).
    Raises on any difference; returns the legs' counts.
    """
    from ..codec.encoder import EncoderConfig
    from ..codec.encoder_device import encode_frames_device
    from ..codec.framemeta_vec import parse_frame_headers_vec
    from .pipeline import decode_blob, pad_frame_batch

    mesh = make_mesh(devices)
    if mesh.size < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {mesh.size}")
    mesh = Mesh(mesh.devices[:n_devices])
    F, frame_samples = 2 * n_devices, 64
    params, enc, pcm, payloads = _tiny_corpus(F, frame_samples)

    fb = pad_frame_batch(parse_frame_headers_vec(payloads, params), F)
    out, n, total, checksum = decode_frames_sharded(fb, mesh, frame_samples)
    got = out.numpy()[:, :, :2].reshape(-1, 2)[: pcm.shape[0]]
    if not np.array_equal(got, pcm):
        raise RuntimeError("decode_frames_sharded: PCM differs from the source")
    if total != F * frame_samples:
        raise RuntimeError(f"decode_frames_sharded: total {total} != {F * frame_samples}")
    if checksum & 0xFFFFFFFF != int(pcm.astype(np.int64).sum()) & 0xFFFFFFFF:
        raise RuntimeError("decode_frames_sharded: checksum differs from the source's")

    sizes = np.array([len(p) for p in payloads], np.int64)
    offsets = np.concatenate(([0], np.cumsum(sizes)))[:-1]
    blob = np.frombuffer(b"".join(payloads), np.uint8)
    out2, _, status = decode_blob(blob, offsets, sizes, params, frame_samples, mesh=mesh)
    if status.any() or not np.array_equal(out2[:, :, :2].reshape(-1, 2), pcm):
        raise RuntimeError("decode_blob(mesh=): PCM differs from the source")

    frames3 = [pcm[i * frame_samples : (i + 1) * frame_samples] for i in range(F)]
    frames3.append(np.zeros((frame_samples, 2), np.int32))
    want3 = [enc.encode_frame(fr) for fr in frames3]
    got3 = encode_frames_device(frames3, params, EncoderConfig(order=4), mesh=mesh)
    if got3 != want3:
        raise RuntimeError("encode_frames_device(mesh=): bytes differ from the host encoder's")
    return {"shards": mesh.size, "devices": [str(d) for d in mesh.devices],
            "decoded_frames": F, "samples": total, "encoded_frames": len(got3)}
