"""Command-line interface of the PyTorch port.

The counterpart of ``alacnet_tpu/cli.py``:

    python -m alacnet_tpu_torch.cli info|decode|encode|batch-encode|
                                    batch-decode|verify|stats|bench ...

Metadata inspection, decode to WAV (whole, with the demo's
seek-to-middle through ``ALACFileReader``, or streamed in resumable
chunks), WAV to ALAC encode, pooled batch decode and encode, a lossless
round-trip check, the pipeline counters and the benchmarks
(``bench_lib``; one JSON line).  Every command that decodes or encodes
runs on ``--device`` (default ``cuda``, which raises without a card;
``cpu`` runs the kernels' plain torch versions); ``encode --host`` runs
the host encoder instead.  ``--mesh`` (``encode``, ``batch-encode``,
``batch-decode``) shards the frames over every visible device of
``--device``'s type (``parallel/mesh.py``).  ``--pack`` and ``--quads``
(``encode``, ``batch-encode``) choose who packs the payload bytes
(``codec/encoder_device.encode_frames_device``); the bytes are the same.
Left out, they and the kernel route take the ``ALAC_ENC_*`` variables
(``encoder_device.resolve_routes``).
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys
import time

import numpy as np


def _cmd_info(args) -> int:
    from .container.demux import parse

    with open(args.path, "rb") as f:
        info = parse(f)
    n = info.tables.num_samples()
    rate = info.sample_rate_or_default()
    print(f"file:          {args.path}")
    print(f"channels:      {info.num_channels_or_default()}")
    print(f"sample rate:   {rate} Hz")
    print(f"bits/sample:   {info.bits_per_sample_or_default()}")
    print(f"frames:        {info.tables.num_frames}")
    print(f"samples:       {n}")
    if n >= 0:
        print(f"duration:      {n / rate:.3f} s")
    print(f"max frame:     {info.params.max_frame_bytes} bytes")
    print(f"mdat:          {info.mdat_len} bytes @ {info.mdat_offset}")
    return 0


def _cmd_decode(args) -> int:
    from .batch import decode_file
    from .config import DecodeConfig
    from .pcm import write_wav
    from .reader import ALACFileReader

    config = DecodeConfig(device=args.device)
    t0 = time.perf_counter()
    if args.stream:
        # Bounded-memory path: decode in resumable chunks and stream the
        # WAV body, patching the RIFF sizes at the end.
        from .batch import DecodeCursor, decode_resumable
        from .container import demux
        from .pcm import format_pcm_bytes

        # Stream metadata up front (not from the first decoded chunk):
        # a zero-frame file must still produce a valid empty WAV.
        with open(args.path, "rb") as src:
            info = demux.parse(src)
        rate = info.sample_rate_or_default()
        bits = info.bits_per_sample_or_default()
        ch = info.num_channels_or_default()
        bps = -(-bits // 8)
        cursor = DecodeCursor(args.path)
        out_path = args.output or (args.path + ".wav")
        nsamples = 0
        with open(out_path, "wb") as f:
            write_wav(f, b"", rate, bits, ch)  # placeholder sizes
            while not cursor.done:
                part, cursor = decode_resumable(
                    cursor, max_frames=args.stream, config=config
                )
                f.write(format_pcm_bytes(part.pcm, bps))
                nsamples += part.num_samples
            data_len = nsamples * bps * ch
            f.seek(4)
            f.write(struct.pack("<I", 36 + data_len))
            f.seek(40)
            f.write(struct.pack("<I", data_len))
        dt = time.perf_counter() - t0
        print(
            f"streamed {nsamples} samples ({ch}ch {bits}-bit {rate} Hz) "
            f"to {out_path} in {dt:.3f}s"
        )
        return 0
    if args.seek_middle:
        # The streaming reader and a mid-stream reposition, like the
        # reference demo's seek to the middle.
        with open(args.path, "rb") as f:
            reader = ALACFileReader(f, config=config)
            reader.position = reader.length // 2
            data = reader.read(reader.length)
            reader.close()
            wf = reader.wave_format
            rate, bits, ch = wf.sample_rate, wf.bits_per_sample, wf.channels
            nsamples = len(data) // wf.block_align
            pcm: bytes | np.ndarray = data
    else:
        dec = decode_file(args.path, config=config)
        rate, bits, ch = dec.sample_rate, dec.bits_per_sample, dec.channels
        nsamples, pcm = dec.num_samples, dec.pcm
    dt = time.perf_counter() - t0
    if args.output:
        with open(args.output, "wb") as f:
            write_wav(f, pcm, rate, bits, ch)
    rt = (nsamples / rate) / dt if dt > 0 else float("inf")
    print(
        f"decoded {nsamples} samples ({ch}ch {bits}-bit {rate} Hz) "
        f"in {dt:.3f}s — {nsamples / dt / 1e6:.2f} Msamples/s "
        f"({rt:.0f}x realtime) on {args.device}"
    )
    return 0


def _mesh(args):
    """The mesh of ``--mesh``: every visible card for a CUDA ``--device``,
    the one CPU device for ``cpu``; None without the flag."""
    if not args.mesh:
        return None
    import torch

    from .parallel.mesh import make_mesh

    dev = torch.device(args.device)
    return make_mesh() if dev.type == "cuda" else make_mesh([dev])


def _cmd_encode(args) -> int:
    from .codec.encoder import EncoderConfig, encode_m4a
    from .pcm import read_wav

    with open(args.path, "rb") as f:
        pcm, rate, bits = read_wav(f)
    if args.bits:
        bits = args.bits
    cfg = EncoderConfig(order=args.order)
    t0 = time.perf_counter()
    with open(args.output, "wb") as f:
        encode_m4a(f, pcm, rate, bits, cfg, device=None if args.host else args.device,
                   mesh=None if args.host else _mesh(args), pack=args.pack,
                   quads=args.quads)
    dt = time.perf_counter() - t0
    ratio = os.path.getsize(args.output) / max(1, pcm.size * (bits // 8))
    print(f"encoded {pcm.shape[0]} samples in {dt:.3f}s — ratio {ratio:.3f}")
    return 0


def _unique_outputs(paths, out_dir: str, ext: str) -> list[str]:
    """One output path per input under ``out_dir``, named after the
    input's stem (``stem.1.ext``, ... for repeated stems)."""
    os.makedirs(out_dir, exist_ok=True)
    used: set[str] = set()
    outs = []
    for path in paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        name, k = stem + ext, 1
        while name in used:  # same basename from different dirs
            name = f"{stem}.{k}{ext}"
            k += 1
        used.add(name)
        outs.append(os.path.join(out_dir, name))
    return outs


def _cmd_batch_encode(args) -> int:
    """Encode many .wav files into .m4a in pooled device batches
    (codec.encoder.encode_files)."""
    from .codec.encoder import EncoderConfig, encode_files
    from .pcm import read_wav

    pcms, rates, bits_l = [], [], []
    for path in args.paths:
        with open(path, "rb") as f:
            pcm, rate, bits = read_wav(f)
        pcms.append(pcm)
        rates.append(rate)
        bits_l.append(args.bits or bits)
    outs = _unique_outputs(args.paths, args.out_dir, ".m4a")
    cfg = EncoderConfig(order=args.order)
    t0 = time.perf_counter()
    encode_files(pcms, outs, rates, bits_l, cfg, device=args.device, mesh=_mesh(args),
                 pack=args.pack, quads=args.quads)
    dt = time.perf_counter() - t0
    total = sum(p.shape[0] for p in pcms)
    coded = sum(os.path.getsize(o) for o in outs)
    raw = sum(p.size * (b // 8) for p, b in zip(pcms, bits_l))
    print(
        f"encoded {len(pcms)} files, {total} samples in {dt:.3f}s — "
        f"{total / dt / 1e6:.2f} Msamples/s, ratio {coded / max(1, raw):.3f}"
    )
    return 0


def _cmd_batch_decode(args) -> int:
    """Decode many .m4a files in pooled device batches -> .wav files
    (batch.decode_files)."""
    from .batch import decode_files
    from .pcm import write_wav

    t0 = time.perf_counter()
    results = decode_files(args.paths, strict=not args.lenient, device=args.device,
                           mesh=_mesh(args))
    dt = time.perf_counter() - t0
    total = sum(r.num_samples for r in results)
    bad = sum(len(r.bad_frames) for r in results)
    if args.out_dir:
        for r, out in zip(results, _unique_outputs(args.paths, args.out_dir, ".wav")):
            with open(out, "wb") as f:
                write_wav(f, r.pcm, r.sample_rate, r.bits_per_sample, r.channels)
    print(
        f"decoded {len(results)} files, {total} samples in {dt:.3f}s — "
        f"{total / dt / 1e6:.2f} Msamples/s"
        + (f", {bad} bad frames skipped" if bad else "")
        + (f", wavs in {args.out_dir}" if args.out_dir else "")
    )
    return 0


def _cmd_verify(args) -> int:
    """Decode, losslessly re-encode, decode again, compare bit for bit,
    all on ``--device``."""
    import io

    from .batch import decode_file, decode_streams
    from .codec.encoder import EncoderConfig, encode_m4a

    dec = decode_file(args.path, device=args.device)
    buf = io.BytesIO()
    encode_m4a(
        buf, dec.pcm.astype(np.int32), dec.sample_rate, dec.bits_per_sample,
        EncoderConfig(order=args.order), device=args.device,
    )
    buf.seek(0)
    (redec,) = decode_streams([buf], device=args.device)
    ok = np.array_equal(redec.pcm, dec.pcm)
    ratio = buf.getbuffer().nbytes / max(
        1, dec.pcm.size * (dec.bits_per_sample // 8)
    )
    print(
        f"{'OK' if ok else 'MISMATCH'}: {dec.num_samples} samples, "
        f"re-encode ratio {ratio:.3f}"
        + (f", {len(dec.bad_frames)} bad frames" if len(dec.bad_frames) else "")
    )
    return 0 if ok else 1


def _cmd_stats(args) -> int:
    """Decode file(s) and print the pipeline counters: frames, samples,
    bytes, batches, the PCM copied back, and each span's seconds and
    count."""
    from .batch import decode_files
    from .utils.observability import GLOBAL_STATS

    GLOBAL_STATS.reset()
    results = decode_files(args.paths, device=args.device)
    total = sum(r.num_samples for r in results)
    print(json.dumps({"files": len(results), "samples": total,
                      **GLOBAL_STATS.snapshot()}))
    return 0


def _cmd_bench(args) -> int:
    """One benchmark record as one JSON line."""
    from .bench_lib import run_benchmark, run_e2e_benchmark, run_full_benchmark

    seeds = {} if args.seed is None else {"seed": args.seed}
    if args.full:
        result = run_full_benchmark(repeats=args.repeats, dispersion=args.dispersion,
                                    device=args.device, trace_dir=args.trace, **seeds)
    elif args.e2e:
        result = run_e2e_benchmark(repeats=args.repeats, device=args.device,
                                   trace_dir=args.trace, **seeds)
    else:
        result = run_benchmark(
            batch=args.batch, seconds_of_audio=args.seconds, bits=args.bits,
            repeats=args.repeats, kind=args.kind, dispersion=args.dispersion,
            device=args.device, trace_dir=args.trace, **seeds,
        )
    print(json.dumps(result))
    return 0


def _device_arg(p, help_: str) -> None:
    p.add_argument("--device", default="cuda", help=help_)


def _mesh_arg(p) -> None:
    p.add_argument(
        "--mesh", action="store_true",
        help="shard the frames over every visible device of --device's type",
    )


def _pack_args(p) -> None:
    from .codec.encoder_device import PACK_CHOICES

    p.add_argument(
        "--pack", choices=PACK_CHOICES, default=None,
        help="who packs the payload bytes: the host's pair packer, or the "
        "device (scatter or gather); the bytes are the same (default: "
        "ALAC_ENC_DEVICE_PACK and ALAC_ENC_PACK_IMPL, else host)",
    )
    p.add_argument(
        "--quads", action="store_true", default=None,
        help="pack one field per four samples on the host pair path "
        "(default: ALAC_ENC_QUAD=1, else off)",
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="alac-tpu-torch",
        description="batch ALAC codec on PyTorch and CUDA "
        "(info/decode/encode/batch-encode/batch-decode/verify/stats/bench)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    on_dev = "torch device of the decode (default cuda; cpu runs the plain versions)"

    p = sub.add_parser("info", help="print stream metadata")
    p.add_argument("path")
    p.set_defaults(fn=_cmd_info)

    p = sub.add_parser("decode", help="decode .m4a to .wav")
    p.add_argument("path")
    p.add_argument("output", nargs="?", default=None)
    p.add_argument(
        "--seek-middle", action="store_true",
        help="reposition to the stream middle first (demo parity)",
    )
    p.add_argument(
        "--stream", type=int, nargs="?", const=4096, default=0,
        metavar="FRAMES",
        help="bounded-memory streaming decode, FRAMES frames per chunk",
    )
    _device_arg(p, on_dev)
    p.set_defaults(fn=_cmd_decode)

    p = sub.add_parser("encode", help="encode .wav to .m4a (lossless)")
    p.add_argument("path")
    p.add_argument("output")
    p.add_argument("--order", type=int, default=6)
    p.add_argument("--bits", type=int, default=0)
    _device_arg(p, "torch device of the encode stages (default cuda)")
    p.add_argument(
        "--host", action="store_true",
        help="encode with the host encoder instead of on --device",
    )
    _mesh_arg(p)
    _pack_args(p)
    p.set_defaults(fn=_cmd_encode)

    p = sub.add_parser(
        "batch-encode",
        help="encode many .wav files into .m4a in pooled device batches",
    )
    p.add_argument("paths", nargs="+")
    p.add_argument("--out-dir", required=True, help="one .m4a per input")
    p.add_argument("--order", type=int, default=6)
    p.add_argument("--bits", type=int, default=0, help="override the WAV bit depth")
    _device_arg(p, "torch device of the encode stages (default cuda)")
    _mesh_arg(p)
    _pack_args(p)
    p.set_defaults(fn=_cmd_batch_encode)

    p = sub.add_parser(
        "batch-decode", help="decode many .m4a files in pooled device batches"
    )
    p.add_argument("paths", nargs="+")
    p.add_argument("--out-dir", default=None, help="write one .wav per input")
    p.add_argument(
        "--lenient", action="store_true",
        help="skip undecodable frames instead of raising",
    )
    _device_arg(p, on_dev)
    _mesh_arg(p)
    p.set_defaults(fn=_cmd_batch_decode)

    p = sub.add_parser(
        "verify", help="decode -> lossless re-encode -> compare bit-for-bit"
    )
    p.add_argument("path")
    p.add_argument("--order", type=int, default=6)
    _device_arg(p, "torch device of the decodes and the re-encode (default cuda)")
    p.set_defaults(fn=_cmd_verify)

    p = sub.add_parser("stats", help="decode files; print the counters and each span's seconds")
    p.add_argument("paths", nargs="+")
    _device_arg(p, on_dev)
    p.set_defaults(fn=_cmd_stats)

    p = sub.add_parser("bench", help="decode/encode throughput benchmark")
    p.add_argument("--batch", type=int, default=1024, help="frames of the kind run")
    p.add_argument(
        "--seconds", type=float, default=None,
        help="size the kind run in seconds of 44.1 kHz audio instead of --batch",
    )
    p.add_argument("--bits", type=int, default=16)
    p.add_argument(
        "--repeats", type=int, default=5,
        help="host-clock runs behind each e2e and encode median, and passes "
        "of each device timing run (at least 5)",
    )
    p.add_argument(
        "--dispersion", type=int, default=5,
        help="device timing runs behind each kind's median (default 5)",
    )
    p.add_argument(
        "--kind", default="music",
        help="corpus kind: music|spiky|silence|orders|hires24|fat24",
    )
    p.add_argument(
        "--e2e", action="store_true",
        help="sustained decode_blob to host PCM over the mixed corpus",
    )
    p.add_argument(
        "--full", action="store_true",
        help="e2e + per-kind device stages + encode, one record",
    )
    p.add_argument("--seed", type=int, default=None,
                   help="corpus seed (default: each benchmark's own)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write one run's Chrome trace (capture_trace) into DIR")
    _device_arg(p, "torch device of the benchmark (default cuda; cpu is untimed)")
    p.set_defaults(fn=_cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
