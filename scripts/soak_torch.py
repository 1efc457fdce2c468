"""Soak test of the PyTorch port: encode a mixed-format synthetic album on
the device, byte-check every file against the host encoder, then decode
the pool and check every file bit for bit; and the randomized frames of
the differential fuzz (:func:`fuzz_payloads`).

    python scripts/soak_torch.py [--minutes 10] [--outdir DIR] [--out x.json]
                                 [--device cuda]

The counterpart of ``scripts/soak.py`` (same six formats, same ``synth``
and seeds), with torch and NumPy only.  Formats: 16-bit stereo order 6,
16-bit mono order 31, 24-bit 96 kHz with extra bits, 48 kHz with the
mdat atom first, chunk gaps, 24-bit order 6.  Each file holds
``minutes * 60 / 6`` seconds of audio (10 minutes: 32,040,000 samples).
Path: ``encode_m4a(device=)`` (the ``enc_pred`` and ``enc_rice`` kernels
on a card, the native pair packer), the host ``AlacEncoder`` on the same
PCM, the muxer, then one pooled ``decode_files(device=)`` (``pack_rows``,
``rice_lpc`` and, for the extra-bits file, ``bulk_bits``).  Exits 0 when
every file matches.  ``run_soak`` is the function ``chip_smoke.py`` calls.

:func:`fuzz_payloads` is the generator of
``tests/test_fuzz_differential.py`` (structurally valid headers over
random entropy bodies, every order and quantisation, ``hassize`` short
frames, truncated and oversized bodies), with the port's ``BitWriter``:
the same seed gives the same bytes (``tests/test_torch_fuzz.py``).
:func:`fuzz_routes` decodes those frames through ``decode_frames`` on two
kernel routes and compares them lane by lane.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import alacnet_tpu_torch  # noqa: E402
from alacnet_tpu_torch.codec.bitwriter import BitWriter  # noqa: E402
from alacnet_tpu_torch.codec.cookie import default_cookie  # noqa: E402
from alacnet_tpu_torch.codec.encoder import EncoderConfig  # noqa: E402
from alacnet_tpu_torch.codec.framemeta_vec import parse_frame_headers_vec  # noqa: E402
from alacnet_tpu_torch.ops.bitreader import WINDOW_WORDS  # noqa: E402
from alacnet_tpu_torch.ops.cuda import _lib  # noqa: E402
from alacnet_tpu_torch.ops.frame_decode import FrameMetaArrays, decode_frames  # noqa: E402

#: (name, rate, bits, channels, encoder config, mux options): scripts/soak.py's.
SPECS = (
    ("t16s_o6", 44100, 16, 2, EncoderConfig(order=6), {}),
    ("t16m_o31", 44100, 16, 1, EncoderConfig(order=31), {}),
    ("t24s_eb", 96000, 24, 2, EncoderConfig(order=4, uncompressed_bytes=1), {}),
    ("t16s_mdat1", 48000, 16, 2, EncoderConfig(order=8), {"mdat_first": True}),
    ("t16s_gap", 44100, 16, 2, EncoderConfig(order=2), {"chunk_gap": 64}),
    ("t24s_o6", 44100, 24, 2, EncoderConfig(order=6), {}),
)


def synth(n: int, channels: int, bits: int, seed: int) -> np.ndarray:
    """Two drifting tones and a little noise, as scripts/soak.py makes them."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    amp = (1 << (bits - 1)) * 0.15
    f = 0.003 + 0.0005 * np.sin(t * 3e-5 + seed)
    chans = []
    for c in range(channels):
        sig = (
            amp * np.sin(np.cumsum(f) + c)
            + 0.4 * amp * np.sin(np.cumsum(2.1 * f))
            + rng.normal(0, amp * 0.015, n)
        )
        chans.append(sig)
    lim = 1 << (bits - 1)
    return np.clip(np.stack(chans, 1), -lim, lim - 1).astype(np.int32)


#: Samples a fuzz frame holds, and the orders and quantisations drawn.
FUZZ_SAMPLES = 64
FUZZ_ORDERS = (0, 1, 2, 4, 6, 8, 31)
FUZZ_QUANTS = (2, 9, 15)
#: (bits, frames, seed) of each fuzz batch.
FUZZ_BATCHES = ((16, 1536, 101), (24, 768, 202))


def _fuzz_payload(rng, bits: int, S: int) -> tuple[bytes, int]:
    """One compressed frame: a structurally valid header over a random
    entropy body.  Returns (payload, channels)."""
    stereo = rng.random() < 0.7
    nch = 2 if stereo else 1
    order = int(rng.choice(FUZZ_ORDERS))
    quant = int(rng.choice(FUZZ_QUANTS))
    hassize = rng.random() < 0.3
    n = int(rng.integers(1, S + 1)) if hassize else S
    ub = int(rng.integers(0, 2)) if bits == 24 else 0

    w = BitWriter()
    w.write(1 if stereo else 0, 3)
    w.write(0, 4)
    w.write(0, 12)
    w.write(1 if hassize else 0, 1)
    w.write(ub, 2)
    w.write(0, 1)  # compressed
    if hassize:
        w.write(n, 32)
    if stereo:
        w.write(int(rng.integers(0, 16)), 8)  # interlacing_shift
        w.write(int(rng.integers(0, 8)), 8)  # interlacing_leftweight
    else:
        w.write(0, 16)
    for _ in range(nch):
        w.write(0, 4)  # prediction type 0
        w.write(quant, 4)
        w.write(int(rng.integers(0, 8)), 3)  # rice modifier
        w.write(order, 5)
        for _ in range(31 if order == 31 else order):
            w.write(int(rng.integers(0, 1 << 16)), 16)
    # The body covers the extra-bits section too when ub > 0; its length
    # runs from heavily truncated to oversized.
    return w.getvalue() + rng.bytes(int(rng.integers(0, 3 * S))), nch


def fuzz_payloads(bits: int, count: int, seed: int, S: int = FUZZ_SAMPLES):
    """``count`` fuzz frames of ``bits``-bit audio from ``seed``.
    Returns (payloads, channels per frame, the stream's CodecParams)."""
    rng = np.random.default_rng(seed)
    params = default_cookie(96000 if bits == 24 else 44100, bits, 2,
                            max_samples_per_frame=S)
    frames = [_fuzz_payload(rng, bits, S) for _ in range(count)]
    return [p for p, _ in frames], [c for _, c in frames], params


def fuzz_routes(device: str = "cuda", routes=("cuda", "torch"), batches=FUZZ_BATCHES) -> list:
    """Each fuzz batch through ``decode_frames`` on ``device`` under both
    kernel ``routes``, compared lane by lane.

    A lane is clipped when, on either route, its channel-A or channel-B
    cursor (``decode_frames(return_ends=True)``, the cursors the decode
    itself produced) ends past word ``W - WINDOW_WORDS`` of its row: a read there
    reaches past the row's end, where the CUDA kernels clip each word to
    the row's last and the plain versions clip the read window's start,
    so the two may differ (the documented clip divergence).  Below it
    every read of both routes stays in the row.  Clipped lanes are
    counted, not compared.  Returns one record a batch.
    """
    recs = []
    for bits, count, seed in batches:
        payloads, _, params = fuzz_payloads(bits, count, seed)
        fb = parse_frame_headers_vec(payloads, params)
        words = torch.from_numpy(fb.words.view(np.int32)).to(device)
        meta = FrameMetaArrays.from_batch(fb, device)
        W = words.shape[1]
        got, clipped = [], np.zeros(count, bool)
        for kernel in routes:
            out, n, ends = decode_frames(words, meta, FUZZ_SAMPLES, kernel=kernel,
                                         return_ends=True)
            got.append((out.cpu().numpy().astype(np.int64), n.cpu().numpy()))
            for end in ends:
                clipped |= (end.cpu().numpy() >> 5) > W - WINDOW_WORDS
        (a, na), (b, nb) = got
        err = np.abs(a - b).reshape(count, -1).max(axis=1)
        keep = ~clipped
        recs.append({
            "bits": bits, "seed": seed, "lanes": count, "words": W,
            "compared": int(keep.sum()), "clipped": int(clipped.sum()),
            "clipped_differing": int((err[clipped] > 0).sum()),
            "max_abs_err": int(err[keep].max()) if keep.any() else 0,
            "n_equal": bool(np.array_equal(na, nb)),
            "equal": bool(np.array_equal(na, nb) and not err[keep].any()),
        })
    return recs


def _launches_since(before) -> dict:
    return {k: v - before.get(k, 0) for k, v in _lib.LAUNCHES.items() if v > before.get(k, 0)}


def run_soak(minutes: float = 10.0, outdir: str | None = None, device: str = "cuda",
             samples: int | None = None, frame_samples: int = 4096, log=print) -> dict:
    """Encode, byte-check, mux and pool-decode the six formats on ``device``.

    ``samples`` (default: ``int(minutes * 60 / 6)`` seconds at each
    file's rate) overrides every file's length, and ``frame_samples``
    the frame size, for short runs on the CPU.  Returns the JSON record;
    its ``all_ok`` holds when every file's device bytes equal the host
    encoder's and every decoded file equals its source.
    """
    own_dir = outdir is None
    outdir = tempfile.mkdtemp(prefix="alac_soak_") if own_dir else outdir
    os.makedirs(outdir, exist_ok=True)
    per_file_s = int(minutes * 60 / len(SPECS))
    paths, sources, files = [], [], []
    device_s = host_s = 0.0
    before = dict(_lib.LAUNCHES)
    t0 = time.perf_counter()
    for i, (name, rate, bits, ch, cfg, kw) in enumerate(SPECS):
        pcm = synth(samples if samples is not None else rate * per_file_s, ch, bits, seed=i)
        td = time.perf_counter()
        got = io.BytesIO()
        alacnet_tpu_torch.encode_m4a(got, pcm, rate, bits, cfg, frame_samples,
                                     device=device, **kw)
        th = time.perf_counter()
        want = io.BytesIO()
        alacnet_tpu_torch.encode_m4a(want, pcm, rate, bits, cfg, frame_samples, **kw)
        device_s += th - td
        host_s += time.perf_counter() - th
        equal = got.getvalue() == want.getvalue()
        if not equal:
            log(f"ENCODER MISMATCH: {name}")
        path = os.path.join(outdir, f"{name}.m4a")
        with open(path, "wb") as f:
            f.write(got.getvalue())
        paths.append(path)
        sources.append(pcm)
        files.append({"name": name, "samples": int(pcm.shape[0]),
                      "bytes": len(got.getvalue()), "host_bytes_equal": equal})
    encode_s = time.perf_counter() - t0
    encode_launches = _launches_since(before)
    total = sum(p.shape[0] for p in sources)
    enc_ok = all(f["host_bytes_equal"] for f in files)
    log(f"encoded {total} samples across {len(paths)} files in {encode_s:.3f}s "
        f"(device leg {device_s:.3f}s, host leg {host_s:.3f}s, "
        f"host==device bytes: {enc_ok})")

    before = dict(_lib.LAUNCHES)
    t0 = time.perf_counter()
    results = alacnet_tpu_torch.decode_files(paths, device=device)
    decode_s = time.perf_counter() - t0
    for f, r, src in zip(files, results, sources):
        f["bit_exact"] = bool(np.array_equal(r.pcm, src))
    dec_ok = all(f["bit_exact"] for f in files)
    log(f"decoded in {decode_s:.3f}s end to end ({total / decode_s / 1e6:.3f} "
        f"Msamples/s with the container and host work) bit_exact={dec_ok}")
    if own_dir:
        for p in paths:
            os.remove(p)
        os.rmdir(outdir)
    return {
        "device": device, "minutes": minutes, "files": files,
        "total_samples": int(total), "frame_samples": frame_samples,
        "encode_s": encode_s, "encode_device_s": device_s, "encode_host_s": host_s,
        "encode_device_msamples_per_s": total / device_s / 1e6,
        "encode_host_device_bytes_equal": enc_ok,
        "decode_s": decode_s, "decode_msamples_per_s": total / decode_s / 1e6,
        "decode_bit_exact": dec_ok, "all_ok": enc_ok and dec_ok,
        "launches": {"encode": encode_launches, "decode": _launches_since(before)},
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--outdir", default=None,
                    help="keep the encoded files here (default: a temporary directory)")
    ap.add_argument("--out", default=None, help="write the JSON record here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    rec = run_soak(args.minutes, args.outdir, args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")
        print(f"wrote {args.out}")
    return 0 if rec["all_ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
