"""Write the smoke corpus of the PyTorch port: tests/fixtures/torch_smoke/.

The machine that runs the port on a GPU has no JAX, so neither the JAX
package's encoder nor its decoder can make or check the port's input
there.  This script runs where the JAX package runs (its CPU backend
suffices) and commits what the port needs:

* one ``<kind>.m4a`` per bench corpus kind (``bench_lib.CORPUS_KINDS``:
  music, spiky, silence, orders, hires24, fat24), 16 distinct
  4096-sample frames each (8 for fat24), made by
  ``bench_lib.make_corpus_frames`` and muxed with
  ``container.mux.write_m4a``;
* ``raw16.m4a`` — uncompressed frames (``EncoderConfig(
  force_uncompressed=True)``), the raw ``bulk_bits`` path;
* ``mono16.m4a`` — mono frames, the path that skips channel B;
* ``expected.json`` — per file the frame count, the sample count and the
  sha256 of the PCM that ``alacnet_tpu.decode_file`` returns (``(N,
  channels)``, C order, little-endian, in the dtype it returns);
* ``encode_expected.json`` — per (file, encoder config) key
  ``"<file>|<config>"`` the frame count, the byte size and the sha256 of
  the ``.m4a`` that ``alacnet_tpu.encode_files(device=True)`` writes from
  that file's decoded PCM: config ``default`` (``EncoderConfig()``) for
  every file, ``ub1`` (``EncoderConfig(uncompressed_bytes=1)``, the
  extra-bits plane) for the 24-bit ones.  The port's encoder must write
  the same bytes.

Run from the repository root:

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_corpus.py

Re-running it must reproduce the committed bytes (the generators are
seeded); ``--check`` exits non-zero if any file would change.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
OUT = ROOT / "tests" / "fixtures" / "torch_smoke"
FRAME_SAMPLES = 4096


def _frames_and_params():
    from alacnet_tpu import bench_lib
    from alacnet_tpu.codec.cookie import default_cookie
    from alacnet_tpu.codec.encoder import AlacEncoder, EncoderConfig

    out = {}
    for kind in bench_lib.CORPUS_KINDS:
        n = 8 if kind == "fat24" else 16
        out[kind] = bench_lib.make_corpus_frames(
            num_distinct=n, frame_samples=FRAME_SAMPLES, kind=kind
        )
    rng = np.random.default_rng(11)
    params = default_cookie(44100, 16, 2, FRAME_SAMPLES)
    pcm = bench_lib._music_pcm(16 * FRAME_SAMPLES, 16, 2, rng)
    enc = AlacEncoder(params, EncoderConfig(force_uncompressed=True))
    out["raw16"] = (
        [enc.encode_frame(pcm[i * FRAME_SAMPLES : (i + 1) * FRAME_SAMPLES])
         for i in range(16)],
        params,
    )
    mono = default_cookie(44100, 16, 1, FRAME_SAMPLES)
    out["mono16"] = (
        bench_lib.make_kind_frames(
            "music", 16, FRAME_SAMPLES, mono, bits=16, channels=1, seed=5
        ),
        mono,
    )
    return out


def build() -> dict[str, bytes]:
    """{file name: bytes} of the whole corpus, expected.json included."""
    import alacnet_tpu
    from alacnet_tpu.codec.framemeta_vec import parse_frame_headers_vec
    from alacnet_tpu.container.mux import write_m4a

    files, expected = {}, {}
    for name, (frames, params) in _frames_and_params().items():
        durations = parse_frame_headers_vec(
            frames, params, pack_words=False
        ).n_samples.tolist()
        buf = io.BytesIO()
        write_m4a(buf, params, frames, durations)
        data = buf.getvalue()
        fname = f"{name}.m4a"
        files[fname] = data
        pcm = alacnet_tpu.decode_streams([io.BytesIO(data)])[0].pcm
        pcm = np.ascontiguousarray(pcm, pcm.dtype.newbyteorder("<"))
        expected[fname] = {
            "frames": len(frames),
            "samples": int(sum(durations)),
            "shape": list(pcm.shape),
            "dtype": str(pcm.dtype.newbyteorder("=")),
            "sha256": hashlib.sha256(pcm.tobytes()).hexdigest(),
        }
    files["expected.json"] = (
        json.dumps(expected, indent=1, sort_keys=True) + "\n"
    ).encode()
    files["encode_expected.json"] = (
        json.dumps(_encode_expected(files), indent=1, sort_keys=True) + "\n"
    ).encode()
    return files


#: Encoder configurations of encode_expected.json, and the files each
#: covers (None: every file).
ENCODE_CONFIGS = {
    "default": ({}, None),
    "ub1": ({"uncompressed_bytes": 1}, ("hires24.m4a", "fat24.m4a")),
}


def _encode_expected(files: dict[str, bytes]) -> dict:
    """Encode every corpus file's decoded PCM with the JAX package's
    pooled device encoder (one encode_files call per configuration)."""
    import alacnet_tpu
    from alacnet_tpu.codec.encoder import EncoderConfig

    names = sorted(f for f in files if f.endswith(".m4a"))
    decoded = dict(zip(names, alacnet_tpu.decode_streams(
        [io.BytesIO(files[n]) for n in names]
    )))
    out = {}
    for cfg_name, (kwargs, only) in ENCODE_CONFIGS.items():
        sel = [n for n in names if only is None or n in only]
        bufs = [io.BytesIO() for _ in sel]
        alacnet_tpu.encode_files(
            [decoded[n].pcm for n in sel], bufs,
            [decoded[n].sample_rate for n in sel],
            [decoded[n].bits_per_sample for n in sel],
            config=EncoderConfig(**kwargs), device=True,
        )
        for n, buf in zip(sel, bufs):
            data = buf.getvalue()
            out[f"{n}|{cfg_name}"] = {
                "frames": -(-decoded[n].pcm.shape[0] // FRAME_SAMPLES),
                "bytes": len(data),
                "sha256": hashlib.sha256(data).hexdigest(),
            }
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="compare with the committed files, write nothing")
    args = ap.parse_args()
    files = build()
    if args.check:
        stale = [f for f, b in files.items()
                 if not (OUT / f).exists() or (OUT / f).read_bytes() != b]
        print("stale:" if stale else "up to date", *stale)
        return 1 if stale else 0
    OUT.mkdir(parents=True, exist_ok=True)
    for f, b in files.items():
        (OUT / f).write_bytes(b)
    total = sum(len(b) for b in files.values())
    print(f"wrote {len(files)} files, {total} bytes, to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
