#!/usr/bin/env python3
"""Benchmark of the PyTorch port on one CUDA card.

    python3 bench_torch.py [--repeats N] [--dispersion N] [--seed N]

Runs ``alacnet_tpu_torch.bench_lib.run_full_benchmark`` on the card: the
sustained ``decode_blob`` decode to host PCM over the mixed corpus (the
headline, ``value``), the six corpus kinds' device stages, and the
device encoder.  Prints the full record as one JSON line, then, as the
last line, a compact JSON summary of its headlines (under 2,000
characters).  Without a card it exits non-zero and prints no record.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5,
                    help="host-clock runs behind each e2e and encode median")
    ap.add_argument("--dispersion", type=int, default=5,
                    help="device timing runs behind each kind's median")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("bench_torch: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is False: this benchmark "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "alacnet_tpu_torch").is_dir():
        print(f"bench_torch: {ROOT} is not a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from alacnet_tpu_torch.bench_lib import run_full_benchmark, summary_line

    record = run_full_benchmark(repeats=args.repeats, dispersion=args.dispersion,
                                seed=args.seed)
    print(json.dumps(record), flush=True)
    print(summary_line(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
