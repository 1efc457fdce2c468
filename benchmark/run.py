"""The benchmark of ``alacnet_tpu_torch`` on CUDA cards: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (the program's kernels built or
loaded from their cache in the checkout, the cell's inputs made from
the seed, a warm-up with the cell's own requests) is timed from the
process's start as ``setup_s``; then the cell's traffic runs for
``--seconds``, every answer is checked against the benchmark's plain
reference, and the last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, read
under ``torch.profiler``), ``device`` and, last, ``checks``: each number
compared with its limit, which also close standard error.

Without the cell's CUDA cards, with a module of JAX or of the JAX
package loaded, or outside a checkout of the program, it prints no
result and exits non-zero.  See PERF.md for the cells and metrics.
"""

from __future__ import annotations

import time


def _process_start() -> float:
    """``time.perf_counter()`` at this process's start (from /proc), or now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import os

        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the checkout's root, in place of this script's folder (whose module
    # names would shadow others)
    sys.path[:] = [str(ROOT)] + [x for x in sys.path if pathlib.Path(x or ".").resolve()
                                 != pathlib.Path(__file__).resolve().parent]
    try:
        from benchmark import harness

        harness.keep_freed_memory()
        result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                             bool(args.trace), T0)
    except ImportError as e:
        print(f"cannot run: {e}", file=sys.stderr)
        return 2
    except harness.HarnessError as e:
        print(f"cannot run: {e}", file=sys.stderr)
        return 2
    except Exception as e:  # noqa: BLE001 - the run reports nothing and fails
        import traceback

        traceback.print_exc()
        print(f"cannot run: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"modules loaded that the run may not load: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
