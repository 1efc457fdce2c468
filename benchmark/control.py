"""The control of a cell: the benchmark's reference put in the program's
place at the precision below the configuration's (each sample's low byte
dropped), through the whole harness at the cell's own size, on several
seeds.  Its check numbers are the upper readings the limits are set
against; ``correct`` has to come out false on every seed.

    python3 benchmark/control.py --workload <cell> --requests <n> --seeds <s> [<s> ...]

``--requests``: as many as a measured run of the cell completes.  Needs
the cell's CUDA cards, as a measured run does (the control itself runs
on the host).  Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--requests", type=int, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path[:] = [str(ROOT)] + [x for x in sys.path if pathlib.Path(x or ".").resolve()
                                 != pathlib.Path(__file__).resolve().parent]
    from benchmark import harness

    refused = 0
    for seed in args.seeds:
        r = harness.run(ROOT, args.workload, seed, 3600.0, False, time.perf_counter(),
                        answer="control", max_requests=args.requests)
        refused += not r["correct"]
        print(json.dumps({"seed": seed, "correct": r["correct"], "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    return 0 if refused == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
