"""Fixtures of the benchmark's CPU tests: a tiny checkout (``BENCHMARK.json``
with the benchmark's cells, its configurations cut to frames of 256
samples and tracks of a fraction of a second, and a copy of the
benchmark's folder), on which the harness runs the port's plain torch
versions on the host.

Run: ``python -m pytest benchmark/tests -q -o addopts= -p no:cacheprovider``.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys
import time

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: The cut that makes a configuration tiny: short tracks of short frames.
TINY = {"sample_rate": 8000, "frame_samples": 256, "tracks": 4,
        "track_seconds": [0.3, 0.5], "silence_seconds": [0.03, 0.06], "pool_frames": 8}
SEED = 2**31 + 977
#: The four-card cell, whose mix stays in ``traffic/`` for a later PR to
#: measure: its CPU rehearsal runs from that file and this entry.
FOUR_CARD = {"name": "cd16-library-decode-4card", "config": "cd16",
             "traffic": "library-decode-4card", "chips": 4, "why": "rehearsal"}
#: The encode cell, whose mix, entry and readers stay in the benchmark for a
#: later PR to measure (its rate spread too widely on the card for any bound,
#: PERF.md): its CPU rehearsal runs from those files and these entries.
ENCODE = {"name": "cd16-library-encode", "config": "cd16", "traffic": "library-encode",
          "chips": 1, "why": "rehearsal"}
ENCODE_METRICS = {
    "end_to_end": [{"name": "encode_msamples_per_s", "unit": "Msamples/s", "better": "higher",
                    "bound": 0.25, "source": "host_clock", "workloads": [ENCODE["name"]]}],
    "per_layer": [
        {"name": name, "unit": "%", "better": better, "source": "device_trace", "layer": layer,
         "moves": "encode_msamples_per_s", "workloads": [ENCODE["name"]]}
        for name, better, layer in [("enc_pred_roofline", "higher", "kernels"),
                                    ("enc_rice_roofline", "higher", "kernels"),
                                    ("device.idle_pct.encode", "lower", "device")]
    ],
}


def tiny_config(name: str) -> dict:
    c = json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())
    c.update(TINY)
    return c


@pytest.fixture
def checkout(tmp_path) -> pathlib.Path:
    """A checkout root whose configurations are tiny."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = f"benchmark/configs/tiny-{c['name']}.json"
        (tmp_path / path).write_text(json.dumps(tiny_config(c["name"])))
        c["file"] = path
    if FOUR_CARD["name"] not in {w["name"] for w in bench["workloads"]}:
        bench["workloads"].append(FOUR_CARD)
        for m in bench["end_to_end"] + bench["per_layer"]:  # those of every decode cell
            if {"cd16-library-decode", "hires24-library-decode"} <= set(m.get("workloads", [])):
                m["workloads"].append(FOUR_CARD["name"])
    if ENCODE["name"] not in {w["name"] for w in bench["workloads"]}:
        bench["workloads"].append(ENCODE)
        for kind, metrics in ENCODE_METRICS.items():
            bench[kind].extend(metrics)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def run_cell(root, workload: str, seed: int = SEED, seconds: float = 1.0, trace=False,
             answer=None) -> dict:
    from benchmark import harness

    return harness.run(root, workload, seed, seconds, trace, time.perf_counter(),
                       device="cpu", answer=answer)
