"""The harness: cells found by name, a new cell from new files alone, the
closed loop's schedule, and the run's refusals (no card, JAX loaded)."""

from __future__ import annotations

import io
import json
import pathlib
import subprocess
import sys
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
from conftest import REPO, run_cell, tiny_config

from benchmark import harness


def test_every_cell_loads_with_its_readers():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.load_cell(REPO, w["name"])
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m.spec["moves"] in names


def test_new_cell_from_new_files_only(checkout):
    """A configuration, a traffic mix and a metric added as new files, and
    a cell naming them in BENCHMARK.json, run with no other edit."""
    before = {p: p.read_bytes() for p in (checkout / "benchmark").rglob("*") if p.is_file()}
    c = tiny_config("cd16")
    c.update(channels=1, orders=[8])
    (checkout / "benchmark" / "configs" / "mono16.json").write_text(json.dumps(c))
    (checkout / "benchmark" / "traffic" / "pair-decode.json").write_text(json.dumps(
        {"entry": "decode_streams", "tracks_per_request": 2, "mesh_cards": 0}))
    (checkout / "benchmark" / "metrics" / "decode_tracks_per_s.py").write_text(
        'UNIT = "tracks/s"\nBETTER = "higher"\nSOURCE = "host_clock"\n\n'
        "def read(w):\n    return sum(len(r.tracks) for r in w.requests) / w.seconds\n")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mono16", "source": "test", "reduced": [], "why": "test",
                             "file": "benchmark/configs/mono16.json"})
    bench["workloads"].append({"name": "mono16-pair-decode", "config": "mono16",
                               "traffic": "pair-decode", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "decode_tracks_per_s", "unit": "tracks/s",
                                "better": "higher", "bound": 0.1, "source": "host_clock",
                                "workloads": ["mono16-pair-decode"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run_cell(checkout, "mono16-pair-decode")
    assert r["correct"], r
    assert r["metrics"]["decode_tracks_per_s"]["value"] > 0
    assert set(r["metrics"]) == {"decode_tracks_per_s", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_reader_must_agree_with_benchmark_json(checkout):
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["end_to_end"][0]["unit"] = "samples/s"
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(harness.HarnessError, match="unit"):
        harness.load_cell(checkout, bench["end_to_end"][0]["workloads"][0])


def test_schedule_deals_every_track_equally():
    for per in (1, 2, 8):
        s = harness.schedule(16, per, np.random.default_rng(5))
        sent = [t for _ in range(64 // per) for t in next(s)]
        assert np.bincount(sent, minlength=16).tolist() == [4] * 16
    a = harness.schedule(16, 1, np.random.default_rng(1))
    b = harness.schedule(16, 1, np.random.default_rng(2))
    assert [next(a) for _ in range(16)] != [next(b) for _ in range(16)]


def test_import_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules(["alacnet_tpu_torch", "alacnet_tpu_torch.batch"]) == []
    assert harness.forbidden_modules(["alacnet_tpu.ops.rice", "numpy"]) == ["alacnet_tpu"]
    assert harness.forbidden_modules(["jaxlib.xla_client", "jax"]) == ["jax", "jaxlib"]
    assert harness.forbidden_modules(["flax.linen", "jaxtyping"]) == ["flax"]


def _main_with(monkeypatch, capsys, planted: str | None) -> tuple[int, str]:
    """``run.main`` with the run itself stubbed out and ``planted`` in
    ``sys.modules``."""
    sys.path.insert(0, str(REPO / "benchmark"))
    try:
        import run as run_script
    finally:
        sys.path.pop(0)
    result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
              "device": {}, "checks": {"wrong_samples": {"value": 0, "limit": 0}}}
    monkeypatch.setattr(harness, "run", lambda *a, **k: result)
    monkeypatch.setattr(harness, "keep_freed_memory", lambda: True)
    if planted:
        monkeypatch.setitem(sys.modules, planted, types.ModuleType(planted))
    monkeypatch.setattr(sys, "path", list(sys.path))
    out = io.StringIO()
    with redirect_stdout(out):
        code = run_script.main(["--workload", "x", "--seed", "1", "--seconds", "1"])
    return code, out.getvalue()


def test_run_refuses_a_loaded_jax_package(monkeypatch, capsys):
    code, out = _main_with(monkeypatch, capsys, "alacnet_tpu")
    assert code != 0 and out == ""
    assert "alacnet_tpu" in capsys.readouterr().err


def test_run_passes_the_port_alone(monkeypatch, capsys):
    code, out = _main_with(monkeypatch, capsys, "alacnet_tpu_torch")
    assert code == 0
    assert json.loads(out.strip().splitlines()[-1])["correct"] is True
    assert capsys.readouterr().err.strip().splitlines()[-1] == "check wrong_samples: 0 (limit 0)"


def test_allocator_keeps_freed_memory():
    """glibc takes the settings (in a process of its own: they are global)."""
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import harness; "
            "print(harness.keep_freed_memory())")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "True"


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command exits non-zero and prints no result
    (this host has none)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cd16-library-decode",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_outside_a_checkout_no_result(tmp_path):
    """A folder with BENCHMARK.json and the benchmark alone (no program)."""
    import shutil

    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cd16-library-decode",
         "--seed", "7", "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("workload", ["cd16-library-decode", "cd16-library-encode"])
def test_traced_run_reads_its_window(checkout, workload):
    r = run_cell(checkout, workload, trace=True)
    assert r["correct"], r
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # a CPU run has no device: no roofline or idle share is read from it
    assert not any(k.endswith("_roofline") or "idle" in k for k in r["metrics"])

