"""The port's bench (``alacnet_tpu_torch.bench_lib``, ``capture_trace``,
the CLI's ``bench``) on the CPU: its corpora byte for byte against the
JAX package's, and its records at a tiny size (every device-timed field
``None``, the lossless gate holding, the counts the corpus's)."""

import functools
import json

import pytest

torch = pytest.importorskip("torch")

from alacnet_tpu import bench_lib as jax_bench  # noqa: E402
from alacnet_tpu_torch import bench_lib  # noqa: E402
from alacnet_tpu_torch.codec.cookie import default_cookie  # noqa: E402

#: Frames of the CPU records: the plain rice_lpc steps through every
#: sample of a span in Python.
S = 256


@pytest.mark.parametrize("kind", bench_lib.CORPUS_KINDS)
def test_corpus_frames_match_jax(kind):
    want, want_params = jax_bench.make_corpus_frames(num_distinct=4, frame_samples=S, kind=kind)
    got, params = bench_lib.make_corpus_frames(num_distinct=4, frame_samples=S, kind=kind)
    assert got == want
    assert (params.sample_size, params.sample_rate) == (
        want_params.sample_size, want_params.sample_rate)


@pytest.mark.parametrize("kind,seed", [("orders", 3), ("hires24", 11)])
def test_kind_frames_match_jax_at_another_seed(kind, seed):
    from alacnet_tpu.codec.cookie import default_cookie as jax_cookie

    bits = 24 if kind == "hires24" else 16
    want = jax_bench.make_kind_frames(kind, 7, S, jax_cookie(44100, bits, 2, S), bits, seed=seed)
    got = bench_lib.make_kind_frames(kind, 7, S, default_cookie(44100, bits, 2, S), bits, seed=seed)
    assert got == want


def test_music_at_another_order_matches_jax():
    want, _ = jax_bench.make_corpus_frames(num_distinct=3, frame_samples=S, order=4)
    got, _ = bench_lib.make_corpus_frames(num_distinct=3, frame_samples=S, order=4)
    assert got == want


def test_mixed_pool_matches_jax():
    want, _ = jax_bench._mixed_pool(S, 16)
    got, _ = bench_lib._mixed_pool(S, 16)
    assert len(got) == 48 and got == want


def test_source_pcm_encodes_to_the_payloads():
    """The lossless gate's reference: each frame's source PCM is what
    its payload was encoded from."""
    from alacnet_tpu_torch.codec.encoder import AlacEncoder, EncoderConfig

    pool, frames, params = bench_lib._mixed_pool_frames(S, 16)
    orders = [6] * 12 + [4] * 24 + [0, 1, 4, 8, 31] * 2 + [0, 1]
    for p, f, o in zip(pool, frames, orders):
        assert AlacEncoder(params, EncoderConfig(order=o)).encode_frame(f) == p


def _check_cpu_record(rec, fn):
    assert rec["device"] == "cpu"
    assert rec["parity_ok"] is True
    for key in bench_lib.DEVICE_FIELDS[fn]:
        assert key in rec and rec[key] is None, key
    assert rec["kernel_launches"] == {}
    json.dumps(rec)


@pytest.mark.parametrize("kind", ["orders", "hires24", "fat24"])
def test_run_benchmark_on_the_cpu(kind):
    rec = bench_lib.run_benchmark(batch=6, frame_samples=S, kind=kind, device="cpu")
    _check_cpu_record(rec, "run_benchmark")
    _, frames, params = bench_lib._corpus(num_distinct=6, frame_samples=S, kind=kind)
    assert rec["total_samples"] == sum(len(f) for f in frames)
    assert rec["batch_frames"] == 6 and rec["spans"] == 1 and rec["passes"] == bench_lib.PASSES
    assert rec["host_parse_s"] > 0 and rec["fused_kernel"] is False
    assert f"{params.sample_size}-bit" in rec["metric"]
    assert "dispersion" not in rec and rec["trace_file"] is None


def test_run_e2e_benchmark_on_the_cpu():
    rec = bench_lib.run_e2e_benchmark(total_frames=16, frame_samples=128, device="cpu")
    _check_cpu_record(rec, "run_e2e_benchmark")
    _, frames, _ = bench_lib._mixed_pool_frames(128, 16)
    # 16 of the 48 distinct frames, each once, in a shuffled order
    assert rec["e2e_total_samples"] == sum(len(f) for f in frames[:16])
    assert rec["e2e_total_frames"] == 16 and rec["overlap_dispatches"] == 1
    assert rec["e2e_repeats"] == bench_lib.MIN_REPEATS
    for key in ("e2e_runs_msps", "e2e_sink_runs_msps", "e2e_host_parse_runs_s"):
        assert len(rec[key]) == bench_lib.MIN_REPEATS
    lo, hi = rec["e2e_msps_quartiles"]
    assert min(rec["e2e_runs_msps"]) <= lo <= rec["e2e_msamples_per_s"] <= hi
    assert rec["e2e_sink_msamples_per_s"] > 0 and rec["host_inline_s"] > 0
    # int32 PCM: the span's pad lanes (16 -> 64) have no 16-bit format,
    # so emit16 stays off (ROADMAP, "emit16 is off for every padded span")
    assert rec["overlap_h2d_bytes"] > 0 and rec["e2e_d2h_bytes"] == 16 * (128 * 2 * 4 + 4)
    assert rec["e2e_trace_file"] is None and rec["e2e_profiled_wall_s"] > 0


def test_run_encode_benchmark_on_the_cpu():
    rec = bench_lib.run_encode_benchmark(num_frames=4, frame_samples=S, device="cpu")
    _check_cpu_record(rec, "run_encode_benchmark")
    assert rec["encode_frames"] == 4 and rec["encode_wall_frames"] == 4
    assert rec["encode_device_gate_frames"] == 4
    assert rec["encode_stage_kernel"] == "torch"
    for key in ("encode_prep_msps", "encode_dispatch_msps", "encode_pack_msps",
                "encode_pack_classic_msps", "encode_host_serial_msps", "encode_wall_msps"):
        assert rec[key] > 0, key
    assert len(rec["encode_wall_runs_msps"]) == bench_lib.MIN_REPEATS
    assert 0 < rec["encode_ratio"] < 1


def test_bench_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for run in (bench_lib.run_benchmark, bench_lib.run_e2e_benchmark,
                bench_lib.run_encode_benchmark, bench_lib.run_full_benchmark):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()


def test_cli_bench_prints_one_json_line(capsys, monkeypatch):
    from alacnet_tpu_torch import cli

    # The CLI runs 4096-sample frames; S-sample frames keep the plain
    # rice_lpc short here.
    monkeypatch.setattr(bench_lib, "run_benchmark",
                        functools.partial(bench_lib.run_benchmark, frame_samples=S))
    argv = ["bench", "--device", "cpu", "--batch", "4", "--kind", "silence",
            "--dispersion", "2"]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["device"] == "cpu" and rec["parity_ok"] is True and rec["batch_frames"] == 4
    assert "silence corpus" in rec["metric"] and rec["passes"] == bench_lib.PASSES


def test_encode_gate_holds_the_timed_stage(monkeypatch):
    """A wrong plane from the timed device stage (its warm-up: the first
    ``encode_stages_pcm`` call) fails the record's ``parity_ok``."""
    from alacnet_tpu_torch.ops import encode

    real, calls = encode.encode_stages_pcm, []

    def corrupt_first(*args, **kw):
        planes = real(*args, **kw)
        calls.append(kw.get("kernel"))
        if len(calls) == 1:
            planes[0][-1, 0] ^= 1
        return planes

    monkeypatch.setattr(encode, "encode_stages_pcm", corrupt_first)
    rec = bench_lib.run_encode_benchmark(num_frames=2, frame_samples=64, device="cpu")
    assert calls[:2] == ["auto", "torch"]  # the timed stage, then its reference
    assert rec["encode_device_gate_frames"] == 2
    assert rec["parity_ok"] is False


@pytest.mark.parametrize("mb,want", [(0.73, 144), (11.0, 10), (33.0, 4), (200.0, 3)])
def test_copies_keep_the_passes_out_of_the_l2(mb, want):
    nbytes = int(mb * 1e6)
    n = bench_lib._copies(nbytes)
    assert n == want and n >= bench_lib.COPIES
    assert n * nbytes >= 2 * bench_lib.L2_BYTES


def test_capture_trace_writes_a_chrome_trace(tmp_path):
    from alacnet_tpu_torch.utils.observability import capture_trace, trace_span

    with capture_trace(str(tmp_path)) as trace:
        with trace_span("alac.test.span"):
            torch.arange(10).sum()
    assert trace.path is not None and trace.path.startswith(str(tmp_path))
    events = json.loads(open(trace.path).read())["traceEvents"]
    assert any(e.get("name") == "alac.test.span" for e in events)


def test_profile_busy_measures_no_cpu_device():
    from alacnet_tpu_torch.utils.observability import profile_busy

    ran = []
    out = profile_busy(lambda: ran.append(1), "cpu")
    assert ran == [1] and out["profiled_wall_s"] >= 0
    assert out["device_busy_ms"] is None and out["device_busy_share"] is None
    assert out["device_ms_by_op"] is None and out["trace_file"] is None


def test_summary_line_is_compact():
    """bench_torch.py's last line stays one parseable JSON line under
    2,000 characters at full float precision."""
    x = 1234.5678901234567
    rec = {k: x for k in bench_lib.SUMMARY_FIELDS}
    rec.update(
        unit="Msamples/s", parity_ok=True, e2e_msps_quartiles=[x, x],
        device_msps_by_kind=dict.fromkeys(bench_lib.CORPUS_KINDS, x),
        device={"type": "cuda", "name": "NVIDIA H100 80GB HBM3",
                "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W", "count": 8},
        e2e_runs_msps=[x] * 50,
    )
    line = bench_lib.summary_line(rec)
    assert len(line) < 2000 and "\n" not in line
    assert json.loads(line)["device_msps_by_kind"]["fat24"] == x
    assert "e2e_runs_msps" not in json.loads(line)
