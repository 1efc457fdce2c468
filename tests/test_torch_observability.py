"""The port's decode spans and counters, on the CPU at a tiny size:
every stage of a ``decode_streams`` request under its own
``trace_span`` (a ``torch.profiler`` range), each span's seconds and
count in ``GLOBAL_STATS``, and the same PCM with the profiler on and off.

Frames of 64 samples and batches of 4 lanes keep the plain torch
versions' per-sample loops, and the profiler's events, few.
"""

import collections
import io
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import alacnet_tpu_torch  # noqa: E402
from alacnet_tpu.codec.encoder import EncoderConfig  # noqa: E402
from alacnet_tpu_torch import batch  # noqa: E402
from alacnet_tpu_torch import cli as tcli  # noqa: E402
from alacnet_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from alacnet_tpu_torch.parallel.pipeline import plan_blob_batches  # noqa: E402
from alacnet_tpu_torch.utils.observability import (  # noqa: E402
    GLOBAL_STATS, capture_trace, trace_span,
)

from .corpus import encode_to_bytes, tone  # noqa: E402

FS = 64  # samples per frame
LIMIT = 4  # lanes per batch
SHARDS = 4
#: The decode's spans, outermost first where they nest: a decode without
#: a mesh runs on a mesh of one shard, so it holds shard 0's too.
SPANS = ["alac.host.demux", "alac.host.parse", "alac.host.enqueue",
         "alac.host.enqueue.shard0", "alac.host.h2d", "alac.device.result_wait",
         "alac.host.unsort", "alac.host.assembly"]


@pytest.fixture(scope="module")
def files():
    """Two stereo 16-bit files of 5 and 6 frames, the last one partial."""
    return [encode_to_bytes(tone(FS * k + 9, 2, 16, seed=k), 44100, 16,
                            EncoderConfig(order=6), max_samples_per_frame=FS)
            for k in (4, 5)]


def config():
    return alacnet_tpu_torch.DecodeConfig(device="cpu", batch_limit=LIMIT)


def decode(files, mesh=None):
    return alacnet_tpu_torch.decode_streams([io.BytesIO(d) for d in files],
                                            config=config(), mesh=mesh)


def batches(files) -> int:
    """The batches the decode plans for the pooled files."""
    _, _, pooled, params = batch._pool([io.BytesIO(d) for d in files])
    return len(plan_blob_batches(*pooled, params, LIMIT, strict=True)[2])


def traced(files, mesh=None):
    """The decode under ``capture_trace``: its results and the number of
    each ``alac.*`` range in the trace."""
    with capture_trace(None) as trace:
        out = decode(files, mesh)
    names = (e.name() for e in trace.profiler.profiler.kineto_results.events())
    return out, collections.Counter(n for n in names if n.startswith("alac."))


@pytest.fixture(scope="module")
def traces(files):
    return {"one": traced(files), "mesh": traced(files, Mesh(["cpu"] * SHARDS))}


@pytest.fixture(scope="module")
def counted(files):
    """``GLOBAL_STATS`` after one decode on one device (its snapshot, its
    span seconds, host and wait seconds), and the decode's wall time."""
    GLOBAL_STATS.reset()
    t0 = time.perf_counter()
    decode(files)
    wall = time.perf_counter() - t0
    return {"snapshot": GLOBAL_STATS.snapshot(), "wall": wall,
            "seconds": dict(GLOBAL_STATS.span_seconds),
            "host": GLOBAL_STATS.host_seconds, "wait": GLOBAL_STATS.result_wait_seconds}


@pytest.mark.parametrize("name", SPANS)
def test_decode_holds_every_span(traces, name):
    _, one = traces["one"]
    _, mesh = traces["mesh"]
    assert one[name] > 0 and mesh[name] > 0


def test_mesh_enqueues_each_shard_once_per_batch(files, traces):
    _, mesh = traces["mesh"]
    n = batches(files)
    assert n > 1
    assert mesh["alac.host.enqueue"] == n
    for i in range(SHARDS):
        assert mesh[f"alac.host.enqueue.shard{i}"] == n
    assert mesh[f"alac.host.enqueue.shard{SHARDS}"] == 0


def test_stats_hold_every_span(counted):
    seconds, snap = counted["seconds"], counted["snapshot"]
    assert set(seconds) == set(SPANS)
    assert set(snap["spans"]) == set(SPANS)
    assert all(s["count"] > 0 for s in snap["spans"].values())
    assert counted["host"] == seconds["alac.host.parse"] > 0
    assert counted["wait"] == seconds["alac.device.result_wait"] > 0


def test_no_span_outlasts_the_decode(counted):
    for name, s in counted["seconds"].items():
        assert 0 < s <= counted["wall"], name


def test_dispatches_count_batches(files, counted):
    snap = counted["snapshot"]
    assert snap["dispatches"] == batches(files)
    assert snap["spans"]["alac.host.enqueue"]["count"] == batches(files)


def test_pcm_same_with_and_without_profiler(files, traces):
    plain = decode(files)
    for key in ("one", "mesh"):
        out, _ = traces[key]
        assert len(out) == len(plain)
        for a, b in zip(out, plain):
            assert a.pcm.dtype == b.pcm.dtype
            np.testing.assert_array_equal(a.pcm, b.pcm)


def test_span_counts_each_entry():
    GLOBAL_STATS.reset()
    for _ in range(3):
        with trace_span("alac.test.span"):
            pass
    snap = GLOBAL_STATS.snapshot()
    assert snap["spans"]["alac.test.span"]["count"] == 3
    assert snap["dispatches"] == 0 and snap["host_seconds"] == 0
    GLOBAL_STATS.reset()
    assert GLOBAL_STATS.snapshot()["spans"] == {}


def assembly(snap):
    return snap["assembled_files"], snap["assembly_views"], snap["assembly_runs"]


def test_assembly_counters_in_snapshot_and_reset(files, counted):
    snap = counted["snapshot"]
    assert snap["assembled_files"] == len(files)
    assert snap["assembly_views"] + snap["assembly_runs"] >= len(files)
    GLOBAL_STATS.reset()
    GLOBAL_STATS.record_assembly(view=True)
    GLOBAL_STATS.record_assembly(runs=2)
    assert assembly(GLOBAL_STATS.snapshot()) == (2, 1, 2)
    GLOBAL_STATS.reset()
    assert assembly(GLOBAL_STATS.snapshot()) == (0, 0, 0)


def test_cli_stats_prints_each_span(files, tmp_path, capsys):
    path = tmp_path / "a.m4a"
    path.write_bytes(files[0])
    assert tcli.main(["stats", str(path), "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert "msamples_per_second" not in stats
    assert stats["files"] == 1 and stats["dispatches"] >= 1
    assert stats["assembled_files"] == 1
    assert stats["assembly_views"] + stats["assembly_runs"] >= 1
    assert set(stats["spans"]) == set(SPANS)
    for s in stats["spans"].values():
        assert s["seconds"] >= 0 and s["count"] >= 1


def test_pcm_counters_in_snapshot_and_reset(files, counted):
    """Every batch of the two 16-bit files comes back int16 (the padded
    ones too), 2 B a value of each real lane."""
    snap = counted["snapshot"]
    assert snap["int16_batches"] == snap["dispatches"] == batches(files)
    assert snap["pcm_bytes_back"] == (5 + 6) * FS * 2 * 2
    GLOBAL_STATS.reset()
    GLOBAL_STATS.record(frames=2, pcm_bytes=96, int16=True)
    GLOBAL_STATS.record(frames=1, pcm_bytes=40)
    snap = GLOBAL_STATS.snapshot()
    assert (snap["dispatches"], snap["int16_batches"], snap["pcm_bytes_back"]) == (2, 1, 136)
    GLOBAL_STATS.reset()
    snap = GLOBAL_STATS.snapshot()
    assert (snap["int16_batches"], snap["pcm_bytes_back"]) == (0, 0)


def test_cli_stats_prints_pcm_counters(files, tmp_path, capsys):
    path = tmp_path / "a.m4a"
    path.write_bytes(files[0])
    assert tcli.main(["stats", str(path), "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["int16_batches"] == stats["dispatches"] >= 1
    assert stats["pcm_bytes_back"] == 5 * FS * 2 * 2
