"""The readers of the program's span shares: each share on a made-up trace,
and in a traced run of a decode cell on the host, where a card with no
device work stands in for the cards (its whole window is idle, named by
the host's innermost range)."""

from __future__ import annotations

import contextlib

import pytest
from conftest import REPO, run_cell

from benchmark import device_trace, harness

#: Each new reader and the idle gaps it adds up.
READERS = {
    "pipeline.demux_share.decode": ["alac.host.demux"],
    "pipeline.h2d_share.decode": ["alac.host.h2d"],
    "pipeline.enqueue_share.decode": ["alac.host.enqueue", "alac.host.enqueue.shard0",
                                      "alac.host.enqueue.shard3"],
    "pipeline.unsort_share.decode": ["alac.host.unsort"],
    "pipeline.assembly_share.decode": ["alac.host.assembly"],
    "pipeline.unspanned_share.decode": ["bench.request", "bench.window", "outside any span"],
}
#: The spans the program had before these readers: the parent's trace.
OLD_SPANS = ("alac.host.parse", "alac.device.result_wait")


def reader(name):
    return harness.load_module(REPO / "benchmark" / "metrics" / f"{name}.py",
                               f"benchmark.metrics.{name}")


def window(idle: dict, window_s: float = 20.0):
    trace = device_trace.TraceData(window_s, {0: 1.0}, {}, idle)
    return harness.Window(cell=None, setup_s=0.0, seconds=window_s, requests=[], stats={},
                          trace=trace)


#: Idle seconds under every range a trace can name, 0.5 s more for each.
IDLE = {name: 0.5 * (i + 1) for i, name in enumerate(
    ["alac.host.demux", "alac.host.parse", "alac.host.h2d", "alac.host.enqueue",
     "alac.host.enqueue.shard0", "alac.host.enqueue.shard3", "alac.device.result_wait",
     "alac.host.unsort", "alac.host.assembly", "bench.request", "bench.window",
     "outside any span", "alac.host.enqueue.other"])}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_share_of_a_made_up_trace(name):
    want = 100.0 * sum(IDLE[s] for s in READERS[name]) / 20.0
    assert reader(name).read(window(IDLE)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_without_a_trace_or_its_span(name):
    m = reader(name)
    w = window(IDLE)
    w.trace = None
    assert m.read(w) is None
    others = {k: v for k, v in IDLE.items() if k not in READERS[name]}
    assert m.read(window(others)) is None


def test_readers_split_the_idle_time_once():
    """With the two older spans, the readers add up every idle second but
    that of a range no reader names."""
    total = sum(reader(name).read(window(IDLE)) for name in READERS)
    old = 100.0 * sum(IDLE[s] for s in OLD_SPANS) / 20.0
    stray = 100.0 * IDLE["alac.host.enqueue.other"] / 20.0
    assert total + old + stray == pytest.approx(100.0 * sum(IDLE.values()) / 20.0)


@pytest.fixture
def host_card(monkeypatch):
    """The trace read as if one card with no work sat beside the host."""
    read = device_trace.read
    monkeypatch.setattr(device_trace, "read", lambda prof, cards: read(prof, cards or [0]))


def _parent_spans(monkeypatch):
    """The program's trace as the parent left it: only its two spans."""
    import torch

    orig = torch.profiler.record_function

    def record_function(name, *a, **k):
        if name.startswith("alac.") and name not in OLD_SPANS:
            return contextlib.nullcontext()
        return orig(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", record_function)


@pytest.mark.parametrize("workload", ["cd16-library-decode", "cd16-library-decode-4card"])
def test_traced_run_reports_the_span_shares(checkout, monkeypatch, host_card, workload):
    r = run_cell(checkout, workload, trace=True)
    assert r["correct"], r
    got = r["metrics"]
    assert set(READERS) <= set(got), sorted(got)
    if workload.endswith("4card"):
        gaps = {name for name, _ in r["breakdown"]["idle_gaps"]}
        assert any(g.startswith("alac.host.enqueue.shard") for g in gaps), gaps
    _parent_spans(monkeypatch)
    parent = run_cell(checkout, workload, trace=True)
    assert parent["correct"], parent
    assert not set(READERS) - {"pipeline.unspanned_share.decode"} & set(parent["metrics"])
    assert (got["pipeline.unspanned_share.decode"]["value"]
            < parent["metrics"]["pipeline.unspanned_share.decode"]["value"])
