"""The 5.1 surround cell (``surround51-library-decode``) on the host at a
tiny size: the frozen splice of elements, the run end to end, its
traced span share, and ``correct`` false for the control and for each
fault a chain of elements can have."""

from __future__ import annotations

import io

import numpy as np
import pytest
from conftest import SEED, run_cell, tiny_config
from test_benchmark_spans import host_card  # noqa: F401  (a fixture)

from benchmark.inputs import alac, surround

CELL = "surround51-library-decode"


@pytest.fixture(scope="module")
def coded():
    lib = surround.make_library(tiny_config("surround51"), SEED)
    return lib, surround.code(lib)


def test_spliced_frames_are_their_elements_bits(coded):
    """Each frame is its elements' bits in the map's order (the tag and
    instance of each where its bit length says it starts), then END and
    the byte alignment: its bytes are the elements' bits plus 3, rounded
    up."""
    lib, c = coded
    kinds = surround.CHANNEL_ELEMENTS[6]
    first = np.cumsum((0,) + kinds)[:-1]
    coding = lib.coding()
    S = lib.pool_pcm.shape[1]
    per_elem = []
    for e, kind in enumerate(kinds):
        one = alac.encode_frames(lib.pool_pcm[:, :, first[e]:first[e] + kind], lib.pool_n,
                                 (4, 8), coding)
        per_elem.append(surround.element_bits(one, lib.pool_n, S, coding.uncompressed_bytes))
        np.testing.assert_array_equal(one.orders, c.orders[:, first[e]:first[e] + kind])
    total = np.sum(per_elem, axis=0)
    for p, payload in enumerate(c.payloads):
        assert len(payload) == -(-(int(total[p]) + 3) // 8)
        bits = np.unpackbits(np.frombuffer(payload, np.uint8))
        at = 0
        for e, kind in enumerate(kinds):
            head = int("".join(map(str, bits[at:at + 7])), 2)
            assert head == ((kind - 1) << 4) | (e // 2), (p, e)  # tag, then instance
            at += int(per_elem[e][p])
        assert bits[at:at + 3].tolist() == [1, 1, 1]
        assert not bits[at + 3:].any()


def test_m4a_carries_the_chan_record(coded):
    from alacnet_tpu_torch.codec.cookie import channel_layout
    from alacnet_tpu_torch.container import demux

    lib, c = coded
    info = demux.parse(io.BytesIO(surround.m4a_of(lib, c, 0)))
    assert info.num_channels == 6
    assert channel_layout(info.codec_data) == ((124 << 16) | 6, 0, 0)


def test_sound_run_is_correct(checkout):
    r = run_cell(checkout, CELL)
    assert r["correct"], r
    assert r["checks"]["wrong_samples"]["value"] == 0
    assert set(r["metrics"]) == {"decode_msamples_per_s", "setup_s"}


def test_traced_run_reports_the_element_chain_share(checkout, host_card):  # noqa: F811
    r = run_cell(checkout, CELL, trace=True)
    assert r["correct"], r
    assert r["metrics"]["pipeline.element_chain_share.decode"]["value"] > 0
    for name in ("pipeline.host_parse_share.decode", "pipeline.result_wait_share.decode"):
        assert r["metrics"][name]["value"] >= 0, name
    gaps = {name for name, _ in r["breakdown"]["idle_gaps"]}
    assert "alac.host.element_chain" in gaps


def test_control_is_not_correct(checkout):
    r = run_cell(checkout, CELL, seconds=0.2, answer="control")
    assert not r["correct"]
    assert r["checks"]["wrong_samples"]["value"] > 0


def _swap_pair(out):
    out[..., [1, 2]] = out[..., [2, 1]]  # L and R of the front pair
    return out


def _lfe_zero(out):
    out[..., 5] = 0
    return out


@pytest.mark.parametrize("fault", [_swap_pair, _lfe_zero])
def test_channel_fault_is_not_correct(checkout, monkeypatch, fault):
    from alacnet_tpu_torch import batch

    orig = batch.decode_blob

    def broken(*a, **k):
        out, n, status = orig(*a, **k)
        return fault(np.array(out)), n, status

    monkeypatch.setattr(batch, "decode_blob", broken)
    r = run_cell(checkout, CELL)
    assert not r["correct"]
    assert r["checks"]["wrong_samples"]["value"] > 0


def test_chained_element_from_the_wrong_bit_is_not_correct(checkout, monkeypatch):
    """Element 2 read one bit after where element 1 ended, from the
    window's first request on (the warm-up decodes as it should, so the
    run reaches its window): the chain refuses the frames and every
    request fails."""
    from alacnet_tpu_torch.ops import frame_decode
    from alacnet_tpu_torch.ops.cuda import elem_head

    from benchmark import harness

    orig, warm = elem_head.elem_head, harness._warm
    on = []

    def off_by_one(words, base, prev, end_a, end_b, status, k, *a, **kw):
        if on and k == 2:
            end_a, end_b = end_a + 1, end_b + 1
        return orig(words, base, prev, end_a, end_b, status, k, *a, **kw)

    def warm_then_fault(*a, **kw):
        warm(*a, **kw)
        on.append(True)

    monkeypatch.setattr(frame_decode.elem_head, "elem_head", off_by_one)
    monkeypatch.setattr(harness, "_warm", warm_then_fault)
    r = run_cell(checkout, CELL)
    assert not r["correct"]
    assert r["failed"] == r["attempted"] > 0
