"""Frames of 3-8 channels: the element chain, on the CPU.

A frame of C channels is the elements of its channel map (Apple's
``sChannelMaps``: SCE, CPE, ..., then END), written here by the port's
host encoder's own element writers (``tests/test_torch_cuda.mc_frame``,
frames of 256 samples, the last one partial).  Every file decodes
through ``decode_streams(device="cpu")`` (the plain torch versions of
the kernels, the chain's header pass included) and through the plain
per-frame decoder (``codec/scalar.AlacFrameDecoder.decode_frame_channels``),
both held to the source PCM.  Exact equality.
"""

import io
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import alacnet_tpu_torch as at  # noqa: E402
from alacnet_tpu_torch.codec.cookie import (  # noqa: E402
    CHANNEL_ELEMENTS, ID_CCE, ID_CPE, ID_DSE, ID_FIL, ID_LFE, ID_PCE, ID_SCE, channel_layout,
    default_cookie,
)
from alacnet_tpu_torch.codec.scalar import AlacFrameDecoder  # noqa: E402
from alacnet_tpu_torch.errors import HeaderError, UnsupportedFormatError  # noqa: E402
from alacnet_tpu_torch.ops.cuda import elem_head  # noqa: E402
from alacnet_tpu_torch.ops.frame_decode import FrameMetaArrays  # noqa: E402
from alacnet_tpu_torch.utils.observability import (  # noqa: E402
    ELEMENT_CHAIN_SPAN, GLOBAL_STATS,
)

from .test_torch_cuda import (  # noqa: E402
    MC_S, _mc_stereo_files, mc_file, mc_frame, mc_library, mc_pcm,
)


def decode(data, **kw):
    return at.decode_streams([io.BytesIO(d) for d in data], device="cpu", **kw)


def scalar_pcm(frames, params):
    dec = AlacFrameDecoder(params, params.num_channels_cookie)
    return np.concatenate([np.array(dec.decode_frame_channels(f)[1], np.int64).T
                           for f in frames])


@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("C", [3, 4, 5, 6, 7, 8])
def test_every_channel_map_decodes_exactly(C, bits):
    data, pcm, frames, params = mc_file(C, bits, seed=C)
    got = decode([data])[0]
    assert (got.channels, got.bits_per_sample, got.sample_rate) == (C, bits, 48000)
    np.testing.assert_array_equal(got.pcm, pcm.astype(got.pcm.dtype))
    np.testing.assert_array_equal(scalar_pcm(frames, params), pcm)


@pytest.mark.parametrize("ub", [0, 1])
def test_surround_24bit_with_and_without_extra_bits(ub):
    data, pcm, frames, params = mc_file(6, 24, lengths=(MC_S, 37), seed=ub, ub=ub)
    np.testing.assert_array_equal(decode([data])[0].pcm, pcm)
    np.testing.assert_array_equal(scalar_pcm(frames, params), pcm)


@pytest.mark.parametrize("raw", [(0,), (1,), (2, 3), (0, 1, 2, 3)],
                         ids=["first", "pair", "pair-and-lfe", "all"])
def test_escape_elements_inside_a_chain(raw):
    """Raw (escape) elements anywhere in the chain: the element after one
    starts where its body ends."""
    data, pcm, frames, params = mc_file(6, 24, lengths=(MC_S, 100), seed=len(raw),
                                        frame_kw={0: {"raw": raw}, 1: {"raw": raw}})
    np.testing.assert_array_equal(decode([data])[0].pcm, pcm)
    np.testing.assert_array_equal(scalar_pcm(frames, params), pcm)


def test_mono_elements_at_order_31_and_mixed_orders():
    orders = (31, 4, 8, 31)
    data, pcm, frames, params = mc_file(6, 16, seed=3, frame_kw={
        0: {"orders": orders}, 1: {"orders": (0, 12, 31, 1)}, 2: {"orders": orders}})
    np.testing.assert_array_equal(decode([data])[0].pcm, pcm.astype(np.int16))
    np.testing.assert_array_equal(scalar_pcm(frames, params), pcm)


@pytest.mark.parametrize("orders", [(4, 12, 16, 6), (4, 31, 8, 30), (8, 4, 4, 8)])
def test_later_elements_above_element_zeros_orders(orders):
    """Element 0's order bucket sizes the narrow launch of the later
    elements; a later element above it (not 31) decodes in the wide one."""
    data, pcm, frames, params = mc_file(6, 16, lengths=(MC_S, 80), seed=sum(orders),
                                        frame_kw={0: {"orders": orders},
                                                  1: {"orders": orders}})
    np.testing.assert_array_equal(decode([data])[0].pcm, pcm.astype(np.int16))
    np.testing.assert_array_equal(scalar_pcm(frames, params), pcm)


def test_partial_last_frame_of_one_sample():
    data, pcm, _, _ = mc_file(6, 24, lengths=(MC_S, 1), seed=4)
    got = decode([data])[0]
    assert got.num_samples == MC_S + 1
    np.testing.assert_array_equal(got.pcm, pcm)


def test_data_stream_and_fill_elements_are_skipped():
    """DSE and FIL elements between elements and before END are skipped
    (byte-aligned or not, short and long counts); before element 0, which
    the host parses, they are refused, not skipped."""
    aux = {1: [(ID_FIL, [(2, 4), (0xFF, 8), (0xFF, 8)]),
               (ID_DSE, [(0, 4), (1, 1), (3, 8), (0, None), (1, 8), (2, 8), (3, 8)])],
           3: [(ID_DSE, [(5, 4), (0, 1), (255, 8), (1, 8)] + [(0x5A, 8)] * 256)],
           4: [(ID_FIL, [(15, 4), (2, 8)] + [(7, 8)] * 16)]}
    data, pcm, frames, params = mc_file(6, 24, seed=5, frame_kw={0: {"aux": aux},
                                                                 2: {"aux": aux}})
    np.testing.assert_array_equal(decode([data])[0].pcm, pcm)
    np.testing.assert_array_equal(scalar_pcm(frames, params), pcm)
    first = {0: [(ID_FIL, [(1, 4), (0, 8)])]}
    data, _, _, _ = mc_file(6, 24, seed=5, frame_kw={1: {"aux": first}})
    with pytest.raises(UnsupportedFormatError):
        decode([data])
    np.testing.assert_array_equal(decode([data], strict=False)[0].bad_frames, [1])


def test_lfe_tag_decodes_as_a_single_channel():
    data, pcm, frames, params = mc_file(6, 16, seed=6, frame_kw={
        0: {"tags": (ID_SCE, ID_CPE, ID_CPE, ID_LFE)}})
    np.testing.assert_array_equal(decode([data])[0].pcm, pcm.astype(np.int16))
    np.testing.assert_array_equal(scalar_pcm(frames, params), pcm)


def test_pool_mixes_stereo_mono_and_surround():
    """One call: 5.1 (16 and 24 bits), 7.1, 3.0, stereo and mono files;
    each file's PCM is its own, whatever batches the pool makes."""
    files = [(f[0], f[1]) for f in mc_library(7)] + _mc_stereo_files()
    got = decode([d for d, _ in files])
    for g, (_, pcm) in zip(got, files):
        assert g.channels == pcm.shape[1]
        np.testing.assert_array_equal(g.pcm, pcm.astype(g.pcm.dtype))


def test_pool_under_a_cpu_mesh():
    from alacnet_tpu_torch.parallel.mesh import Mesh

    files = mc_library(8)
    got = at.decode_streams([io.BytesIO(f[0]) for f in files], mesh=Mesh(["cpu"] * 2))
    for g, f in zip(got, files):
        np.testing.assert_array_equal(g.pcm, f[1].astype(g.pcm.dtype))


def test_context_seek_and_read_on_surround():
    data, pcm, _, _ = mc_file(6, 24, lengths=(MC_S,) * 5 + (90,), seed=9)
    with at.AlacContext(io.BytesIO(data), window=2, device="cpu") as ctx:
        assert ctx.get_num_channels() == 6
        first = ctx.read_frame()
        np.testing.assert_array_equal(first, pcm[:MC_S])
        ctx.set_position(3 * MC_S + 17)
        rest = ctx.read_all()
    np.testing.assert_array_equal(rest, pcm[3 * MC_S + 17:])


def test_decode_file_and_resumable_cursor(tmp_path):
    data, pcm, _, _ = mc_file(5, 16, lengths=(MC_S,) * 3 + (9,), seed=10)
    path = tmp_path / "x.m4a"
    path.write_bytes(data)
    np.testing.assert_array_equal(at.decode_file(path, device="cpu").pcm, pcm.astype(np.int16))
    part, cur = at.decode_resumable(at.DecodeCursor(str(path)), max_frames=2, device="cpu")
    np.testing.assert_array_equal(part.pcm, pcm[: 2 * MC_S])
    part, cur = at.decode_resumable(cur, max_frames=2, device="cpu")
    np.testing.assert_array_equal(part.pcm, pcm[2 * MC_S:])
    assert cur.done


BAD_FRAMES = {
    "cce": {"tags": (ID_SCE, ID_CCE, ID_CPE, ID_SCE)},
    "pce": {"tags": (ID_SCE, ID_CPE, ID_PCE, ID_SCE)},
    "pair_for_single": {"tags": (ID_SCE, ID_CPE, ID_CPE, ID_CPE)},
    "no_end": {"end": False},
    "extra_element": {"aux": {4: [(ID_SCE, [(0, 4)])]}},
    "sample_count": {"counts": (MC_S, MC_S, MC_S - 1, MC_S)},
    "pair_first": {"tags": (ID_CPE, ID_CPE, ID_CPE, ID_SCE)},
}


@pytest.mark.parametrize("case", list(BAD_FRAMES))
def test_malformed_chains_are_refused_never_silent(case):
    """A CCE or PCE element, a tag unlike the map's, a missing END, an
    element past the map's or a sample count unlike element 0's: strict
    decode raises; lenient decode reports the frame bad and drops its
    samples, the good frames decoding exactly."""
    data, pcm, frames, params = mc_file(6, 24, lengths=(MC_S,) * 3, seed=11,
                                        frame_kw={1: BAD_FRAMES[case]})
    with pytest.raises(UnsupportedFormatError):
        decode([data])
    got = decode([data], strict=False)[0]
    np.testing.assert_array_equal(got.bad_frames, [1])
    np.testing.assert_array_equal(got.pcm, np.concatenate([pcm[:MC_S], pcm[2 * MC_S:]]))
    with pytest.raises(UnsupportedFormatError):
        AlacFrameDecoder(params, 6).decode_frame_channels(frames[1])


def test_prediction_type_in_a_later_element_is_refused():
    """A prediction type other than 0 in element 2: status 2."""
    data, pcm, frames, params = mc_file(6, 16, lengths=(MC_S, MC_S), seed=12)
    from alacnet_tpu_torch.codec.framemeta_vec import parse_frame_headers_vec
    from alacnet_tpu_torch.ops import frame_decode as fd
    from alacnet_tpu_torch.parallel.pipeline import pad_frame_batch

    # find element 2's prediction-type field by decoding the chain's end bits
    fb = pad_frame_batch(parse_frame_headers_vec(frames, params), 8)
    words = torch.from_numpy(fb.words.view(np.int32))
    seen = {}
    real = fd.elem_head.elem_head

    def spy(*a, **kw):
        out = real(*a, **kw)
        if not kw.get("last"):
            seen[a[6]] = out[0].clone()  # a[6]: the element
        return out

    fd.elem_head.elem_head = spy
    try:
        out, n = fd.decode_frames_packed(words, fd.FrameMetaArrays.pack_host(fb), MC_S)
    finally:
        fd.elem_head.elem_head = real
    np.testing.assert_array_equal(out[:2].numpy().reshape(-1, 6)[: 2 * MC_S], pcm)
    # element 2 (a pair): its payload follows two prediction headers of
    # 16 bits, each with its coefficients; the first's type comes first
    start = int(seen[2][8][0]) - 2 * 16 - 16 * int(seen[2][13][0]) - 16 * int(seen[2][14][0])
    bad = bytearray(frames[0])
    bad[start // 8] |= 0x80 >> (start % 8)  # prediction type's top bit
    fb = pad_frame_batch(parse_frame_headers_vec([bytes(bad), frames[1]], params), 8)
    words = torch.from_numpy(fb.words.view(np.int32))
    _, n = fd.decode_frames_packed(words, fd.FrameMetaArrays.pack_host(fb), MC_S)
    assert n[:2].tolist() == [-2, MC_S]


def test_first_element_must_be_the_maps():
    """Element 0 of a 5.1 frame is a single channel; a pair there is
    refused by the host parse (status 1), not decoded as stereo."""
    from alacnet_tpu_torch.codec.framemeta_vec import parse_frame_headers_vec

    _, _, frames, params = mc_file(6, 24, lengths=(MC_S,) * 2, seed=13,
                                   frame_kw={0: BAD_FRAMES["pair_first"]})
    fb = parse_frame_headers_vec(frames, params, strict=False)
    assert fb.status[0] != 0 and fb.status[1] == 0
    # a well-formed pair in element 0's place: the map check refuses it
    stereo = mc_frame(mc_pcm(MC_S, 2, 24, 0), default_cookie(48000, 24, 2, MC_S), ub=1)
    fb = parse_frame_headers_vec([stereo, frames[1]], params, strict=False)
    assert fb.status.tolist() == [1, 0] and fb.n_samples[0] == 0
    with pytest.raises(UnsupportedFormatError):
        parse_frame_headers_vec(frames, params)


def test_more_than_eight_channels_is_unsupported():
    params = default_cookie(48000, 16, 9, MC_S)
    pcm = mc_pcm(MC_S, 2, 16, 0)
    frame = mc_frame(pcm, default_cookie(48000, 16, 2, MC_S))
    from alacnet_tpu_torch.codec.framemeta_vec import parse_frame_headers_vec

    with pytest.raises(UnsupportedFormatError):
        parse_frame_headers_vec([frame], params)


def test_chan_record_written_and_checked():
    data, _, _, _ = mc_file(6, 24, lengths=(MC_S,), seed=14)
    from alacnet_tpu_torch.container import demux

    info = demux.parse(io.BytesIO(data))
    assert channel_layout(info.codec_data) == ((124 << 16) | 6, 0, 0)
    assert info.num_channels == 6
    bad = data.replace(((124 << 16) | 6).to_bytes(4, "big"), ((101 << 16) | 2).to_bytes(4, "big"))
    with pytest.raises(HeaderError):
        demux.parse(io.BytesIO(bad))
    assert len(CHANNEL_ELEMENTS) == 8


def test_unpacked_metadata_refuses_surround():
    from alacnet_tpu_torch.codec.framemeta_vec import parse_frame_headers_vec
    from alacnet_tpu_torch.ops.frame_decode import FrameMetaArrays

    _, _, frames, params = mc_file(6, 16, lengths=(MC_S,), seed=15)
    with pytest.raises(UnsupportedFormatError):
        FrameMetaArrays.from_batch(parse_frame_headers_vec(frames, params), "cpu")


def test_element_chain_counters_and_span():
    """One ``element_passes`` a chained element a batch (three for 5.1),
    an ``alac.host.element_chain`` span a batch with frames of 3-8
    channels, none for a stereo pool."""
    files = _mc_stereo_files()
    GLOBAL_STATS.reset()
    decode([d for d, _ in files])
    snap = GLOBAL_STATS.snapshot()
    assert (snap["element_passes"], snap["multichannel_frames"]) == (0, 0)
    assert snap["elements"] == snap["frames"]
    assert ELEMENT_CHAIN_SPAN not in snap["spans"]

    data, _, _, _ = mc_file(6, 24, lengths=(MC_S,) * 3, seed=16)
    GLOBAL_STATS.reset()
    decode([data])
    snap = GLOBAL_STATS.snapshot()
    assert snap["dispatches"] == 1
    assert (snap["element_passes"], snap["multichannel_frames"], snap["elements"]) == (3, 3, 12)
    assert snap["spans"][ELEMENT_CHAIN_SPAN]["count"] == 1


def test_cli_stats_reports_the_chain(tmp_path, capsys):
    import json

    from alacnet_tpu_torch import cli

    data, _, _, _ = mc_file(8, 16, lengths=(MC_S, 5), seed=17)
    path = tmp_path / "x.m4a"
    path.write_bytes(data)
    assert cli.main(["stats", str(path), "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["element_passes"], out["multichannel_frames"], out["elements"]) == (4, 2, 10)
    assert ELEMENT_CHAIN_SPAN in out["spans"]


CU_SOURCE = (pathlib.Path(at.__file__).parent / "csrc" / "elem_head.cu").read_text()


def cu_constant(name: str) -> int:
    found = re.findall(rf"\b{name} = (\d+)", CU_SOURCE)
    assert len(found) == 1, (name, found)
    return int(found[0])


def _flag_row(field: str) -> int:
    """The row of the transposed layout that sets a bool field."""
    for r in range(elem_head.ROWS):
        rows = torch.zeros((elem_head.ROWS, 1), dtype=torch.int32)
        rows[r] = 1
        if bool(getattr(FrameMetaArrays.from_rows(rows), field)[0]):
            return r
    raise AssertionError(field)


def _layout_pairs():
    m = FrameMetaArrays.from_rows(torch.arange(elem_head.ROWS, dtype=torch.int32)[:, None])
    return {
        "kStereo": _flag_row("is_stereo"), "kComp": _flag_row("is_compressed"),
        "kN": int(m.n_samples[0]), "kSS": int(m.sample_size[0]),
        "kPayload": int(m.payload_pos[0]), "kKmod": int(m.kmod[0]),
        "kIhist": int(m.init_history[0]), "kKmask": int(m.kmask[0]),
        "kElements": FrameMetaArrays.N_PACKED, "kHistMult4": elem_head.COL_HIST_MULT4,
        "kFrame": elem_head.COL_FRAME, "kChained": elem_head.N_CHAINED,
        "kRowNComp": elem_head.ROW_N_COMP, "kRowNB": elem_head.ROW_N_B,
        "kRowBulkN": elem_head.ROW_BULK_N, "kRowBulkN1": elem_head.ROW_BULK_N1,
        "kRowBulkN2": elem_head.ROW_BULK_N2, "kRowWideA": elem_head.ROW_WIDE_A,
        "kRowWideB": elem_head.ROW_WIDE_B, "kRowCoff": elem_head.ROW_COFF,
        "kRowStatus": elem_head.ROW_STATUS, "kRows": elem_head.ROWS,
        "kMaxElements": elem_head.MAX_ELEMENTS, "kMaxSkips": elem_head.MAX_SKIPS,
    }


@pytest.mark.parametrize("name", list(_layout_pairs()))
def test_header_kernel_layout_matches_the_packed_metadata(name):
    """The header kernel's rows and columns (``csrc/elem_head.cu``) are
    the wrapper's and ``FrameMetaArrays``' (the C entry refuses another
    layout at every launch; this holds the source to them here)."""
    assert elem_head.N_PACKED == FrameMetaArrays.N_PACKED
    assert elem_head.COL_ELEMENTS == FrameMetaArrays.N_PACKED
    assert cu_constant(name) == _layout_pairs()[name]


@pytest.mark.parametrize("C", range(9))
def test_elements_column_spells_the_channel_map(C):
    word = np.array([elem_head.ELEMENT_WORDS[C]])
    kinds = CHANNEL_ELEMENTS.get(C, ()) if C > 2 else ()
    assert int(elem_head.element_count(word)[0]) == len(kinds)
    assert [int(elem_head.element_kind(word, e)[0]) for e in range(len(kinds))] == list(kinds)
    t = torch.from_numpy(word).to(torch.int64)
    assert int(elem_head.element_count(t)[0]) == len(kinds)


def _c_entries():
    from alacnet_tpu_torch.ops.cuda import _lib

    src = "".join(p.read_text() for p in sorted(_lib.CSRC.glob("*.cu")))
    return {name: re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
            for name in _lib._SIGNATURES}


@pytest.mark.parametrize("name", sorted(_c_entries()))
def test_c_entry_signature_counts_every_parameter(name):
    """Each ctypes signature (``_lib._SIGNATURES``) gives a type to every
    parameter of its C entry, the stream last: a parameter left without
    one is passed as a C int, which would cut a 64-bit stream handle."""
    from alacnet_tpu_torch.ops.cuda import _lib

    found = _c_entries()[name]
    assert found is not None, name
    params = [p.strip() for p in found.group(1).split(",") if p.strip()]
    assert len(_lib._SIGNATURES[name]) == len(params)
    assert params[-1] == "void* stream"
    assert _lib._SIGNATURES[name][-1] is _lib._P
