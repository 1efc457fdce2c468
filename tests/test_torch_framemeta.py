"""The port's scalar header parser (``codec/framemeta.parse_frame_headers``)
against the JAX package's scalar parser and the port's vectorised twin
(``codec/framemeta_vec.parse_frame_headers_vec``), on the committed
fixtures and on the fuzz frames: every field equal, dtype included.  It
must raise ``UnsupportedFormatError`` on the inputs the JAX parser
rejects: a channel tag above 1, a prediction type other than 0, a sample
size other than 16 or 24."""

import dataclasses
import io
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alacnet_tpu.codec import framemeta as j_fm  # noqa: E402
from alacnet_tpu.container import demux as j_demux  # noqa: E402
from alacnet_tpu.errors import UnsupportedFormatError as JaxUnsupported  # noqa: E402

from alacnet_tpu_torch.codec import framemeta as t_fm  # noqa: E402
from alacnet_tpu_torch.codec import framemeta_vec as t_fmv  # noqa: E402
from alacnet_tpu_torch.container import demux as t_demux  # noqa: E402
from alacnet_tpu_torch.errors import UnsupportedFormatError  # noqa: E402

from .test_torch_host import FILES, assert_batches_equal  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "scripts"))
import soak_torch  # noqa: E402


def payloads_of(path):
    """(payloads, JAX params, port params) of one file's frames."""
    data = path.read_bytes()
    ji = j_demux.parse(io.BytesIO(data))
    ti = t_demux.parse(io.BytesIO(data))
    offs = ti.tables.frame_file_offsets()
    sizes = ti.tables.frame_byte_sizes
    return [data[o: o + s] for o, s in zip(offs, sizes)], ji.params, ti.params


def _jax_params(p):
    """The JAX package's CodecParams with the port's field values."""
    from alacnet_tpu.codec.cookie import CodecParams

    return CodecParams(**dataclasses.asdict(p))


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_scalar_parser_matches_jax_and_vec_on_fixtures(path):
    payloads, jp, tp = payloads_of(path)
    got = t_fm.parse_frame_headers(payloads, tp)
    assert_batches_equal(j_fm.parse_frame_headers(payloads, jp), got)
    assert_batches_equal(t_fmv.parse_frame_headers_vec(payloads, tp), got)
    # per-frame params, as a pooled decode passes them
    assert_batches_equal(got, t_fm.parse_frame_headers(payloads, [tp] * len(payloads)))


@pytest.mark.parametrize("bits,count,seed", soak_torch.FUZZ_BATCHES,
                         ids=[f"{b}bit" for b, _, _ in soak_torch.FUZZ_BATCHES])
def test_scalar_parser_matches_jax_and_vec_on_fuzz(bits, count, seed):
    payloads, _, tp = soak_torch.fuzz_payloads(bits, count, seed)
    got = t_fm.parse_frame_headers(payloads, tp, max_bytes=512)
    assert_batches_equal(j_fm.parse_frame_headers(payloads, _jax_params(tp), max_bytes=512), got)
    assert_batches_equal(t_fmv.parse_frame_headers_vec(payloads, tp, max_bytes=512), got)


def _first_frame(name="stereo16_order6.m4a"):
    payloads, jp, tp = payloads_of(pathlib.Path(__file__).parent / "fixtures" / name)
    return bytearray(payloads[0]), jp, tp


def _tag3():
    payload, jp, tp = _first_frame()
    payload[0] = 0b01100000 | (payload[0] & 0x1F)  # channel tag 3
    return bytes(payload), jp, tp


def _ptype15():
    # A full stereo frame: 39 header bits (tag, pads, flags, shift,
    # leftweight), then channel A's prediction type at bits 39-42.
    payload, jp, tp = _first_frame()
    payload[4] |= 0b00000001
    payload[5] |= 0b11100000
    return bytes(payload), jp, tp


def _size20():
    payload, jp, tp = _first_frame()
    return (bytes(payload), dataclasses.replace(jp, sample_size=20),
            dataclasses.replace(tp, sample_size=20))


@pytest.mark.parametrize("make", [_tag3, _ptype15, _size20],
                         ids=["channel-tag", "prediction-type", "sample-size"])
def test_rejects_what_the_jax_parser_rejects(make):
    payload, jp, tp = make()
    with pytest.raises(JaxUnsupported):
        j_fm.parse_frame_headers([payload], jp)
    with pytest.raises(UnsupportedFormatError):
        t_fm.parse_frame_headers([payload], tp)
    with pytest.raises(UnsupportedFormatError):
        t_fmv.parse_frame_headers_vec([payload], tp)
