"""The port's host tier against the JAX package's: demux tables, frame
header parsing and lane planning, on the committed fixtures and the
port's smoke corpus.  Exact equality throughout."""

import dataclasses
import io
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alacnet_tpu.codec import framemeta_vec as j_fmv  # noqa: E402
from alacnet_tpu.container import demux as j_demux  # noqa: E402
from alacnet_tpu.parallel import pipeline as j_pipe  # noqa: E402
from alacnet_tpu_torch.codec import framemeta_vec as t_fmv  # noqa: E402
from alacnet_tpu_torch.container import demux as t_demux  # noqa: E402
from alacnet_tpu_torch.parallel import pipeline as t_pipe  # noqa: E402

FIX = pathlib.Path(__file__).parent / "fixtures"
FILES = sorted(FIX.glob("*.m4a")) + sorted((FIX / "torch_smoke").glob("*.m4a"))


def pool(paths, copies=1):
    """(blob, offsets, sizes, jax params, port params) of the pooled files."""
    blobs, offs, szs, jp, tp = [], [], [], [], []
    base = 0
    for p in paths:
        data = p.read_bytes()
        for _ in range(copies):
            ji = j_demux.parse(io.BytesIO(data))
            ti = t_demux.parse(io.BytesIO(data))
            o = ti.tables.frame_file_offsets()
            offs.append(o + base)
            szs.append(ti.tables.frame_byte_sizes)
            jp += [ji.params] * len(o)
            tp += [ti.params] * len(o)
            blobs.append(np.frombuffer(data, np.uint8))
            base += len(data)
    return (np.concatenate(blobs), np.concatenate(offs), np.concatenate(szs),
            jp, tp)


def assert_batches_equal(jfb, tfb):
    for f in dataclasses.fields(jfb):
        a, b = getattr(jfb, f.name), getattr(tfb, f.name)
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=f.name)
        assert np.asarray(b).dtype == np.asarray(a).dtype, f.name


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_demux_matches(path):
    data = path.read_bytes()
    j = j_demux.parse(io.BytesIO(data))
    t = t_demux.parse(io.BytesIO(data))
    for name in ("format", "num_channels", "sample_size", "sample_rate",
                 "codec_data", "mdat_offset", "mdat_len"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.status.name == j.status.name
    assert dataclasses.asdict(t.params) == dataclasses.asdict(j.params)
    for f in dataclasses.fields(j.tables):
        np.testing.assert_array_equal(
            getattr(t.tables, f.name), getattr(j.tables, f.name), err_msg=f.name
        )
    np.testing.assert_array_equal(
        t.tables.frame_file_offsets(), j.tables.frame_file_offsets()
    )


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("pack_words", [True, False], ids=["words", "headers"])
def test_parse_frame_headers_blob_matches(native, pack_words):
    blob, offs, szs, jp, tp = pool(FILES)
    jfb = j_fmv.parse_frame_headers_blob(blob, offs, szs, jp, pack_words=pack_words)
    tfb = t_fmv.parse_frame_headers_blob(
        blob, offs, szs, tp, pack_words=pack_words, native=native
    )
    assert_batches_equal(jfb, tfb)


@pytest.mark.parametrize(
    "copies,batch_limit", [(1, 64), (1, 4096), (16, 4096)],
    ids=["pool-b64", "pool-b4096", "pool16-b4096"],
)
def test_plan_blob_batches_matches(copies, batch_limit):
    blob, offs, szs, jp, tp = pool(FILES, copies)
    jperm, jinv, jspans, jspan = j_pipe.plan_blob_batches(
        blob, offs, szs, jp, batch_limit, True
    )
    tperm, tinv, tspans, tspan = t_pipe.plan_blob_batches(
        blob, offs, szs, tp, batch_limit, True
    )
    np.testing.assert_array_equal(tperm, jperm)
    np.testing.assert_array_equal(tinv, jinv)
    assert tspans == jspans
    for lo, hi in jspans:
        idx = jperm[lo:hi]
        assert_batches_equal(jspan(idx), tspan(idx))
        jfb, jow, jnb, jW = jspan(idx, device_rows=True)
        tfb, tow, tnb, tW = tspan(idx, device_rows=True)
        assert_batches_equal(jfb, tfb)
        np.testing.assert_array_equal(tow, jow)
        np.testing.assert_array_equal(tnb, jnb)
        assert tW == jW


def test_pad_frame_batch_matches():
    blob, offs, szs, jp, tp = pool(FILES[:3])
    jfb = j_fmv.parse_frame_headers_blob(blob, offs, szs, jp)
    tfb = t_fmv.parse_frame_headers_blob(blob, offs, szs, tp)
    assert_batches_equal(j_pipe.pad_frame_batch(jfb), t_pipe.pad_frame_batch(tfb))
