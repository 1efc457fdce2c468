"""The CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and ``nvcc``; without a card each
skips with the reason.  On the card, whose machine has no JAX (which
``tests/conftest.py`` imports): ``python -m pytest
tests/test_torch_cuda.py --noconftest -o addopts= -q``.  Exact equality.
"""

import io
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

SMOKE = pathlib.Path(__file__).parent / "fixtures" / "torch_smoke"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    from alacnet_tpu_torch.ops.cuda import _lib

    _lib.get_lib()  # builds the kernels; a failed build fails the test
    return torch.device("cuda")


def _span(dev, name="music.m4a", copies=4):
    """The first planned span of a smoke file, as the main path builds it."""
    from alacnet_tpu_torch.batch import _collect
    from alacnet_tpu_torch.ops.cuda.pack_rows import blob_words
    from alacnet_tpu_torch.parallel import pipeline as P

    info, blob = _collect(io.BytesIO((SMOKE / name).read_bytes()))
    blob = np.concatenate([blob] * copies)
    off1 = info.tables.frame_file_offsets()
    offs = np.concatenate([off1 + i * (len(blob) // copies) for i in range(copies)])
    szs = np.tile(info.tables.frame_byte_sizes, copies)
    perm, _, spans, span_batch = P.plan_blob_batches(
        blob, offs, szs, info.params, 4096, True
    )
    fb, ow, nb, W = span_batch(perm[spans[0][0] : spans[0][1]], device_rows=True)
    fb = P.pad_frame_batch(fb)
    bw = blob_words(blob, dev, max_w=W + 8)
    ow = torch.from_numpy(P._pad_axis0(ow, fb.batch)).to(dev)
    nb = torch.from_numpy(P._pad_axis0(nb, fb.batch)).to(dev)
    return fb, bw, ow, nb, W


def test_pack_rows_kernel_matches_plain(cuda):
    from alacnet_tpu_torch.ops.cuda.pack_rows import pack_rows

    _, bw, ow, nb, W = _span(cuda)
    got = pack_rows(bw, ow, nb, W, kernel="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, pack_rows(bw, ow, nb, W, kernel="torch"))


@pytest.mark.parametrize("name", ["music.m4a", "orders.m4a", "spiky.m4a", "mono16.m4a"])
def test_rice_lpc_kernel_matches_plain(cuda, name):
    from alacnet_tpu_torch.ops.cuda.pack_rows import pack_rows
    from alacnet_tpu_torch.ops.cuda.rice_lpc import fused_rice_lpc
    from alacnet_tpu_torch.ops.frame_decode import FrameMetaArrays

    fb, bw, ow, nb, W = _span(cuda, name, copies=1)
    words = pack_rows(bw, ow, nb, W)
    m = FrameMetaArrays.from_packed(FrameMetaArrays.pack_host(fb), cuda)
    n = torch.clamp(m.n_samples, 0, 4096)
    args = (words, m.entropy_pos, n, m.rss, m.kmod, m.init_history,
            m.rice_mult[:, 0], m.kmask, m.order[:, 0], m.quant[:, 0],
            m.rc[:, 0].contiguous(), 4096)
    out, end = fused_rice_lpc(*args, kernel="cuda")
    torch.cuda.synchronize()
    p_out, p_end = fused_rice_lpc(*args, kernel="torch")
    assert torch.equal(out, p_out) and torch.equal(end, p_end)


def test_bulk_bits_kernel_matches_plain(cuda):
    from alacnet_tpu_torch.ops.cuda.bulk_bits import bulk_bits
    from alacnet_tpu_torch.ops.cuda.pack_rows import pack_rows
    from alacnet_tpu_torch.ops.frame_decode import FrameMetaArrays

    fb, bw, ow, nb, W = _span(cuda, "hires24.m4a")
    words = pack_rows(bw, ow, nb, W)
    m = FrameMetaArrays.from_packed(FrameMetaArrays.pack_host(fb), cuda)
    ub8 = m.ub * 8
    args = (words, m.payload_pos, torch.clamp(m.n_samples, 0, 4096), ub8,
            torch.where(m.is_stereo, ub8, 0), 4096)
    got = bulk_bits(*args, kernel="cuda")
    torch.cuda.synchronize()
    want = bulk_bits(*args, kernel="torch")
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_decode_streams_on_card_matches_expected(cuda):
    import hashlib

    import alacnet_tpu_torch
    from alacnet_tpu_torch.ops.cuda import _lib

    expected = json.loads((SMOKE / "expected.json").read_text())
    names = sorted(expected)
    _lib.reset_launches()
    got = alacnet_tpu_torch.decode_streams(
        [io.BytesIO((SMOKE / n).read_bytes()) for n in names], device="cuda"
    )
    for name, r in zip(names, got):
        assert hashlib.sha256(r.pcm.tobytes()).hexdigest() == expected[name]["sha256"]
    assert all(_lib.LAUNCHES[k] > 0 for k in ("pack_rows", "rice_lpc", "bulk_bits"))
