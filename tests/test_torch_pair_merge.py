"""The pair and quad merge's plain versions (kernel 9's reference)
against the JAX package, and the wrapper's routing, on the CPU.

``ops/encode.merge_pair_chunks`` and ``merge_quad_chunks`` against the
JAX ``ops/encode.merge_pair_chunks`` (:324) and ``merge_quad_chunks``
(:377) on the same planes, made from numpy seeds
(``tests/test_torch_cuda.pair_merge_case``, which the card tests share):
odd S and S of 1, 2 and 3, widths at the ladder's edges (0, 31, 32,
33, 64, 81, 96), pairs past 96 bits (-1 widths, ``fat``), quads fed a
-1 pair, words with bits above their width, and planes given as (B, S)
views of (S, B) storage, as ``enc_rice`` returns them.  Exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from alacnet_tpu.ops import encode as jenc  # noqa: E402
from alacnet_tpu_torch.ops import encode as tenc  # noqa: E402
from alacnet_tpu_torch.ops.cuda.pair_merge import (  # noqa: E402
    merge_pair_chunks_fused,
    merge_pair_chunks_plain,
)

from .test_torch_cuda import (  # noqa: E402
    pair_merge_case,
    pair_merge_edges,
    pair_merge_planes,
)


def _jax_merge(case, quads):
    """The JAX package's merge of the case's planes, as numpy, the uint32
    planes viewed as int32."""
    out = jenc.merge_pair_chunks(*(jnp.asarray(x) for x in case))
    if quads:
        out = (*out, *jenc.merge_quad_chunks(*out[:4]))
    out = [np.asarray(x) for x in out]
    return [x.view(np.int32) if x.dtype == np.uint32 else x for x in out]


def _check(case, quads, layout="lane_major"):
    want = _jax_merge(case, quads)
    got = merge_pair_chunks_plain(*pair_merge_planes(case, layout, "cpu"), quads=quads)
    assert len(got) == len(want) == (10 if quads else 5)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.numpy().dtype == w.dtype, i
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"output {i}")
    return got


@pytest.mark.parametrize("quads", [False, True])
@pytest.mark.parametrize("B,S", [(1, 1), (2, 2), (3, 3), (4, 7), (9, 64), (6, 161), (5, 257)])
def test_merge_matches_jax(B, S, quads):
    got = _check(pair_merge_case(B, S, seed=B * S, edge_share=0.2), quads)
    P = -(-S // 2)
    assert got[0].shape == (B, P)
    if quads:
        assert got[5].shape == (B, -(-P // 2))


@pytest.mark.parametrize("quads", [False, True])
def test_merge_ladder_edges_match_jax(quads):
    """Every (wa, wb) of the ladder's edge widths: a 96-bit B rolls A out
    of the three words, 64 + 33 passes 96 bits (-1, fat), and with quads
    every pair of those pairs (-1 pairs clamped to 0 and poisoning)."""
    got = _check(pair_merge_edges(), quads)
    pws = got[3].numpy()
    assert (pws[0] == -1).any() and bool(got[4][0]) and bool(got[4][1])
    widths = [(a + b) if a + b <= 96 else -1
              for a in (0, 31, 32, 33, 64, 81, 96) for b in (0, 31, 32, 33, 64, 81, 96)]
    np.testing.assert_array_equal(pws[0], widths)
    if quads:
        assert bool(got[9][0])


def test_fat_pair_and_poisoned_quad_match_jax():
    """Lane 1's adjacent 81-bit samples: pair 1 is -1 and the lane fat;
    its quad 0 takes the -1 pair as width 0 and the lane is quad-fat,
    while the all-zero-width lane 0 is neither."""
    got = _check(pair_merge_case(4, 64, seed=3), quads=True)
    ph, pm, pl, pws, fat, qh, qm, ql, qws, qfat = got
    assert pws[1, 1] == -1 and bool(fat[1]) and bool(qfat[1])
    assert not bool(fat[0]) and not bool(qfat[0]) and not pws[0].any()


@pytest.mark.parametrize("layout", ["sample_major", "misaligned"])
@pytest.mark.parametrize("S", [3, 64, 65])
def test_merge_of_sample_major_views_matches_jax(S, layout):
    """Planes as (B, S) views of (S, B) storage (and such views one
    element into a larger buffer), as ``enc_rice`` returns them."""
    _check(pair_merge_case(7, S, seed=S, edge_share=0.1), quads=True, layout=layout)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    planes = pair_merge_planes(pair_merge_case(10, 100, seed=2), "sample_major", "cpu")
    for quads in (False, True):
        want = merge_pair_chunks_plain(*planes, quads=quads)
        for kernel in ("auto", "torch"):
            got = merge_pair_chunks_fused(*planes, quads=quads, kernel=kernel)
            assert len(got) == len(want)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    pairs = tenc.merge_pair_chunks(*planes)
    assert all(torch.equal(g, w) for g, w in zip(merge_pair_chunks_fused(*planes), pairs))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        merge_pair_chunks_fused(*planes, kernel="cuda")
    with pytest.raises(ValueError, match="kernel must be one of"):
        merge_pair_chunks_fused(*planes, kernel="fused")


def test_wrapper_rejects_bad_planes():
    c0, c1, c2, ws = pair_merge_planes(pair_merge_case(6, 40, seed=4), "lane_major", "cpu")
    with pytest.raises(ValueError, match="expected \\(B, S\\) planes"):
        merge_pair_chunks_fused(c0[0], c1[0], c2[0], ws[0])
    with pytest.raises(ValueError, match="c1: expected"):
        merge_pair_chunks_fused(c0, c1[:, :39], c2, ws)
    with pytest.raises(ValueError, match="ws: expected"):
        merge_pair_chunks_fused(c0, c1, c2, ws.to(torch.int32))
    with pytest.raises(ValueError, match="c2: expected"):
        merge_pair_chunks_fused(c0, c1, c2.to(torch.int64), ws)
