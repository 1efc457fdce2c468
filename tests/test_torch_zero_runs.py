"""The zero-run lookahead's plain version (kernel 8's reference) against
the JAX package.

``ops/encode.zero_run_lengths_sb`` on the sample-major (S, B) plane
against the JAX ``ops/encode.zero_run_lengths`` on the same (B, S)
residuals, made from numpy seeds: sparse and dense zeros, an all-zero
lane, and counts n of 0, S, past S and below 0.  Exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from alacnet_tpu.ops import encode as jenc  # noqa: E402
from alacnet_tpu_torch.ops.cuda.zero_runs import zero_run_lengths_fused  # noqa: E402
from alacnet_tpu_torch.ops.encode import zero_run_lengths_sb  # noqa: E402

from .test_torch_cuda import zero_run_case  # noqa: E402


def _check(errs, n):
    S = errs.shape[1]
    want = np.asarray(jenc.zero_run_lengths(jnp.asarray(errs), jnp.asarray(n), S))
    got = zero_run_lengths_sb(torch.from_numpy(errs.T.copy()), torch.from_numpy(n))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().T, want)
    return want


@pytest.mark.parametrize("zero_share", [0.0, 0.5, 0.97, 1.0])
@pytest.mark.parametrize("B,S", [(7, 1), (12, 64), (9, 257)])
def test_zero_runs_match_jax(B, S, zero_share):
    errs, n = zero_run_case(B, S, zero_share, seed=B * S)
    want = _check(errs, n)
    if S > 1:
        # lane 0 (all zero, n = S) runs to the end; lane 1 (n = 0) never runs
        np.testing.assert_array_equal(want[0], S - 1 - np.arange(S))
        assert not want[1].any()


def test_zero_runs_cap_at_0xffff_matches_jax():
    errs, n = zero_run_case(3, 70000, 1.0, seed=1)
    n[1] = 66000
    want = _check(errs, n)
    assert want.max() == 0xFFFF


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    errs, n = zero_run_case(10, 100, 0.8, seed=2)
    e, nn = torch.from_numpy(errs.T.copy()), torch.from_numpy(n)
    want = zero_run_lengths_sb(e, nn)
    assert torch.equal(zero_run_lengths_fused(e, nn), want)
    assert torch.equal(zero_run_lengths_fused(e, nn, kernel="torch"), want)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        zero_run_lengths_fused(e, nn, kernel="cuda")
