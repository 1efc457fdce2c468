"""The decode epilogue's plain version (kernel 7's reference) against the
JAX package.

Frames made by the encoder from numpy seeds (256-sample frames, the last
one partial) go through the port's ``decode_frames_packed(kernel="torch")``,
whose epilogue is ``ops/cuda/epilogue.decode_epilogue_plain``, and through
the JAX ``decode_frames_packed(use_fused=False)``, on the same packed
metadata and word rows.  The grid covers mono and stereo, 16 and 24 bits,
``uncompressed_bytes`` 0 and 1, interlacing off, at the default and at
shift 20 / leftweight 200, raw (uncompressed) frames, and ``emit16``.
Beside it: ``decode_epilogue_plain`` with ``None`` planes against the
same call with zero planes.  Exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from alacnet_tpu.ops import frame_decode as jfd  # noqa: E402
from alacnet_tpu_torch.ops import frame_decode as tfd  # noqa: E402
from alacnet_tpu_torch.ops.cuda.epilogue import (  # noqa: E402
    decode_epilogue,
    decode_epilogue_plain,
)

from .test_torch_cuda import (  # noqa: E402
    EPI_S as S,
    EPILOGUE_CASES,
    EPILOGUE_COLUMNS,
    epilogue_batch,
    epilogue_frames,
    epilogue_mixed,
    epilogue_synthetic,
)


def _check(fb, words, emit16):
    packed = jfd.FrameMetaArrays.pack_host(fb)
    j_out, j_n = jfd.decode_frames_packed(
        jnp.asarray(words), jnp.asarray(packed), S, use_fused=False, emit16=emit16)
    t_out, t_n = tfd.decode_frames_packed(
        torch.from_numpy(words.view(np.int32).copy()), packed, S, emit16=emit16,
        kernel="torch")
    assert str(t_out.dtype) == "torch." + str(np.asarray(j_out).dtype)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))
    return packed


@pytest.mark.parametrize("name", list(EPILOGUE_CASES))
def test_epilogue_matches_jax(name):
    _, _, kw, raw, emit16 = EPILOGUE_CASES[name]
    packed = _check(*epilogue_batch(*epilogue_frames(name)), emit16)
    ub, comp = packed[:, 4], packed[:, 1] != 0
    assert (ub[comp] > 0).any() == bool(kw.get("uncompressed_bytes"))
    assert (~comp & (packed[:, 2] > 0)).any() == raw


@pytest.mark.parametrize("bits", [16, 24])
def test_epilogue_mixed_batch_matches_jax(bits):
    """Every case of one width in one batch: lanes of each format side
    by side, every optional plane present."""
    _check(*epilogue_mixed(bits), emit16=False)


def _synthetic(B, seed):
    planes, cols = epilogue_synthetic(B, S, seed)
    return ([torch.from_numpy(p) for p in planes],
            [torch.from_numpy(cols[k]) for k in EPILOGUE_COLUMNS])


@pytest.mark.parametrize("absent", [(1,), (2, 3), (4, 5), (1, 2, 3, 4, 5)],
                         ids=["out_b", "extra", "raw", "all-but-a"])
@pytest.mark.parametrize("emit16", [False, True])
def test_plain_none_planes_read_as_zeros(absent, emit16):
    """``None`` for a plane gives what an explicit zero plane gives."""
    B = 40
    planes, cols = _synthetic(B, seed=len(absent) + 10 * emit16)
    given = [None if i in absent else p for i, p in enumerate(planes)]
    zeros = [torch.zeros_like(p) if i in absent else p for i, p in enumerate(planes)]
    got = decode_epilogue_plain(*given, *cols, S, emit16)
    want = decode_epilogue_plain(*zeros, *cols, S, emit16)
    assert got.dtype == (torch.int16 if emit16 else torch.int32)
    assert got.shape == (B, S, 2)
    assert torch.equal(got, want)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    planes, cols = _synthetic(24, seed=3)
    want = decode_epilogue_plain(*planes, *cols, S)
    assert torch.equal(decode_epilogue(*planes, *cols, S), want)
    assert torch.equal(decode_epilogue(*planes, *cols, S, kernel="torch"), want)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        decode_epilogue(*planes, *cols, S, kernel="cuda")
