"""The port's runtime configuration against the JAX package's, on the CPU.

The port reads the 13 ``ALAC_*`` variables that configure behaviour it
shares with the JAX package: the decode config (``ALAC_BATCH_LIMIT``,
``ALAC_STREAM_WINDOW``, ``ALAC_KERNEL``, ``ALAC_STRICT``,
``ALAC_EMIT16``, ``ALAC_NATIVE``, ``ALAC_DEVICE_PACK``), the encoder's
routes (``ALAC_ENC_KERNEL``, ``ALAC_ENC_PAIR``, ``ALAC_ENC_QUAD``,
``ALAC_ENC_DEVICE_PACK``, ``ALAC_ENC_PACK_IMPL``) and the native tier
(``ALAC_NO_NATIVE``).  Under each, and with none set, the port's
resolved config, lane plan and route equal the JAX package's; an
explicit argument beats the variable; a value the JAX package refuses
raises in the port too.  Three variables that only tune the JAX
package's speed (``ALAC_ORDER_SPANS``, ``ALAC_ORDER_PRIMARY``,
``ALAC_ENC_PAIR_ILV``) are not read: the port keeps the default plan and
the default pair writer under any value.

The JAX package reads its ``config.DEFAULT`` once, at import: its config
is built fresh here (its fields read the environment when built), and
its planner and native tier are given the value through ``DEFAULT``'s
fields.  Every variable is set with ``monkeypatch``, so none leaks.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alacnet_tpu import config as jconfig  # noqa: E402
from alacnet_tpu import native as jnative  # noqa: E402
from alacnet_tpu.codec import encoder_tpu as jet  # noqa: E402
from alacnet_tpu.codec.cookie import CodecParams as JaxCodecParams  # noqa: E402
from alacnet_tpu.parallel import pipeline as jpipe  # noqa: E402

from alacnet_tpu_torch import bench_lib, native  # noqa: E402
from alacnet_tpu_torch.codec import encoder_device as ed  # noqa: E402
from alacnet_tpu_torch.config import DecodeConfig, resolve  # noqa: E402
from alacnet_tpu_torch.parallel import pipeline as tpipe  # noqa: E402

DECODE_VARS = ("ALAC_BATCH_LIMIT", "ALAC_STREAM_WINDOW", "ALAC_KERNEL", "ALAC_STRICT",
               "ALAC_EMIT16", "ALAC_NATIVE", "ALAC_DEVICE_PACK")
ENCODE_VARS = ("ALAC_ENC_KERNEL", "ALAC_ENC_PAIR", "ALAC_ENC_QUAD", "ALAC_ENC_DEVICE_PACK",
               "ALAC_ENC_PACK_IMPL")
NATIVE_VARS = ("ALAC_NO_NATIVE",)
CARRIED = DECODE_VARS + ENCODE_VARS + NATIVE_VARS
#: The JAX package's speed-only variables, which the port does not read.
SPEED_ONLY = ("ALAC_ORDER_SPANS", "ALAC_ORDER_PRIMARY", "ALAC_ENC_PAIR_ILV")
#: DecodeConfig fields both packages have.
SHARED = ("batch_limit", "stream_window", "kernel", "strict", "emit16", "native",
          "device_pack")
#: The JAX package's kernel routes as the port names them.
PORT_KERNEL = {"auto": "auto", "fused": "cuda", "xla": "torch", "fused-interpret": "cuda"}


@pytest.fixture(autouse=True)
def no_alac_env(monkeypatch):
    """Start every test with none of the carried variables set."""
    for name in CARRIED + SPEED_ONLY:
        monkeypatch.delenv(name, raising=False)


def test_thirteen_variables_carried():
    assert len(set(CARRIED)) == 13
    assert not set(CARRIED) & set(SPEED_ONLY)


def _assert_configs_equal(j, t):
    for f in SHARED:
        want = PORT_KERNEL[j.kernel] if f == "kernel" else getattr(j, f)
        assert getattr(t, f) == want, f


@pytest.mark.parametrize("name,value", [
    (None, None),
    ("ALAC_BATCH_LIMIT", "1024"), ("ALAC_STREAM_WINDOW", "8"),
    ("ALAC_KERNEL", "auto"), ("ALAC_KERNEL", "fused"), ("ALAC_KERNEL", "xla"),
    ("ALAC_STRICT", "0"), ("ALAC_STRICT", "false"), ("ALAC_STRICT", "1"),
    ("ALAC_EMIT16", "no"), ("ALAC_NATIVE", "0"), ("ALAC_DEVICE_PACK", "False"),
])
def test_decode_config_matches_jax(monkeypatch, name, value):
    if name is not None:
        monkeypatch.setenv(name, value)
    _assert_configs_equal(jconfig.DecodeConfig().validate(), DecodeConfig(device="cpu"))


@pytest.mark.parametrize("name,value", [
    ("ALAC_KERNEL", "bogus"), ("ALAC_BATCH_LIMIT", "0"), ("ALAC_BATCH_LIMIT", "many"),
    ("ALAC_STREAM_WINDOW", "x"),
])
def test_bad_decode_value_raises_in_both(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError):
        jconfig.DecodeConfig().validate()
    with pytest.raises(ValueError):
        DecodeConfig(device="cpu")


def test_validate_returns_the_config():
    j, t = jconfig.DecodeConfig(), DecodeConfig(device="cpu")
    assert j.validate() is j and t.validate() is t


@pytest.mark.parametrize("field,bad", [("kernel", "gpu"), ("batch_limit", 0),
                                       ("batch_limit", -4)])
def test_validate_raises_on_a_bad_field_in_both(field, bad):
    with pytest.raises(ValueError):
        jconfig.DecodeConfig(**{field: bad}).validate()
    with pytest.raises(ValueError):
        DecodeConfig(device="cpu", **{field: bad}).validate()
    # a field set after construction, on the frozen dataclass
    j, t = jconfig.DecodeConfig(), DecodeConfig(device="cpu")
    object.__setattr__(j, field, bad)
    object.__setattr__(t, field, bad)
    with pytest.raises(ValueError):
        j.validate()
    with pytest.raises(ValueError):
        t.validate()


def test_kernel_variable_takes_both_packages_names(monkeypatch):
    for value, want in (("fused", "cuda"), ("xla", "torch"), ("cuda", "cuda"),
                        ("torch", "torch"), ("auto", "auto")):
        monkeypatch.setenv("ALAC_KERNEL", value)
        assert DecodeConfig(device="cpu").kernel == want, value
    # An explicit argument keeps to the port's names.
    with pytest.raises(ValueError, match="kernel"):
        DecodeConfig(device="cpu", kernel="fused")


def test_explicit_arguments_beat_the_variables(monkeypatch):
    monkeypatch.setenv("ALAC_STRICT", "0")
    monkeypatch.setenv("ALAC_BATCH_LIMIT", "1024")
    monkeypatch.setenv("ALAC_KERNEL", "xla")
    c = DecodeConfig(device="cpu", strict=True, batch_limit=64, kernel="auto")
    assert (c.strict, c.batch_limit, c.kernel) == (True, 64, "auto")
    assert resolve(device="cpu", strict=True).strict is True
    assert resolve(device="cpu").strict is False


def test_variables_are_read_when_a_config_is_built(monkeypatch):
    first = DecodeConfig(device="cpu")
    monkeypatch.setenv("ALAC_STREAM_WINDOW", "5")
    assert DecodeConfig(device="cpu").stream_window == 5
    assert first.stream_window == 64
    # replace keeps the fields it is not given, whatever the environment
    assert dataclasses.replace(first, strict=False).stream_window == 64


def test_device_has_no_variable(monkeypatch):
    monkeypatch.setenv("ALAC_DEVICE", "cpu")
    assert DecodeConfig(device="cpu").device == "cpu"
    assert "device" not in [f.name for f in dataclasses.fields(jconfig.DecodeConfig)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DecodeConfig()


# ---- the lane plan --------------------------------------------------------

@pytest.fixture(scope="module")
def mixed_pool():
    """The bench's mixed pool (12,288 frames, the run order of seed 7),
    as a blob with the port's and the JAX package's params."""
    pool, _, params = bench_lib._mixed_pool_frames(4096, 16)
    rng = np.random.default_rng(7)
    total = 3 * 4096
    src = rng.permutation(np.repeat(np.arange(len(pool)), -(-total // len(pool)))[:total])
    blob, offsets, sizes = bench_lib._blob([pool[i] for i in src])
    return blob, offsets, sizes, params, JaxCodecParams(**dataclasses.asdict(params))


@pytest.mark.parametrize("batch_limit", [4096, 1024])
def test_plan_matches_jax(monkeypatch, mixed_pool, batch_limit):
    """The port's plan is the JAX package's default plan (``order_spans``
    on, ``order_primary`` off), directly and through ``decode_blob``'s
    host stage from ``ALAC_BATCH_LIMIT``."""
    blob, offsets, sizes, params, jparams = mixed_pool
    assert (jconfig.DEFAULT.order_spans, jconfig.DEFAULT.order_primary) == (True, False)
    jperm, jinv, jspans, _ = jpipe.plan_blob_batches(blob, offsets, sizes, jparams,
                                                     batch_limit, True)
    tperm, tinv, tspans, _ = tpipe.plan_blob_batches(blob, offsets, sizes, params,
                                                     batch_limit, True)
    np.testing.assert_array_equal(tperm, jperm)
    np.testing.assert_array_equal(tinv, jinv)
    assert tspans == jspans
    monkeypatch.setenv("ALAC_BATCH_LIMIT", str(batch_limit))
    config = DecodeConfig(device="cpu")
    inv, _, spans = tpipe.blob_spans(blob, offsets, sizes, params, config.batch_limit, config)
    got = [idx for idx, _, _ in spans]
    np.testing.assert_array_equal(inv, jinv)
    assert [len(i) for i in got] == [hi - lo for lo, hi in jspans]
    np.testing.assert_array_equal(np.concatenate(got), jperm)


def test_speed_only_variables_leave_the_plan(monkeypatch, mixed_pool):
    """``ALAC_ORDER_SPANS`` and ``ALAC_ORDER_PRIMARY`` change the JAX
    package's lane order but never its output; the port does not read
    them and keeps the default plan."""
    blob, offsets, sizes, params, _ = mixed_pool
    want = tpipe.blob_spans(blob, offsets, sizes, params, 4096, DecodeConfig(device="cpu"))
    monkeypatch.setenv("ALAC_ORDER_SPANS", "0")
    monkeypatch.setenv("ALAC_ORDER_PRIMARY", "1")
    got = tpipe.blob_spans(blob, offsets, sizes, params, 4096, DecodeConfig(device="cpu"))
    np.testing.assert_array_equal(got[0], want[0])
    got_idx, want_idx = [[idx for idx, _, _ in p[2]] for p in (got, want)]
    assert [len(i) for i in got_idx] == [len(i) for i in want_idx]
    np.testing.assert_array_equal(np.concatenate(got_idx), np.concatenate(want_idx))
    assert not {"order_spans", "order_primary"} & {
        f.name for f in dataclasses.fields(DecodeConfig)}


# ---- encoder routes and the native tier --------------------------------------

def _jax_route() -> dict:
    """The JAX package's encode route under the current environment, on
    the CPU, with the port's names."""
    device_pack = jet._enc_device_pack()
    return {"kernel": PORT_KERNEL[jet._enc_kernel("cpu")],
            "pairs": jet._enc_pairs() and not device_pack,
            "quads": jet._enc_quads(), "device_pack": device_pack}


def _port_route() -> dict:
    r = ed.resolve_routes()
    return {"kernel": "torch" if r["kernel"] == "auto" else r["kernel"],  # auto on the CPU
            "pairs": r["pairs"], "quads": r["quads"], "device_pack": r["pack"] != "host"}


@pytest.fixture
def jax_native_unlatched(monkeypatch):
    """Let the JAX native tier read the environment again (it latches at
    its first load); the loaded library comes back after the test."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)


ROUTE_SETTINGS = [
    {}, {"ALAC_ENC_KERNEL": "auto"}, {"ALAC_ENC_KERNEL": "fused"}, {"ALAC_ENC_KERNEL": "xla"},
    {"ALAC_ENC_PAIR": "auto"}, {"ALAC_ENC_PAIR": "0"}, {"ALAC_ENC_PAIR": "1"},
    {"ALAC_ENC_QUAD": "0"}, {"ALAC_ENC_QUAD": "1"}, {"ALAC_ENC_QUAD": "auto"},
    {"ALAC_ENC_DEVICE_PACK": "1"}, {"ALAC_ENC_DEVICE_PACK": "0"},
    {"ALAC_ENC_DEVICE_PACK": "1", "ALAC_ENC_PACK_IMPL": "gather"},
    {"ALAC_ENC_DEVICE_PACK": "1", "ALAC_ENC_PAIR": "1", "ALAC_ENC_QUAD": "1"},
    {"ALAC_NO_NATIVE": "1"}, {"ALAC_NO_NATIVE": "1", "ALAC_ENC_PAIR": "0"},
]


@pytest.mark.parametrize("env", ROUTE_SETTINGS,
                         ids=["-".join(f"{k[5:]}={v}" for k, v in e.items()) or "none"
                              for e in ROUTE_SETTINGS])
def test_encode_route_matches_jax(monkeypatch, jax_native_unlatched, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert _port_route() == _jax_route()


def test_native_variable_turns_the_tier_off(monkeypatch, jax_native_unlatched):
    assert native.available() and jnative.available()
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    monkeypatch.setenv("ALAC_NATIVE", "0")
    monkeypatch.setattr(jconfig.DEFAULT, "native", False)  # read at import there
    assert not native.available() and not jnative.available()
    assert _port_route() == _jax_route()
    assert not ed.resolve_routes()["pairs"]


@pytest.mark.parametrize("env", [
    {"ALAC_ENC_KERNEL": "cuda"}, {"ALAC_ENC_PAIR": "yes"}, {"ALAC_ENC_QUAD": "2"},
], ids=["kernel", "pair", "quad"])
def test_bad_route_value_raises_in_both(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError):
        _jax_route()
    with pytest.raises(ValueError):
        ed.resolve_routes()


def test_bad_pack_impl_raises(monkeypatch):
    monkeypatch.setenv("ALAC_ENC_DEVICE_PACK", "1")
    monkeypatch.setenv("ALAC_ENC_PACK_IMPL", "both")
    with pytest.raises(ValueError, match="ALAC_ENC_PACK_IMPL"):
        ed.resolve_routes()
    monkeypatch.setenv("ALAC_ENC_DEVICE_PACK", "0")  # read only with the device pack
    assert ed.resolve_routes()["pack"] == "host"


def test_pairs_on_without_the_native_tier_raises_in_both(monkeypatch, jax_native_unlatched):
    monkeypatch.setenv("ALAC_NO_NATIVE", "1")
    monkeypatch.setenv("ALAC_ENC_PAIR", "1")
    with pytest.raises(RuntimeError):
        jet._enc_pairs()
    with pytest.raises(RuntimeError, match="native"):
        ed.resolve_routes()
    monkeypatch.delenv("ALAC_ENC_PAIR")
    with pytest.raises(RuntimeError, match="native"):
        ed.resolve_routes(pairs=True)


def test_explicit_route_arguments_beat_the_variables(monkeypatch):
    for k, v in {"ALAC_ENC_KERNEL": "fused", "ALAC_ENC_DEVICE_PACK": "1",
                 "ALAC_ENC_PACK_IMPL": "gather", "ALAC_ENC_QUAD": "1",
                 "ALAC_ENC_PAIR": "0"}.items():
        monkeypatch.setenv(k, v)
    assert ed.resolve_routes() == {"kernel": "cuda", "pack": "gather", "quads": True,
                                   "pairs": False}
    assert ed.resolve_routes(kernel="torch", pack="host", quads=False, pairs=True) == {
        "kernel": "torch", "pack": "host", "quads": False, "pairs": True}
    assert ed.resolve_routes(pack="scatter")["pack"] == "scatter"


def test_no_variable_keeps_the_default_route():
    assert ed.resolve_routes() == {"kernel": "auto", "pack": "host", "quads": False,
                                   "pairs": native.available()}


def _pick_writer(lib, monkeypatch, pack):
    """Which pair writer ``pack`` calls: each writer of ``lib`` swapped
    for a recorder of its name."""
    called = []
    for name in ("alac_pack_pair_frames", "alac_pack_pair_frames4", "alac_pack_pair_frames8"):
        monkeypatch.setattr(lib, name, lambda *a, name=name: called.append(name))
    pack()
    return called


@pytest.mark.parametrize("ilv", [None, "4"])
def test_pair_writer_matches_jax(monkeypatch, ilv):
    """The port's pair writer is the JAX package's default (``auto``: the
    eight-lane writer where the library has it, else two); the port does
    not read ``ALAC_ENC_PAIR_ILV``, so it keeps that writer under any
    value, and every writer's bytes are the same."""
    F, NP = 2, 4
    planes = [np.zeros((2 * F, NP), np.uint32)] * 3
    args = (np.zeros(1, np.uint32), np.zeros(1, np.uint8), np.array([0, 0, 0], np.int64),
            None, None, *planes, np.zeros((2 * F, NP), np.int8),
            np.full(F, 2 * NP, np.int32), np.ones(F, np.uint8), 2 * NP, 64)
    want = _pick_writer(jnative.get_lib(), monkeypatch,
                        lambda: jnative.pack_pair_frames_native(*args))
    if ilv is not None:
        monkeypatch.setenv("ALAC_ENC_PAIR_ILV", ilv)
    got = _pick_writer(native.get_lib(), monkeypatch,
                       lambda: native.pack_pair_frames_native(*args))
    assert len(got) == 1 and got == want
