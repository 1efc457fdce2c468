"""``scripts/soak_torch.py`` on the CPU: its formats and signal are the JAX
soak's (``scripts/soak.py``), and a short run (one 256-sample frame per
format, the plain torch versions) encodes every file to the host
encoder's bytes and decodes every file back to its source."""

import ast
import dataclasses
import importlib.util
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "scripts"
sys.path.insert(0, str(SCRIPTS))
import soak_torch  # noqa: E402


def _jax_soak():
    spec = importlib.util.spec_from_file_location("jax_soak", SCRIPTS / "soak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_specs():
    """The ``specs`` list of the JAX soak's ``main``, evaluated with the
    JAX package's EncoderConfig."""
    from alacnet_tpu.codec.encoder import EncoderConfig

    tree = ast.parse((SCRIPTS / "soak.py").read_text())
    node = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "specs")
    return eval(compile(ast.Expression(node), "soak.py", "eval"),
                {"EncoderConfig": EncoderConfig})


def test_specs_and_signal_are_the_jax_soaks():
    want = [(n, r, b, c, dataclasses.asdict(cfg), kw) for n, r, b, c, cfg, kw in _jax_specs()]
    got = [(n, r, b, c, dataclasses.asdict(cfg), kw)
           for n, r, b, c, cfg, kw in soak_torch.SPECS]
    assert got == want
    jax_soak = _jax_soak()
    for i, (_, _, bits, ch, _, _) in enumerate(soak_torch.SPECS):
        np.testing.assert_array_equal(soak_torch.synth(5000, ch, bits, i),
                                      jax_soak.synth(5000, ch, bits, i))


def test_short_soak_on_the_cpu():
    rec = soak_torch.run_soak(device="cpu", samples=256, frame_samples=256,
                              log=lambda *a: None)
    assert [f["name"] for f in rec["files"]] == [s[0] for s in soak_torch.SPECS]
    assert all(f["host_bytes_equal"] and f["bit_exact"] for f in rec["files"])
    assert rec["all_ok"] and rec["total_samples"] == 6 * 256
    assert not rec["launches"]["encode"] and not rec["launches"]["decode"]  # no card
