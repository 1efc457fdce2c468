"""The port stands alone: it never imports JAX, it never falls back to
the CPU on its own, and chip_smoke.py refuses to run without a card."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import alacnet_tpu_torch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "stereo24_extrabits.m4a"


def _run(args, cwd, env=None, timeout=300):
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, capture_output=True, text=True,
        timeout=timeout, env={**os.environ, **(env or {})},
    )


def test_port_imports_no_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
        "import alacnet_tpu_torch as at\n"
        f"r = at.decode_file({str(FIXTURE)!r}, device='cpu')\n"
        "assert r.pcm.shape == (700, 2), r.pcm.shape\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'alacnet_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = _run(["-c", code], cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _no_ok_line(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return False
        except (ValueError, AttributeError):
            continue
    return True


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    res = _run(["chip_smoke.py"], cwd=ROOT)
    assert res.returncode != 0
    assert _no_ok_line(res.stdout)


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(["chip_smoke.py"], cwd=tmp_path)
    assert res.returncode != 0
    assert _no_ok_line(res.stdout)


def test_cuda_config_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        alacnet_tpu_torch.DecodeConfig(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        alacnet_tpu_torch.DecodeConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        alacnet_tpu_torch.decode_file(FIXTURE)


def test_config_validates_kernel_route():
    with pytest.raises(ValueError, match="kernel"):
        alacnet_tpu_torch.DecodeConfig(device="cpu", kernel="fused")
    assert alacnet_tpu_torch.DecodeConfig(device="cpu", kernel="torch").kernel == "torch"
