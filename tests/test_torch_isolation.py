"""The port stands alone: it never imports JAX, it never falls back to
the CPU on its own, and chip_smoke.py refuses to run without a card."""

import ast
import json
import os
import pathlib
import re
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


def test_port_encodes_without_jax():
    code = (
        "import sys, io; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
        "import numpy as np\n"
        "import alacnet_tpu_torch as at\n"
        "t = np.arange(700)\n"
        "pcm = np.stack([t % 300 - 150, (t * 7) % 500 - 250], 1).astype(np.int32)\n"
        "outs = [io.BytesIO(), io.BytesIO()]\n"
        "at.encode_files([pcm, pcm[:, :1]], outs, 44100, 16, max_samples_per_frame=256,\n"
        "                device='cpu')\n"
        "got = at.decode_streams([io.BytesIO(o.getvalue()) for o in outs], device='cpu')\n"
        "assert np.array_equal(got[0].pcm, pcm) and np.array_equal(got[1].pcm, pcm[:, :1])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'alacnet_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = _run(["-c", code], cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cuda_encode_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import io

    import numpy as np

    pcm = np.zeros((100, 2), np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        alacnet_tpu_torch.encode_files([pcm], [io.BytesIO()], 44100)
    with pytest.raises(RuntimeError, match="CUDA"):
        alacnet_tpu_torch.encode_m4a(io.BytesIO(), pcm, 44100, device="cuda")
    # the host encoder needs no device
    alacnet_tpu_torch.encode_files([pcm], [io.BytesIO()], 44100, device=None)


def test_port_session_api_without_jax():
    code = (
        "import sys, io; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
        "import numpy as np\n"
        "import alacnet_tpu_torch as at\n"
        "from alacnet_tpu_torch import cli\n"
        f"data = open({str(FIXTURE)!r}, 'rb').read()\n"
        "with at.AlacContext(io.BytesIO(data), window=1, device='cpu') as ctx:\n"
        "    pcm = ctx.read_all()\n"
        "assert pcm.shape == (700, 2), pcm.shape\n"
        "r = at.ALACFileReader(io.BytesIO(data), device='cpu')\n"
        "r.seek(r.length // 2)\n"
        "assert len(r.read(r.length)) == r.length - r.length // 2\n"
        "r.close()\n"
        f"assert cli.main(['info', {str(FIXTURE)!r}]) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'alacnet_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = _run(["-c", code], cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"


def test_session_api_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import io

    from alacnet_tpu_torch import cli

    import numpy as np

    from alacnet_tpu_torch.pcm import write_wav

    data = FIXTURE.read_bytes()
    wav = tmp_path / "in.wav"
    with open(wav, "wb") as f:
        write_wav(f, np.zeros((300, 2), np.int32), 44100, 16, 2)
    for make in (
        lambda: alacnet_tpu_torch.AlacContext(io.BytesIO(data)),
        lambda: alacnet_tpu_torch.AlacContext(io.BytesIO(data), device="cuda"),
        lambda: alacnet_tpu_torch.ALACFileReader(io.BytesIO(data)),
        lambda: alacnet_tpu_torch.decode_resumable(alacnet_tpu_torch.DecodeCursor(str(FIXTURE))),
        lambda: cli.main(["decode", str(FIXTURE), str(tmp_path / "x.wav")]),
        lambda: cli.main(["batch-decode", str(FIXTURE)]),
        lambda: cli.main(["verify", str(FIXTURE)]),
        lambda: cli.main(["encode", str(wav), str(tmp_path / "y.m4a")]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert not (tmp_path / "x.wav").exists()
    assert cli.main(["encode", str(wav), str(tmp_path / "y.m4a"), "--host"]) == 0
    with alacnet_tpu_torch.AlacContext(io.BytesIO(data), device="cpu") as ctx:
        assert ctx.read_all().shape == (700, 2)
    assert cli.main(["decode", str(FIXTURE), str(tmp_path / "x.wav"), "--device", "cpu"]) == 0


def test_native_source_is_the_ports_own():
    from alacnet_tpu_torch import native

    port = ROOT / "alacnet_tpu_torch"
    assert native._SRC.resolve().is_relative_to(port.resolve())
    assert native._SRC.exists()


def test_native_source_equals_the_reference():
    """The port's copy of the host tier and the JAX package's stay byte
    for byte equal, so the two cannot drift (test code only: the port
    itself never reads the reference's file)."""
    copy = ROOT / "alacnet_tpu_torch" / "_native" / "host.cpp"
    ref = ROOT / "alacnet_tpu" / "_native" / "host.cpp"
    assert copy.read_bytes() == ref.read_bytes()


#: A provenance citation ("alacnet_tpu/ops/pallas/pack_rows.py:227"): a
#: file and line, never a path the code opens.
_CITATION = re.compile(r"^alacnet_tpu/[\w/]+\.py:\d+$")


def _reference_path_literals(path: pathlib.Path) -> list[str]:
    """String literals of ``path`` (docstrings aside) that name the JAX
    package as a path or a path component."""
    tree = ast.parse(path.read_text())
    docs = {
        id(node.body[0].value)
        for node in ast.walk(tree)
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
        and node.body and isinstance(node.body[0], ast.Expr)
        and isinstance(node.body[0].value, ast.Constant)
    }
    bad = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Constant) or not isinstance(node.value, str):
            continue
        if id(node) in docs or _CITATION.match(node.value):
            continue
        if re.search(r"(^|[/\\])alacnet_tpu([/\\]|$)", node.value):
            bad.append(f"{path.name}:{node.lineno}: {node.value!r}")
    return bad


def test_port_builds_no_path_into_the_reference(tmp_path):
    files = sorted((ROOT / "alacnet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [b for f in files for b in _reference_path_literals(f)]
    assert not bad, bad
    # the scan catches the pattern it is for (the old native.py's)
    probe = tmp_path / "probe.py"
    probe.write_text('SRC = ROOT / "alacnet_tpu" / "_native" / "host.cpp"\n'
                     'CITE = "alacnet_tpu/ops/pallas/pack_rows.py:227"\n')
    assert len(_reference_path_literals(probe)) == 1
