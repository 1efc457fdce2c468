"""The port's multi-process decode on torch.distributed (gloo, CPU).

Mirrors tests/test_distributed.py: N worker processes, each with a local
mesh of 4 CPU shards, shard the corpus by global frame index, decode,
and check (a) the all-reduced accounting scalars and (b) their own PCM,
bit for bit.  The worker is this file run as a script:

    python tests/test_torch_distributed.py <coordinator> <nprocs> <pid> [mode]

Modes: ``even`` (every process ingests FRAMES_PER_PROC frames),
``uneven`` (process p ingests FRAMES_PER_PROC + (P-1-p) frames and pads
to the common local batch with n_samples=0 lanes) and ``mismatch``
(process p pads to a local batch of its own, which must raise).
ALAC_DIST_INIT_TIMEOUT bounds the rendezvous, so a missing peer fails
the job instead of hanging it.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME_SAMPLES = 64
FRAMES_PER_PROC = 8
LOCAL_SHARDS = 4


def corpus(total_frames: int):
    """Deterministic corpus, identical in every process."""
    from alacnet_tpu_torch.codec.cookie import default_cookie
    from alacnet_tpu_torch.codec.encoder import AlacEncoder, EncoderConfig

    params = default_cookie(44100, 16, 2, max_samples_per_frame=FRAME_SAMPLES)
    enc = AlacEncoder(params, EncoderConfig(order=4))
    rng = np.random.default_rng(0xD15C)
    t = np.arange(total_frames * FRAME_SAMPLES)
    pcm = np.stack(
        [
            np.clip(2500 * np.sin(t * 0.06) + rng.normal(0, 30, t.size), -32768, 32767),
            np.clip(2000 * np.sin(t * 0.05 + 1) + rng.normal(0, 30, t.size), -32768, 32767),
        ],
        axis=1,
    ).astype(np.int32)
    payloads = [
        enc.encode_frame(pcm[i * FRAME_SAMPLES : (i + 1) * FRAME_SAMPLES])
        for i in range(total_frames)
    ]
    return payloads, params, pcm


def worker(coordinator: str, nprocs: int, pid: int, mode: str) -> int:
    sys.path.insert(0, REPO)
    import alacnet_tpu_torch.parallel.distributed as dist
    from alacnet_tpu_torch.codec.framemeta_vec import parse_frame_headers_vec
    from alacnet_tpu_torch.parallel.pipeline import pad_frame_batch

    timeout = int(os.environ.get("ALAC_DIST_INIT_TIMEOUT", "0")) or None
    dist.initialize(coordinator, nprocs, pid, initialization_timeout=timeout,
                    backend="gloo")
    try:
        mesh = dist.global_mesh(["cpu"] * LOCAL_SHARDS)
        if (mesh.rank, mesh.world_size) != (pid, nprocs):
            raise RuntimeError(f"rank {mesh.rank}/{mesh.world_size}")
        if mode == "uneven":
            counts = [FRAMES_PER_PROC + (nprocs - 1 - p) for p in range(nprocs)]
        else:
            counts = [FRAMES_PER_PROC] * nprocs
        # Common local batch: the largest shard, rounded up to the local
        # shard count (every process presents the same local batch).
        pad_to = -(-max(counts) // LOCAL_SHARDS) * LOCAL_SHARDS
        if mode == "mismatch":
            pad_to += LOCAL_SHARDS * pid
        total_frames = sum(counts)
        payloads, params, pcm = corpus(total_frames)
        lo = sum(counts[:pid])
        local = payloads[lo : lo + counts[pid]]
        fb = pad_frame_batch(parse_frame_headers_vec(local, params), pad_to)
        out, n, total, checksum = dist.decode_frames_global(fb, mesh, FRAME_SAMPLES)

        if total != total_frames * FRAME_SAMPLES:
            raise RuntimeError(f"total {total}")
        expect_ck = int(pcm.astype(np.int64).sum()) & 0xFFFFFFFF
        if checksum & 0xFFFFFFFF != expect_ck or not -(1 << 31) <= checksum < 1 << 31:
            raise RuntimeError(f"checksum {checksum}, expected {expect_ck} mod 2^32")
        out_l, n_l = dist.local_samples(out, n)
        k = counts[pid]
        if not ((n_l[:k] == FRAME_SAMPLES).all() and (n_l[k:] == 0).all()):
            raise RuntimeError(f"n {n_l}")
        got = out_l[:k, :, :2].reshape(-1, 2)
        want = pcm[lo * FRAME_SAMPLES : (lo + k) * FRAME_SAMPLES]
        np.testing.assert_array_equal(got, want)
        print(f"proc {pid}/{nprocs}: OK total={total} ck={checksum}", flush=True)
    finally:
        import torch.distributed

        torch.distributed.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(nprocs, mode="even", skip=(), extra_env=None):
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, **(extra_env or {})}
    return [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), coordinator, str(nprocs),
             str(pid), mode],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(nprocs)
        if pid not in skip
    ]


def _communicate(procs, timeout):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    return outs


@pytest.mark.parametrize("nprocs,mode", [(2, "even"), (2, "uneven"), (4, "uneven")])
def test_torch_multiprocess_decode_bit_exact(nprocs, mode):
    procs = _launch(nprocs, mode)
    outs = _communicate(procs, timeout=240)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"proc {pid}/{nprocs}: OK" in out


def test_torch_missing_worker_fails_within_its_timeout():
    """A worker whose peer never joins fails within the 10 s
    rendezvous timeout: it neither hangs nor succeeds."""
    t0 = time.monotonic()
    procs = _launch(2, skip={1}, extra_env={"ALAC_DIST_INIT_TIMEOUT": "10"})
    (out,) = _communicate(procs, timeout=120)
    (p,) = procs
    assert p.returncode != 0, "a lone worker should fail, not succeed"
    assert "proc 0/2: OK" not in out
    assert time.monotonic() - t0 < 60, "the lone worker outlived its timeout"


def test_torch_mismatched_local_batches_raise():
    """Processes presenting different padded local batches fail with
    a clear error instead of decoding a ragged global batch."""
    procs = _launch(2, mode="mismatch")
    outs = _communicate(procs, timeout=240)
    for p, out in zip(procs, outs):
        assert p.returncode != 0
        assert "same padded local batch" in out


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                    sys.argv[4] if len(sys.argv) > 4 else "even"))
