"""The port's multi-process decode on torch.distributed (gloo, CPU).

Mirrors tests/test_distributed.py: N worker processes, each with a local
mesh of 4 CPU shards, shard the corpus by global frame index, decode,
and check (a) the all-reduced accounting scalars and (b) their own PCM,
bit for bit.  The worker is this file run as a script:

    python tests/test_torch_distributed.py <coordinator> <nprocs> <pid> [mode]

Modes: ``even`` (every process ingests FRAMES_PER_PROC frames),
``uneven`` (process p ingests FRAMES_PER_PROC + (P-1-p) frames and pads
to the common local batch with n_samples=0 lanes), ``mismatch``
(process p pads to a local batch of its own, which must raise) and
``ranks`` (as ``even``, but each process takes its devices through
``global_mesh()``'s default under ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``,
from LOCAL_SHARDS * P stand-in cards ``cpu:0``, ``cpu:1``, ...: the
visible card count is faked inside the worker).
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
        if mode == "ranks":
            import torch

            cards = [torch.device("cpu", i) for i in range(LOCAL_SHARDS * nprocs)]
            dist.visible_cards = lambda: cards
            mesh = dist.global_mesh()
            mine = [d.index for d in mesh.local.devices]
            if mine != list(range(pid * LOCAL_SHARDS, (pid + 1) * LOCAL_SHARDS)):
                raise RuntimeError(f"rank {pid} took cards {mine}")
        else:
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
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(extra_env or {})

    def rank_env(pid):
        if mode != "ranks":
            return env
        return {**env, "LOCAL_RANK": str(pid), "LOCAL_WORLD_SIZE": str(nprocs)}

    return [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), coordinator, str(nprocs),
             str(pid), mode],
            env=rank_env(pid), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
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


@pytest.mark.parametrize("nprocs,mode", [(2, "even"), (2, "uneven"), (4, "uneven"),
                                         (2, "ranks")])
def test_torch_multiprocess_decode_bit_exact(nprocs, mode):
    procs = _launch(nprocs, mode)
    outs = _communicate(procs, timeout=240)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"proc {pid}/{nprocs}: OK" in out


@pytest.mark.parametrize("local_world,cards,shares", [
    (2, 4, [[0, 1], [2, 3]]),              # an even split
    (4, 4, [[0], [1], [2], [3]]),          # one card each of four
    (1, 4, [[0, 1, 2, 3]]),                # one process with every card
    (2, 8, [[0, 1, 2, 3], [4, 5, 6, 7]]),
    (3, 4, None),                          # uneven: raises
    (4, 2, None),                          # a share of zero cards: raises
    (2, 0, None),
])
def test_each_rank_takes_its_own_cards(local_world, cards, shares, monkeypatch):
    """``local_cards`` gives the ranks of one host equal, disjoint,
    contiguous shares that cover every card, or raises naming the
    counts; ``rank_devices`` maps the share onto the visible cards."""
    import torch

    import alacnet_tpu_torch.parallel.distributed as tdist

    if shares is None:
        for rank in range(local_world):
            with pytest.raises(ValueError, match=f"{cards} visible cards .* {local_world} ranks"):
                tdist.local_cards(rank, local_world, cards)
        return
    got = [list(tdist.local_cards(r, local_world, cards)) for r in range(local_world)]
    assert got == shares
    with pytest.raises(ValueError, match="outside"):
        tdist.local_cards(local_world, local_world, cards)
    visible = [torch.device("cpu", i) for i in range(cards)]
    monkeypatch.setattr(tdist, "visible_cards", lambda: visible)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert tdist.rank_devices() == visible
    for r, share in enumerate(shares):
        monkeypatch.setenv("LOCAL_RANK", str(r))
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
        assert [d.index for d in tdist.rank_devices()] == share


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
