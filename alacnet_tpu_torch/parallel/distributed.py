"""Multi-process decode on ``torch.distributed``.

The counterpart of ``alacnet_tpu/parallel/distributed.py``:

  * **Corpus sharding:** frames are independent, so a corpus shards by
    global frame index: process p takes its own contiguous frames.  No
    frame data crosses a process.
  * **Device sharding:** inside each process the frames shard further
    over its local :class:`~.mesh.Mesh` (``parallel/mesh.py``).
  * **Collectives:** the decode needs none.  One small ``all_gather``
    checks that every process presents the same padded local batch (the
    JAX package's contract), and one ``all_reduce`` sums the accounting
    scalars (total samples, the PCM checksum mod 2^32).

Recipe (each process):

    import alacnet_tpu_torch.parallel.distributed as dist
    dist.initialize(coordinator, num_processes, process_id, backend="nccl")
    mesh = dist.global_mesh(["cuda:0"])        # this process's devices
    fb_local = parse(local frame shard)        # host, padded
    out, n, total, checksum = dist.decode_frames_global(
        fb_local, mesh, num_samples)
    pcm, n = dist.local_samples(out, n)        # this process's lanes

``backend`` is explicit: ``nccl`` for one card per rank (NCCL refuses
two ranks on one card), ``gloo`` for CPU processes or several ranks on
one card.  Under ``gloo`` the collectives run on CPU tensors.
"""

from __future__ import annotations

import datetime
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import (
    Mesh, Sharded, _decode_and_account, make_mesh, shard_frame_batch, wrap_int32,
)


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    initialization_timeout: int | None = None,
    *,
    backend: str,
) -> None:
    """Join the process group (``torch.distributed.init_process_group``).

    ``coordinator_address``: ``host:port`` (or ``tcp://host:port``) of
    process 0, which serves the rendezvous.  ``initialization_timeout``
    (seconds) bounds the wait for peers and every later collective: a
    process that never arrives fails the job instead of hanging it
    (default: torch's).
    """
    init = coordinator_address
    if "://" not in init:
        init = f"tcp://{init}"
    kw = {}
    if initialization_timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    dist.init_process_group(
        backend=backend, init_method=init, world_size=num_processes,
        rank=process_id, **kw,
    )


class GlobalMesh(NamedTuple):
    """The frame axis across processes: this process's ``local`` mesh,
    its ``rank`` among ``world_size`` processes.  Process p's lanes
    follow process p-1's."""

    local: Mesh
    rank: int
    world_size: int


def global_mesh(devices=None) -> GlobalMesh:
    """The frame-parallel mesh over every process: this process's shards
    on ``devices`` (default every visible card, ``make_mesh``)."""
    return GlobalMesh(make_mesh(devices), dist.get_rank(), dist.get_world_size())


def _collective_device(mesh: GlobalMesh) -> torch.device:
    """Where the collectives' tensors live: the process's card under
    NCCL, the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return mesh.local.devices[0]
    return torch.device("cpu")


def shard_frame_batch_global(fb_local, mesh: GlobalMesh, num_samples: int):
    """This process's slice of the global batch onto its local mesh.

    Every process must present the same padded local batch and
    ``num_samples`` (pad with n_samples=0 lanes via
    parallel.pipeline.pad_frame_batch); one ``all_gather`` of the sizes
    checks it and raises on a mismatch.  Only the local slice moves, to
    local devices.  Returns (words, packed_meta) as ``shard_frame_batch``.
    """
    dev = _collective_device(mesh)
    mine = torch.tensor([fb_local.batch, num_samples], dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(mine) for _ in range(mesh.world_size)]
    dist.all_gather(sizes, mine)
    sizes = [tuple(int(v) for v in s.cpu()) for s in sizes]
    if len(set(sizes)) != 1:
        raise ValueError(
            "every process must present the same padded local batch and "
            f"num_samples; (batch, num_samples) by rank: {sizes}"
        )
    return shard_frame_batch(fb_local, mesh.local)


def decode_frames_global(fb_local, mesh: GlobalMesh, num_samples: int,
                         kernel: str = "auto"):
    """Decode the global frame batch; returns this process's results.

    Returns (out (B_local, S, 2), n (B_local,), each :class:`Sharded`
    over the local mesh, total_samples, checksum); the scalars are the
    global sums, equal on every process (checksum: int32, wrapping mod
    2^32 as the JAX package's).
    """
    words, meta = shard_frame_batch_global(fb_local, mesh, num_samples)
    out, n, total, checksum = _decode_and_account(
        words, meta, mesh.local, num_samples, kernel
    )
    acc = torch.tensor([total, checksum & 0xFFFFFFFF], dtype=torch.int64,
                       device=_collective_device(mesh))
    dist.all_reduce(acc)
    total, checksum = (int(v) for v in acc.cpu())
    return out, n, total, wrap_int32(checksum)


def local_samples(out: Sharded, n: Sharded) -> tuple[np.ndarray, np.ndarray]:
    """This process's lanes of (out, n) as host arrays, in global-index
    order: concatenating the processes' results in rank order
    reassembles the whole corpus."""
    return out.numpy(), n.numpy()
