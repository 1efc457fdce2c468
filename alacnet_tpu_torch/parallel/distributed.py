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

Recipe (each process; under ``torchrun``, or with ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` set by hand for the ranks of one host):

    import alacnet_tpu_torch.parallel.distributed as dist
    dist.initialize(coordinator, num_processes, process_id, backend="nccl")
    mesh = dist.global_mesh()                  # this rank's own cards
    fb_local = parse(local frame shard)        # host, padded
    out, n, total, checksum = dist.decode_frames_global(
        fb_local, mesh, num_samples)
    pcm, n = dist.local_samples(out, n)        # this process's lanes

Each rank of a host takes its own share of the host's visible cards
(:func:`local_cards`: with 4 cards and 4 ranks, rank r gets ``cuda:r``;
with 8 cards and 2 ranks, four each), disjoint from every other rank's,
as each JAX process addresses only its own devices.  Without
``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` a process takes every visible card
(one process per host).  ``global_mesh(devices)`` names the devices
instead.

``backend`` is explicit: ``nccl`` for one card per rank (NCCL refuses
two ranks on one card; :func:`global_mesh` makes the rank's first card
its current device, and the collectives run there), ``gloo`` for CPU
processes or several ranks on one card.  Under ``gloo`` the collectives
run on CPU tensors.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import (
    Mesh, Sharded, _decode_and_account, make_mesh, shard_frame_batch, visible_cards,
    wrap_int32,
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


def local_cards(local_rank: int, local_world_size: int, device_count: int) -> range:
    """The indices of the visible cards that rank ``local_rank`` of
    ``local_world_size`` ranks on one host takes: an equal, contiguous
    share, disjoint from every other rank's.  Raises unless the cards
    split evenly into shares of at least one."""
    if not 0 <= local_rank < local_world_size:
        raise ValueError(f"local rank {local_rank} is outside a local world of "
                         f"{local_world_size} ranks")
    if device_count < local_world_size or device_count % local_world_size:
        raise ValueError(
            f"{device_count} visible cards do not split evenly into "
            f"{local_world_size} ranks' shares of at least one card; run as "
            "many ranks a host as it has cards (or a divisor of them), or "
            "pass global_mesh(devices)"
        )
    share = device_count // local_world_size
    return range(local_rank * share, (local_rank + 1) * share)


def rank_devices() -> list:
    """This process's devices: its :func:`local_cards` share of the
    visible cards under ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` (as
    ``torchrun`` sets them), every visible card without them."""
    cards = visible_cards()
    rank, world = os.environ.get("LOCAL_RANK"), os.environ.get("LOCAL_WORLD_SIZE")
    if rank is None or world is None:
        return cards
    return [cards[i] for i in local_cards(int(rank), int(world), len(cards))]


def global_mesh(devices=None) -> GlobalMesh:
    """The frame-parallel mesh over every process: this process's shards
    on ``devices`` (default :func:`rank_devices`, this rank's own
    cards).  Under NCCL the mesh's first card becomes the process's
    current device, where its collectives run (:func:`_collective_device`)."""
    devs = [torch.device(d) for d in (rank_devices() if devices is None else devices)]
    if dist.get_backend() == "nccl" and devs and devs[0].index is not None:
        # before the mesh's streams, so no context opens on another card
        torch.cuda.set_device(devs[0])
    return GlobalMesh(make_mesh(devs), dist.get_rank(), dist.get_world_size())


def _collective_device(mesh: GlobalMesh) -> torch.device:
    """Where the collectives' tensors live: the rank's first card under
    NCCL (its current device since :func:`global_mesh`), the CPU
    otherwise."""
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
