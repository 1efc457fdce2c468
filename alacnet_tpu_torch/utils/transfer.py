"""Host <-> device copies for the decode pipeline.

On a CUDA device both directions go through pinned host memory and
``non_blocking`` copies on the current stream, so that the host can
parse the next batch while the card decodes this one (at most two
batches in flight, ``parallel/pipeline.decode_blob``).  On the CPU they
are plain copies.
"""

from __future__ import annotations

import numpy as np
import torch


def pin(arr: np.ndarray) -> torch.Tensor:
    """A pinned host copy of ``arr``, the staging buffer of an
    asynchronous upload; one buffer may feed uploads to several cards."""
    arr = np.ascontiguousarray(arr)
    host = torch.from_numpy(np.empty(0, arr.dtype)).new_empty(
        arr.shape, pin_memory=True
    )
    host.numpy()[...] = arr
    return host


def h2d(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a host int32 array; asynchronous on CUDA.

    The result never aliases ``arr`` (which may be read-only, or reused
    by the caller after the call).
    """
    if device.type != "cuda":
        return torch.from_numpy(np.ascontiguousarray(arr).copy())
    return pin(arr).to(device, non_blocking=True)


def d2h_async(*tensors: torch.Tensor):
    """Start copying device tensors to the host.

    Returns a callable that waits for the copies and gives the NumPy
    arrays.  On CUDA the copies are queued now, on the current stream,
    into pinned buffers, so they run right after the work that made the
    tensors and not after whatever is queued later; the event that
    :func:`wait` waits for is recorded on that same stream, the tensors'
    device's, whatever the calling thread's current device is.
    """
    if not tensors or not tensors[0].is_cuda:
        return lambda: tuple(t.numpy() for t in tensors)
    hosts = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        hosts.append(h)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(tensors[0].device))

    def wait():
        done.synchronize()
        return tuple(h.numpy() for h in hosts)

    return wait
