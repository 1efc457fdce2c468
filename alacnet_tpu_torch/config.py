"""Typed runtime configuration for the PyTorch port.

Ports the fields of ``alacnet_tpu.config.DecodeConfig`` that the
batched decode path and the streaming session read, plus two the port
needs:

* ``device`` — where the decode runs.  It is explicit: a config that
  names ``cuda`` on a machine without a usable card raises at
  construction instead of moving to the CPU on its own.
* ``kernel`` — ``auto`` launches the hand-written CUDA kernel for a CUDA
  tensor and runs the plain torch version for a CPU tensor; ``cuda``
  demands the kernel (a CPU tensor then raises); ``torch`` forces the
  plain version, which exists so a run can compare the two on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from .ops.cuda._lib import KERNEL_CHOICES


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Execution knobs for the decode pipeline."""

    #: Max frames per device dispatch.
    batch_limit: int = 4096
    #: Frames decoded per window in the streaming ``AlacContext``.
    stream_window: int = 64
    #: strict=True raises on undecodable frames; strict=False zeroes only
    #: the offending lanes and reports them in ``bad_frames``.
    strict: bool = True
    #: Emit int16 PCM for all-16-bit batches (halves the D2H copy).
    emit16: bool = True
    #: Parse headers with the native C++ host tier (``native.py``).
    native: bool = True
    #: Cut the (B, W) word rows on the device from the raw blob
    #: (kernel 1) instead of packing them on the host.
    device_pack: bool = True
    #: Torch device of the decode ("cuda", "cuda:1", "cpu").
    device: str = "cuda"
    #: Kernel route: "auto" | "cuda" | "torch" (see the module docstring).
    kernel: str = "auto"

    def __post_init__(self):
        if self.kernel not in KERNEL_CHOICES:
            raise ValueError(
                f"kernel must be one of {KERNEL_CHOICES}, got {self.kernel!r}"
            )
        if self.batch_limit <= 0:
            raise ValueError("batch_limit must be positive")
        if self.torch_device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"DecodeConfig(device={self.device!r}) needs a CUDA device, "
                "and torch.cuda.is_available() is False; pass device='cpu' "
                "to decode with the plain torch versions"
            )

    @property
    def torch_device(self) -> torch.device:
        return torch.device(self.device)


def resolve(config: DecodeConfig | None = None, device: str | None = None,
            strict: bool | None = None) -> DecodeConfig:
    """The config a public entry point runs with: ``config`` (default
    ``DecodeConfig()``) with ``device``/``strict`` overrides applied."""
    overrides = {}
    if device is not None:
        overrides["device"] = device
    if strict is not None:
        overrides["strict"] = strict
    if config is None:
        return DecodeConfig(**overrides)
    return dataclasses.replace(config, **overrides) if overrides else config
