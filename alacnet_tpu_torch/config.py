"""Typed runtime configuration for the PyTorch port.

Ports ``alacnet_tpu.config.DecodeConfig``: every field the two share
takes its default from the same ``ALAC_*`` environment variable, read
when a config is built (``ALAC_BATCH_LIMIT``, ``ALAC_STREAM_WINDOW``,
``ALAC_KERNEL``, ``ALAC_STRICT``, ``ALAC_EMIT16``, ``ALAC_NATIVE``,
``ALAC_DEVICE_PACK``).  An argument given to the constructor wins over
the variable.  Two fields are the port's own:

* ``device`` — where the decode runs.  It has no variable and is
  explicit: a config that names ``cuda`` on a machine without a usable
  card raises at construction instead of moving to the CPU on its own.
* ``kernel`` — ``auto`` launches the hand-written CUDA kernel for a CUDA
  tensor and runs the plain torch version for a CPU tensor; ``cuda``
  demands the kernel (a CPU tensor then raises); ``torch`` forces the
  plain version, which exists so a run can compare the two on the card.
  ``ALAC_KERNEL`` also takes the JAX package's names, ``fused`` for
  ``cuda`` and ``xla`` for ``torch``.

There is no process-wide default instance: building one at import
would raise on every machine without a card.

:func:`env_int`, :func:`env_bool` and :func:`env_choice` are the one
place the port parses an ``ALAC_*`` variable (``native.py`` and
``codec/encoder_device.py`` read theirs through them).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from .ops.cuda._lib import KERNEL_CHOICES

#: The JAX package's kernel route names, as the port's.
KERNEL_ALIASES = {"fused": "cuda", "xla": "torch"}


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v not in ("0", "false", "False", "no")


def env_choice(name: str, default: str, choices: tuple, aliases: dict | None = None) -> str:
    """``name``'s value (``default`` when unset), mapped through
    ``aliases``; a value outside ``choices`` raises."""
    v = os.environ.get(name, default)
    if v not in choices:
        raise ValueError(f"{name}={v!r}: expected one of {choices}")
    return (aliases or {}).get(v, v)


def _env(read, name: str, default):
    return dataclasses.field(default_factory=lambda: read(name, default))


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Execution knobs for the decode pipeline."""

    #: Max frames per device dispatch.
    batch_limit: int = _env(env_int, "ALAC_BATCH_LIMIT", 4096)
    #: Frames decoded per window in the streaming ``AlacContext``.
    stream_window: int = _env(env_int, "ALAC_STREAM_WINDOW", 64)
    #: strict=True raises on undecodable frames; strict=False zeroes only
    #: the offending lanes and reports them in ``bad_frames``.
    strict: bool = _env(env_bool, "ALAC_STRICT", True)
    #: Emit int16 PCM for all-16-bit batches (halves the D2H copy).
    emit16: bool = _env(env_bool, "ALAC_EMIT16", True)
    #: Parse headers with the native C++ host tier (``native.py``).
    native: bool = _env(env_bool, "ALAC_NATIVE", True)
    #: Cut the (B, W) word rows on the device from the raw blob
    #: (kernel 1) instead of packing them on the host.
    device_pack: bool = _env(env_bool, "ALAC_DEVICE_PACK", True)
    #: Torch device of the decode ("cuda", "cuda:1", "cpu").
    device: str = "cuda"
    #: Kernel route: "auto" | "cuda" | "torch" (see the module docstring).
    kernel: str = dataclasses.field(default_factory=lambda: env_choice(
        "ALAC_KERNEL", "auto", KERNEL_CHOICES + tuple(KERNEL_ALIASES), KERNEL_ALIASES))

    def __post_init__(self):
        self._check()
        if self.torch_device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"DecodeConfig(device={self.device!r}) needs a CUDA device, "
                "and torch.cuda.is_available() is False; pass device='cpu' "
                "to decode with the plain torch versions"
            )

    def _check(self) -> None:
        if self.kernel not in KERNEL_CHOICES:
            raise ValueError(
                f"kernel must be one of {KERNEL_CHOICES}, got {self.kernel!r}"
            )
        if self.batch_limit <= 0:
            raise ValueError("batch_limit must be positive")

    def validate(self) -> "DecodeConfig":
        """``self``, after the checks construction makes (the kernel
        route, a positive ``batch_limit``): a field changed since then
        raises here."""
        self._check()
        return self

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
