"""Pipeline counters and trace spans.

The counterpart of ``alacnet_tpu/utils/observability.py``:

  * ``DecodeStats`` / ``GLOBAL_STATS`` — process-wide counters (frames,
    samples, bytes, host-parse seconds and device-result *wait* seconds)
    with the Msamples/s derivation;
  * ``trace_span`` — a wall-clock span that also opens a
    ``torch.profiler.record_function`` range, so a ``torch.profiler``
    trace shows the pipeline stages beside the kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time

import torch

logger = logging.getLogger("alacnet_tpu_torch")


@dataclasses.dataclass
class DecodeStats:
    """Cumulative decode counters (thread-safe)."""

    frames: int = 0
    samples: int = 0
    coded_bytes: int = 0
    #: Host wall-clock spent *blocked on* device results (the D2H wait),
    #: not pure device compute time (use a torch.profiler trace).
    result_wait_seconds: float = 0.0
    host_seconds: float = 0.0
    dispatches: int = 0

    def __post_init__(self):
        self._lock = threading.Lock()

    def record(
        self,
        frames: int = 0,
        samples: int = 0,
        coded_bytes: int = 0,
        result_wait_seconds: float = 0.0,
        host_seconds: float = 0.0,
    ) -> None:
        with self._lock:
            self.frames += frames
            self.samples += samples
            self.coded_bytes += coded_bytes
            self.result_wait_seconds += result_wait_seconds
            self.host_seconds += host_seconds
            self.dispatches += 1

    @property
    def msamples_per_second(self) -> float:
        t = self.result_wait_seconds + self.host_seconds
        return self.samples / t / 1e6 if t > 0 else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "frames": self.frames,
                "samples": self.samples,
                "coded_bytes": self.coded_bytes,
                "result_wait_seconds": round(self.result_wait_seconds, 6),
                "host_seconds": round(self.host_seconds, 6),
                "dispatches": self.dispatches,
                "msamples_per_second": round(self.msamples_per_second, 3),
            }

    def reset(self) -> None:
        with self._lock:
            self.frames = self.samples = self.coded_bytes = 0
            self.result_wait_seconds = self.host_seconds = 0.0
            self.dispatches = 0


#: Process-wide stats for the decode pipeline.
GLOBAL_STATS = DecodeStats()


@contextlib.contextmanager
def trace_span(name: str, stats_field: str | None = None):
    """Wall-clock + profiler span.

    ``stats_field``: 'result_wait_seconds' or 'host_seconds' to
    accumulate the elapsed time into GLOBAL_STATS.
    """
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    logger.debug("span %s: %.3f ms", name, dt * 1e3)
    if stats_field == "result_wait_seconds":
        GLOBAL_STATS.record(result_wait_seconds=dt)
    elif stats_field == "host_seconds":
        GLOBAL_STATS.record(host_seconds=dt)
