"""Pipeline counters and trace spans.

The counterpart of ``alacnet_tpu/utils/observability.py``:

  * ``DecodeStats`` / ``GLOBAL_STATS`` — process-wide counters (frames,
    samples, bytes, host-parse seconds and device-result *wait* seconds)
    with the Msamples/s derivation;
  * ``trace_span`` — a wall-clock span that also opens a
    ``torch.profiler.record_function`` range, so a ``torch.profiler``
    trace shows the pipeline stages beside the kernels;
  * ``capture_trace`` — a ``torch.profiler`` run written out as a
    Chrome trace (chrome://tracing, Perfetto);
  * ``profile_busy`` — a callable run under the profiler: the device's
    busy time, its share of the wall and the busiest device ops.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
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


@dataclasses.dataclass
class Trace:
    """What :func:`capture_trace` yields: the running profiler, and the
    Chrome trace's path once the block has ended."""

    profiler: torch.profiler.profile
    path: str | None = None


@contextlib.contextmanager
def capture_trace(log_dir: str | None):
    """Profile the block with ``torch.profiler`` (the host's ops, and the
    card's kernels and copies where CUDA is available) and write a
    Chrome trace into ``log_dir`` on exit (no file for ``None``).  The
    ``trace_span`` ranges show up in it beside the kernels."""
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        trace = Trace(prof)
        yield trace
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        trace.path = os.path.join(
            log_dir, f"alac_trace_{os.getpid()}_{time.time_ns()}.json"
        )
        prof.export_chrome_trace(trace.path)


def profile_busy(run, device="cuda", trace_dir: str | None = None,
                 top: int = 12) -> dict:
    """Run ``run()`` once under the profiler; the device's busy time
    (the sum of its kernels and copies), that time over the run's wall,
    and the ``top`` busiest device ops in ms.

    Only a CUDA device is measured: for any other device the busy
    fields are ``None`` (a CPU time is never reported under a device's
    name).  ``trace_dir``: also write the run's Chrome trace there
    (``trace_file``).
    """
    cuda = torch.device(device).type == "cuda"
    with capture_trace(trace_dir) as trace:
        t0 = time.perf_counter()
        run()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"profiled_wall_s": wall, "device_busy_ms": None,
           "device_busy_share": None, "device_ms_by_op": None,
           "trace_file": trace.path}
    if not cuda:
        return out
    # Sum the device-side events only (kernels and copies): a CPU op's
    # device time repeats that of the kernels it launched.
    by_op = {}
    busy_us = 0.0
    for ev in trace.profiler.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            busy_us += dev_us
            by_op[ev.key[:60]] = dev_us / 1e3
    if busy_us:
        out.update(
            device_busy_ms=busy_us / 1e3,
            device_busy_share=busy_us / 1e6 / wall,
            device_ms_by_op=dict(sorted(by_op.items(), key=lambda kv: -kv[1])[:top]),
        )
    return out
