"""Pipeline counters and trace spans.

The counterpart of ``alacnet_tpu/utils/observability.py``:

  * ``DecodeStats`` / ``GLOBAL_STATS`` — process-wide counters (frames,
    samples, bytes, batches, the PCM copied back and the batches of it
    that came back int16, files assembled as views or in block copies)
    and each span's seconds and count;
  * ``trace_span`` — a wall-clock span that also opens a
    ``torch.profiler.record_function`` range, so a ``torch.profiler``
    trace shows the pipeline stages beside the kernels, and adds its
    seconds to ``GLOBAL_STATS`` under its name;
  * ``capture_trace`` — a ``torch.profiler`` run written out as a
    Chrome trace (chrome://tracing, Perfetto);
  * ``profile_busy`` — a callable run under the profiler: the device's
    busy time, its share of the wall and the busiest device ops.

The decode's spans (``parallel/pipeline.py``, ``parallel/mesh.py``,
``batch.py``), innermost ranges named by what the host does there:

  * ``alac.host.demux`` — container parse, stream read, pooling;
  * ``alac.host.parse`` — frame headers, the lane plan, each batch's
    fields and rows cut from it (:data:`PARSE_SPAN`);
  * ``alac.host.h2d`` — host staging and uploads, the blob's byteswap;
  * ``alac.host.enqueue`` — one batch's dispatch and the issue of its
    copy back; ``alac.host.enqueue.shard<i>`` — mesh shard i's part;
  * ``alac.host.element_chain`` — inside the enqueue, the launches for
    the later elements of frames of 3-8 channels: each element's header
    kernel and the launches it feeds (:data:`ELEMENT_CHAIN_SPAN`);
  * ``alac.device.result_wait`` — blocked on a batch's copy back
    (:data:`RESULT_WAIT_SPAN`);
  * ``alac.host.unsort`` — the PCM put back in the frames' order;
  * ``alac.host.assembly`` — each file's PCM cut from the pool.
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

#: The span whose seconds are ``DecodeStats.host_seconds``.
PARSE_SPAN = "alac.host.parse"
#: The span whose seconds are ``DecodeStats.result_wait_seconds``.
RESULT_WAIT_SPAN = "alac.device.result_wait"
#: The span of the element chain's launches (``ops/frame_decode``).
ELEMENT_CHAIN_SPAN = "alac.host.element_chain"


@dataclasses.dataclass
class DecodeStats:
    """Cumulative decode counters (thread-safe)."""

    frames: int = 0
    samples: int = 0
    coded_bytes: int = 0
    #: Frame batches decoded (one :meth:`record` call each).
    dispatches: int = 0
    #: Of those batches, the ones whose PCM came back to the host as
    #: int16; and the bytes of PCM copied back (real lanes only).
    int16_batches: int = 0
    pcm_bytes_back: int = 0
    #: Files assembled from a decoded pool (``batch._file_pcm``): those
    #: handed back as a view of the pool, and the block copies (runs of
    #: frames) made for the others.
    assembled_files: int = 0
    assembly_views: int = 0
    assembly_runs: int = 0
    #: Elements decoded (one a frame of one or two channels, the map's
    #: count for 3-8), chained element passes launched (one a later
    #: element of a batch's widest frame) and frames of 3-8 channels
    #: (:meth:`record_elements`, at enqueue).
    elements: int = 0
    element_passes: int = 0
    multichannel_frames: int = 0
    #: Wall seconds and entries of every :func:`trace_span`, by name.
    span_seconds: dict = dataclasses.field(default_factory=dict)
    span_counts: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._lock = threading.Lock()

    def record(self, frames: int = 0, samples: int = 0, coded_bytes: int = 0,
               pcm_bytes: int = 0, int16: bool = False) -> None:
        """Count one decoded batch, and the ``pcm_bytes`` of its PCM
        copied back (``int16`` if they came back as int16)."""
        with self._lock:
            self.frames += frames
            self.samples += samples
            self.coded_bytes += coded_bytes
            self.dispatches += 1
            self.int16_batches += int(int16)
            self.pcm_bytes_back += pcm_bytes

    def record_assembly(self, view: bool = False, runs: int = 0) -> None:
        """Count one assembled file: a view, or a copy in ``runs`` blocks."""
        with self._lock:
            self.assembled_files += 1
            self.assembly_views += int(view)
            self.assembly_runs += runs

    def record_elements(self, elements: int, passes: int = 0,
                        multichannel_frames: int = 0) -> None:
        """Count elements decoded, chained passes and multichannel frames."""
        with self._lock:
            self.elements += elements
            self.element_passes += passes
            self.multichannel_frames += multichannel_frames

    def record_span(self, name: str, seconds: float) -> None:
        with self._lock:
            self.span_seconds[name] = self.span_seconds.get(name, 0.0) + seconds
            self.span_counts[name] = self.span_counts.get(name, 0) + 1

    @property
    def host_seconds(self) -> float:
        """Host wall-clock in plan and parse (the ``alac.host.parse`` spans)."""
        return self.span_seconds.get(PARSE_SPAN, 0.0)

    @property
    def result_wait_seconds(self) -> float:
        """Host wall-clock *blocked on* device results (the D2H wait, the
        ``alac.device.result_wait`` spans), not device compute time (use a
        torch.profiler trace)."""
        return self.span_seconds.get(RESULT_WAIT_SPAN, 0.0)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "frames": self.frames,
                "samples": self.samples,
                "coded_bytes": self.coded_bytes,
                "dispatches": self.dispatches,
                "int16_batches": self.int16_batches,
                "pcm_bytes_back": self.pcm_bytes_back,
                "assembled_files": self.assembled_files,
                "assembly_views": self.assembly_views,
                "assembly_runs": self.assembly_runs,
                "elements": self.elements,
                "element_passes": self.element_passes,
                "multichannel_frames": self.multichannel_frames,
                "host_seconds": round(self.host_seconds, 6),
                "result_wait_seconds": round(self.result_wait_seconds, 6),
                "spans": {
                    name: {"seconds": round(s, 6), "count": self.span_counts[name]}
                    for name, s in sorted(self.span_seconds.items())
                },
            }

    def reset(self) -> None:
        with self._lock:
            self.frames = self.samples = self.coded_bytes = self.dispatches = 0
            self.int16_batches = self.pcm_bytes_back = 0
            self.assembled_files = self.assembly_views = self.assembly_runs = 0
            self.elements = self.element_passes = self.multichannel_frames = 0
            self.span_seconds.clear()
            self.span_counts.clear()


#: Process-wide stats for the decode pipeline.
GLOBAL_STATS = DecodeStats()


@contextlib.contextmanager
def trace_span(name: str):
    """Wall-clock + profiler span; its seconds and one entry go to
    ``GLOBAL_STATS`` under ``name``."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    logger.debug("span %s: %.3f ms", name, dt * 1e3)
    GLOBAL_STATS.record_span(name, dt)


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
    and the ``top`` busiest device ops in ms (ops whose names share
    their first 60 characters summed as one).

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
            key = ev.key[:60]
            by_op[key] = by_op.get(key, 0.0) + dev_us / 1e3
    if busy_us:
        out.update(
            device_busy_ms=busy_us / 1e3,
            device_busy_share=busy_us / 1e6 / wall,
            device_ms_by_op=dict(sorted(by_op.items(), key=lambda kv: -kv[1])[:top]),
        )
    return out
