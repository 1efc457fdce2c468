"""The benchmark's harness: one run of one cell.

Everything particular to a cell is found by name, so a later cell needs
new files and no edit here:

* ``BENCHMARK.json`` (the checkout's root) lists the cells, each with its
  configuration, traffic mix and chips, and the metrics;
* ``configs/<config>.json``: the format and the library's sizes;
* ``traffic/<mix>.json``: the entry point (``entry``), the tracks a
  request takes, the cards of a mesh, the encoder settings;
* ``entries/<entry>.py``: how a request drives the program, and the
  reference that checks its answers;
* ``metrics/<metric>.py``: a reader per metric, which declares its unit,
  direction, source, layer and the end-to-end metric it moves, and
  reads its value from the finished window (None: nothing to read).

One run: make the inputs from the seed, warm up with the cell's own
requests, run the closed loop (one client: a request is sent when the
last has returned) for the given seconds, check every answer against
the reference, then read the metrics.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pathlib
import resource
import sys
import time
import traceback

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
#: Top-level module names that may not be loaded in a run (compared whole:
#: the port's own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "alacnet_tpu")


class HarnessError(RuntimeError):
    """A run that cannot report: no card, a missing file, a bad entry."""


@dataclasses.dataclass
class Metric:
    name: str
    spec: dict  # the BENCHMARK.json entry
    module: object


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Context:
    """What an entry's ``prepare`` gets."""

    config: dict
    mix: dict
    seed: int
    devices: list


@dataclasses.dataclass
class Request:
    tracks: tuple
    start: float
    end: float
    samples: int
    result: object = None
    error: str | None = None

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Window:
    """What a metric reader gets: the finished window of one run."""

    cell: Cell
    setup_s: float
    seconds: float
    requests: list
    #: changes of the program's counters over the window
    stats: dict
    #: ``device_trace.TraceData`` of a traced run, else None
    trace: object = None
    #: ``inputs.library.Frames`` of every completed request
    frames: object = None


def load_module(path: pathlib.Path, name: str):
    if not path.is_file():
        raise HarnessError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _metric(folder: pathlib.Path, spec: dict, per_layer: bool) -> Metric:
    name = spec["name"]
    mod = load_module(folder / "metrics" / f"{name}.py", f"benchmark.metrics.{name}")
    keys = ["unit", "better", "source"] + (["layer", "moves"] if per_layer else [])
    for key in keys:
        if getattr(mod, key.upper(), None) != spec[key]:
            raise HarnessError(
                f"metric {name}: the reader says {key}={getattr(mod, key.upper(), None)!r},"
                f" BENCHMARK.json {spec[key]!r}")
    return Metric(name, spec, mod)


def load_cell(root: pathlib.Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its files looked
    up in the benchmark's folder under ``root``."""
    folder = root / HERE.name
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise HarnessError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((folder / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [
        m for m in bench["per_layer"]
        if workload in m.get("workloads", [workload] if m["moves"] in reported else [])
    ]
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, mix=mix,
        end_to_end=[_metric(folder, m, False) for m in e2e],
        per_layer=[_metric(folder, m, True) for m in layer],
    )


def schedule(tracks: int, per_request: int, rng):
    """The closed loop's requests: the library dealt out in a fresh seeded
    order each pass, ``per_request`` tracks at a time (every seed sends
    the same tracks as often, in another order)."""
    pending: list = []
    while True:
        while len(pending) < per_request:
            pending.extend(rng.permutation(tracks).tolist())
        yield tuple(pending[:per_request])
        del pending[:per_request]


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def keep_freed_memory() -> bool:
    """Have glibc's allocator keep what the process frees: no block of its
    own mapping (``M_MMAP_MAX`` 0), no trim of the heap's top below 2 GiB
    (``M_TRIM_THRESHOLD``), and 64 MiB more whenever the heap grows
    (``M_TOP_PAD``).  A request's arrays then reuse pages that the warm-up
    touched, where glibc's defaults map every array over 32 MiB afresh and
    fault its pages in on each request; the window then measures the
    program's work more than how fast the host's kernel hands out pages.
    False where the C library has no ``mallopt``."""
    import ctypes
    import ctypes.util

    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return False
    m_trim_threshold, m_top_pad, m_mmap_max = -1, -2, -4
    return all((mallopt(m_mmap_max, 0), mallopt(m_trim_threshold, (1 << 31) - 1),
                mallopt(m_top_pad, 64 << 20)))


def _environment() -> None:
    """The program runs with its defaults (it builds into its own
    ``_build/`` in the checkout)."""
    for key in [k for k in os.environ if k.startswith("ALAC_")]:
        del os.environ[key]


def _counters() -> dict:
    from alacnet_tpu_torch.utils.observability import GLOBAL_STATS as s

    return {"host_seconds": s.host_seconds, "result_wait_seconds": s.result_wait_seconds}


def _host() -> dict:
    """The process's own CPU seconds, page faults and context switches."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "sys_s": ru.ru_stime,
            "minor_faults": ru.ru_minflt, "major_faults": ru.ru_majflt,
            "involuntary_switches": ru.ru_nivcsw}


def _sync(devices) -> None:
    import torch

    for d in sorted(set(devices)):
        if d.startswith("cuda"):
            torch.cuda.synchronize(d)


def _attempt(ask, state, tracks) -> Request:
    """One request, timed from call to return, inside a ``bench.request``
    range of the trace."""
    import torch

    with torch.profiler.record_function("bench.request"):
        t0 = time.perf_counter()
        try:
            out, samples = ask(state, tracks)
            err = None
        except Exception:  # a failed request is counted and the loop goes on
            out, samples, err = None, 0, traceback.format_exc()
        return Request(tuple(tracks), t0, time.perf_counter(), samples, out, err)


def _warm(ask, state, per_request: int) -> None:
    """Every track of the library once, the longest first, ``per_request``
    at a time: each size the window will see has been allocated once (the
    host's pinned buffers and the card's cache grow by size)."""
    order = sorted(range(state.tracks), key=state.track_samples, reverse=True)
    for i in range(0, len(order), per_request):
        r = _attempt(ask, state, order[i : i + per_request])
        if r.error:
            raise HarnessError(f"warm-up request failed:\n{r.error}")


def run(root, workload: str, seed: int, seconds: float, trace: bool, t0: float,
        device: str | None = None, answer=None, max_requests: int | None = None) -> dict:
    """One run; returns the result line's object.  ``device=None`` is a
    measured run, which needs the cell's cards; a test passes ``"cpu"``
    (the plain torch versions on the host, at a tiny size: no number of
    it is a device's).  ``answer``: the entry's function that answers a
    request (default ``request``; the control passes ``control``), and
    ``max_requests`` ends its window after that many requests."""
    import torch

    root = pathlib.Path(root)
    cell = load_cell(root, workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise HarnessError(f"{workload} needs {cell.chips} CUDA card(s); {have} visible")
        devices = [f"cuda:{i}" for i in range(cell.chips)]
    else:
        devices = [device] * cell.chips
    _environment()
    entry = load_module(root / HERE.name / "entries" / f"{cell.mix['entry']}.py",
                        f"benchmark.entries.{cell.mix['entry']}")
    ask = getattr(entry, answer or "request")
    state = entry.prepare(Context(cell.config, cell.mix, seed, devices))
    per_request = int(cell.mix["tracks_per_request"])
    _warm(ask, state, per_request)
    _sync(devices)
    for d in set(devices):
        if d.startswith("cuda"):
            torch.cuda.reset_peak_memory_stats(d)
    rng = np.random.default_rng([seed % (1 << 64), 1])
    requests = schedule(state.tracks, per_request, rng)
    records: list = []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if any(d.startswith("cuda") for d in devices):
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    stats0, host0 = _counters(), _host()
    with torch.profiler.record_function("bench.window"):
        start = time.perf_counter()
        deadline = start + seconds
        while time.perf_counter() < deadline and len(records) != max_requests:
            records.append(_attempt(ask, state, next(requests)))
        _sync(devices)
        end = time.perf_counter()
    stats1, host1 = _counters(), _host()
    if prof is not None:
        prof.stop()
    peak = max((torch.cuda.max_memory_allocated(d) for d in set(devices)
                if d.startswith("cuda")), default=0)
    entry.release(state)
    if any(d.startswith("cuda") for d in devices):
        torch.cuda.empty_cache()

    failed = [r for r in records if r.error]
    for r in failed[:1]:
        print(f"request {r.tracks} failed:\n{r.error}", file=sys.stderr)
    checks = entry.check(state, records)
    done = [r for r in records if not r.error]
    window = Window(
        cell=cell, setup_s=start - t0, seconds=end - start, requests=done,
        stats={k: stats1[k] - stats0[k] for k in stats0},
        frames=entry.frames(state, done),
    )
    cards = sorted({int(d.split(":")[1]) for d in devices if d.startswith("cuda:")})
    if prof is not None:
        from . import device_trace

        window.trace = device_trace.read(prof, cards)
    for r in records:
        r.result = None
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.module.read(window)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.spec["unit"]}
    correct = bool(done) and not failed and all(v <= lim for v, lim in checks.values())
    result = {
        "correct": correct,
        "attempted": len(records),
        "failed": len(failed),
        "metrics": metrics,
        "device": _device(devices, peak),
    }
    if window.trace is not None:
        result["device"]["busy_s"] = window.trace.busy_s
        result["device"]["window_s"] = window.trace.window_s
        result["breakdown"] = window.trace.breakdown()
    # the host's side of the window, to tell its weather from the program's work
    result["host"] = {k: host1[k] - host0[k] for k in host0}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def _device(devices, peak: int) -> dict:
    import torch

    if devices[0].startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": len(set(devices)), "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "host", "count": len(devices), "memory_peak_bytes": 0}
