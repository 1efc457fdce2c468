"""The yardstick counts a kernel's work from the inputs, and the trace
reader's busy time and idle gaps."""

from __future__ import annotations

import types

import numpy as np
import pytest
from conftest import SEED, tiny_config

from benchmark import device_trace, yardstick
from benchmark.inputs import library


def _frames(ub=0):
    return library.Frames(
        n=np.array([4096, 100]), orders=np.array([[8, 8], [4, 4]]),
        rice_bits=np.array([[64000, 32001], [10, 0]]), channels=2, uncompressed_bytes=ub)


def test_rice_lpc_work_from_the_inputs():
    nbytes, ops = yardstick.rice_lpc_work(_frames())
    words = 2000 + 1001 + 1 + 0
    live = 2 * 4096 + 2 * 100
    assert nbytes == 4 * words + 168 * 4 + 4 * live
    assert ops == 40 * live + 4 * (8 * 2 * 4096 + 4 * 2 * 100)


def test_bulk_bits_work_only_with_extra_bits():
    assert yardstick.bulk_bits_work(_frames(0)) == (0, 0)
    nbytes, ops = yardstick.bulk_bits_work(_frames(1))
    assert nbytes == (4196 * 2 * 8) // 8 + 16 * 2 + 8 * 4196
    assert ops == 16 * 4196


def test_encode_work_from_the_inputs():
    f = _frames()
    f.orders = np.full((2, 2), 6)
    assert yardstick.enc_pred_work(f) == (8 * 8392 + 144 * 4, 20 * 8392 + 4 * 6 * 8392)
    assert yardstick.enc_rice_work(f) == (21 * 8392 + 29 * 4, 135 * 8392)


def test_work_adds_over_tracks():
    lib = library.make_library(tiny_config("cd16"), SEED)
    coded = lib.code()
    whole = yardstick.rice_lpc_work(library.frames_of(lib, [0, 1, 1], coded.orders,
                                                      coded.rice_bits))
    parts = [yardstick.rice_lpc_work(library.frames_of(lib, [t], coded.orders, coded.rice_bits))
             for t in (0, 1, 1)]
    assert whole == tuple(map(sum, zip(*parts)))


def test_int32_peak_is_derived():
    assert yardstick.INT32_OPS_PER_S == pytest.approx(16.73e12, rel=1e-3)


class _Ev:
    def __init__(self, name, cuda, start, dur, index=0, annotation=False):
        self._v = (name, cuda, start, dur, index)
        self.annotation = annotation

    def is_user_annotation(self):
        return self.annotation

    def activity_type(self):
        return "gpu_user_annotation" if self.annotation else "kernel"

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def device_index(self):
        return self._v[4]


def _prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_trace_busy_union_and_gaps():
    ms = 1_000_000
    events = [
        _Ev("bench.window", False, 0, 100 * ms),
        _Ev("bench.request", False, 0, 100 * ms),
        _Ev("alac.host.parse", False, 0, 20 * ms),
        _Ev("alac.device.result_wait", False, 60 * ms, 40 * ms),
        _Ev("void rice_lpc_kernel<8>(Args)", True, 20 * ms, 30 * ms),
        _Ev("Memcpy DtoH", True, 40 * ms, 20 * ms),  # overlaps the kernel
        # a range's annotation on the device's timeline is no device work
        _Ev("bench.request", True, 20 * ms, 40 * ms, annotation=True),
    ]
    t = device_trace.read(_prof(events), [0])
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(0.04)
    assert t.kernel_seconds("rice_lpc_kernel") == pytest.approx(0.03)
    assert t.idle_by_activity == pytest.approx(
        {"alac.host.parse": 0.02, "alac.device.result_wait": 0.04})
    assert t.breakdown()["device_ops"][0] == ["void rice_lpc_kernel<8>(Args)", 0.03]


def test_roofline_is_silent_without_its_kernel():
    w = types.SimpleNamespace(trace=types.SimpleNamespace(kernel_seconds=lambda *p: 0.0),
                              frames=_frames())
    assert yardstick.roofline_pct(w, yardstick.rice_lpc_work, "rice_lpc_kernel") is None
    w.trace = types.SimpleNamespace(kernel_seconds=lambda *p: 1e-3)
    got = yardstick.roofline_pct(w, yardstick.rice_lpc_work, "rice_lpc_kernel")
    assert got == pytest.approx(100 * yardstick.least_seconds(
        *yardstick.rice_lpc_work(_frames())) / 1e-3)
