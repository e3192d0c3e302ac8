"""The trace readings on a hand-made timeline: the busy union, the
operations by time and the idle gaps put to the host range open at their
middle."""
from __future__ import annotations

import pytest
import torch
from bench_tiny import BENCH  # noqa: F401  (puts the benchmark on the path)

from benchlib import trace


class _Ev:
    def __init__(self, name, start, end, device=False, thread=1):
        self.name, self.thread, self.is_user_annotation = name, thread, False
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)
        self.time_range = type("R", (), {"start": start, "end": end})()


EVENTS = [_Ev(trace.PROFILED, 0, 100), _Ev("bench.step", 1, 90), _Ev("aten::mm", 2, 5),
          _Ev("bench.loss", 10, 40), _Ev("aten::item", 20, 30), _Ev("other", 0, 100, thread=2),
          _Ev("k1", 0, 10, True), _Ev("k2", 12, 22, True), _Ev("k1", 50, 60, True),
          _Ev("k2", 55, 58, True)]


def test_busy_union():
    dev = trace.device_events(EVENTS)
    assert trace.union_us([(e.time_range.start, e.time_range.end) for e in dev]) == 30


def test_top_ops():
    dev = trace.device_events(EVENTS)
    assert trace.top_ops(dev) == [["k1", pytest.approx(20e-6)], ["k2", pytest.approx(13e-6)]]


def test_idle_gaps_by_host_range():
    dev = trace.device_events(EVENTS)
    got = dict(trace.idle_by_host(EVENTS, dev))
    # gaps 10-12 and 22-50 inside bench.loss, 60-100 inside bench.step
    assert got == {"bench.step / bench.loss": pytest.approx(30e-6),
                   "bench.step": pytest.approx(40e-6)}


class _Kin:
    """A raw profiler event as ``launched_in`` reads it."""

    def __init__(self, name, start, end, corr=0, device=False, annotation=False):
        self._v = (name, start, end, corr, annotation)
        self._dev = (torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def correlation_id(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def device_type(self):
        return self._dev


def test_launched_in_takes_the_device_time_of_launches_inside_the_ranges():
    r = "bench.msda_fwd"
    kin = [_Kin(r, 100, 200), _Kin(r, 500, 600), _Kin("aten::add", 110, 120, corr=7),
           _Kin("cudaLaunchKernel", 120, 125, corr=7),       # inside the first range
           _Kin("cudaMemsetAsync", 130, 131, corr=8),        # inside, a set
           _Kin("cuLaunchKernel", 550, 552, corr=9),         # inside the second
           _Kin("cudaLaunchKernel", 300, 305, corr=10),      # outside both
           _Kin("k7", 1000, 1400, corr=7, device=True), _Kin("set8", 1400, 1410, corr=8, device=True),
           _Kin("k9", 2000, 2100, corr=9, device=True), _Kin("k9b", 2100, 2150, corr=9, device=True),
           _Kin("k10", 1500, 1900, corr=10, device=True),
           _Kin(r, 1000, 2150, device=True, annotation=True)]   # the range on the device timeline
    seconds, ranges = trace.launched_in(kin, r)
    assert ranges == 2
    assert seconds == pytest.approx((400 + 10 + 100 + 50) / 1e9)
    assert trace.launched_in(kin, "bench.msda_bwd") == (0.0, 0)
