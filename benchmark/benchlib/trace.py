"""Readings from a ``torch.profiler`` trace of the device: the busy time
(the union of the device's operation intervals, as the port's
``tools/profile_vis.py`` takes it), the operations that took most time, the
idle gaps by what the host was doing, and the device time of the operations
launched inside a host range."""
from __future__ import annotations

import bisect
import contextlib
import re
import time
from collections import defaultdict

import torch

PROFILED = "bench.profiled"   # the range around the whole profiled run


def _is_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def device_events(events):
    """The device's activity (kernels, copies, sets) without the
    user-annotation ranges the profiler also puts on the device timeline."""
    return [e for e in events if _is_device(e)]


def union_us(spans) -> float:
    """Microseconds in the union of the (start, end) intervals."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def top_ops(dev, n: int = 10):
    """[[name, seconds]] of the device operations that took most time."""
    per = defaultdict(float)
    for e in dev:
        per[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    return [[k[:120], v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_host(events, dev, n: int = 10):
    """[[what the host was doing, seconds]]: the device's idle gaps inside
    the profiled run, each put to the innermost host range open at its
    middle on the thread that ran the profiled call (prefixed with the
    outermost ``bench.`` range below the run's own), summed by that name,
    the largest ``n``."""
    cpu = torch.autograd.DeviceType.CPU
    outer = [e for e in events if e.name == PROFILED and e.device_type == cpu]
    if not outer or not dev:
        return []
    tid = outer[0].thread
    w0, w1 = outer[0].time_range.start, outer[0].time_range.end
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    gaps, cur_e = [], max(w0, spans[0][0])
    if spans[0][0] > w0:
        gaps.append((w0, spans[0][0]))
    for s, e in spans:
        if s > cur_e:
            gaps.append((cur_e, s))
        cur_e = max(cur_e, e)
    if cur_e < w1:
        gaps.append((cur_e, w1))
    host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == cpu and e.thread == tid and e.name != PROFILED),
                  key=lambda t: (t[0], -t[1]))
    per = defaultdict(float)
    stack, j = [], 0   # the ranges open at the gap's middle, outermost first
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (g0 + g1)
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] <= host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        inner = stack[-1][2] if stack else None
        bench = next((name for _, _, name in stack if name.startswith("bench.")), None)
        label = (f"{bench} / {inner}" if bench and inner != bench
                 else (inner or "no host range"))
        per[label[:120]] += (g1 - g0) / 1e6
    return [[k, v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]


# the host's CUDA API calls that put work on the device (launches,
# copies, sets): the trace links each to its device operation by a
# correlation id
_DEVICE_CALL = re.compile(r"^cu(da)?[A-Z]")


def launched_in(kineto_events, range_name: str):
    """(seconds, ranges): the device time of every operation launched by a
    CUDA API call that started while a host range ``range_name`` was open,
    and the number of such ranges. ``kineto_events`` are the profiler's raw
    events (``profiled``'s ``kineto``); the ranges are matched by time on
    the host clock, whatever thread launched."""
    cpu = torch.autograd.DeviceType.CPU
    ranges = sorted((e.start_ns(), e.end_ns()) for e in kineto_events
                    if e.device_type() == cpu and e.name() == range_name)
    if not ranges:
        return 0.0, 0
    starts = [r[0] for r in ranges]
    device_ns = defaultdict(int)
    for e in kineto_events:
        if e.device_type() != cpu and not e.is_user_annotation() and e.correlation_id() > 0:
            device_ns[e.correlation_id()] += e.duration_ns()
    seen = set()
    for e in kineto_events:
        corr = e.correlation_id()
        if (e.device_type() != cpu or corr in seen or corr not in device_ns
                or not _DEVICE_CALL.match(e.name())):
            continue
        i = bisect.bisect_right(starts, e.start_ns()) - 1
        if i >= 0 and e.start_ns() < ranges[i][1]:
            seen.add(corr)
    return sum(device_ns[c] for c in seen) / 1e9, len(ranges)


@contextlib.contextmanager
def profiled(device, host: bool = True):
    """Profile the block: device activity, and with ``host`` the host's
    (every operator and range; it slows the host down); yields a dict that
    gets ``events``, the raw ``kineto`` events and the block's host seconds
    ``wall_s``."""
    res = {}
    cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(PROFILED):
            yield res
            if cuda:
                torch.cuda.synchronize()
        res["wall_s"] = time.perf_counter() - t0
    res["events"] = prof.events()
    res["kineto"] = prof.profiler.kineto_results.events()


def summarize(res) -> dict:
    """busy_s, window_s, the device operations and idle gaps of a
    ``profiled`` block."""
    events = res["events"]
    dev = device_events(events)
    return {"busy_s": union_us([(e.time_range.start, e.time_range.end) for e in dev]) / 1e6,
            "window_s": res["wall_s"],
            "device_ops": top_ops(dev),
            "idle_gaps": idle_by_host(events, dev)}
