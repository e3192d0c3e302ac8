"""The port's tracer: host spans, the host's waits on the device and
counters, aggregated per request, on the clock of ``torch.profiler``.

- ``request(kind, device=None, **attrs)`` opens one request (one
  ``inference_vis``, ``inference_image`` or ``train_step`` call). The
  request is itself the outermost span, named ``kind``.
- ``span(name)`` times a block on the host. ``wait(name)`` is a span in
  which the host is blocked on the device: a read of a device tensor
  (``.cpu()``, ``int()``, ``.item()``) or an upload from pageable host
  memory, which synchronizes the stream. Each wait adds one (or
  ``syncs``) to the request's counter ``<prefix>.syncs``, where
  ``<prefix>`` is the request kind up to its first dot (``vis.video`` ->
  ``vis.syncs``). Names of waits end in ``.wait``.
- ``count(name, n=1)`` adds to a counter of the open request.
  ``register(prefix, counts)`` adds a dict of counts kept elsewhere (the
  deformable attention's launches) as it is: each request then carries
  what the dict's entries rose by while it was open, as
  ``<prefix>.<key>``.

Outside a request, spans and counters record nothing. Stamps are
``perf_counter_ns`` plus the offset of the Unix epoch, taken once at
import: the clock of the profiler's events (``start_ns``).

Default mode (always on): per request, for each span name its count,
total and self ns (total less its child spans), and the counters; the last
``RING`` requests are kept (``requests``, ``last``). No record is kept per
span.

Full mode (``set_mode(full=True)``) also keeps every span as an event
(``events``, ``export_chrome``); with ``device=True`` each span of a
request on a CUDA device also records a CUDA event pair on the current
stream, mapped to the host's clock through an anchor event recorded when
device timing is switched on (switch it on after a synchronize for the two
clocks to line up; the durations hold in any case). The tracer never
synchronizes: read ``events`` after the device has finished the spans'
work.

While a ``torch.profiler`` is active, each span of a request also opens a
``record_function`` range of its name.
"""
from __future__ import annotations

import collections
import contextvars
import itertools
import json
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 4096          # requests kept in default mode
MAX_EVENTS = 1 << 20  # span events kept in full mode

_clock = time.perf_counter_ns
_EPOCH_NS = time.time_ns() - _clock()


def now_ns() -> int:
    """The tracer's clock: host ns since the Unix epoch, monotonic."""
    return _clock() + _EPOCH_NS


class Request:
    """One request's aggregates: ``spans`` {name: [count, total ns, self
    ns]}, ``counters`` {name: n}, host ``start_ns`` and ``end_ns``."""
    __slots__ = ("kind", "id", "attrs", "start_ns", "end_ns", "spans", "counters",
                 "cuda", "_stack", "_before", "_syncs")

    def __init__(self, kind: str, rid: int, attrs: dict, cuda: bool):
        self.kind, self.id, self.attrs, self.cuda = kind, rid, attrs, cuda
        self.spans: Dict[str, list] = {}
        self.counters: Dict[str, int] = {}
        self.start_ns = self.end_ns = 0
        self._stack: list = []
        self._syncs = kind.split(".", 1)[0] + ".syncs"
        self._before = [(prefix, counts, dict(counts)) for prefix, counts in _REGISTERED]

    def total_ms(self, name: str) -> float:
        s = self.spans.get(name)
        return s[1] / 1e6 if s else 0.0

    def self_ms(self, name: str) -> float:
        s = self.spans.get(name)
        return s[2] / 1e6 if s else 0.0

    def wait_ms(self) -> float:
        """The host's time blocked on the device: every ``*.wait`` span."""
        return sum(s[1] for n, s in self.spans.items() if n.endswith(".wait")) / 1e6

    def seconds(self) -> Dict[str, float]:
        """{span name: total host seconds}."""
        return {n: s[1] / 1e9 for n, s in self.spans.items()}


# the open request of this thread (and context)
_current: contextvars.ContextVar = contextvars.ContextVar("mdqe_tracing_request",
                                                          default=None)
_open = _current.get
_ring: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_REGISTERED: list = []       # (prefix, the dict of counts)

_full = False
_device = False
_anchor = None               # (CUDA event, host ns at its record)
_events: collections.deque = collections.deque(maxlen=MAX_EVENTS)
_span_ids = itertools.count(1)


class _Span:
    """A span's name, kept and shared: its state while open is a frame on
    the open request's stack, so one object serves every use of the name,
    nested or on other threads."""
    __slots__ = ("name", "syncs")

    def __init__(self, name: str, syncs: int):
        self.name, self.syncs = name, syncs

    def __enter__(self):
        req = _open()
        if req is None:
            return self
        # frame: [start ns, child ns, span id, device start event, range, name]
        frame = [0, 0, 0, None, None, self.name]
        if _full:
            frame[2] = next(_span_ids)
            if _device and req.cuda:
                ev = frame[3] = torch.cuda.Event(enable_timing=True)
                ev.record()
        req._stack.append(frame)
        if _autograd_profiler._is_profiler_enabled:   # its start stamp just before this one
            frame[4] = _autograd_profiler.record_function(self.name)
            frame[4].__enter__()
        frame[0] = _clock()
        return self

    def __exit__(self, et, ev, tb):
        req = _open()
        if req is None:
            return False
        stack = req._stack
        frame = stack.pop()
        if frame[4] is not None:   # the range's end stamp just before this one
            frame[4].__exit__(et, ev, tb)
        t1 = _clock()
        dur = t1 - frame[0]
        agg = req.spans.get(self.name)
        if agg is None:
            agg = req.spans[self.name] = [0, 0, 0]
        agg[0] += 1
        agg[1] += dur
        agg[2] += dur - frame[1]
        if stack:
            stack[-1][1] += dur
        if self.syncs:
            c = req.counters
            c[req._syncs] = c.get(req._syncs, 0) + self.syncs
        if _full:
            end_ev = None
            if frame[3] is not None:
                end_ev = torch.cuda.Event(enable_timing=True)
                end_ev.record()
            _events.append((frame[2], self.name, req.id, stack[-1][2] if stack else 0,
                            frame[0] + _EPOCH_NS, t1 + _EPOCH_NS, bool(self.syncs),
                            frame[3], end_ev))
        return False


_SPANS: Dict[str, _Span] = {}
_WAITS: Dict[object, _Span] = {}


def span(name: str) -> _Span:
    """A span of host time named ``name`` (a context manager)."""
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS[name] = _Span(name, 0)
    return s


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def wait(name: str, syncs: int = 1):
    """A span in which the host waits on the device (``name`` ends in
    ``.wait``); adds ``syncs`` to the request's ``<prefix>.syncs``. With
    ``syncs`` 0 (a read of a host tensor) it records nothing."""
    if not syncs:
        return _NO_SPAN
    key = name if syncs == 1 else (name, syncs)
    s = _WAITS.get(key)
    if s is None:
        s = _WAITS[key] = _Span(name, syncs)
    return s


def open_spans() -> List[str]:
    """The names of this thread's open spans in its open request,
    outermost first."""
    req = _open()
    return [f[5] for f in req._stack] if req is not None else []


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open request's counter ``name``."""
    req = _open()
    if req is not None:
        c = req.counters
        c[name] = c.get(name, 0) + n


def register(prefix: str, counts: dict) -> dict:
    """Carry the rise of each entry of ``counts`` (a dict of ints kept and
    raised elsewhere, the same object) in every request, as
    ``<prefix>.<key>``. Returns ``counts``."""
    if not any(c is counts for _, c in _REGISTERED):
        _REGISTERED.append((prefix, counts))
    return counts


class _RequestCtx:
    __slots__ = ("kind", "attrs", "cuda", "req", "root", "token")

    def __init__(self, kind, attrs, cuda):
        self.kind, self.attrs, self.cuda = kind, attrs, cuda

    def __enter__(self) -> Request:
        req = self.req = Request(self.kind, next(_ids), self.attrs, self.cuda)
        self.token = _current.set(req)
        req.start_ns = now_ns()
        self.root = span(self.kind)
        self.root.__enter__()
        return req

    def __exit__(self, *exc):
        self.root.__exit__(*exc)
        req = self.req
        req.end_ns = now_ns()
        for prefix, counts, before in req._before:
            for k, v in counts.items():
                d = v - before.get(k, 0)
                if d < 0:      # the dict was reset inside the request
                    d = v
                if d:
                    req.counters[f"{prefix}.{k}"] = d
        req._before = req._stack = None
        _current.reset(self.token)
        _ring.append(req)
        return False


def request(kind: str, device=None, **attrs) -> _RequestCtx:
    """Open a request of ``kind`` (its outermost span); ``device`` the
    device it runs on (device timing in full mode needs a CUDA one);
    ``attrs`` are kept with it. A request opened inside another is a
    request of its own, whose time the outer one's open span counts as its
    own."""
    cuda = device is not None and torch.device(device).type == "cuda"
    return _RequestCtx(kind, attrs, cuda)


def requests(kind: Optional[str] = None) -> List[Request]:
    """The kept requests, oldest first (only those of ``kind``, if given)."""
    return [r for r in list(_ring) if kind is None or r.kind == kind]


def last(kind: Optional[str] = None) -> Optional[Request]:
    """The newest kept request (of ``kind``), or None."""
    for r in reversed(list(_ring)):
        if kind is None or r.kind == kind:
            return r
    return None


def clear() -> None:
    """Forget the kept requests and events."""
    _ring.clear()
    _events.clear()


def clear_events() -> None:
    """Forget the kept span events."""
    _events.clear()


def set_mode(full: bool = False, device: bool = False) -> None:
    """Default mode (``full=False``), or full mode: every span kept as an
    event, with ``device`` a CUDA event pair too (when CUDA is available)
    and the anchor recorded now."""
    global _full, _device, _anchor
    _full = bool(full)
    _device = bool(full and device and torch.cuda.is_available())
    if _device:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        _anchor = (ev, now_ns())


def mode() -> dict:
    return {"full": _full, "device": _device}


class full_mode:
    """``set_mode(full=True, device=device)`` for a block, then the mode
    that was on before."""

    def __init__(self, device: bool = False):
        self.device = device

    def __enter__(self):
        self.before = mode()
        set_mode(True, self.device)
        return self

    def __exit__(self, *exc):
        set_mode(**self.before)
        return False


def events(request_id: Optional[int] = None) -> List[dict]:
    """The kept span events (of one request), each {id, name, request,
    parent (the id of the innermost span open around it, 0 for none),
    start_ns, end_ns, wait} and, with device timing, device_start_ns and
    device_end_ns on the host's clock. Call it after the device has
    finished the spans' work."""
    out = []
    for sid, name, rid, parent, t0, t1, is_wait, d0, d1 in list(_events):
        if request_id is not None and rid != request_id:
            continue
        e = {"id": sid, "name": name, "request": rid, "parent": parent,
             "start_ns": t0, "end_ns": t1, "wait": is_wait}
        if d0 is not None and _anchor is not None:
            a_ev, a_ns = _anchor
            e["device_start_ns"] = a_ns + _elapsed_ns(a_ev, d0)
            e["device_end_ns"] = a_ns + _elapsed_ns(a_ev, d1)
        out.append(e)
    return out


def _elapsed_ns(a, b) -> int:
    """ns from CUDA event ``a`` to ``b``, either order."""
    try:
        return int(round(a.elapsed_time(b) * 1e6))
    except RuntimeError:
        return -int(round(b.elapsed_time(a) * 1e6))


def device_ms(evs: List[dict]) -> Dict[str, float]:
    """{span name: device-timeline ms} summed over ``evs`` (``events``)
    that have device timing."""
    out: Dict[str, float] = {}
    for e in evs:
        if "device_start_ns" in e:
            out[e["name"]] = out.get(e["name"], 0.0) + \
                (e["device_end_ns"] - e["device_start_ns"]) / 1e6
    return out


def span_s(req: Optional[Request], name: str) -> float:
    """Seconds of the spans ``name`` of ``req``: on the device's timeline
    where full mode kept them with device timing (read after the device has
    finished them), else on the host's; 0 for none."""
    if req is None:
        return 0.0
    evs = [e for e in events(req.id) if e["name"] == name]
    if evs and all("device_start_ns" in e for e in evs):
        return sum(e["device_end_ns"] - e["device_start_ns"] for e in evs) / 1e9
    return req.total_ms(name) / 1e3


def export_chrome(path: str, like: Optional[str] = None) -> None:
    """Write the kept span events as a Chrome trace: a host track and, with
    device timing, a device track, each event at µs since a base. With
    ``like`` (a trace written by ``prof.export_chrome_trace``) the base is
    that trace's ``baseTimeNanoseconds``, so that the two overlay; else 0."""
    base = 0
    if like is not None:
        with open(like) as f:
            base = int(json.load(f).get("baseTimeNanoseconds", 0))
    pid = "mdqe tracer"
    trace = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
              "args": {"name": label}} for tid, label in ((0, "host"), (1, "device"))]
    for e in events():
        args = {"request": e["request"], "id": e["id"], "parent": e["parent"],
                "wait": e["wait"]}
        trace.append({"ph": "X", "cat": "host", "name": e["name"], "pid": pid, "tid": 0,
                      "ts": (e["start_ns"] - base) / 1e3,
                      "dur": (e["end_ns"] - e["start_ns"]) / 1e3, "args": args})
        if "device_start_ns" in e:
            trace.append({"ph": "X", "cat": "device", "name": e["name"], "pid": pid,
                          "tid": 1, "ts": (e["device_start_ns"] - base) / 1e3,
                          "dur": (e["device_end_ns"] - e["device_start_ns"]) / 1e3,
                          "args": args})
    with open(path, "w") as f:
        json.dump({"traceEvents": trace, "displayTimeUnit": "ms",
                   "baseTimeNanoseconds": base}, f)
