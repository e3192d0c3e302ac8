"""Spans of the benchmark's own: CUDA events recorded around calls into the
port, read after the window. An event pair's elapsed time is on the device
timeline; no span waits for the device while it runs. On the CPU (the
tests) the spans read the host clock."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Spans:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.pairs = defaultdict(list)   # name -> [(start, end)]

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def add(self, name: str, start, end) -> None:
        self.pairs[name].append((start, end))

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = self.mark()
        try:
            yield
        finally:
            self.add(name, start, self.mark())

    def wrap(self, name: str, fn):
        def wrapped(*args, **kwargs):
            with self(name):
                return fn(*args, **kwargs)
        return wrapped

    def totals_ms(self) -> dict:
        """{name: total ms, name + "_n": count}, after the device has
        finished the window's work."""
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for name, pairs in self.pairs.items():
            if self.cuda:
                out[name] = sum(s.elapsed_time(e) for s, e in pairs)
            else:
                out[name] = sum(e - s for s, e in pairs) * 1e3
            out[name + "_n"] = len(pairs)
        return out
