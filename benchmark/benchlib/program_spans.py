"""Readings of the port's own tracer (``mdqe_cvpr2023_tpu_torch/utils/
tracing.py``): the requests it kept in this process (the last 4096), read
after the kind's run.

A reader takes the median over the kept requests of one kind of a value
per request. The ring also holds the kind's warm-up and the passes after
the window (a VIS run: 2 videos before and 3 after some 50-100 in the
window; a training run: the set-up steps and 6 after some 90); the median
drops them without knowing the kind's structure. A port without the
tracer, or a run with no request of the kind (the control, which runs the
reference), reads None."""
from __future__ import annotations

import statistics


def median(kind: str, value):
    """The median of ``value(request)`` over the kept requests of ``kind``
    (those for which it is not None), or None."""
    try:
        from mdqe_cvpr2023_tpu_torch.utils import tracing
    except ImportError:
        return None
    vals = [v for v in map(value, tracing.requests(kind)) if v is not None]
    return statistics.median(vals) if vals else None


def per_clip(ms_of):
    """A value per request of ``vis.video``: ``ms_of(request)`` over its
    clips (the counter ``vis.clips``)."""
    def value(r):
        clips = r.counters.get("vis.clips", 0)
        return ms_of(r) / clips if clips else None
    return median("vis.video", value)


def per_step(span: str):
    """Host ms of ``span`` in a request of ``train.step``."""
    return median("train.step", lambda r: r.total_ms(span) if span in r.spans else None)
