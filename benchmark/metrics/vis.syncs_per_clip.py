"""Synchronizing calls a clip: the counter ``vis.syncs`` (one per device
read or upload from host memory of ``inference_vis``) over ``vis.clips``.
The median over the tracer's kept requests, which drops the warm-up and
the passes after the window (``benchlib/program_spans.py``)."""
from benchlib import program_spans

LAYER = "host thread"
MOVES = "vis_clips_per_s"


def read(obs):
    return program_spans.per_clip(lambda r: float(r.counters.get("vis.syncs", 0)))
