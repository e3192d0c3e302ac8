"""Tracker rows finalized early a clip: the counter ``vis.evict_rows`` (the
live rows of the windows that ``slab_hbm_budget`` finalizes before the
video's end, ``models/meta.py::_inference_vis``) over ``vis.clips``. The
median over the tracer's kept requests that finalized a window early
(those that did not carry no such counter), which drops the warm-up and the
passes after the window (``benchlib/program_spans.py``). A port without the
counter reads None."""
from benchlib import program_spans

LAYER = "tracker"
MOVES = "vis_clips_per_s"


def _rows_per_clip(r):
    clips = r.counters.get("vis.clips", 0)
    if "vis.evict_rows" not in r.counters or not clips:
        return None
    return r.counters["vis.evict_rows"] / clips


def read(obs):
    return program_spans.median("vis.video", _rows_per_clip)
