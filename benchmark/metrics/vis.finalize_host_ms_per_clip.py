"""Host ms a clip of the early finalize: the span ``vis.finalize`` of
``models/meta.py::_inference_vis`` (the oldest window's live rows
thresholded and bit-packed on the card when the slabs pass
``slab_hbm_budget``) with its wait ``vis.finalize.wait`` (the read of the
window's live-row count) left out, over ``vis.clips``. The median over the
tracer's kept requests that finalized a window early, which drops the
warm-up and the passes after the window (``benchlib/program_spans.py``)."""
from benchlib import program_spans

LAYER = "host thread"
MOVES = "vis_clips_per_s"


def _host_ms_per_clip(r):
    clips = r.counters.get("vis.clips", 0)
    if "vis.finalize" not in r.spans or not clips:
        return None
    return (r.total_ms("vis.finalize") - r.total_ms("vis.finalize.wait")) / clips


def read(obs):
    return program_spans.median("vis.video", _host_ms_per_clip)
