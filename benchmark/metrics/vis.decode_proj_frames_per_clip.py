"""Encoder frames the clip decode projects a clip: the counter
``vis.decode_proj_frames`` (per decode batch, the distinct window frames
its clips read, each projected once a decoder layer and site;
``models/meta.py::decode_clips_batched``) over ``vis.clips``. The median
over the tracer's kept requests, which drops the warm-up and the passes
after the window (``benchlib/program_spans.py``). A port without the
counter reads None."""
from benchlib import program_spans

LAYER = "clip decode"
MOVES = "vis_clips_per_s"


def _frames_per_clip(r):
    clips = r.counters.get("vis.clips", 0)
    if "vis.decode_proj_frames" not in r.counters or not clips:
        return None
    return r.counters["vis.decode_proj_frames"] / clips


def read(obs):
    return program_spans.median("vis.video", _frames_per_clip)
