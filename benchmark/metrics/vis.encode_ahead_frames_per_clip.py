"""Frames encoded ahead of the clip loop a clip: the counter
``vis.encode_ahead_frames`` (the frames of each encode window whose upload
and encode ``inference_vis`` queued before the clip loop reached the window;
``models/meta.py::_inference_vis``) over ``vis.clips``. The median over the
tracer's kept requests, which drops the warm-up and the passes after the
window (``benchlib/program_spans.py``). A port without the counter reads
None."""
from benchlib import program_spans

LAYER = "host thread"
MOVES = "vis_clips_per_s"


def _frames_per_clip(r):
    clips = r.counters.get("vis.clips", 0)
    if "vis.encode_ahead_frames" not in r.counters or not clips:
        return None
    return r.counters["vis.encode_ahead_frames"] / clips


def read(obs):
    return program_spans.median("vis.video", _frames_per_clip)
