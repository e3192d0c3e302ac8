"""Host ms a clip of the tracker's exact assignment: the span
``vis.track.assign`` (the host JV of ``ops/hungarian.py::lsa_maximize`` and
its numpy, the wait for the score matrix left out) over ``vis.clips``. The
median over the tracer's kept requests, which drops the warm-up and the
passes after the window (``benchlib/program_spans.py``)."""
from benchlib import program_spans

LAYER = "tracker"
MOVES = "vis_clips_per_s"


def read(obs):
    return program_spans.per_clip(lambda r: r.total_ms("vis.track.assign"))
