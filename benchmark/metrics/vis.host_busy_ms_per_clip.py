"""Host ms a clip in which the host thread works: the request ``vis.video``
(one ``inference_vis`` call) less every ``*.wait`` span in it (the host
blocked on a device read or a synchronizing upload), over its clips
(``vis.clips``). The median over the tracer's kept requests, which drops
the warm-up and the passes after the window (``benchlib/program_spans.py``)."""
from benchlib import program_spans

LAYER = "host thread"
MOVES = "vis_clips_per_s"


def read(obs):
    return program_spans.per_clip(lambda r: r.total_ms("vis.video") - r.wait_ms())
