"""Host ms a clip in which the host thread waits on the card: the sum of the
``*.wait`` spans under ``vis.video`` (every device read and synchronizing
upload of ``inference_vis``), over its clips (``vis.clips``). The median
over the tracer's kept requests, which drops the warm-up and the passes
after the window (``benchlib/program_spans.py``)."""
from benchlib import program_spans

LAYER = "host thread"
MOVES = "vis_clips_per_s"


def read(obs):
    return program_spans.per_clip(lambda r: r.wait_ms())
