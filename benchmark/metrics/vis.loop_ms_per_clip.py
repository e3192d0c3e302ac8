"""Host ms a clip of the loop between the stages: the self time of
``vis.video`` (the request less its child spans: the schedule, the clip
loop's own Python), over its clips (``vis.clips``). The median over the
tracer's kept requests, which drops the warm-up and the passes after the
window (``benchlib/program_spans.py``)."""
from benchlib import program_spans

LAYER = "host thread"
MOVES = "vis_clips_per_s"


def read(obs):
    return program_spans.per_clip(lambda r: r.self_ms("vis.video"))
