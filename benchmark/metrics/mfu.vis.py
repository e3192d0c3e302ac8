"""The whole step's share of the card's peak over the traced window: the
model FLOPs of the work completed (``benchmark/flops.py``, from the
configuration and the input shapes) in each precision over that precision's
peak (``benchlib/roofline.py::PEAK_FLOP_PER_S``), summed, over the window,
in %."""
from benchlib.roofline import PEAK_FLOP_PER_S

LAYER = "whole step"
MOVES = "vis_clips_per_s"


def read(obs):
    if not obs.get("flops") or obs["window_s"] <= 0:
        return None
    busy = sum(f / PEAK_FLOP_PER_S[prec] for prec, f in obs["flops"].items())
    return 100.0 * busy / obs["window_s"] if busy > 0 else None
