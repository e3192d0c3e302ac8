"""Host ms a step of ``train.loss`` (``loss_fn``: the training forward, the
matcher and the criterion as the host issues them, its waits included).
The median over the tracer's kept ``train.step`` requests, which drops the
set-up steps and the passes after the window
(``benchlib/program_spans.py``)."""
from benchlib import program_spans

LAYER = "train step"
MOVES = "train_clips_per_s"


def read(obs):
    return program_spans.per_step("train.loss")
