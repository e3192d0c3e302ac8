"""Device-timeline ms a step of the backward, the gradient exchange and the
optimizer: the span around the whole step less the span around
``loss_fn``, over the traced window's steps."""
LAYER = "train step"
MOVES = "train_clips_per_s"


def read(obs):
    sp = obs["spans_ms"]
    if not obs.get("steps") or "step" not in sp or "loss" not in sp:
        return None
    return (sp["step"] - sp["loss"]) / obs["steps"]
