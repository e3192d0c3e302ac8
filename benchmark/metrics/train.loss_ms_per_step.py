"""Device-timeline ms a step of the loss: spans around
``parallel/train.py::loss_fn`` (the training forward, the matcher and the
criterion) over the traced window's steps."""
LAYER = "train step"
MOVES = "train_clips_per_s"


def read(obs):
    if not obs.get("steps") or "loss" not in obs["spans_ms"]:
        return None
    return obs["spans_ms"]["loss"] / obs["steps"]
