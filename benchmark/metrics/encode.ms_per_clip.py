"""Device-timeline ms a clip of the window encode: the benchmark's CUDA-event
spans around ``models/meta.py::encode_window`` (backbone, input projections,
encoder, mask head) over the traced window, over its clips."""
LAYER = "window encode"
MOVES = "vis_clips_per_s"


def read(obs):
    if not obs.get("clips") or "encode" not in obs["spans_ms"]:
        return None
    return obs["spans_ms"]["encode"] / obs["clips"]
