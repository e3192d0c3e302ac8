"""Device-timeline ms a clip of the batched clip decode: spans around
``models/meta.py::decode_clips_batched`` (the decoder and ``postprocess_clip``)
over the traced window, over its clips."""
LAYER = "clip decode"
MOVES = "vis_clips_per_s"


def read(obs):
    if not obs.get("clips") or "decode" not in obs["spans_ms"]:
        return None
    return obs["spans_ms"]["decode"] / obs["clips"]
