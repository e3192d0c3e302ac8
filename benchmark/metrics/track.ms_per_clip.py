"""Device-timeline ms a clip of the tracker: spans around
``tracking/device_tracker.py::tracker_step`` and ``tracker_window_average``
and the tail of ``inference_vis`` after the last window average (mask
finalize, the merge, the copies to the host), over the traced window's
clips."""
LAYER = "tracker"
MOVES = "vis_clips_per_s"


def read(obs):
    sp = obs["spans_ms"]
    if not obs.get("clips") or "track" not in sp:
        return None
    return (sp["track"] + sp.get("tail", 0.0)) / obs["clips"]
