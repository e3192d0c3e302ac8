"""The device's idle share in the profiled run that records the device's
activity alone (no host operators or ranges, the least the profiler adds
to the host): 1 - (the union of its operations' intervals, from
``torch.profiler``) / (the run's length), in %."""
LAYER = "device"
MOVES = "train_clips_per_s"


def read(obs):
    p = obs.get("profile")
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
