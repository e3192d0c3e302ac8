"""The forward deformable attention's share of its roofline, in the profiled
video: the sum over its calls of the frozen bound
(``benchlib/roofline.py::msda_bound``, from each call's inputs, kept in an
unprofiled pass over the same video) over the device time of every
operation launched inside the calls to ``models/attention.py::ms_deform_attn``
(``benchlib/trace.py::launched_in``: the trace's launches inside the
benchmark's range around each call, matched to their device operations),
whatever kernel implements them."""
LAYER = "kernels"
MOVES = "vis_clips_per_s"


def read(obs):
    m = obs.get("profile", {}).get("msda_fwd")
    if not m or not m["calls"] or m["calls"] != m["bound_calls"] or m["device_ms"] <= 0:
        return None
    return 100.0 * m["bound_ms"] / m["device_ms"]
