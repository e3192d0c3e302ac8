"""The deformable attention backward's share of its roofline, in the
profiled steps: the sum over its calls of the frozen bound
(``benchlib/roofline.py::msda_bwd_bound``, from each call's inputs, kept in
an unprofiled pass over the same steps from the same state) over the device
time of every operation launched inside the calls to
``ops/deform_attn.py::MSDeformAttnFunction.backward``
(``benchlib/trace.py::launched_in``), whatever kernel implements them."""
LAYER = "kernels"
MOVES = "train_clips_per_s"


def read(obs):
    m = obs.get("profile", {}).get("msda_bwd")
    if not m or not m["calls"] or m["calls"] != m["bound_calls"] or m["device_ms"] <= 0:
        return None
    return 100.0 * m["bound_ms"] / m["device_ms"]
