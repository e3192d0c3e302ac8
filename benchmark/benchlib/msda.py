"""The deformable attention's calls in a traced run. ``installed`` puts a
``record_function`` range of the benchmark's own around each forward
(``models/attention.py::ms_deform_attn`` of the port; ``FWD_RANGE``) and
each backward (``ops/deform_attn.py::MSDeformAttnFunction.backward``;
``BWD_RANGE``). In a profiled pass the kernels' device time is read from
the trace: every operation launched while such a range is open
(``trace.launched_in``), whatever kernel implements the call. Given a
``keep`` dict, it also keeps each call's inputs, which the frozen bounds
need (``roofline.msda_bound``, ``msda_bwd_bound``); that is a pass of its
own, unprofiled, over the same work, so that the copies it makes stay out
of the profiled one."""
from __future__ import annotations

import contextlib

import torch

from . import roofline

FWD_RANGE = "bench.msda_fwd"
BWD_RANGE = "bench.msda_bwd"


def _keep(calls, value, shapes, loc, attw):
    calls.append((tuple(value.shape), value.dtype, tuple((int(h), int(w)) for h, w in shapes),
                  loc.detach().clone(), tuple(attw.shape)))


@contextlib.contextmanager
def installed(fwd: bool = True, bwd: bool = False, keep: dict = None):
    """Ranges around the port's forward (``fwd``) and backward (``bwd``)
    calls; with ``keep`` ({"fwd": [], "bwd": []}) each call's inputs are
    appended to its list."""
    from mdqe_cvpr2023_tpu_torch.models import attention
    from mdqe_cvpr2023_tpu_torch.ops import deform_attn as da
    orig_fwd = attention.ms_deform_attn
    orig_bwd = da.MSDeformAttnFunction.backward

    def fwd_call(value, shapes, loc, attw, site):
        with torch.profiler.record_function(FWD_RANGE):
            out = orig_fwd(value, shapes, loc, attw, site)
        if keep is not None:
            _keep(keep["fwd"], value, shapes, loc, attw)
        return out

    def bwd_call(ctx, grad_output):
        with torch.profiler.record_function(BWD_RANGE):
            grads = orig_bwd(ctx, grad_output)
        if keep is not None:
            value, loc, attw = ctx.saved_tensors
            _keep(keep["bwd"], value, ctx.spatial_shapes, loc, attw)
        return grads

    if fwd:
        attention.ms_deform_attn = fwd_call
    if bwd:
        da.MSDeformAttnFunction.backward = staticmethod(bwd_call)
    try:
        yield
    finally:
        attention.ms_deform_attn = orig_fwd
        da.MSDeformAttnFunction.backward = staticmethod(orig_bwd)


def bound_ms(calls, which: str) -> float:
    """The sum of the frozen bound over the kept calls of ``which``
    ("fwd" or "bwd"), in ms."""
    fn = roofline.msda_bound if which == "fwd" else roofline.msda_bwd_bound
    total = 0.0
    for vshape, vdtype, shapes, loc, ashape in calls:
        value = torch.empty(vshape, dtype=vdtype, device="meta")
        attw = torch.empty(ashape, device="meta")
        total += fn(value, shapes, loc, attw)[0]
    return total
