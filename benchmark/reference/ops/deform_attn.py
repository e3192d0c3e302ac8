"""Multi-scale deformable attention, plain PyTorch only: the benchmark's
reference copy of ``ms_deform_attn_plain`` (``ops/deform_attn.py`` of the
port). No kernel: every call site computes the 4-corner gather, on any
device. Under autograd ``PlainMSDA`` saves only its inputs and works the
gradients out in its backward, corner by corner, so that the reference's
training step fits on one card (autograd of the gather would keep every
corner's gathered rows).

Contract:
  value               (B, N, H, D)   N = sum_l h_l * w_l
  spatial_shapes      static tuple of (h_l, w_l)
  sampling_locations  (B, Q, H, L, P, 2) normalized [0, 1], last axis (x, y)
  attention_weights   (B, Q, H, L, P), softmaxed over L * P
  returns             (B, Q, H * D) fp32 (f64 when an input is f64)
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

SITES = ("encoder", "decoder_box", "decoder_inst")


def ms_deform_attn_plain(value, spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations, attention_weights):
    """4-corner gather per level (mirrors ``_ms_deform_attn_xla``). Computes in
    fp32, or in f64 when given f64."""
    B, N, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    if L != len(spatial_shapes):
        raise ValueError(f"{L} levels in locations, shapes {spatial_shapes}")
    cdt = (torch.float64 if torch.float64 in (value.dtype, sampling_locations.dtype)
           else torch.float32)
    loc = sampling_locations.to(cdt)
    attw = attention_weights.to(cdt)
    out = torch.zeros((B, Q, H, D), dtype=cdt, device=value.device)
    b_idx = torch.arange(B, device=value.device).view(B, 1, 1, 1)
    h_idx = torch.arange(H, device=value.device).view(1, 1, H, 1)
    start = 0
    for l, (h_l, w_l) in enumerate(spatial_shapes):
        h_l, w_l = int(h_l), int(w_l)
        hw = h_l * w_l
        v_flat = value[:, start:start + hw].reshape(B * hw * H, D)
        start += hw
        x = loc[:, :, :, l, :, 0] * w_l - 0.5          # (B, Q, H, P)
        y = loc[:, :, :, l, :, 1] * h_l - 0.5
        x0f, y0f = torch.floor(x), torch.floor(y)
        fx, fy = x - x0f, y - y0f
        x0, y0 = x0f.long(), y0f.long()
        a = attw[:, :, :, l]                            # (B, Q, H, P)
        for cx, cy, wgt in ((x0, y0, (1 - fx) * (1 - fy)),
                            (x0 + 1, y0, fx * (1 - fy)),
                            (x0, y0 + 1, (1 - fx) * fy),
                            (x0 + 1, y0 + 1, fx * fy)):
            ok = (cx >= 0) & (cx < w_l) & (cy >= 0) & (cy < h_l)
            pix = cy.clamp(0, h_l - 1) * w_l + cx.clamp(0, w_l - 1)
            rows = v_flat[((b_idx * hw + pix) * H + h_idx).reshape(-1)]
            rows = rows.view(B, Q, H, P, D).to(cdt)
            out += ((wgt * ok * a)[..., None] * rows).sum(dim=3)
    return out.reshape(B, Q, H * D)


def _corners(loc, l, h_l, w_l):
    """Per corner of level ``l``: (x index, y index, in range, bilinear
    weight, d weight / d x, d weight / d y), each (B, Q, H, P), in the
    locations' type."""
    x = loc[:, :, :, l, :, 0] * w_l - 0.5
    y = loc[:, :, :, l, :, 1] * h_l - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    out = []
    for cx, cy, wgt, dwx, dwy in ((x0, y0, (1 - fx) * (1 - fy), -(1 - fy), -(1 - fx)),
                                  (x0 + 1, y0, fx * (1 - fy), 1 - fy, -fx),
                                  (x0, y0 + 1, (1 - fx) * fy, -fy, 1 - fx),
                                  (x0 + 1, y0 + 1, fx * fy, fy, fx)):
        ok = (cx >= 0) & (cx < w_l) & (cy >= 0) & (cy < h_l)
        out.append((cx, cy, ok, wgt, dwx, dwy))
    return out


class PlainMSDA(torch.autograd.Function):
    """``ms_deform_attn_plain`` with a backward of its own: d(value) is the
    scatter of each tap's weighted output gradient, d(weights) and
    d(locations) the gathered rows against the output gradient."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights):
        ctx.spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                    attention_weights)

    @staticmethod
    def backward(ctx, grad_output):
        value, loc_in, attw_in = ctx.saved_tensors
        B, N, H, D = value.shape
        _, Q, _, L, P, _ = loc_in.shape
        cdt = (torch.float64 if torch.float64 in (value.dtype, loc_in.dtype)
               else torch.float32)
        loc, attw = loc_in.to(cdt), attw_in.to(cdt)
        g = grad_output.to(cdt).reshape(B, Q, H, 1, D)
        d_value = torch.zeros((B * N * H, D), dtype=cdt, device=value.device)
        d_loc = torch.zeros(loc.shape, dtype=cdt, device=value.device)
        d_attw = torch.zeros(attw.shape, dtype=cdt, device=value.device)
        b_idx = torch.arange(B, device=value.device).view(B, 1, 1, 1)
        h_idx = torch.arange(H, device=value.device).view(1, 1, H, 1)
        start = 0
        for l, (h_l, w_l) in enumerate(ctx.spatial_shapes):
            hw = h_l * w_l
            v_flat = value[:, start:start + hw].reshape(B * hw * H, D)
            a = attw[:, :, :, l]
            dfx = torch.zeros_like(a)
            dfy = torch.zeros_like(a)
            for cx, cy, ok, wgt, dwx, dwy in _corners(loc, l, h_l, w_l):
                pix = cy.clamp(0, h_l - 1) * w_l + cx.clamp(0, w_l - 1)
                rows_idx = (((b_idx * N + start + pix) * H + h_idx)).reshape(-1)
                rows = v_flat[((b_idx * hw + pix) * H + h_idx).reshape(-1)]
                vg = (rows.view(B, Q, H, P, D).to(cdt) * g).sum(-1) * ok   # (B,Q,H,P)
                d_attw[:, :, :, l] += wgt * vg
                dfx += dwx * a * vg
                dfy += dwy * a * vg
                contrib = ((wgt * ok * a)[..., None] * g).reshape(-1, D)
                d_value.index_add_(0, rows_idx, contrib)
            d_loc[:, :, :, l, :, 0] = dfx * w_l
            d_loc[:, :, :, l, :, 1] = dfy * h_l
            start += hw
        return (d_value.view(B, N, H, D).to(value.dtype), None, d_loc.to(loc_in.dtype),
                d_attw.to(attw_in.dtype))


def ms_deform_attn(value, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations, attention_weights, site: str):
    """Deformable attention for the call site ``site``: always the plain
    version."""
    if site not in SITES:
        raise KeyError(site)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (
            value, sampling_locations, attention_weights)):
        return PlainMSDA.apply(value, spatial_shapes, sampling_locations,
                               attention_weights)
    return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                attention_weights)
