"""The benchmark's frozen roofline arithmetic: the published peaks of one
NVIDIA H100 SXM and the least time the card could take for the deformable
attention's work. Copied from the port's ``tools/measure.py`` (``_bound``,
``msda_taps``, ``msda_bound``, ``msda_bwd_bound``) so that a later change
to the program cannot move the yardstick.

Peaks (NVIDIA's data sheet, dense, at the full 700 W power limit): 3.35 TB/s
of HBM3, 67 TFLOP/s fp32 outside the tensor cores, 989 TFLOP/s bf16 on the
tensor cores.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
# the peak each precision's model FLOPs are held to (``mfu``): fp32 with TF32
# off runs outside the tensor cores
PEAK_FLOP_PER_S = {"fp32": FP32_FLOP_PER_S, "bf16": BF16_TC_FLOP_PER_S}


def _bound(nbytes: float, flops: float, flop_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def msda_taps(value, shapes, loc):
    """(distinct value rows the in-range taps touch, number of in-range taps)."""
    B, N, H, D = value.shape
    b = torch.arange(B, device=loc.device).view(B, 1, 1, 1)
    h = torch.arange(H, device=loc.device).view(1, 1, H, 1)
    rows, taps, start = [], 0, 0
    for l, (hl, wl) in enumerate(shapes):
        x = loc[:, :, :, l, :, 0] * wl - 0.5
        y = loc[:, :, :, l, :, 1] * hl - 0.5
        x0, y0 = torch.floor(x).long(), torch.floor(y).long()
        for cx, cy in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)):
            ok = (cx >= 0) & (cx < wl) & (cy >= 0) & (cy < hl)
            taps += int(ok.sum())
            rows.append((((b * N + start + cy * wl + cx) * H + h)[ok]).reshape(-1))
        start += hl * wl
    return int(torch.unique(torch.cat(rows)).numel()), taps


def msda_bound(value, shapes, loc, attw):
    """Least time of the forward on an H100: the larger of (bytes it must
    move: the value rows its in-range taps touch, locations, weights, output)
    over HBM bandwidth and (2*D flops per in-range tap) over fp32 peak.
    Returns (ms, "bytes" or "operations", bytes)."""
    B, N, H, D = value.shape
    Q = loc.shape[1]
    touched, taps = msda_taps(value, shapes, loc)
    nbytes = (touched * D * value.element_size() + loc.numel() * 4
              + attw.numel() * 4 + B * Q * H * D * 4)
    ms, by = _bound(nbytes, 2.0 * D * taps, FP32_FLOP_PER_S)
    return ms, by, nbytes


def msda_bwd_bound(value, shapes, loc, attw):
    """Least time of the backward on an H100: the larger of (bytes: the value
    rows the in-range taps touch, read; d(value) written once in full, both
    in the value's type; locations, weights and the output gradient read,
    fp32; d(locations) and d(weights) written, fp32) over HBM bandwidth and
    (8*D flops per in-range tap: the sample, its two derivatives, the
    scattered product) over fp32 peak. Returns (ms, bound_by, bytes, the
    kernel's 16-byte vector atomics: one per 4 channels of every in-range
    tap, which the bound does not count)."""
    B, N, H, D = value.shape
    Q = loc.shape[1]
    touched, taps = msda_taps(value, shapes, loc)
    esize = value.element_size()
    nbytes = (touched * D * esize + value.numel() * esize + 2 * loc.numel() * 4
              + 2 * attw.numel() * 4 + B * Q * H * D * 4)
    ms, by = _bound(nbytes, 8.0 * D * taps, FP32_FLOP_PER_S)
    return ms, by, nbytes, taps * D // 4
