#!/usr/bin/env python3
"""Gather probe: one-point bilinear sampling of one 48x80 level at D = 32, for
a tight and a wide spread of coordinates.

The Hopper counterpart of ``tools/probe_band_primitives.py``, whose TPU kernel
computes out[q, d] = sum_{y,x} hat(y - gy) hat(x - gx) V[y, x*D + d] (one
point, weight 1, zero outside the level; V position-major (48, 80*32), shared
by two batches of 256 queries) by a banded hat-matmul over the rows the
coordinates touch when they lie in a tight band, and by the full-extent one
when they spread wide. On Hopper the same function is the forward
deformable-attention kernel with B = 1, H = 1, L = 1, P = 1: the two batches
fold into Q = 512 queries, loc = (g + 0.5) / size, value (1, 48*80, 1, 32).

Per spread and size (the tool's 512 queries, and 80 * 5120 queries so that the
time is the gather's and not the launch's), each checked against the tool's
oracle formula and the plain version on the inputs it times: ms per launch
in bf16 (the TPU kernel's compute type), GB/s and share of the bound, and
the device time alone from a CUDA graph replay (``device_ms``), beside one
F.grid_sample call on the same inputs. The question it answers on Hopper: does the locality
of the sampled rows change gather throughput?

Usage: python3 -m mdqe_cvpr2023_tpu_torch.tools.probe_band_primitives [--iters N]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import deform_attn as da
from .measure import card, graph_ms, msda_bound, time_ms

H, W, D = 48, 80, 32        # the level; V position-major (H, W*D)
QT, NB = 256, 2             # the tool's queries per batch, batches
BIG_Q = 80 * 5120           # the encoder level's (batch-head, query) pairs
SPREADS = ("tight", "wide")
THREADS = 256               # the main paths' block size
REPLACES = "tools/probe_band_primitives.py:91"  # the TPU tool's pallas_call
SHAPES = ((H, W),)
SIZES = (("q512", NB * QT), (f"q{BIG_Q}", BIG_Q))  # (name, queries) of the timed problems
ORACLE_CHUNK = 8192         # queries per (n, H*W) f64 hat matrix of the oracle


def spread_coords(kind: str, shape, rng):
    """Pixel coordinates (..., 2) = (gy, gx) of the tool's spreads: tight in
    [10, 28) both ways (the band path); wide gy in [-2, 46), gx in [-2, 78)
    (the fallback path), some outside the level."""
    if kind == "tight":
        return rng.uniform(10.0, 28.0, tuple(shape) + (2,)).astype(np.float32)
    g = rng.uniform(-2.0, 78.0, tuple(shape) + (2,)).astype(np.float32)
    g[..., 0] = rng.uniform(-2.0, 46.0, tuple(shape))
    return g


def probe_inputs():
    """The TPU tool's inputs, drawn in its order: V (H, W*D) and the tight and
    wide coordinates (NB, QT, 2)."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((H, W * D)).astype(np.float32)
    g_tight = rng.uniform(10.0, 28.0, (NB, QT, 2)).astype(np.float32)
    g_wide = rng.uniform(-2.0, 78.0, (NB, QT, 2)).astype(np.float32)
    g_wide[:, :, 0] = rng.uniform(-2.0, 46.0, (NB, QT))
    return v, {"tight": g_tight, "wide": g_wide}


def oracle(g, v, device="cpu"):
    """The tool's oracle formula, out[q, d] = sum_{y,x} hat(y - gy) hat(x - gx)
    V[y, x*D + d], in f64 on ``device``, ``ORACLE_CHUNK`` queries at a time: g (...,
    2) = (gy, gx) pixel coordinates, v (H, W*D) -> (..., D) numpy."""
    gf = torch.from_numpy(np.ascontiguousarray(g.reshape(-1, 2))).to(device, torch.float64)
    v2 = torch.from_numpy(v).to(device, torch.float64).reshape(H * W, D)
    ys = torch.arange(H, dtype=torch.float64, device=device)
    xs = torch.arange(W, dtype=torch.float64, device=device)
    out = []
    for c in range(0, gf.shape[0], ORACLE_CHUNK):
        hy = (1.0 - (ys - gf[c:c + ORACLE_CHUNK, :1]).abs()).clamp(min=0.0)   # (n, H)
        hx = (1.0 - (xs - gf[c:c + ORACLE_CHUNK, 1:]).abs()).clamp(min=0.0)   # (n, W)
        out.append((hy[:, :, None] * hx[:, None, :]).reshape(-1, H * W) @ v2)
    return torch.cat(out).cpu().numpy().reshape(g.shape[:-1] + (D,))


def to_port_layout(g, v):
    """(..., 2) pixel coordinates and V (H, W*D) -> value (1, H*W, 1, D), loc
    (1, n, 1, 1, 1, 2), weights (1, n, 1, 1, 1) of ones; fp32 numpy."""
    gf = g.reshape(-1, 2)
    loc = np.stack([(gf[:, 1] + 0.5) / W, (gf[:, 0] + 0.5) / H], -1)
    n = gf.shape[0]
    return (np.ascontiguousarray(v.reshape(1, H * W, 1, D), np.float32),
            np.ascontiguousarray(loc.reshape(1, n, 1, 1, 1, 2), np.float32),
            np.ones((1, n, 1, 1, 1), np.float32))


def effective_coords(g):
    """The pixel coordinates (..., 2) = (gy, gx) the kernel samples at: loc =
    (g + 0.5) / size rounded to fp32, then loc * size - 0.5 in fp32 as the
    kernel computes it (within a few fp32 ulps of g)."""
    loc = to_port_layout(g, np.zeros((H, W * D), np.float32))[1].reshape(g.shape)
    return np.stack([loc[..., 1] * np.float32(H) - np.float32(0.5),
                     loc[..., 0] * np.float32(W) - np.float32(0.5)], -1)


def grid_sample_probe(value, loc):
    """One F.grid_sample call: value (1, H*W, 1, D) as a (1, D, H, W) image,
    the n points as a (1, 1, n) grid -> (1, n, D)."""
    img = value.float().reshape(1, H, W, D).permute(0, 3, 1, 2)
    grid = (2 * loc - 1).reshape(1, 1, -1, 2)
    out = torch.nn.functional.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                          align_corners=False)
    return out[0, :, 0].t()[None]


def probe_coords(kind: str, n: int):
    """Pixel coordinates (n, 2) of a spread: the tool's own at its size (its
    two batches one after the other), fresh draws of the same spread at
    others."""
    if n == NB * QT:
        return probe_inputs()[1][kind].reshape(n, 2)
    return spread_coords(kind, (n,), np.random.default_rng(1))


def problems():
    """Every timed problem: (spread, size name, queries)."""
    return [(kind, name, n) for kind in SPREADS for name, n in SIZES]


def sweep(iters: int = 20, only=None, device="cuda"):
    """Time the problems (``only``: a list of ``problems()`` entries, all of
    them when None) in bf16; one dict per problem."""
    v, _ = probe_inputs()
    rows = []
    for kind, name, n in only or problems():
        value, loc, attw = (torch.from_numpy(a).to(device)
                            for a in to_port_layout(probe_coords(kind, n), v))
        vb = value.to(torch.bfloat16)
        bound_ms, bound_by, nbytes = msda_bound(vb, SHAPES, loc, attw)
        ms = time_ms(lambda: da.ms_deform_attn_cuda_block(vb, SHAPES, loc, attw, THREADS),
                     iters)
        device_ms = graph_ms(lambda: da.ms_deform_attn_cuda_block(
            vb, SHAPES, loc, attw, THREADS, count=False), iters)
        plain_ms = time_ms(lambda: da.ms_deform_attn_plain(vb, SHAPES, loc, attw), 3)
        lib_ms = time_ms(lambda: grid_sample_probe(vb, loc), 3)
        rows.append({"spread": kind, "size": name, "queries": n, "value": "bf16",
                     "ms": ms, "device_ms": device_ms, "gb_per_s": nbytes / ms / 1e6,
                     "device_gb_per_s": nbytes / device_ms / 1e6, "bound_ms": bound_ms,
                     "bound_by": bound_by, "share_of_bound": bound_ms / ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms})
    return rows


def check(device="cuda"):
    """Per problem (spread, size name), on the inputs ``sweep`` times: max
    |err| of the fp32 kernel against the oracle at the coordinates the kernel
    samples (``effective_coords``), and of the bf16 kernel (the timed one)
    against the plain version on the same bf16 values, with the largest |out|
    as the scale (launches not counted)."""
    v, _ = probe_inputs()
    res = {}
    for kind, name, n in problems():
        g = probe_coords(kind, n)
        value, loc, attw = (torch.from_numpy(a).to(device) for a in to_port_layout(g, v))
        want = oracle(effective_coords(g), v, device)
        got = da.ms_deform_attn_cuda_block(value, SHAPES, loc, attw, THREADS, count=False)
        got = got.reshape(want.shape).double().cpu().numpy()
        vb = value.to(torch.bfloat16)
        got_b = da.ms_deform_attn_cuda_block(vb, SHAPES, loc, attw, THREADS, count=False)
        want_b = da.ms_deform_attn_plain(vb, SHAPES, loc, attw)
        res.setdefault(kind, {})[name] = {
            "f32_vs_oracle": float(np.abs(got - want).max()),
            "bf16_vs_plain": float((got_b - want_b).abs().max()),
            "scale": float(np.abs(want).max())}
    return res


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=20, help="timed launches per problem")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(card(), flush=True)
    print(json.dumps({"max_abs_err": check()}), flush=True)
    for row in sweep(args.iters):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
