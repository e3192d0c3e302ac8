#!/usr/bin/env python3
"""Block-size sweep of the forward deformable-attention kernel at the
encoder's four level shapes.

The Hopper counterpart of ``tools/tune_deform_kernel.py``, whose ``run_level``
times one pyramid level of the TPU hat-matmul kernel over query tiles (``Qt``)
and the type of its elementwise stage (``ew_bf16``). Its problem: 80 (batch,
head) pairs, 5120 queries, D = 32 channels, 4 points on one level of
48x80, 24x40, 12x20 or 6x10; pixel coordinates and weights g (BH, 3P, Q) =
(gy, gx, weight), uniform in [0, 20); a channel-major value (BH, h, D*w).
Here it runs in the port's layout (B = 10, H = 8, L = 1; loc = (g + 0.5) /
size, value (B, h*w, H, D)) through ``msda_fwd_*_block``, swept over the block
size (64, 128, 256, 512 threads) and the value type (bf16, fp32).

Per variant: ms per launch (CUDA events after a warm-up, cycling through
inputs that differ by 0.001 as the TPU tool's do), GB/s of the bytes the
launch must move, and the share of the least time an H100 could take (its
bound); per level and value type, the plain version's and the grid_sample
yardstick's ms.

Usage: python3 -m mdqe_cvpr2023_tpu_torch.tools.tune_deform_kernel [--iters N]
"""
from __future__ import annotations

import argparse
import itertools
import json

import numpy as np
import torch

from ..ops import deform_attn as da
from .measure import card, grid_sample_msda, msda_bound, time_ms

LEVELS = ((48, 80), (24, 40), (12, 20), (6, 10))
B, H, Q, D, P = 10, 8, 5120, 32, 4
VALUE_DTYPES = (torch.bfloat16, torch.float32)
N_VARIED = 3           # value inputs cycled through a timed loop
REPLACES = "tools/tune_deform_kernel.py:33"  # the TPU tool's pallas_call


def tool_inputs(h: int, w: int, seed: int, bh: int = B * H, q: int = Q, d: int = D,
                p: int = P):
    """The TPU tool's inputs for one level: channel-major value (BH, h, D*w)
    and g (BH, 3P, Q) = (gy, gx, weight), fp32 numpy."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((bh, h, d * w)).astype(np.float32)
    g = rng.uniform(0, 20, (bh, 3 * p, q)).astype(np.float32)
    return v, g


def to_port_layout(v_cm, g, h: int, w: int, heads: int = H):
    """The TPU tool's layout -> the port's: value (B, h*w, H, D), loc (B, Q,
    H, 1, P, 2) with loc = (g + 0.5) / size (x, y), weights (B, Q, H, 1, P);
    batch-head pair bh = b * heads + head. fp32 numpy, contiguous."""
    bh = v_cm.shape[0]
    b, d = bh // heads, v_cm.shape[2] // w
    p, q = g.shape[1] // 3, g.shape[2]
    value = v_cm.reshape(b, heads, h, d, w).transpose(0, 2, 4, 1, 3).reshape(b, h * w, heads, d)
    gy, gx, aw = g[:, :p], g[:, p:2 * p], g[:, 2 * p:]             # (BH, P, Q)
    loc = np.stack([(gx + 0.5) / w, (gy + 0.5) / h], -1)           # (BH, P, Q, 2)
    loc = loc.reshape(b, heads, p, q, 2).transpose(0, 3, 1, 2, 4)[:, :, :, None]
    attw = aw.reshape(b, heads, p, q).transpose(0, 3, 1, 2)[:, :, :, None]
    return (np.ascontiguousarray(value, np.float32), np.ascontiguousarray(loc, np.float32),
            np.ascontiguousarray(attw, np.float32))


def from_port_output(out, heads: int = H):
    """(B, Q, H*D) -> the TPU tool's (BH, Q, D)."""
    b, q, hd = out.shape
    return out.reshape(b, q, heads, hd // heads).transpose(1, 2).reshape(b * heads, q, -1)


def level_inputs(h: int, w: int, seed: int, device="cuda"):
    """One level's inputs in the port's layout as fp32 tensors on ``device``."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in to_port_layout(*tool_inputs(h, w, seed), h, w))


def check_variants(value, shapes, loc, attw):
    """max |err| of every block size against the plain version on these
    inputs (launches not counted), and the largest |out| as the scale."""
    want = da.ms_deform_attn_plain(value, shapes, loc, attw)
    errs = {}
    for t in da.BLOCK_THREADS:
        got = da.ms_deform_attn_cuda_block(value, shapes, loc, attw, t, count=False)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"non-finite output at block size {t}")
        errs[t] = float((got - want).abs().max())
    return errs, float(want.abs().max())


def sweep(iters: int = 20, levels=LEVELS, device="cuda"):
    """Time every (level, value type, block size) of ``levels`` (a subset of
    LEVELS; each level's inputs drawn from its index there, as ``main``
    checks them); one dict per variant."""
    rows = []
    for h, w in levels:
        shapes = ((h, w),)
        value, loc, attw = level_inputs(h, w, seed=LEVELS.index((h, w)), device=device)
        for vdt in VALUE_DTYPES:
            vals = [(value + 0.001 * i).to(vdt) for i in range(N_VARIED)]
            bound_ms, bound_by, nbytes = msda_bound(vals[0], shapes, loc, attw)
            plain_ms = time_ms(lambda: da.ms_deform_attn_plain(vals[0], shapes, loc, attw), 3)
            lib_ms = time_ms(lambda: grid_sample_msda(vals[0], shapes, loc, attw), 3)
            for t in da.BLOCK_THREADS:
                cyc = itertools.cycle(vals)
                ms = time_ms(lambda: da.ms_deform_attn_cuda_block(next(cyc), shapes, loc,
                                                                  attw, t), iters)
                rows.append({"level": f"{h}x{w}", "value": da.VALUE_DTYPES[vdt],
                             "threads": t, "ms": ms, "gb_per_s": nbytes / ms / 1e6,
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "share_of_bound": bound_ms / ms, "plain_ms": plain_ms,
                             "library_ms": lib_ms})
            del vals
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=20, help="timed launches per variant")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(card(), flush=True)
    for li, (h, w) in enumerate(LEVELS):
        value, loc, attw = level_inputs(h, w, seed=li)
        for vdt in VALUE_DTYPES:
            errs, scale = check_variants(value.to(vdt), ((h, w),), loc, attw)
            print(json.dumps({"level": f"{h}x{w}", "value": da.VALUE_DTYPES[vdt],
                              "max_abs_err_by_threads": errs, "max_abs_out": scale}),
                  flush=True)
    for row in sweep(args.iters):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
