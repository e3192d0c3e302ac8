#!/usr/bin/env python3
"""Tensor-core throughput against contraction depth K.

The Hopper counterpart of ``tools/probe_mxu_kdepth.py``, whose TPU kernel
chains 48 bf16 products (1024, K) x (K, N) with fp32 accumulation over a grid
of 8 steps that recompute the same block, to see whether the matrix unit pads
a shallow K. Here the hand-written ``tc_kdepth`` kernel (wgmma bf16 -> fp32,
A from registers) computes the same function, out = sum_{i<48} bf16(A + i) @
B, launched 8 times in place of the grid of 8, over the same sweep: K = 16 ..
256 and N = 1024, 1536.

Per (K, N): ms per launch (CUDA events after a warm-up, cycling through
inputs that differ by 0.001 as the TPU tool's do), TFLOP/s, the share of the
H100 SXM dense bf16 tensor peak (989 TFLOP/s, NVIDIA's data sheet) and us per
product; the same from a CUDA graph of the 8 launches (``device_*``: the
kernel's device time without the wrapper's host cost, which bounds the
eager time of a short launch); beside it cuBLAS (``torch.matmul``) as the yardstick: on the 48
stacked left operands, (48*1024, K) x (K, N) (the same products, not summed),
and on the same function written as one product, (1024, 48*K) x (48*K, N)
(``library_ms``; ``library_device_ms`` from a CUDA-graph replay).

Usage: python3 -m mdqe_cvpr2023_tpu_torch.tools.probe_mxu_kdepth [--iters N]
"""
from __future__ import annotations

import argparse
import itertools
import json

import numpy as np
import torch

from ..ops import tc_kdepth as tc
from .measure import BF16_TC_FLOP_PER_S, card, graph_ms, tc_bound, time_ms

M = 1024
REPS = 48        # products chained per launch
GRID = 8         # launches per run: the TPU kernel's grid of 8
KS = (16, 32, 48, 64, 80, 128, 256)
NS = (1024, 1536)
N_VARIED = 3     # left operands cycled through a timed loop
REPLACES = "tools/probe_mxu_kdepth.py:42"  # the TPU tool's pallas_call


def tool_inputs(K: int, N: int):
    """The TPU tool's operands: A (M, K) fp32 (every row the same, 0.01 times
    a standard normal), B (K, N) standard normal rounded to bf16 (fp32 numpy
    holding bf16 values is returned as B's source)."""
    a = np.random.default_rng(0).standard_normal((K, 128)).astype(np.float32)
    A = np.tile(a[:, :1], (1, M)).T[:, :K] * np.float32(0.01)
    B = np.random.default_rng(1).standard_normal((K, N)).astype(np.float32)
    return np.ascontiguousarray(A, np.float32), B


def operands(K: int, N: int, device="cuda"):
    """The tool's operands as tensors: A fp32, B bf16, on ``device``."""
    A, B = tool_inputs(K, N)
    return (torch.from_numpy(A).to(device),
            torch.from_numpy(B).to(device).to(torch.bfloat16))


def stacked_lhs(a):
    """(REPS*M, K) bf16: the REPS offset left operands stacked by rows."""
    return torch.cat([(a + float(i)).to(torch.bfloat16) for i in range(REPS)])


def sweep(iters: int = 10, device="cuda"):
    """Time the kernel and the cuBLAS yardsticks at every (K, N)."""
    rows = []
    for N in NS:
        for K in KS:
            a, b = operands(K, N, device)
            avs = [a + 0.001 * i for i in range(N_VARIED)]
            cyc = itertools.cycle(avs)

            def run():
                av = next(cyc)
                for _ in range(GRID):
                    tc.tc_kdepth_cuda(av, b, REPS)

            ms = time_ms(run, iters) / GRID
            device_ms = graph_ms(lambda: [tc.tc_kdepth_cuda(a, b, REPS, count=False)
                                          for _ in range(GRID)], iters) / GRID
            stk = stacked_lhs(a)
            stacked_ms = time_ms(lambda: torch.matmul(stk, b), iters)
            cat_a = stk.reshape(REPS, M, K).permute(1, 0, 2).reshape(M, REPS * K)
            cat_b = b.repeat(REPS, 1)
            library_ms = time_ms(lambda: torch.matmul(cat_a, cat_b), iters)
            library_device_ms = graph_ms(lambda: torch.matmul(cat_a, cat_b), iters)
            plain_ms = time_ms(lambda: tc.tc_kdepth_plain(a, b, REPS), 2)
            bound_ms, bound_by, flops = tc_bound(M, N, K, REPS)
            tflops = flops / ms / 1e9
            dev_tflops = flops / device_ms / 1e9
            rows.append({"K": K, "N": N, "ms": ms, "run_ms": ms * GRID, "tflop_per_s": tflops,
                         "share_of_peak": tflops * 1e12 / BF16_TC_FLOP_PER_S,
                         "us_per_product": ms * 1e3 / REPS, "device_ms": device_ms,
                         "device_tflop_per_s": dev_tflops,
                         "device_share_of_peak": dev_tflops * 1e12 / BF16_TC_FLOP_PER_S,
                         "bound_ms": bound_ms,
                         "bound_by": bound_by, "plain_ms": plain_ms,
                         "cublas_stacked_ms": stacked_ms,
                         "cublas_stacked_tflop_per_s": flops / stacked_ms / 1e9,
                         "library_ms": library_ms,
                         "library_tflop_per_s": flops / library_ms / 1e9,
                         "library_device_ms": library_device_ms})
            del avs, stk, cat_a, cat_b
    return rows


def check(K: int, N: int, device="cuda", random_lhs: bool = False):
    """(max |err|, max |out|) of the kernel against ``tc_kdepth_plain`` on the
    tool's operands, or with a random A (rows that differ) when
    ``random_lhs`` (launches not counted)."""
    a, b = operands(K, N, device)
    if random_lhs:
        gen = np.random.default_rng(K * 7919 + N)
        a = torch.from_numpy(gen.standard_normal((M, K)).astype(np.float32)).to(device)
    got = tc.tc_kdepth_cuda(a, b, REPS, count=False)
    want = tc.tc_kdepth_plain(a, b, REPS)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"non-finite tc_kdepth output at K={K} N={N}")
    return float((got - want).abs().max()), float(want.abs().max())


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=10, help="timed runs per shape")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(card(), flush=True)
    rel = {}
    for N in NS:
        for K in KS:
            rel[f"K{K}_N{N}"] = max(err / scale for err, scale in
                                    (check(K, N), check(K, N, random_lhs=True)))
    print(json.dumps({"max_abs_err_over_max_out": rel}), flush=True)
    for row in sweep(args.iters):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
