"""What the kernel tools and chip_smoke.py measure with: the card's name and
power limit, CUDA-event timing, the least time an H100 could take for a
kernel's work (its bound), and the library yardsticks that compute the same
functions (timed beside the kernels; no model path calls them).

Peaks are those of one H100 SXM (NVIDIA's data sheet, dense): 3.35 TB/s of
HBM3, 67 TFLOP/s fp32 outside the tensor cores, 989 TFLOP/s bf16 on the
tensor cores. They assume the full 700 W power limit; ``card()`` reports the
limit the card is set to.
"""
from __future__ import annotations

import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12


def card() -> str:
    """``name, power.limit`` of card 0, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn`` on the card: CUDA events around
    ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, warmup: int = 2) -> float:
    """Milliseconds per replay of ``fn`` captured once in a CUDA graph: the
    device time of its launches without the host's cost of issuing them
    (which bounds ``time_ms`` when a launch is shorter than its wrapper).
    ``fn`` should launch uncounted: a replay runs no Python."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, iters, warmup=1)


def _bound(nbytes: float, flops: float, flop_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def grid_sample_msda(value, shapes, loc, attw):
    """Deformable attention in the reference's PyTorch oracle form: one
    F.grid_sample per level on (B*H, D, h, w), then the weighted sum."""
    F = torch.nn.functional
    B, N, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    value = value.float()
    grids = 2 * loc - 1
    outs, start = [], 0
    for l, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].flatten(2).transpose(1, 2).reshape(B * H, D, h, w)
        start += h * w
        g = grids[:, :, :, l].transpose(1, 2).flatten(0, 1)           # (B*H, Q, P, 2)
        outs.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                  align_corners=False))                # (B*H, D, Q, P)
    a = attw.transpose(1, 2).reshape(B * H, 1, Q, L * P)
    out = (torch.stack(outs, -2).flatten(-2) * a).sum(-1)
    return out.view(B, H * D, Q).transpose(1, 2)


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


def msda_bf16_reds(value, shapes, loc, tile=None):
    """The 16-byte vector reductions ``msda_bwd_bf16`` sends at Q == N (its
    tiled kernel), from the inputs: per (b, head, query tile, sampled level,
    round of 4 points) whose in-range taps' bounding box spans W <=
    ``deform_attn.BF16_WINDOW`` rows, D / 4 for each distinct row they touch
    and for each tap past the first slots // W of its row (slots: 4 a tap of
    the round, the kernel's kSlots); else D / 4 for each tap. ``tile``
    (height, width) defaults to the kernel's (``deform_attn.BF16_TILE``).
    Returns (reductions, the D / 4 per tap that msda_bwd_f32 sends)."""
    from ..ops import deform_attn as da
    B, N, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    th, tw = tile or da.BF16_TILE
    slots = 4 * th * tw * 16
    dev = loc.device
    tiles, first = [], 0
    for h_l, w_l in shapes:  # each query pixel's tile, levels' tiles row-major
        yy, xx = torch.meshgrid(torch.arange(h_l, device=dev), torch.arange(w_l, device=dev),
                                indexing="ij")
        nx = -(-w_l // tw)
        tiles.append((first + yy // th * nx + xx // tw).reshape(-1))
        first += -(-h_l // th) * nx
    tile_of = torch.cat(tiles)[:Q]
    rounds = -(-P // 4)
    b = torch.arange(B, device=dev).view(B, 1, 1, 1)
    h = torch.arange(H, device=dev).view(1, 1, H, 1)
    p = torch.arange(P, device=dev).view(1, 1, 1, P)
    merged_rows, per_tap, all_taps = 0, 0, 0
    for l, (h_l, w_l) in enumerate(shapes):
        x = loc[:, :, :, l, :, 0] * w_l - 0.5
        y = loc[:, :, :, l, :, 1] * h_l - 0.5
        x0, y0 = torch.floor(x).long(), torch.floor(y).long()
        group = ((b * H + h) * first + tile_of.view(1, Q, 1, 1)) * rounds + p // 4
        gs, xs, ys = [], [], []
        for cx, cy in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)):
            ok = (cx >= 0) & (cx < w_l) & (cy >= 0) & (cy < h_l)
            gs.append(group.expand_as(cx)[ok])
            xs.append(cx[ok])
            ys.append(cy[ok])
        g, cx, cy = torch.cat(gs), torch.cat(xs), torch.cat(ys)
        all_taps += g.numel()
        if g.numel() == 0:
            continue
        groups = B * H * first * rounds
        big = torch.iinfo(torch.long).max
        box = [torch.full((groups,), init, dtype=torch.long, device=dev).scatter_reduce(
            0, g, v, reduce, include_self=True)
            for v, init, reduce in ((cx, big, "amin"), (cx, -1, "amax"),
                                    (cy, big, "amin"), (cy, -1, "amax"))]
        span = (box[1] - box[0] + 1) * (box[3] - box[2] + 1)
        fits = span[g] <= da.BF16_WINDOW
        rows, taps = torch.unique(g[fits] * (h_l * w_l) + cy[fits] * w_l + cx[fits],
                                  return_counts=True)
        past = taps - slots // span[torch.div(rows, h_l * w_l, rounding_mode="floor")]
        merged_rows += rows.numel() + int(past.clamp(min=0).sum())
        per_tap += int((~fits).sum())
    return (merged_rows + per_tap) * (D // 4), all_taps * (D // 4)


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


def tc_bound(M: int, N: int, K: int, reps: int):
    """Least time of one tc_kdepth launch on an H100: the larger of
    (2*M*N*K*reps flops) over the bf16 tensor-core peak and (A fp32, B bf16
    read once, out fp32 written once) over HBM bandwidth. Returns (ms,
    bound_by, flops)."""
    flops = 2.0 * M * N * K * reps
    nbytes = M * K * 4 + K * N * 2 + M * N * 4
    ms, by = _bound(nbytes, flops, BF16_TC_FLOP_PER_S)
    return ms, by, flops
