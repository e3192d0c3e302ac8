#!/usr/bin/env python3
"""Parameter counts, model structure and forward FLOPs of a configuration
(counterpart of the repository's ``tools/analyze_model.py``).

``parameter`` and ``structure`` count every tensor of ``MDQEModel``'s state
dict (parameters and buffers, as the JAX package's tree holds both), grouped
by the top-level module under ``detr.`` (backbone, input_proj,
transformer_enc, transformer_dec), the JAX tool's groups.

``flop`` runs one forward of ``detr_apply_backbone`` (encode and decode) on T
zero frames of H x W (T = INPUT.SAMPLING_FRAME_NUM) under
``torch.utils.flop_counter.FlopCounterMode``, which counts 2 x the
multiply-adds of convolutions and matrix products (elementwise work, norms
and softmaxes count nothing). The deformable-attention sampling is invisible
to it: the CUDA kernel is opaque, and its plain version is gathers and
elementwise products. So it is added analytically from every
``MSDeformAttn`` call's shapes: each sampling point costs 8 x D FLOPs (four
bilinear corners, one multiply-add a channel each, the attention weight
folded into the corner weights), over B x Q x heads x levels x points
points a call (a temporal call once a pyramid level).

Usage:
  python3 -m mdqe_cvpr2023_tpu_torch.tools.analyze_model --config-file configs/R50_ovis_360.yaml
      [--tasks parameter flop structure] [--size 384 640] [--device cuda|cpu]
      [KEY VALUE ...]
"""
from __future__ import annotations

import argparse
import contextlib
from typing import Dict, List, Tuple

import torch

from ..engine.build import build_model_cfg
from ..engine.config import load_config
from ..models.attention import MSDeformAttn
from ..models.detr import MDQEModel, detr_apply_backbone


def count_params(model: torch.nn.Module) -> Tuple[int, List[Tuple[str, tuple, int]]]:
    """(total, [(name, shape, count)]) over the state dict."""
    rows = [(name, tuple(t.shape), t.numel()) for name, t in model.state_dict().items()]
    return sum(r[2] for r in rows), rows


def group_counts(rows) -> Dict[str, int]:
    """Counts by top-level module under ``detr.``."""
    out: Dict[str, int] = {}
    for name, _, n in rows:
        parts = name.split(".")
        key = parts[1] if parts[0] == "detr" and len(parts) > 1 else parts[0]
        out[key] = out.get(key, 0) + n
    return out


@contextlib.contextmanager
def sampling_flops(model: torch.nn.Module):
    """While active, ``counted["flops"]`` sums the deformable-attention
    sampling FLOPs of every ``MSDeformAttn`` forward (module docstring)."""
    counted = {"flops": 0, "calls": 0}

    def hook(module, args, _out):
        query, spatial_shapes = args[0], args[3]
        cfg = module.cfg
        B, Q = query.shape[:2]
        D = cfg.d_model // cfg.n_heads
        calls = 1 if cfg.mode == "spatial" else len(spatial_shapes)
        counted["flops"] += 8 * D * B * Q * cfg.n_heads * cfg.lvl * cfg.n_points * calls
        counted["calls"] += calls

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, MSDeformAttn)]
    try:
        yield counted
    finally:
        for h in handles:
            h.remove()


@torch.no_grad()
def forward_flops(model: MDQEModel, n_frames: int, h: int, w: int) -> Dict[str, int]:
    """FLOPs of one ``detr_apply_backbone`` forward of n_frames x h x w:
    {"counted": FlopCounterMode's, "sampling": the analytic deformable-
    attention sampling, "total": their sum, "msda_calls": op calls}."""
    from torch.utils.flop_counter import FlopCounterMode
    dev = model.device
    images = torch.zeros((n_frames, h, w, 3), dtype=torch.float32, device=dev)
    sizes = torch.tensor([[h, w]] * n_frames, dtype=torch.int32, device=dev)
    counter = FlopCounterMode(display=False)
    with counter, sampling_flops(model) as sampled:
        detr_apply_backbone(model.detr, images, sizes, n_frames=n_frames)
    counted = counter.get_total_flops()
    return {"counted": counted, "sampling": sampled["flops"],
            "total": counted + sampled["flops"], "msda_calls": sampled["calls"]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--tasks", nargs="+", default=["parameter", "flop"],
                   choices=["parameter", "flop", "structure"])
    p.add_argument("--size", nargs=2, type=int, default=[384, 640])
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain PyTorch path)")
    p.add_argument("opts", nargs=argparse.REMAINDER, help="config overrides: KEY VALUE pairs")
    args = p.parse_args(argv)

    cfg = load_config(args.config_file, args.opts or None)
    mcfg = build_model_cfg(cfg)
    model = MDQEModel(mcfg, device=args.device, seed=0)
    result = {}
    if "parameter" in args.tasks or "structure" in args.tasks:
        total, rows = count_params(model)
        if "structure" in args.tasks:
            for name, shape, n in rows:
                print(f"{name:80s} {str(shape):24s} {n:>12,}")
        groups = group_counts(rows)
        for k, v in sorted(groups.items(), key=lambda x: -x[1]):
            print(f"{k:20s} {v / 1e6:8.2f}M")
        print(f"total parameters: {total / 1e6:.2f}M ({total})")
        result.update(total=total, groups=groups)
    if "flop" in args.tasks:
        T = mcfg.n_frames
        H, W = args.size
        f = forward_flops(model, T, H, W)
        print(f"forward FLOPs @ {T}x{H}x{W}: {f['total'] / 1e9:.1f} GFLOP "
              f"({f['total'] / T / 1e9:.1f} GFLOP/frame); counted "
              f"{f['counted'] / 1e9:.1f}, deformable-attention sampling "
              f"{f['sampling'] / 1e9:.2f} in {f['msda_calls']} op calls")
        result["flops"] = f
    return result


if __name__ == "__main__":
    main()
