#!/usr/bin/env python3
"""Where the time of the training step goes on one CUDA card.

Runs the training step at the full-width R50 training geometry (the largest
bucket of ``configs/R50_ovis_360.yaml`` scaled to one card: 2 clips of 4
frames, 512x800 padded frames, 20 instance slots, 25 classes; hidden 256, 8
heads, 6+6 layers, 196 queries; fp32, TF32 off), or with ``--backbone swinl``
at the Swin-L one (``configs/swinl_ovis.yaml``'s largest bucket: 2 clips of 2
frames of 736x1024, Swin-L v2 with drop path 0.2), on a synthetic batch from
a seed, with random weights; with ``--amp`` the mixed-precision step
(SOLVER.AMP.ENABLED: bf16 forward and mask products, fp32 sums and masters,
the bf16 backward kernel ``msda_bwd_bf16``). Prints s/step and clips/s on the
host clock (steps ending in a synchronize), peak device memory, and from steps
run under ``torch.profiler``: the device-busy share (union of kernel intervals
over the wall time), the kernels by total device time and the share of the
deformable-attention backward kernel (``msda_bwd``) in the device time; then,
from one more step profiled with input shapes recorded (which costs host time,
so it is kept out of the busy share), the operators by their own device time.

Usage: python3 -m mdqe_cvpr2023_tpu_torch.tools.profile_train [--steps N]
           [--backbone r50|swinl] [--amp]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from .. import configs
from ..models.detr import MDQEModel
from ..parallel import train as ptrain
from ..parallel.train import CLIPS, synthetic_batch, to_device
from .profile_vis import _busy_and_kernels, device_events


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3, help="timed and profiled steps")
    parser.add_argument("--backbone", choices=("r50", "swinl"), default="r50",
                        help="the training geometry: R50 (TRAIN_CFG) or Swin-L")
    parser.add_argument("--amp", action="store_true",
                        help="the mixed-precision step (SOLVER.AMP.ENABLED)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, check=True).stdout.strip()
    if args.backbone == "swinl":
        cfg, crit = configs.SWINL_OVIS, ptrain.SWINL_TRAIN_CRIT
        batch = synthetic_batch(frames=ptrain.SWINL_FRAMES, hp=ptrain.SWINL_HP,
                                wp=ptrain.SWINL_WP)
    else:
        cfg, crit, batch = ptrain.TRAIN_CFG, ptrain.TRAIN_CRIT, synthetic_batch()
    model = MDQEModel(cfg, device="cuda", seed=0)
    opt = ptrain.make_optimizer(model, ptrain.TrainCfg(amp=args.amp))
    step = ptrain.make_train_step(crit, amp=args.amp)
    batch = to_device(batch, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(model, opt, batch, gen)  # warm-up (cuDNN algorithm choice, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step(model, opt, batch, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(model, opt, batch, gen)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy, top = _busy_and_kernels(prof, prof_wall)
    events = device_events(prof)

    def device_us(part=""):
        return sum(e.time_range.end - e.time_range.start for e in events if part in e.name)

    dev_us, bwd_us, fwd_us = device_us(), device_us("msda_bwd"), device_us("msda_fwd")
    with torch.profiler.profile(activities=acts, record_shapes=True) as shaped:
        step(model, opt, batch, gen)
        torch.cuda.synchronize()
    ops = sorted(shaped.key_averages(group_by_input_shape=True),
                 key=lambda a: -a.self_device_time_total)[:10]
    top_ops = [(a.key, str(a.input_shapes)[:120], round(a.self_device_time_total / 1e3, 3),
                a.count) for a in ops]
    print(json.dumps({
        "card": card, "backbone": cfg.backbone, "amp": args.amp, "steps": args.steps,
        "s_per_step": walls,
        "clips_per_s": [CLIPS / w for w in walls],
        "peak_memory_gib": peak / 2 ** 30, "profiled_wall_s": prof_wall,
        "device_busy_share": busy if busy is not None else "not measured",
        "device_ms_per_step": dev_us / 1e3 / args.steps if dev_us else "not measured",
        "msda_bwd_share_of_device_time": bwd_us / dev_us if dev_us else "not measured",
        "msda_fwd_share_of_device_time": fwd_us / dev_us if dev_us else "not measured",
        "top_kernels_ms_count": top, "top_ops_shapes_ms_count": top_ops}), flush=True)


if __name__ == "__main__":
    main()
