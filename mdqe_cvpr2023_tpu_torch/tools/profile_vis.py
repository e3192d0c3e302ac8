#!/usr/bin/env python3
"""Where the time of windowed VIS inference goes on one CUDA card.

Runs ``inference_vis`` at the full-width configuration of ``chip_smoke.py``
(R50, hidden 256, 6+6 layers, 196 queries, 4-frame clips, 30-frame windows,
360x640; or with ``--backbone swinl`` ``configs/swinl_ovis.yaml``'s: Swin-L
v2, 2-frame clips, 20-frame windows, 480x854; random weights from a seed) on
a 36-frame synthetic video, for the
reference gates and for the crowded tracker (gates off, the tracker fills to
120 instances). For each it prints the wall time and clips/s, the host
seconds per stage (each stage ending in a synchronize), and from one run under
``torch.profiler``: the device-busy share (union of kernel intervals over the
run's wall time), the device time, the forward deformable-attention kernel's
part of it, and the kernels by total device time (user annotations left out).
Last, where the window encode's device time goes: one encode chunk
(``encode_chunk`` frames, the arguments of the run's first ``encode_window``
call) profiled alone, by kernel.

Usage: python3 -m mdqe_cvpr2023_tpu_torch.tools.profile_vis [--runs N]
           [--backbone r50|swinl]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from .. import configs
from ..models import meta
from ..models.detr import MDQEModel, MDQEModelCfg

CFG = MDQEModelCfg(backbone="resnet50", num_classes=25, hidden_dim=256, n_heads=8,
                   enc_layers=6, dec_layers=6, n_frames=4, n_query=196,
                   query_embed_dim=64, dec_temporal=True)
INF = meta.InferenceCfg(clip_stride=1, n_frames_test=4, n_frames_window_test=30,
                        max_num_instances=120, apply_cls_thres=0.1, clip_topk=150,
                        encode_chunk=10, num_classes=25)
# the model, inference configuration and frame size of each --backbone
GEOMETRY = {"r50": (CFG, INF, (360, 640)),
            "swinl": (configs.SWINL_OVIS, configs.SWINL_OVIS_INF, (480, 854))}


def crowded(inf):
    """The gates off and threshold 0: the tracker fills to max_num_instances."""
    return dataclasses.replace(inf, apply_cls_thres=0.0, dedup_sim=2.0,
                               suppress_siou=2.0, suppress_ctt=2.0)


def device_events(prof):
    """The profiled run's device activity (kernels, copies, sets), without the
    user-annotation ranges (``record_function``, ``Optimizer.step``) that the
    profiler also puts on the device timeline."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]


def _busy_and_kernels(prof, wall_s):
    events = device_events(prof)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if not spans:
        return None, []
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    per_kernel = {}
    for e in events:
        k = per_kernel.setdefault(e.name, [0.0, 0])
        k[0] += e.time_range.end - e.time_range.start
        k[1] += 1
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    return busy / 1e6 / wall_s, [(n[:90], round(t / 1e3, 3), c) for n, (t, c) in top]


def _device_ms(events, part=""):
    return sum(e.time_range.end - e.time_range.start for e in events if part in e.name) / 1e3


def encode_breakdown(model, inf, frames, hw):
    """Device ms of one window-encode chunk, the forward kernel's part, and
    its kernels by device time: the arguments of the first ``encode_window``
    call of a run, replayed alone under the profiler after a warm-up."""
    captured = []
    encode = meta.encode_window

    def grab(*args, **kwargs):
        if not captured:
            captured.append((args, kwargs))
        return encode(*args, **kwargs)

    meta.encode_window = grab
    try:
        meta.inference_vis(model, inf, frames, hw, hw)
    finally:
        meta.encode_window = encode
    args, kwargs = captured[0]
    encode(*args, **kwargs)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        encode(*args, **kwargs)
        torch.cuda.synchronize()
    events = device_events(prof)
    _, top = _busy_and_kernels(prof, 1.0)
    return {"frames": int(args[1].shape[0]), "device_ms": _device_ms(events),
            "msda_fwd_ms": _device_ms(events, "msda_fwd"), "top_kernels_ms_count": top[:8]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=3, help="timed runs per variant")
    parser.add_argument("--backbone", choices=sorted(GEOMETRY), default="r50",
                        help="the model and video geometry")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cfg, inf0, (H, W) = GEOMETRY[args.backbone]
    model = MDQEModel(cfg, device="cuda", seed=0)
    n_frames = 36
    video = np.random.default_rng(0).integers(0, 255, (n_frames, H, W, 3)).astype(np.uint8)
    frames, _ = meta.preprocess_frames(video)
    n_clips = n_frames - inf0.n_frames_test + 1
    for name, inf in (("reference gates", inf0), ("crowded tracker", crowded(inf0))):
        meta.inference_vis(model, inf, frames, (H, W), (H, W))  # warm-up
        walls = []
        for _ in range(args.runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = meta.inference_vis(model, inf, frames, (H, W), (H, W))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        timers = {}
        meta.inference_vis(model, inf, frames, (H, W), (H, W), timers=timers)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            meta.inference_vis(model, inf, frames, (H, W), (H, W))
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        busy, top = _busy_and_kernels(prof, prof_wall)
        events = device_events(prof)
        dev_ms, fwd_ms = _device_ms(events), _device_ms(events, "msda_fwd")
        print(json.dumps({
            "variant": name, "backbone": cfg.backbone, "card": card,
            "tracks": out["num_tracks"],
            "wall_s": walls, "clips_per_s": [n_clips / w for w in walls],
            "stage_s": {k: v for k, v in timers.items() if not k.endswith("_n")},
            "profiled_wall_s": prof_wall,
            "device_busy_share": busy if busy is not None else "not measured",
            "device_ms": dev_ms if events else "not measured",
            "msda_fwd_ms": fwd_ms if events else "not measured",
            "msda_fwd_share_of_device_time": fwd_ms / dev_ms if dev_ms else "not measured",
            "top_kernels_ms_count": top}), flush=True)
    print(json.dumps({"card": card, "encode_chunk": encode_breakdown(model, inf0, frames,
                                                                     (H, W))}), flush=True)


if __name__ == "__main__":
    main()
