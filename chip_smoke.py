#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

Phases (each exits non-zero on failure; none is caught and continued):
  1. device: the card's name and power limit;
  2. build: compile the CUDA kernels from the checkout with nvcc (sm_90a), one
     nvcc per source started together (ms_deform_attn.cu, tc_kdepth.cu),
     print ptxas's register / shared-memory / spill report, and check that
     tc_kdepth's SASS holds wgmma (HGMMA) and no mma.sync (HMMA) and that the
     backward kernels' global atomics are 16-byte vector reductions
     (REDG ... F32x4) and nothing else, with no bf16 atomic and no
     compare-and-swap loop in msda_bwd_bf16;
  3. the forward kernel against its plain PyTorch version at every call shape
     of the inference path (encoder, decoder box level, decoder temporal) and
     at odd shapes; the backward kernel against autograd of the plain version,
     and the forward kernel against the plain forward, at every call shape of
     the training step; the backward also at odd shapes (D=16, D=48,
     non-square levels, locations far outside); every block size of the
     forward kernel (both value types) at the tuning tool's four level
     problems and the COCO encoder's shape; the gather probe against the
     tool's oracle at every problem it times; tc_kdepth against its plain
     version at every (K, N) of the depth sweep;
  4. kernel timing (CUDA events, and CUDA-graph replay),
     forward (inference, training and COCO shapes) and backward (training
     shapes), beside the plain version, the grid_sample composition (a
     yardstick the port never calls) and the least time the card could take
     for the same work;
  5. windowed VIS inference (inference_vis) at full width (R50, hidden 256,
     6+6 layers, 196 queries, 4-frame clips, 30-frame windows, 360x640) on a
     36-frame synthetic video with random weights from a seed: launch counts
     per call site, output checks, and on a small input the card's output
     against the port's CPU path (plain versions); then COCO image inference
     (inference_image) at full width (R50 COCO, 800x1216, fp32): s/image,
     peak memory, launches per call site, output checks, and a small image
     against the CPU path under both multi_cls_on branches; then the COCO
     post-processing at 196 queries x 80 classes on object-like decoder
     outputs (distinct masks, boxes overlapping in part) against the CPU
     path, both branches;
  6. the training step at full width (2 clips x 4 frames of 512x800, 20
     instance slots, 25 classes, fp32) on a synthetic batch: s/step, peak
     memory, forward and backward launches per call site, finite losses,
     frozen parameters and buffers unchanged, a lower loss after a few steps;
     then a tiny training step on the card against the port's CPU path (loss
     dict, gradients, parameters after one step); then the train/test entry
     point (python -m mdqe_cvpr2023_tpu_torch.train_net) at full width on a
     synthetic OVIS-layout dataset of 360x640 frames: 5 iterations with 2
     loader threads, a checkpoint, a second process resumed from it for 2
     more, each ending in test with the YTVIS AP; s/iter, data_wait_frac,
     peak memory, launches per call site, exact resume (iteration, LR
     schedule, AdamW steps), test clips/s and the host seconds of RLE encoding
     and evaluation; then the tiny Trainer on the card against the port's CPU
     path (loader batches, losses, test predictions, AP) and the native RLE
     codec against the Python one;
  6a. mixed precision (SOLVER.AMP.ENABLED): the bf16 kernels at the R50
     training call shapes (msda_fwd_bf16 against its plain version,
     msda_bwd_bf16 against autograd of the plain version on f64 copies of the
     same bf16 inputs, and no worse than the plain version in bf16; also at
     odd shapes, Q == N levels cut by its query tiles and a crowded input
     whose rows sum tens of thousands of taps), timed
     beside msda_bwd_f32, the plain version, the grid_sample form and the
     bound; the AMP training step at full width (s/step, peak memory, 6 / 6 /
     24 launches a step of the forward and msda_bwd_bf16 and none of
     msda_bwd_f32, finite and falling loss, fp32 masters, frozen leaves, the
     first step's losses against the fp32 step's); a tiny AMP step on the
     card against the CPU path; train_net with SOLVER.AMP.ENABLED True (3
     iterations, a checkpoint, test; a second process resumed for 1 more);
  6c. Swin-L (configs/swinl_*.yaml, random weights, drop path 0.2 in
     training) through the same three paths at full width, the kernels'
     call shapes recorded on the way: inference_vis at the swinl_ovis
     geometry (2-frame clips, 20-frame windows) on a 36-frame 480x854 video
     (35 clips; the crowded tracker too), a small Swin video against the CPU
     path; inference_image at 800x1216; the training step at 2 clips x 2
     frames of 736x1024 (s/step, peak memory, launches, finite and falling
     loss, frozen leaves unchanged) and the same step in AMP (the bf16
     kernels' call shapes recorded), a tiny Swin step against the CPU path;
     train_net with configs/swinl_ovis.yaml for 2 iterations ending in
     test; then the forward kernel at every recorded call shape against its
     plain version and the backward kernel against autograd of the plain
     version at the training shapes, each timed (eager, graph replay) beside
     the plain version, the grid_sample form and the bound, and the bf16
     kernels at the AMP step's shapes as in 6a;
  6d. data parallelism (``tools/ddp_step.py``, ranks as subprocesses under
     torch.distributed.run, each with a timeout): the R50 step at full width
     (2 clips of 4 x 512x800, one a rank) on two ranks sharing the one card
     over gloo, fp32 and AMP, against the one-process step (first-step
     losses, the parameters after it, the ranks bit-equal after 3 steps,
     6 / 6 / 24 launches a step in each rank, gradient bytes and all-reduce
     seconds); the same step in a one-rank NCCL group; NCCL across
     min(4, count) cards where there are several; NCCL asked for with two
     ranks on one card, which must raise the port's error; train_net over 2
     ranks (3 iterations, one checkpoint, the test split and gathered, rank
     0 alone writing) against a one-process --eval-only of its checkpoint;
     inference_vis with the window encode sharded by frames over two devices
     against the unsharded run; the kernels at one rank's call shapes and at
     the sharded encoder's, against their plain versions and timed;
  6e. the demos, the host tracker and the model tools, random weights from
     seed 0 with the class threshold at 0: ``python -m
     mdqe_cvpr2023_tpu_torch.demo.demo`` on R50_ovis_360.yaml with two
     36-frame 360x640 videos (PNG frames; two mp4 files of 36 frames, the
     tracks equal to inference_vis here on the same resized frames, 24 / 30 /
     120 launches a video, videos/s and the render share AsyncPredictor
     hides); ``demo.clip_demo`` on R50_coco.yaml with three 480x640 images,
     with --no-aug and with the seeded augmentation (a _vis.jpg each, the
     detections equal to inference_image here on the same pseudo-clip, 6 / 6
     / 24 launches an image, s/image); the host OverTracker with its memory
     on the card against the device tracker and the CPU OverTracker on a
     seeded stream at the VIS shapes (M 120, K 32, 90x160 masks: the same
     matched IDs every clip, class averages within 1e-5, equal packed
     masks; host ms a clip); analyze_model (R50, Swin-L) on the card,
     eval_parity run / diff against Trainer.test (exit 0), convert_weights
     inflate loaded back; the forward kernel at the demos' call shapes;
  7. the kernel tools' sweeps (block sizes, gather probe, tensor-core depth),
     each problem with the launch counts set to 0 before it and read after
     it;
  8. the kernel list as one JSON line; the card line; the result line.

Usage: python3 chip_smoke.py   (needs one CUDA card; runs from the checkout)
       python3 chip_smoke.py --kernel-times   (only the kernels' times at every
       forward site, the backward's training sites and every tc_kdepth shape,
       one JSON line each; see kernel_times)
       python3 chip_smoke.py --bwd-split [SOURCE]   (the backward kernels' time
       split into their d(value) scatter and the rest, msda_bwd_bf16's
       reductions counted; see bwd_split)
"""
import collections
import contextlib
import dataclasses
import functools
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

try:
    import torch
    from mdqe_cvpr2023_tpu_torch.tools import measure
except ModuleNotFoundError as exc:
    print(f"chip_smoke: FAIL: {exc}: run this script from a checkout of the repository, "
          "with PyTorch installed", file=sys.stderr, flush=True)
    sys.exit(1)

ENC_SHAPES = ((48, 80), (24, 40), (12, 20), (6, 10))  # 384x640 padded frames
TRAIN_SHAPES = ((64, 100), (32, 50), (16, 25), (8, 13))  # 512x800 padded frames
COCO_SHAPES = ((100, 152), (50, 76), (25, 38), (13, 19))  # 800x1216 padded image
COCO_N = sum(h * w for h, w in COCO_SHAPES)               # 20197 encoder tokens
SWIN_TRAIN_SHAPES = ((92, 128), (46, 64), (23, 32), (12, 16))  # 736x1024 padded frames
PALLAS = "mdqe_cvpr2023_tpu/ops/deform_attn_pallas.py"
SOURCE = "mdqe_cvpr2023_tpu_torch/ops/csrc/ms_deform_attn.cu"
TC_SOURCE = "mdqe_cvpr2023_tpu_torch/ops/csrc/tc_kdepth.cu"
# the forward kernel's timed VIS call sites: B, Q, H, D, P, shapes, loc mode,
# value type, line of the TPU kernel replaced (_deform_attn_banded for the
# encoder, _deform_attn_fused otherwise)
VIS_SITES = {
    "encoder": (10, 5100, 8, 32, 4, ENC_SHAPES, "local", torch.bfloat16, 569),
    "decoder_box": (32, 196, 8, 32, 4, ENC_SHAPES, "uniform", torch.float32, 121),
    "decoder_inst": (8, 196, 8, 32, 4, ((48, 80),) * 4, "uniform", torch.float32, 121),
}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def phase(msg):
    print(f"== {msg} [{time.perf_counter() - T_START:.1f} s]", flush=True)


def make_inputs(torch, B, Q, H, D, P, shapes, loc_mode, vdtype, seed):
    """value (B,N,H,D), locations (B,Q,H,L,P,2), weights on the card."""
    rng = np.random.default_rng(seed)
    N = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.standard_normal((B, N, H, D), dtype=np.float32)
    if loc_mode == "local":  # encoder-like: each query's pixel centre + offsets
        refs = []
        for h, w in shapes:
            yy, xx = np.mgrid[0:h, 0:w]
            refs.append(np.stack([(xx.ravel() + 0.5) / w, (yy.ravel() + 0.5) / h], -1))
        ref = np.concatenate(refs)[:Q].astype(np.float32)
        loc = ref[None, :, None, None, None, :] + rng.uniform(
            -0.05, 0.05, (B, Q, H, L, P, 2)).astype(np.float32)
    elif loc_mode == "far":  # well outside the levels too
        loc = rng.uniform(-1.5, 2.5, (B, Q, H, L, P, 2)).astype(np.float32)
    else:
        loc = rng.uniform(-0.1, 1.1, (B, Q, H, L, P, 2)).astype(np.float32)
    attw = rng.random((B, Q, H, L * P), dtype=np.float32)
    attw /= attw.sum(-1, keepdims=True)
    dev = torch.device("cuda")
    v = torch.from_numpy(value).to(dev).to(vdtype)
    return (v, torch.from_numpy(loc).to(dev),
            torch.from_numpy(attw.reshape(B, Q, H, L, P)).to(dev))


def grads_of(torch, fn, value, loc, attw, gout, retain=False):
    """Leaves (value, loc, attw) with gradients, fn's output on them, and the
    gradients of <output, gout>."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (value, loc, attw)]
    out = fn(*leaves)
    return leaves, out, torch.autograd.grad(out, leaves, gout, retain_graph=retain)


# backward checks: site, B, Q, H, D, P, shapes, loc mode (the training step's
# call shapes, then odd ones). Tolerance per output: 1e-4 of its largest
# entry (at least 1e-4): warp sums in another order than autograd's, and
# d(value) summed with fp32 atomics in an order that changes between runs.
BWD_CHECKS = [
    ("encoder", 8, 8504, 8, 32, 4, TRAIN_SHAPES, "local"),
    ("decoder_box", 8, 196, 8, 32, 4, TRAIN_SHAPES, "uniform"),
    ("decoder_inst", 2, 196, 8, 32, 4, ((64, 100),) * 4, "uniform"),
    ("odd", 3, 70, 3, 16, 3, ((10, 6), (7, 13), (3, 5)), "far"),
    ("odd", 2, 45, 2, 48, 2, ((9, 4), (2, 11)), "uniform"),
]
BWD_REPLACES = f"{PALLAS}:225,278,768,789"  # _bwd_sample/_bwd_value, banded pair
# msda_bwd_bf16 replaces the pair the AMP step reaches on the TPU (the
# training encoder passes allow_banded=False): _bwd_sample / _bwd_value
BWD_BF16_REPLACES = f"{PALLAS}:225,278"


# msda_bwd_bf16's timed call shapes (``--kernel-times``, ``--bwd-split``):
# the AMP step's sites, R50 and Swin-L, and one DDP rank's (one clip): path,
# site, B, Q, level shapes; H 8, D 32, P 4 as in BWD_CHECKS
BWD_BF16_SITES = [
    ("train_amp", "encoder", 8, 8504, TRAIN_SHAPES),
    ("train_amp", "decoder_box", 8, 196, TRAIN_SHAPES),
    ("train_amp", "decoder_inst", 2, 196, ((64, 100),) * 4),
    ("swinl_train_amp", "encoder", 4, 15648, SWIN_TRAIN_SHAPES),
    ("swinl_train_amp", "decoder_box", 4, 196, SWIN_TRAIN_SHAPES),
    *(("swinl_train_amp", "decoder_inst", 2, 196, ((h, w),) * 2) for h, w in SWIN_TRAIN_SHAPES),
    ("ddp_amp", "encoder", 4, 8504, TRAIN_SHAPES),
    ("ddp_amp", "decoder_box", 4, 196, TRAIN_SHAPES),
    ("ddp_amp", "decoder_inst", 1, 196, ((64, 100),) * 4),
]


def bf16_site_inputs(k, site, B, Q, shapes):
    """bf16 value, locations (encoder-like at the encoder, uniform at the
    decoder sites), weights and fp32 output gradient of row k of
    BWD_BF16_SITES."""
    v, lo, aw, gout = bwd_inputs(torch, B, Q, 8, 32, 4, shapes,
                                 "local" if site == "encoder" else "uniform", seed=800 + k)
    return v.bfloat16(), lo, aw, gout


def bwd_inputs(torch, B, Q, H, D, P, shapes, mode, seed):
    v, lo, aw = make_inputs(torch, B, Q, H, D, P, shapes, mode, torch.float32, seed)
    gout = np.random.default_rng(seed + 1000).standard_normal((B, Q, H * D), dtype=np.float32)
    return v, lo, aw, torch.from_numpy(gout).to(v.device)


def check_backward(torch, da):
    """The backward kernel against autograd of the plain version at every row
    of BWD_CHECKS and, at the training step's rows, the forward kernel against
    the plain output on the same inputs (tolerance 1e-4, as at the inference
    shapes). Returns max |err| per site: backward, training-shape forward."""
    max_err, fwd_err = {}, {}
    for k, (site, B, Q, H, D, P, shapes, mode) in enumerate(BWD_CHECKS):
        v, lo, aw, gout = bwd_inputs(torch, B, Q, H, D, P, shapes, mode, seed=200 + k)
        got = da.ms_deform_attn_bwd_cuda(v, shapes, lo, aw, gout)
        _, plain_out, want = grads_of(
            torch, lambda a, b, c: da.ms_deform_attn_plain(a, shapes, b, c), v, lo, aw, gout)
        fwd = ""
        if site != "odd":
            out = da.ms_deform_attn_cuda(v, shapes, lo, aw)
            err = float((out - plain_out).abs().max())
            fwd_err[site] = max(fwd_err.get(site, 0.0), err)
            if not (err <= 1e-4 and bool(torch.isfinite(out).all())):
                fail(f"forward kernel disagrees with its plain version at the training "
                     f"shape of {site}: max|err| {err:.3e}")
            fwd = f"fwd {err:.2e} (tol 1e-4), "
            del out
        torch.cuda.synchronize()
        errs, ok = [], True
        for name, g, w in zip(("value", "loc", "attw"), got, want):
            err = float((g - w).abs().max())
            tol = 1e-4 * max(1.0, float(w.abs().max()))
            errs.append(f"d{name} {err:.2e} (tol {tol:.1e})")
            ok = ok and err <= tol and bool(torch.isfinite(g).all())
            max_err[site] = max(max_err.get(site, 0.0), err)
        print(f"bwd {site:12s} B={B} Q={Q} H={H} D={D} P={P} L={len(shapes)} {mode:7s} "
              f"max|err| {fwd}{', '.join(errs)} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"backward kernel disagrees with autograd of the plain version at {site}")
        del got, want, plain_out, v, lo, aw, gout
    return max_err, fwd_err


def time_backward(torch, da):
    """At the training step's call shapes: ms per backward launch (CUDA
    events around eager calls, the wrapper's zeroed d(value) and allocations
    included, and a CUDA-graph replay) beside the plain version's backward,
    the grid_sample form's backward and the bound; and ms per forward launch
    beside the plain forward, the grid_sample form and the forward's bound."""
    timings, fwd_timings = {}, {}
    for k, (site, B, Q, H, D, P, shapes, mode) in enumerate(BWD_CHECKS[:3]):
        v, lo, aw, gout = bwd_inputs(torch, B, Q, H, D, P, shapes, mode, seed=300 + k)
        ms = measure.time_ms(lambda: da.ms_deform_attn_bwd_cuda(v, shapes, lo, aw, gout), 20)
        dev_ms = measure.graph_ms(lambda: da.ms_deform_attn_bwd_cuda(v, shapes, lo, aw, gout),
                                  20)
        leaves, out, _ = grads_of(
            torch, lambda a, b, c: da.ms_deform_attn_plain(a, shapes, b, c),
            v, lo, aw, gout, retain=True)
        plain_ms = measure.time_ms(lambda: torch.autograd.grad(out, leaves, gout,
                                                               retain_graph=True), 3)
        del out
        leaves, out, _ = grads_of(
            torch, lambda a, b, c: measure.grid_sample_msda(a, shapes, b, c),
            v, lo, aw, gout, retain=True)
        lib_ms = measure.time_ms(lambda: torch.autograd.grad(out, leaves, gout,
                                                             retain_graph=True), 3)
        del out, leaves
        bound_ms, bound_by, nbytes, atomics = measure.msda_bwd_bound(v, shapes, lo, aw)
        timings[site] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        print(f"bwd {site:12s} B={B} Q={Q} kernel {ms:.4f} ms (graph replay {dev_ms:.4f} ms) "
              f"| plain backward {plain_ms:.3f} ms | grid_sample form backward {lib_ms:.3f} ms "
              f"| bound {bound_ms * 1e3:.1f} us by {bound_by} ({nbytes / 1e6:.1f} MB) | "
              f"{atomics / 1e6:.2f} M 16-byte vector atomics | {bound_ms / dev_ms:.1%} of "
              f"bound (graph)", flush=True)
        f_ms = measure.time_ms(lambda: da.ms_deform_attn_cuda(v, shapes, lo, aw), 20)
        f_dev = measure.graph_ms(lambda: da.ms_deform_attn_cuda(v, shapes, lo, aw), 20)
        f_plain = measure.time_ms(lambda: da.ms_deform_attn_plain(v, shapes, lo, aw), 3)
        f_lib = measure.time_ms(lambda: measure.grid_sample_msda(v, shapes, lo, aw), 3)
        f_bound, f_by, f_bytes = measure.msda_bound(v, shapes, lo, aw)
        fwd_timings[site] = dict(ms=f_ms, plain_ms=f_plain, library_ms=f_lib,
                                 bound_ms=f_bound, bound_by=f_by)
        print(f"fwd {site:12s} B={B} Q={Q} float32  kernel {f_ms:.4f} ms (graph replay "
              f"{f_dev:.4f} ms) | plain "
              f"{f_plain:.3f} ms | grid_sample form {f_lib:.3f} ms | bound "
              f"{f_bound * 1e3:.1f} us by {f_by} ({f_bytes / 1e6:.1f} MB) | "
              f"{f_bound / f_ms:.1%} of bound", flush=True)
        del v, lo, aw, gout
    return timings, fwd_timings


def expected_train_launches(cfg):
    """Launches per training step and call site, forward and backward alike."""
    return {"encoder": cfg.enc_layers, "decoder_box": cfg.dec_layers,
            "decoder_inst": cfg.dec_layers * cfg.n_feature_levels}


def train_full_width(torch, da, card, bwd_timings=None, swin=False, amp=False,
                     fp32_losses=None):
    """The training step at full width, R50 (``TRAIN_CFG``: 2 clips x 4
    frames of 512x800) or Swin-L (``configs.SWINL_OVIS``: 2 clips x 2 frames of
    736x1024, drop path 0.2), fp32 or with ``amp`` mixed precision: s/step,
    peak memory, launches, finite losses, a lower loss after a few steps,
    frozen leaves unchanged, fp32 parameters and gradients. The backward
    launches are those of msda_bwd_f32 (fp32) or msda_bwd_bf16 (amp), and the
    other kernel must not run. ``fp32_losses``: the fp32 run's first-step
    losses (the same weights, batch and dropout masks: the masks are drawn in
    fp32 either way), which the AMP run's first step is held to: the total
    within 5% and the weighted losses as a vector within 10% of its norm
    (bf16 rounds the forward, and can flip argmax decisions such as the query
    selection). Returns the forward and backward launch counts of its timed
    steps and the first step's losses."""
    from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel
    from mdqe_cvpr2023_tpu_torch.parallel import train as ptrain
    if swin:
        from mdqe_cvpr2023_tpu_torch import configs
        cfg, crit = configs.SWINL_OVIS, ptrain.SWINL_TRAIN_CRIT
        batch = ptrain.synthetic_batch(seed=0, frames=ptrain.SWINL_FRAMES,
                                       hp=ptrain.SWINL_HP, wp=ptrain.SWINL_WP)
    else:
        cfg, crit, batch = ptrain.TRAIN_CFG, ptrain.TRAIN_CRIT, ptrain.synthetic_batch(seed=0)
    t0 = time.perf_counter()
    model = MDQEModel(cfg, device="cuda", seed=0)
    # the JAX package's loss-decrease settings (tests/test_train_step.py)
    opt = ptrain.make_optimizer(model, ptrain.TrainCfg(base_lr=1e-3, steps=(1000,),
                                                       clip_norm=1.0, amp=amp))
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    frozen = {k: v.clone() for k, v in model.state_dict().items() if k not in trainable}
    step = ptrain.make_train_step(crit, amp=amp)
    kind = "AMP (mixed precision)" if amp else "fp32"
    batch = ptrain.to_device(batch, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"model {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters "
          f"({len(trainable)} trainable tensors, {len(frozen)} frozen or buffers); "
          f"batch {tuple(batch['images'].shape)} uint8, "
          f"{int(batch['valid'].sum())} instances; set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    totals = []
    t0 = time.perf_counter()
    total, ldict = step(model, opt, batch, gen)
    totals.append(total)
    first = {k: float(v) for k, v in ldict.items()}
    torch.cuda.synchronize()
    print(f"{kind} warm-up step {time.perf_counter() - t0:.2f} s", flush=True)

    n_steps = 3
    torch.cuda.reset_peak_memory_stats()
    da.reset_launches()
    walls = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        total, ldict = step(model, opt, batch, gen)
        totals.append(total)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    fwd = dict(da.LAUNCHES)
    bwd, other = ((dict(da.BWD_BF16_LAUNCHES), dict(da.BWD_LAUNCHES)) if amp
                  else (dict(da.BWD_LAUNCHES), dict(da.BWD_BF16_LAUNCHES)))
    peak = torch.cuda.max_memory_allocated()
    s_step = sum(walls) / n_steps
    totals = [float(t) for t in totals]
    print(f"{kind} training step: {', '.join(f'{w:.4f}' for w in walls)} s -> "
          f"{s_step:.4f} s/step, {ptrain.CLIPS / s_step:.3f} clips/s ({card})")
    print(f"peak device memory {peak / 2 ** 30:.2f} GiB")
    print(f"launches in {n_steps} steps: forward {json.dumps(fwd)}, backward "
          f"msda_bwd_{'bf16' if amp else 'f32'} {json.dumps(bwd)}, msda_bwd_"
          f"{'f32' if amp else 'bf16'} {json.dumps(other)}")
    print(f"total loss per step {[round(t, 4) for t in totals]}")
    print(f"losses {json.dumps({k: round(float(v), 4) for k, v in ldict.items()})}")
    if bwd_timings is not None:
        share = sum(bwd_timings[s]["ms"] * n for s, n in bwd.items()) / n_steps / (s_step * 1e3)
        print(f"backward kernel at its timed per-launch cost: {share:.1%} of the step",
              flush=True)

    want = {k: n_steps * v for k, v in expected_train_launches(cfg).items()}
    if fwd != want or bwd != want or any(other.values()):
        fail(f"training launches {fwd} / {bwd} / {other}, want {want}, {want}, none")
    if fp32_losses is not None:
        keys = sorted(fp32_losses)
        a = np.array([first[k] for k in keys])
        b = np.array([fp32_losses[k] for k in keys])
        rel_total = abs(a.sum() - b.sum()) / abs(b.sum())
        rel_vec = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        print(f"first step, AMP against fp32 (same weights, batch, masks): total "
              f"{a.sum():.4f} vs {b.sum():.4f} (rel {rel_total:.2e}, tol 5e-2); loss vector "
              f"rel distance {rel_vec:.2e} (tol 1e-1); "
              f"{json.dumps({k: [round(first[k], 4), round(fp32_losses[k], 4)] for k in keys})}",
              flush=True)
        if rel_total > 5e-2 or rel_vec > 1e-1:
            fail("the AMP step's first losses are far from the fp32 step's")
    if not all(p.dtype == torch.float32 for p in model.parameters()) or not all(
            p.grad is None or p.grad.dtype == torch.float32 for p in model.parameters()):
        fail("parameters or gradients are not fp32 masters")
    if not all(np.isfinite(totals)) or not all(
            bool(torch.isfinite(v)) for v in ldict.values()):
        fail("non-finite training loss")
    if not totals[-1] < totals[0]:
        fail(f"the total loss did not fall on a fixed batch: {totals}")
    state = model.state_dict()
    changed = [k for k, v in frozen.items() if not torch.equal(state[k], v)]
    if changed:
        fail(f"frozen parameters or buffers changed: {changed[:5]}")
    del model, opt, batch, frozen, state
    torch.cuda.empty_cache()
    return fwd, bwd, first


def tiny_train_card_vs_cpu(torch, tiny=None, amp=False):
    """One training step of the tiny configuration (R50 unless ``tiny`` is
    given; drop path 0 in a Swin one) on the card and on the
    port's CPU path, dropout 0, the same reid priorities. Tolerances (those of
    tests/test_torch_train_step.py against JAX): losses rtol 1e-4; the global
    gradient norm rtol 1e-4; per trainable leaf max |err| <= 0.1 s + 1e-6 G
    and cosine >= 0.9999 where s > 1e-4 G (s the leaf's largest CPU gradient,
    G the model's); after the step, frozen parameters and buffers equal, the
    trainable entries 99% within 0.01 lr, 99.9% within 0.05 lr, all within lr
    (Adam's first step is about lr * sign(g)).

    With ``amp`` the mixed-precision step on both, held as
    tests/test_torch_amp.py holds the port's AMP to JAX's (cuDNN and the CPU
    round their bf16 outputs on their own, and a rounding can flip an argmax):
    the total within 1e-2 relative and the loss vector within 5e-2 of its
    norm; the angle between the card's AMP gradients and the fp32 ones (the
    CPU's fp32 step; the card's fp32 step equals it, above) at most twice
    the CPU's AMP gradients' angle to them, and at least a quarter of it:
    each device's bf16 rounds on its own (the CPU's plain backward also sums
    d(value) in bf16, the card's kernel in fp32), so the two AMP steps differ
    by about both roundings, a wrong card path would lie far outside, and a
    card step that ran in fp32 would lie at an angle of about 0 (measured on
    the H100: 0.2199 against 0.3184 rad; the card-vs-CPU AMP cosine, 0.940,
    is printed and not held: it reads both roundings at once); after the
    step, frozen leaves equal and the trainable entries 90% within 0.05 lr,
    all within 2.1 lr."""
    from mdqe_cvpr2023_tpu_torch.engine.weights import grad_state_dict
    from mdqe_cvpr2023_tpu_torch.losses.criterion import CriterionCfg
    from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel, MDQEModelCfg
    from mdqe_cvpr2023_tpu_torch.parallel import train as ptrain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tiny = tiny or MDQEModelCfg(backbone="resnet50", num_classes=5, hidden_dim=64, n_heads=4,
                                enc_layers=1, dec_layers=1, n_frames=2, n_query=16,
                                query_embed_dim=8, dec_temporal=True)
    crit = CriterionCfg(num_classes=5, n_frames=2, n_query=16, num_points=64)
    tc = ptrain.TrainCfg()
    batch = ptrain.synthetic_batch(seed=1, clips=2, frames=2, hp=128, wp=128, slots=3,
                               n_inst=2, num_classes=5)
    pri = torch.rand((2, 3, 2, 2 * 16), generator=torch.Generator().manual_seed(2))
    res = {}
    # with amp, the CPU's fp32 step too: how far bf16 rounding alone moves the
    # gradients on one device
    runs = [("cuda", "cuda", amp), ("cpu", "cpu", amp)] + ([("cpu32", "cpu", False)] if amp
                                                          else [])
    for key, dev, run_amp in runs:
        model = MDQEModel(tiny, device=dev, seed=3)
        opt = ptrain.make_optimizer(model, tc)
        opt.zero_grad()
        total, ldict = ptrain.loss_fn(model, crit, ptrain.to_device(batch, dev), None,
                                      dropout_rate=0.0, reid_priorities=pri.to(dev),
                                      amp=run_amp)
        total.backward()
        grads = grad_state_dict(model)
        trainable = {n for n, p in model.named_parameters() if p.requires_grad}
        opt.step()
        res[key] = (total.item(), {k: v.item() for k, v in ldict.items()}, grads,
                    {k: v.cpu().double().numpy() for k, v in model.state_dict().items()},
                    trainable)
    (tg, lg, gg, pg, trainable), (tc_, lc, gc, pc, _) = res["cuda"], res["cpu"]
    loss_err = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc)
    loss_err = max(loss_err, abs(tg - tc_) / abs(tc_))
    norm_g = np.sqrt(sum(float((gg[k].astype(np.float64) ** 2).sum()) for k in trainable))
    norm_c = np.sqrt(sum(float((gc[k].astype(np.float64) ** 2).sum()) for k in trainable))
    G = max(np.abs(gc[k]).max() for k in trainable)
    worst_rel, worst_cos, bad = 0.0, 1.0, []
    for k in trainable:
        g, c = gg[k].astype(np.float64), gc[k].astype(np.float64)
        s_ = np.abs(c).max()
        err = np.abs(g - c).max()
        worst_rel = max(worst_rel, err / max(s_, 1e-30) if s_ > 1e-4 * G else 0.0)
        if err > 0.1 * s_ + 1e-6 * G:
            bad.append(f"{k} err {err:.2e} s {s_:.2e}")
        if s_ > 1e-4 * G:
            cos = (g * c).sum() / (np.linalg.norm(g) * np.linalg.norm(c))
            worst_cos = min(worst_cos, cos)
    lr = tc.base_lr
    diffs = np.concatenate([np.abs(pg[k] - pc[k]).ravel() for k in trainable]) / lr
    frozen_diff = max(float(np.abs(pg[k] - pc[k]).max()) for k in pc if k not in trainable)
    q99, q999 = np.quantile(diffs, [0.99, 0.999])
    if amp:
        keys = sorted(lc)
        a, b = np.array([lg[k] for k in keys]), np.array([lc[k] for k in keys])
        vec = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        tot = abs(tg - tc_) / abs(tc_)
        def flat(g):
            return np.concatenate([g[k].astype(np.float64).ravel() for k in sorted(trainable)])

        def cosine(a, b):
            return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        g32 = flat(res["cpu32"][2])
        cos = cosine(flat(gg), flat(gc))
        ang_card = float(np.arccos(min(1.0, cosine(flat(gg), g32))))
        ang_cpu = float(np.arccos(min(1.0, cosine(flat(gc), g32))))
        q90 = float(np.quantile(diffs, 0.9))
        print(f"tiny AMP step ({tiny.backbone}) card vs CPU: total rel err {tot:.2e} (tol "
              f"1e-2), loss vector rel distance {vec:.2e} (tol 5e-2); gradients' angle to "
              f"the fp32 ones: card AMP {ang_card:.4f} rad, CPU AMP {ang_cpu:.4f} rad (tol: "
              f"the card's from a quarter to twice the CPU's); card-vs-CPU AMP cosine "
              f"{cos:.6f}, grad norm {norm_g:.6f} vs {norm_c:.6f}; per leaf worst "
              f"max|err|/s {worst_rel:.2e}, worst cosine {worst_cos:.6f} (not held); after one "
              f"step |dparam|/lr q90 {q90:.2e} (tol 0.05), q99 {q99:.2e}, max "
              f"{diffs.max():.3f} (tol 2.1), frozen max diff {frozen_diff:.1e} (tol 0)",
              flush=True)
        if (tot > 1e-2 or vec > 5e-2 or not 0.25 * ang_cpu <= ang_card <= 2.0 * ang_cpu
                or q90 > 0.05
                or diffs.max() > 2.1 or frozen_diff != 0):
            fail("the tiny AMP training step on the card disagrees with the CPU path")
        return
    print(f"tiny step ({tiny.backbone}) card vs CPU: losses max rel err {loss_err:.2e} "
          f"(tol 1e-4); grad norm "
          f"{norm_g:.6f} vs {norm_c:.6f} (rel {abs(norm_g - norm_c) / norm_c:.2e}, tol 1e-4); "
          f"per leaf worst max|err|/s {worst_rel:.2e} (tol 0.1), worst cosine "
          f"{worst_cos:.6f} (tol 0.9999); after one step |dparam|/lr q99 {q99:.2e} "
          f"(tol 0.01), q99.9 {q999:.2e} (tol 0.05), max {diffs.max():.3f} (tol 1), "
          f"frozen max diff {frozen_diff:.1e} (tol 0)", flush=True)
    if (loss_err > 1e-4 or abs(norm_g - norm_c) / norm_c > 1e-4 or bad or worst_cos < 0.9999
            or q99 > 0.01 or q999 > 0.05 or diffs.max() > 1.0 or frozen_diff != 0):
        fail(f"the tiny training step on the card disagrees with the CPU path: {bad[:5]}")


def write_ppm(path, img):
    """RGB uint8 (H, W, 3) -> a binary PPM (P6) file, with numpy alone."""
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def write_ovis_dataset(root, hw, train_frames, dev_frames, num_classes, seed):
    """A synthetic OVIS-layout dataset under ``root``: ``ovis/train/v<i>/*.ppm``,
    ``ovis/annotations_train.json`` (a video per entry of ``train_frames``,
    that many frames each) and ``ovis/valid_sub.json`` (one video of
    ``dev_frames`` frames, or one per entry of a tuple), the splits
    ytvis_ovis_train and ytvis_ovis_dev name. Each video holds 3-6 ellipses
    that move from frame to frame over a noisy background, with the RLE GT
    of tests/synth_dataset.py's schema (per-frame segmentations, xywh boxes,
    areas)."""
    from mdqe_cvpr2023_tpu_torch.data import rle
    rng = np.random.default_rng(seed)
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W]
    splits = {"annotations_train.json": [], "valid_sub.json": []}
    dev = [dev_frames] if isinstance(dev_frames, int) else list(dev_frames)
    for vid, T in enumerate(list(train_frames) + dev, start=1):
        split = "valid_sub.json" if vid > len(train_frames) else "annotations_train.json"
        os.makedirs(os.path.join(root, "ovis", "train", f"v{vid}"), exist_ok=True)
        objs = [dict(r=rng.uniform(0.06, 0.2, 2) * (H, W), c=rng.uniform(0.2, 0.8, 2) * (H, W),
                     v=rng.uniform(-0.01, 0.01, 2) * (H, W), col=rng.integers(60, 255, 3),
                     cat=int(rng.integers(1, num_classes + 1)))
                  for _ in range(int(rng.integers(3, 7)))]
        segs = [[] for _ in objs]
        boxes = [[] for _ in objs]
        areas = [[] for _ in objs]
        names = []
        for t in range(T):
            img = rng.integers(0, 50, (H, W, 3)).astype(np.uint8)
            for k, o in enumerate(objs):
                cy, cx = np.clip(o["c"] + t * o["v"], o["r"], (H, W) - o["r"])
                m = ((yy - cy) / o["r"][0]) ** 2 + ((xx - cx) / o["r"][1]) ** 2 <= 1.0
                img[m] = o["col"]
                ys, xs = np.nonzero(m)
                segs[k].append(rle.encode(m))
                boxes[k].append([float(xs.min()), float(ys.min()),
                                 float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1)])
                areas[k].append(int(m.sum()))
            name = f"v{vid}/f{t:03d}.ppm"
            write_ppm(os.path.join(root, "ovis", "train", name), img)
            names.append(name)
        video = {"id": vid, "file_names": names, "height": H, "width": W, "length": T}
        anns = [{"id": 100 * vid + k, "video_id": vid, "category_id": o["cat"],
                 "segmentations": segs[k], "bboxes": boxes[k], "areas": areas[k],
                 "iscrowd": 0} for k, o in enumerate(objs)]
        splits[split].append((video, anns))
    for split, entries in splits.items():
        gt = {"videos": [v for v, _ in entries], "annotations": [a for _, an in entries for a in an],
              "categories": [{"id": c, "name": f"class{c}"} for c in range(1, num_classes + 1)]}
        with open(os.path.join(root, "ovis", split), "w") as f:
            json.dump(gt, f)
    return root


# the Trainer's full-width run: the cuts that one card and the repository force
# (R50_ovis_360.yaml otherwise as it is: R50, hidden 256, 6+6 layers, 196
# queries, 25 classes, the 320-512 x 800 buckets, 4-frame clips)
TRAINER_CUTS = [
    ("DATASETS.TRAIN", "['ytvis_ovis_train']",
     "no COCO pseudo-videos: no COCO data is in the repository"),
    ("DATASETS.TEST", "['ytvis_ovis_dev']",
     "the dev split of the synthetic dataset (OVIS valid has no public GT)"),
    ("SOLVER.IMS_PER_BATCH", "2",
     "16 clips of 4 frames at 512x800 do not fit one card: the training step of 2 clips "
     "peaks at 19.26 GiB on an 80 GB H100"),
    ("MODEL.WEIGHTS", "''", "no released weights are in the repository: random, seed 0"),
    ("DATALOADER.NUM_WORKERS", "2", "2 loader threads (the config's 4) on the 8-core host"),
]
TRAIN_ITERS, RESUMED_ITERS = 5, 2


def run_train_net(args, out_dir):
    """``python -m mdqe_cvpr2023_tpu_torch.train_net args`` from the checkout,
    its output echoed; fails on a non-zero exit."""
    cmd = [sys.executable, "-m", "mdqe_cvpr2023_tpu_torch.train_net", *args]
    print("$ " + " ".join(cmd), flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=900)
    print(proc.stdout.strip(), flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-6000:], file=sys.stderr, flush=True)
        fail(f"train_net exited with {proc.returncode}")
    print(f"train_net took {time.perf_counter() - t0:.1f} s", flush=True)
    return [json.loads(l) for l in open(f"{out_dir}/metrics.jsonl")]


def trainer_full_width(card):
    """The port's train/test entry point at full width through its CLI: a
    synthetic OVIS-layout dataset of 360x640 frames, R50_ovis_360.yaml with
    the cuts of TRAINER_CUTS. Three processes: ``--eval-only`` on the
    initial weights (``test`` on the dev video, 36 frames: trained weights
    soon predict blank masks, so only the initial ones leave tracks to
    encode and score); TRAIN_ITERS iterations with 2 loader threads and a
    checkpoint; a new process resumed from it for RESUMED_ITERS more. The
    training runs end in ``test`` too. Every metrics.jsonl row carries the
    kernels' launches since the row before. Returns the launches per call
    site: training forward, training backward, test forward (the first
    test)."""
    from mdqe_cvpr2023_tpu_torch.data import image
    from mdqe_cvpr2023_tpu_torch.engine.build import build_train_cfg
    from mdqe_cvpr2023_tpu_torch.engine.config import load_config
    from mdqe_cvpr2023_tpu_torch.parallel.train import lr_factor
    tmp = tempfile.mkdtemp(prefix="mdqe_trainer_")
    try:
        t0 = time.perf_counter()
        write_ovis_dataset(tmp, (360, 640), train_frames=(24, 30, 36), dev_frames=36,
                           num_classes=25, seed=0)
        print(f"synthetic OVIS dataset: 3 train videos (24, 30, 36 frames) and 1 dev video "
              f"(36 frames) of 360x640 PPM, 3-6 moving objects each, in "
              f"{time.perf_counter() - t0:.1f} s; images read by {image.BACKEND}", flush=True)
        print("reduced: " + "; ".join(f"{k} {v} ({why})" for k, v, why in TRAINER_CUTS),
              flush=True)
        out = os.path.join(tmp, "out")
        config = "configs/R50_ovis_360.yaml"
        opts = [x for k, v, _ in TRAINER_CUTS for x in (k, v)] + ["OUTPUT_DIR", out]
        common = ["--config-file", config, "--datasets-root", tmp, "--max-videos", "1",
                  "--log-every", "1"]
        run_train_net(common + ["--eval-only"] + opts, out)
        run_train_net(common + ["--max-iter", str(TRAIN_ITERS)] + opts, out)
        first = os.path.join(out, f"ckpt_{TRAIN_ITERS:07d}.pth")
        total = TRAIN_ITERS + RESUMED_ITERS
        rows = run_train_net(common + ["--resume", first, "--max-iter", str(total)] + opts, out)

        train = [r for r in rows if "test" not in r]
        tests = [r for r in rows if "test" in r]
        if ([r["iteration"] for r in train] != list(range(1, total + 1))
                or [r["iteration"] for r in tests] != [0, TRAIN_ITERS, total]):
            fail(f"metrics rows {[(r['iteration'], 'test' in r) for r in rows]}")
        steady = [r for r in train if r["iteration"] not in (1, TRAIN_ITERS + 1)]
        s_iter = float(np.mean([r["sec_per_iter"] for r in steady]))
        wait = float(np.mean([r["data_wait_frac"] for r in steady]))
        print(f"s/iter per iteration {[round(r['sec_per_iter'], 4) for r in train]} "
              f"-> {s_iter:.4f} s/iter over iterations 2-{TRAIN_ITERS}, {TRAIN_ITERS + 2}-"
              f"{total} (the first of each process warms up) ({card})")
        print(f"data_wait_frac per iteration {[round(r['data_wait_frac'], 4) for r in train]}"
              f" -> {wait:.4f}")
        print(f"peak device memory {max(r['max_mem_gib'] for r in rows):.2f} GiB")
        print(f"total loss per iteration {[round(r['total_loss'], 4) for r in train]}")
        fwd = {s: sum(r["msda_launches"]["fwd"][s] for r in train) for s in train[0]["msda_launches"]["fwd"]}
        bwd = {s: sum(r["msda_launches"]["bwd"][s] for r in train) for s in fwd}
        test_fwd = tests[0]["msda_launches"]["fwd"]
        print(f"launches in {total} training steps: forward {json.dumps(fwd)}, backward "
              f"{json.dumps(bwd)}; in each test: "
              f"{'; '.join(json.dumps(t['msda_launches']) for t in tests)}", flush=True)
        want = {k: total * v for k, v in expected_train_launches(trainer_model_cfg()).items()}
        if fwd != want or bwd != want:
            fail(f"trainer launches {fwd} / {bwd}, want {want} each")
        for t in tests:
            if min(t["msda_launches"]["fwd"].values()) == 0 or any(
                    t["msda_launches"]["bwd"].values()):
                fail(f"test launches {t['msda_launches']}")
        if not all(np.isfinite(r["total_loss"]) for r in train):
            fail("non-finite training loss")

        tc = build_train_cfg(load_config(config))
        for it in (TRAIN_ITERS, total):
            ck = torch.load(os.path.join(out, f"ckpt_{it:07d}.pth"), map_location="cpu",
                            weights_only=True)
            lrs = [g["lr"] for g in ck["optimizer"]["param_groups"]]
            want_lrs = [tc.base_lr * tc.backbone_multiplier * lr_factor(tc, it - 1),
                        tc.base_lr * lr_factor(tc, it - 1)]
            steps = {float(s["step"]) for s in ck["optimizer"]["state"].values()}
            print(f"checkpoint {it}: iteration {ck['iteration']}, step_count "
                  f"{ck['step_count']}, AdamW steps {sorted(steps)}, LR factor of the last "
                  f"step {lrs[1] / tc.base_lr:.6g} (want {lr_factor(tc, it - 1):.6g}), group "
                  f"LRs {lrs}", flush=True)
            if (ck["iteration"] != it or ck["step_count"] != it or steps != {float(it)}
                    or lrs != want_lrs):
                fail(f"checkpoint {it} is not exact: {ck['iteration']}, {ck['step_count']}, "
                     f"{steps}, {lrs} vs {want_lrs}")
        # the loader alone: host seconds of batch_at(k) for the run's batches
        from mdqe_cvpr2023_tpu_torch.engine.trainer import build_train_loader
        loader = build_train_loader(load_config(config, opts), tmp)
        secs, hws = [], []
        for k in range(total):
            t0 = time.perf_counter()
            b = loader.batch_at(k)
            secs.append(time.perf_counter() - t0)
            hws.append("x".join(map(str, b["images"].shape[1:3])))
        print(f"loader: batch_at(k) host seconds {[round(x, 4) for x in secs]} (mean "
              f"{np.mean(secs):.4f}) for the run's {total} batches, padded to {hws}; "
              f"{int(b['valid'].sum())} valid instances in the last", flush=True)
        # a process's first batch of a shape pays for its first kernels and
        # allocations: s/iter at the shapes the process had already run
        seen, again = {}, []
        for r, hw in zip(train, hws):
            proc = r["iteration"] > TRAIN_ITERS
            if hw in seen.setdefault(proc, set()):
                again.append(r["sec_per_iter"])
            seen[proc].add(hw)
        print("s/iter by batch shape: " + ", ".join(
            f"{r['iteration']}: {hw} {r['sec_per_iter']:.4f}" for r, hw in zip(train, hws))
            + (f"; at a shape its process had run before: {np.mean(again):.4f} s/iter "
               f"({len(again)} iterations)" if again else ""), flush=True)
        for t in tests:
            ap = {k: t[k] for k in ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1",
                                    "AR10", "AR100")}
            print(f"test after iteration {t['iteration']} ({card}): {t['videos']} video, "
                  f"{t['clips']} clips, {t['predictions']} predictions in "
                  f"{t['predict_s']:.3f} s -> {t['clips_per_s']:.3f} clips/s; host seconds: "
                  f"RLE encoding {t['rle_s']:.4f}, evaluate {t['evaluate_s']:.4f}; AP (random "
                  f"weights) {json.dumps({k: round(v, 4) for k, v in ap.items()})}", flush=True)
            if not all(np.isfinite(t[k]) and 0.0 <= t[k] <= 100.0 for k in ("AP", "AP50")):
                fail(f"AP out of [0, 100]: {ap}")
        if tests[0]["predictions"] == 0:
            fail("test of the initial weights predicted no track")
        return fwd, bwd, test_fwd
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def trainer_model_cfg():
    from mdqe_cvpr2023_tpu_torch.engine.build import build_model_cfg
    from mdqe_cvpr2023_tpu_torch.engine.config import load_config
    return build_model_cfg(load_config("configs/R50_ovis_360.yaml"))


# tests/synth_dataset.py's TINY_OVERRIDES (the tiny model of
# tests/test_trainer_e2e.py), dropout 0
TINY_TRAINER = [
    "MODEL.MDQE.HIDDEN_DIM", "64", "MODEL.MDQE.NHEADS", "4",
    "MODEL.MDQE.ENC_LAYERS", "1", "MODEL.MDQE.DEC_LAYERS", "1",
    "MODEL.MDQE.NUM_OBJECT_QUERIES", "16", "MODEL.MDQE.QUERY_EMBED_DIM", "8",
    "MODEL.MDQE.NUM_CLASSES", "1", "MODEL.MDQE.MAX_NUM_INSTANCES", "6",
    "MODEL.MDQE.SAMPLING_FRAME_NUM_TEST", "2", "MODEL.MDQE.WINDOW_FRAME_NUM_TEST", "4",
    "INPUT.SAMPLING_FRAME_NUM", "2", "INPUT.MIN_SIZE_TRAIN", "[64]",
    "INPUT.MAX_SIZE_TRAIN", "64", "INPUT.MIN_SIZE_TEST", "64", "INPUT.CROP.ENABLED", "False",
    "DATASETS.TRAIN", "[ytvis_ovis_train]", "DATASETS.TEST", "[ytvis_ovis_dev]",
    "SOLVER.IMS_PER_BATCH", "2", "TEST.EVAL_PERIOD", "0", "DATALOADER.NUM_WORKERS", "0",
    "MODEL.MDQE.DROPOUT", "0.0",
]


def tiny_trainer_card_vs_cpu():
    """The tiny Trainer on the card and on the port's CPU path, from the same
    seed and dataset: the loader's batches bit-equal; the losses of both
    training steps within rtol 1e-4 (the card takes its second step from the
    CPU's checkpoint after the first); ``test`` of the card's trained weights
    (fp32 encode on both sides) by the VIS rule: the same tracks and labels,
    scores within 5e-3, mask IoU >= 0.99; the AP within 0.5 points. Then the
    native RLE codec against the Python codec on 200 random masks."""
    from mdqe_cvpr2023_tpu_torch.data import rle
    from mdqe_cvpr2023_tpu_torch.engine.config import load_config
    from mdqe_cvpr2023_tpu_torch.engine.trainer import Trainer
    tmp = tempfile.mkdtemp(prefix="mdqe_tiny_")
    try:
        write_ovis_dataset(tmp, (64, 96), train_frames=(6, 8), dev_frames=7, num_classes=1,
                           seed=1)
        trainers = {}
        for dev in ("cpu", "cuda"):
            cfg = load_config("configs/R50_ovis_360.yaml",
                              TINY_TRAINER + ["OUTPUT_DIR", os.path.join(tmp, dev)])
            tr = Trainer(cfg, datasets_root=tmp, device=dev)
            batches = [tr.build_train_loader().batch_at(k) for k in range(3)]
            tr.train(max_iter=1, log_every=1)
            # the second step from one state on both, the CPU's (the same in
            # every run): Adam's first step moves a weight by about
            # lr * sign(g), so gradient rounding noise (and the card's
            # d(value) atomics, whose order varies between runs) leaves two
            # trainings' weights up to ~0.2 lr apart, near a tie of the
            # matching costs at times
            if dev == "cuda":
                tr.load_checkpoint(os.path.join(tmp, "cpu", "ckpt_0000001.pth"))
            tr.train(max_iter=2, log_every=1)
            trainers[dev] = (tr, batches)
        # both test the card's trained weights, fp32 encode
        trained = {k: v.cpu() for k, v in trainers["cuda"][0].model.state_dict().items()}
        res = {}
        for dev, (tr, batches) in trainers.items():
            tr.model.load_state_dict(trained)
            tr.inf_cfg = dataclasses.replace(tr.inf_cfg, bf16_encode=False)
            metrics, preds = tr.test(max_videos=1)
            rows = [json.loads(l) for l in open(os.path.join(tmp, dev, "metrics.jsonl"))]
            res[dev] = (batches, rows, metrics, preds)
        (bg, rg, mg, pg), (bc, rc, mc, pc) = res["cuda"], res["cpu"]
        for k, (a, b) in enumerate(zip(bg, bc)):
            for key in b:
                if a[key].dtype != b[key].dtype or not np.array_equal(a[key], b[key]):
                    fail(f"loader batch {k} differs between the two trainers at {key}")
        loss_err, worst = 0.0, []
        for step, (a, b) in enumerate(zip(rg[:2], rc[:2]), start=1):
            keys = [k for k in b if k == "total_loss" or k.startswith("loss_")]
            errs = {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in keys}
            k = max(errs, key=errs.get)
            worst.append(f"step {step}: total {errs['total_loss']:.2e}, worst {k} {a[k]:.6g} "
                         f"vs {b[k]:.6g}")
            loss_err = max(loss_err, errs[k])
        labels_ok = len(pg) == len(pc) and [p["category_id"] for p in pg] == [
            p["category_id"] for p in pc]
        score_err = (max(abs(a["score"] - b["score"]) for a, b in zip(pg, pc))
                     if labels_ok and pg else float("inf"))
        ious = []
        for a, b in zip(pg, pc):
            ma = np.stack([rle.decode(s) for s in a["segmentations"]]).astype(bool)
            mb = np.stack([rle.decode(s) for s in b["segmentations"]]).astype(bool)
            ious.append(np.logical_and(ma, mb).sum() / max(np.logical_or(ma, mb).sum(), 1))
        ap_err = abs(mg["AP"] - mc["AP"])
        print(f"tiny Trainer card vs CPU: 3 loader batches bit-equal; losses of 2 steps (the "
              f"second from the CPU's checkpoint on both) max rel err {loss_err:.2e} (tol "
              f"1e-4; {'; '.join(worst)}); test: {len(pg)} vs {len(pc)} predictions, labels "
              f"{'equal' if labels_ok else 'differ'}, max|score err| {score_err:.2e} (tol 5e-3), "
              f"min mask IoU {min(ious) if ious else 1.0:.4f} (tol 0.99); AP {mg['AP']:.3f} vs "
              f"{mc['AP']:.3f} (tol 0.5); card launches in the test "
              f"{json.dumps(rg[-1]['msda_launches']['fwd'])}", flush=True)
        if (loss_err > 1e-4 or not labels_ok or not pg or score_err > 5e-3
                or (ious and min(ious) < 0.99) or not ap_err <= 0.5):
            fail("the tiny Trainer on the card disagrees with the CPU path")
        if min(rg[-1]["msda_launches"]["fwd"].values()) == 0:
            fail("the tiny Trainer's test did not launch the forward kernel at every site")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    lib = rle.load_native()
    if not lib:
        fail("the native RLE codec did not build or load")
    rng = np.random.default_rng(5)
    for i in range(200):
        h, w = int(rng.integers(1, 400)), int(rng.integers(1, 700))
        m = np.zeros((h, w), bool)
        for _ in range(int(rng.integers(0, 6))):
            y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
            m[y:y + int(rng.integers(1, h + 1)), x:x + int(rng.integers(1, w + 1))] = True
        m ^= rng.random((h, w)) < 0.01 * (i % 3)
        counts = rle._runs(m.reshape(-1, order="F"))
        s = rle.counts_to_string(counts)
        if s != rle.counts_to_string_py(counts) or not np.array_equal(
                rle.string_to_counts(s), rle.string_to_counts_py(s)):
            fail(f"the native RLE codec disagrees with the Python codec on mask {i}")
        if not np.array_equal(rle.decode(rle.encode(m)), m):
            fail(f"RLE round trip failed on mask {i}")
    print(f"native RLE codec {os.path.basename(lib._name)} equals the Python codec on 200 "
          "random masks (strings and counts), round trips exact", flush=True)


def check_outputs(out, n_frames, hw, num_classes):
    if not out["pred_scores"]:
        fail("inference_vis returned no instance")
    if not np.all(np.isfinite(out["pred_scores"])):
        fail("non-finite scores")
    if not all(0 <= int(c) < num_classes for c in out["pred_labels"]):
        fail(f"labels out of range: {out['pred_labels']}")
    if len(out["pred_masks"]) != len(out["pred_scores"]) \
            or len(out["pred_labels"]) != len(out["pred_scores"]):
        fail("scores, labels and masks differ in count")
    for m in out["pred_masks"]:
        if m.shape != (n_frames,) + tuple(hw) or m.dtype != bool:
            fail(f"mask of shape {m.shape} {m.dtype}, want {(n_frames,) + tuple(hw)} bool")


def sass_lines(_build, name):
    """The SASS of ``csrc/<name>.cu``'s library (cuobjdump), line by line."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.build(name))],
                          capture_output=True, text=True)
    if sass.returncode != 0:
        fail(f"cuobjdump failed: {sass.stderr.strip()}")
    return sass.stdout.splitlines()


def check_vector_red(_build):
    """The backward kernels' global atomics: msda_bwd_f32 scatters d(value)
    with 16-byte vector reductions (REDG.E.ADD.F32x4) alone; msda_bwd_bf16
    sums in fp32 too, its merged rows by the same reductions (its tiled
    kernel; its decoder kernels send none), and holds no bf16 global atomic
    and no compare-and-swap loop (ATOMS.CAS / ATOMS.CAST.SPIN, ATOMG ... CAS:
    fp32 atomics on shared memory compile to one on this card); its merge
    takes shared-memory integer atomics (ATOMS.ADD, ATOMS.MIN). The library
    holds no other global reduction or atomic."""
    lines = sass_lines(_build, "ms_deform_attn")
    per_kind = {"f32": collections.Counter(), "bf16": collections.Counter()}
    other, fn = [], None
    for ln in lines:
        if "Function :" in ln:
            fn = ("bf16" if "msda_bwd_bf16" in ln else
                  "f32" if "msda_bwd_kernelIf" in ln else None)
            continue
        ops = [w for w in ln.replace(";", " ").split() if w.startswith(("REDG", "ATOMG",
                                                                        "ATOMS", "ATOM.",
                                                                        "RED."))]
        for op in ops:
            vec = op.startswith("REDG") and "ADD.F32x4" in op
            cas = "CAS" in op or "SPIN" in op
            if fn:
                per_kind[fn][op] += 1
            if cas or (op.startswith(("REDG", "ATOMG", "ATOM.", "RED.")) and not vec):
                other.append((fn, op))
    vec = {k: sum(n for op, n in c.items() if op.startswith("REDG")) for k, c in per_kind.items()}
    print(f"ms_deform_attn SASS: msda_bwd_f32's kernels {dict(per_kind['f32'])}, "
          f"msda_bwd_bf16's {dict(per_kind['bf16'])}; other global atomics or CAS "
          f"{collections.Counter(other)}", flush=True)
    if other or not vec["f32"] or not vec["bf16"]:
        fail("the backward kernels' atomics are not 16-byte vector reductions alone, with "
             "shared integer atomics in msda_bwd_bf16's merge and no CAS loop")


def check_wgmma(_build):
    """tc_kdepth must run on Hopper's warpgroup products: its library's SASS
    (cuobjdump) holds HGMMA instructions and no mma.sync (HMMA), and ptxas did
    not serialize them (its C7513 note: a wait after every wgmma)."""
    lines = sass_lines(_build, "tc_kdepth")
    hgmma = sum("HGMMA" in ln for ln in lines)
    hmma = sum("HMMA" in ln and "HGMMA" not in ln for ln in lines)
    print(f"tc_kdepth SASS: {hgmma} HGMMA, {hmma} HMMA instructions", flush=True)
    if hgmma == 0 or hmma:
        fail("tc_kdepth is not built on wgmma (no HGMMA in its SASS)")
    if "C7513" in _build.ptxas_report("tc_kdepth"):
        fail("ptxas serialized tc_kdepth's wgmma instructions (C7513)")


def sig(x):
    """x to 6 significant digits (the kernels line stays short)."""
    return None if x is None else float(f"{x:.6g}")


def kernel_entry(name, source, replaces, launches, err, t):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": int(launches), "max_abs_err": sig(err), "ms": sig(t["ms"]),
            "plain_ms": sig(t["plain_ms"]), "bound_ms": sig(t["bound_ms"]),
            "bound_by": t["bound_by"], "library_ms": sig(t["library_ms"])}


def check_block_variants(da, tdk):
    """Every block size x value type against the plain version, on the tuning
    tool's inputs at each of its four levels (B*H = 80, Q = 5120, one level,
    weights in [0, 20); the inputs its sweep times) and at the COCO encoder's
    shape (B = 1, Q = N = 20197). Tolerance 1e-5 of the largest |out| (at
    least 1e-4): both read the same numbers and differ only in summation
    order. Returns max |err| per (problem, variant key); the tuning problems
    are named by their level, "48x80" ..."""
    problems = [(f"{h}x{w}", ((h, w),), tdk.level_inputs(h, w, seed=li))
                for li, (h, w) in enumerate(tdk.LEVELS)]
    problems.append(("coco encoder", COCO_SHAPES,
                     make_inputs(torch, 1, COCO_N, 8, 32, 4, COCO_SHAPES, "local",
                                 torch.float32, seed=400)))
    max_err = {}
    for name, shapes, (v, lo, aw) in problems:
        for vdt in (torch.bfloat16, torch.float32):
            errs, scale = tdk.check_variants(v.to(vdt), shapes, lo, aw)
            tol = max(1e-4, 1e-5 * scale)
            print(f"block sizes {name:14s} {str(vdt)[6:]:8s} max|err| "
                  f"{json.dumps({t: float(f'{e:.3g}') for t, e in errs.items()})} "
                  f"(tol {tol:.1e})", flush=True)
            for t, e in errs.items():
                max_err[name, da.block_variant(vdt, t)] = e
                if not e <= tol:
                    fail(f"block size {t} ({vdt}) disagrees with the plain version at {name}")
        del v, lo, aw
    return max_err


def check_probe(pbp):
    """The gather probe's kernel against the tool's oracle (fp32) and the
    plain version (bf16) at every problem the probe times (both spreads, 512
    and 409600 queries): max |err| <= 1e-5 of the largest |out|. Returns max
    |err| per (spread, size name)."""
    res = pbp.check()
    print(f"gather probe max|err|: {json.dumps(res)} (tol 1e-5 of scale)", flush=True)
    errs = {}
    for kind, by_size in res.items():
        for name, r in by_size.items():
            errs[kind, name] = max(r["f32_vs_oracle"], r["bf16_vs_plain"])
            if not errs[kind, name] <= 1e-5 * r["scale"]:
                fail(f"the gather probe disagrees at the {kind} spread, {name}: {r}")
    return errs


def check_tc(pmk):
    """tc_kdepth against tc_kdepth_plain at every (K, N) of the sweep, on the
    tool's operands and on a random left operand: max |err| <= 1e-4 of the
    largest |out| (exact bf16 products; only the order of the sums differs).
    Returns max |err| per shape key."""
    from mdqe_cvpr2023_tpu_torch.ops import tc_kdepth as tc
    errs, rel = {}, {}
    for N in pmk.NS:
        for K in pmk.KS:
            key = tc.shape_key(K, N)
            for random_lhs in (False, True):
                err, scale = pmk.check(K, N, random_lhs=random_lhs)
                errs[key] = max(errs.get(key, 0.0), err)
                rel[key] = max(rel.get(key, 0.0), err / scale)
                if not err <= 1e-4 * scale:
                    fail(f"tc_kdepth disagrees with its plain version at K={K} N={N}: "
                         f"{err:.2e} of {scale:.2e}")
    print(f"tc_kdepth max|err| / max|out| per shape: "
          f"{json.dumps({k: float(f'{e:.3g}') for k, e in rel.items()})} (tol 1e-4)",
          flush=True)
    return errs


def coco_site_inputs(site):
    """The forward kernel's inputs at a COCO call site: list of (shapes, v,
    loc, weights); the temporal site has one per pyramid level (one frame,
    one attention level)."""
    if site == "encoder":
        return [(COCO_SHAPES, *make_inputs(torch, 1, COCO_N, 8, 32, 4, COCO_SHAPES, "local",
                                           torch.float32, seed=410))]
    if site == "decoder_box":
        return [(COCO_SHAPES, *make_inputs(torch, 1, 196, 8, 32, 4, COCO_SHAPES, "uniform",
                                           torch.float32, seed=411))]
    return [(((h, w),), *make_inputs(torch, 1, 196, 8, 32, 4, ((h, w),), "uniform",
                                     torch.float32, seed=412 + k))
            for k, (h, w) in enumerate(COCO_SHAPES)]


def coco_kernel_sites(da):
    """The forward kernel at the COCO sites: max |err| against the plain
    version (tolerance 1e-4, as at the inference shapes) and the timing per
    launch beside the plain version, the grid_sample composition and the
    bound; the temporal site averages its four level shapes (one launch each
    per layer)."""
    errs, timings = {}, {}
    for site in ("encoder", "decoder_box", "decoder_inst"):
        rows = []
        for shapes, v, lo, aw in coco_site_inputs(site):
            got = da.ms_deform_attn_cuda(v, shapes, lo, aw)
            want = da.ms_deform_attn_plain(v, shapes, lo, aw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs[site] = max(errs.get(site, 0.0), err)
            if not (err <= 1e-4 and bool(torch.isfinite(got).all())):
                fail(f"kernel disagrees with its plain version at the COCO {site}: {err:.2e}")
            ms = measure.time_ms(lambda: da.ms_deform_attn_cuda(v, shapes, lo, aw), 50)
            dev_ms = measure.graph_ms(lambda: da.ms_deform_attn_cuda(v, shapes, lo, aw), 50)
            plain_ms = measure.time_ms(lambda: da.ms_deform_attn_plain(v, shapes, lo, aw), 3)
            lib_ms = measure.time_ms(lambda: measure.grid_sample_msda(v, shapes, lo, aw), 3)
            bound_ms, bound_by, _ = measure.msda_bound(v, shapes, lo, aw)
            rows.append((ms, plain_ms, lib_ms, bound_ms, bound_by, dev_ms))
            del got, want, v, lo, aw
        n = len(rows)
        timings[site] = dict(ms=sum(r[0] for r in rows) / n,
                             plain_ms=sum(r[1] for r in rows) / n,
                             library_ms=sum(r[2] for r in rows) / n,
                             bound_ms=sum(r[3] for r in rows) / n, bound_by=rows[0][4],
                             device_ms=sum(r[5] for r in rows) / n)
        t = timings[site]
        print(f"coco {site:12s} max|err| {errs[site]:.2e} (tol 1e-4) | kernel "
              f"{t['ms']:.4f} ms (graph replay {t['device_ms']:.4f} ms) | plain "
              f"{t['plain_ms']:.3f} ms | grid_sample form "
              f"{t['library_ms']:.3f} ms | bound {t['bound_ms'] * 1e3:.1f} us by "
              f"{t['bound_by']} | {t['bound_ms'] / t['ms']:.1%} of bound"
              + (" (mean of the four level shapes)" if n > 1 else ""), flush=True)
    return errs, timings


def coco_full_width(da, card, swin=False, n_images=5):
    """COCO image inference at full width (R50 COCO, or Swin-L COCO with
    ``swin``; random weights from seed 0, the class head's bias zeroed so
    that scores pass the 0.05 threshold and the 100-detection slab fills, as
    a trained model's would): one 800x1200 image padded to 800x1216, original
    size 480x720; a warm-up image, then ``n_images`` timed ones, then one
    with stage timers. Returns the launches of the timed images."""
    from mdqe_cvpr2023_tpu_torch import configs
    from mdqe_cvpr2023_tpu_torch.models import meta
    from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel
    cfg = configs.SWINL_COCO if swin else configs.R50_COCO
    inf = configs.R50_COCO_INF  # swinl_coco.yaml keeps R50_coco.yaml's post-processing
    ori = (480, 720)
    size = configs.coco_test_size(*ori)
    t0 = time.perf_counter()
    model = MDQEModel(cfg, device="cuda", seed=0)
    with torch.no_grad():
        model.detr.transformer_dec.cls_embed.layers[-1].bias.zero_()
    img = np.random.default_rng(0).integers(0, 255, (1,) + size + (3,)).astype(np.uint8)
    frames, _ = meta.preprocess_frames(img)
    print(f"COCO model ({cfg.backbone}) built in {time.perf_counter() - t0:.1f} s; image "
          f"{size} padded to "
          f"{frames.shape[1:3]}, original size {ori}", flush=True)
    t0 = time.perf_counter()
    meta.inference_image(model, inf, frames, size, ori)
    torch.cuda.synchronize()
    print(f"warm-up image {time.perf_counter() - t0:.3f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    da.reset_launches()
    walls = []
    for _ in range(n_images):
        t0 = time.perf_counter()
        out = meta.inference_image(model, inf, frames, size, ori)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = dict(da.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    s_img = sum(walls) / n_images
    n = len(out["scores"])
    timers = {}
    meta.inference_image(model, inf, frames, size, ori, timers=timers)
    print(f"COCO inference: {', '.join(f'{w:.4f}' for w in walls)} s -> {s_img:.4f} s/image, "
          f"{1 / s_img:.3f} images/s ({card})")
    print(f"stage host seconds of one more image (each ends in synchronize): "
          f"{json.dumps({k: round(v, 4) for k, v in timers.items() if not k.endswith('_n')})}")
    print(f"peak device memory {peak / 2 ** 30:.2f} GiB")
    print(f"launches in {n_images} images: {json.dumps(launches)}")
    print(f"detections {n}, top scores {[round(x, 4) for x in out['scores'][:5]]}, "
          f"classes {out['classes'][:5]}", flush=True)
    want = {"encoder": cfg.enc_layers, "decoder_box": cfg.dec_layers,
            "decoder_inst": cfg.dec_layers * cfg.n_feature_levels}
    if launches != {k: n_images * v for k, v in want.items()}:
        fail(f"COCO launches {launches}, want {want} per image")
    if not 1 <= n <= inf.coco_topk or len(out["classes"]) != n:
        fail(f"{n} detections, want 1 .. {inf.coco_topk}")
    if not np.all(np.isfinite(out["scores"])) or not all(0 <= c < cfg.num_classes
                                                         for c in out["classes"]):
        fail("non-finite scores or labels out of range")
    if out["masks"].shape != (n,) + ori or out["masks"].dtype != bool:
        fail(f"masks {out['masks'].shape} {out['masks'].dtype}, want {(n,) + ori} bool")
    if out["boxes"].shape != (n, 4) or not np.all(np.isfinite(out["boxes"])):
        fail(f"boxes {out['boxes'].shape}")
    del model
    torch.cuda.empty_cache()
    return launches


def match_detections(got, want):
    """Pair each detection of ``got`` with one of ``want`` of the same label,
    score within 5e-3, mask IoU >= 0.99 and boxes within 1 px (near-equal
    scores may order differently). Returns (max score err, min IoU) or None
    when some detection has no partner."""
    if len(got["scores"]) != len(want["scores"]):
        return None
    free = set(range(len(want["scores"])))
    worst_s, worst_iou = 0.0, 1.0
    for i, (s, c) in enumerate(zip(got["scores"], got["classes"])):
        best, best_iou = None, -1.0
        for j in free:
            if want["classes"][j] != c or abs(want["scores"][j] - s) > 5e-3:
                continue
            a, b = got["masks"][i], want["masks"][j]
            union = np.logical_or(a, b).sum()
            iou = 1.0 if union == 0 else np.logical_and(a, b).sum() / union
            if iou > best_iou:
                best, best_iou = j, iou
        if best is None or best_iou < 0.99 \
                or np.abs(got["boxes"][i] - want["boxes"][best]).max() > 1.0:
            return None
        worst_s = max(worst_s, abs(want["scores"][best] - s))
        worst_iou = min(worst_iou, best_iou)
        free.discard(best)
    return worst_s, worst_iou


def coco_small_card_vs_cpu(da):
    """COCO inference of a small image on the card against the port's CPU
    path, tiny R50 COCO configuration (that of tests/test_torch_coco.py, the
    class bias zeroed), both multi_cls_on branches: the same detections. Then
    ``coco_object_masks_card_vs_cpu`` with the same two models."""
    from mdqe_cvpr2023_tpu_torch.models import meta
    from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel, MDQEModelCfg
    tiny = MDQEModelCfg(backbone="resnet50", num_classes=3, hidden_dim=64, n_heads=4,
                        enc_layers=1, dec_layers=1, n_frames=1, n_query=16,
                        query_embed_dim=8, window_inter_frame_asso=5, dec_temporal=True)
    img = np.random.default_rng(0).integers(0, 255, (1, 56, 60, 3)).astype(np.uint8)
    frames, _ = meta.preprocess_frames(img)
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = MDQEModel(tiny, device=dev, seed=3)
        with torch.no_grad():
            models[dev].detr.transformer_dec.cls_embed.layers[-1].bias.zero_()
    for multi in (True, False):
        inf = meta.InferenceCfg(num_classes=3, apply_cls_thres=0.05, multi_cls_on=multi,
                                coco_topk=100)
        da.reset_launches()
        got = meta.inference_image(models["cuda"], inf, frames, (56, 60), (84, 90))
        if min(da.LAUNCHES.values()) == 0:
            fail(f"small COCO run did not reach every kernel call site: {da.LAUNCHES}")
        want = meta.inference_image(models["cpu"], inf, frames, (56, 60), (84, 90),
                                    device="cpu")
        res = match_detections(got, want)
        print(f"small image, multi_cls_on={multi}: detections {len(got['scores'])} vs "
              f"{len(want['scores'])}; max|score err|, min mask IoU: {res}", flush=True)
        if res is None or not got["scores"]:
            fail(f"the card's COCO output disagrees with the CPU path (multi_cls_on={multi})")
    coco_object_masks_card_vs_cpu(meta, models)


def object_mask_outputs(n_query, n_cls, hw4, seed):
    """Decoder outputs of a model that finds objects: class scores (1, Q, K)
    in (0, 1), a few queries below the threshold, and per query an elliptic
    mask-logit blob (1, Q, 1, h4, w4) of its own centre and radii, so masks
    differ and their boxes overlap in part (random weights give masks that
    all span the image, whose boxes coincide)."""
    rng = np.random.default_rng(seed)
    cls = rng.uniform(0.06, 0.9, (n_query, n_cls)).astype(np.float32)
    cls[rng.choice(n_query, 3, replace=False)] = 0.02
    yy, xx = np.mgrid[0:hw4[0], 0:hw4[1]].astype(np.float32)
    cy = rng.uniform(0, hw4[0], n_query)[:, None, None]
    cx = rng.uniform(0, hw4[1], n_query)[:, None, None]
    ry = rng.uniform(1.5, hw4[0] / 2.5, n_query)[:, None, None]
    rx = rng.uniform(1.5, hw4[1] / 2.5, n_query)[:, None, None]
    m4 = 4.0 * (1.0 - ((yy - cy) / ry) ** 2 - ((xx - cx) / rx) ** 2)
    return cls[None], m4.astype(np.float32)[None, :, None]


def coco_object_masks_card_vs_cpu(meta, models):
    """COCO post-processing (rescoring, box-IoU decay in score order, the
    top-100 slab, packed masks, host resize, boxes) on the card against the
    CPU path at the full query and class width (196 x 80) of a 320x480 image,
    on object-like decoder outputs (``object_mask_outputs``) put in place of
    the forward, both multi_cls_on branches: the same detections, at least
    5 distinct queries among them, some boxes overlapping in part."""
    cls, m4 = object_mask_outputs(196, 80, (80, 120), seed=7)
    frames = np.zeros((1, 320, 480, 3), np.uint8)
    forward = meta.detr_apply_coco
    meta.detr_apply_coco = lambda detr, images, sizes, T: {
        "cls": torch.from_numpy(cls).to(images.device),
        "masks": torch.from_numpy(m4).to(images.device)}
    try:
        for multi in (True, False):
            inf = meta.InferenceCfg(num_classes=80, apply_cls_thres=0.05, multi_cls_on=multi,
                                    coco_topk=100)
            got = meta.inference_image(models["cuda"], inf, frames, (320, 480), (480, 720))
            want = meta.inference_image(models["cpu"], inf, frames, (320, 480), (480, 720),
                                        device="cpu")
            res = match_detections(got, want)
            distinct = {m.tobytes(): i for i, m in enumerate(got["masks"])}
            boxes = [got["boxes"][i] for i in distinct.values()]
            partial = sum(0.0 < box_iou(a, b) < 1.0
                          for k, a in enumerate(boxes) for b in boxes[k + 1:])
            print(f"object-like masks, multi_cls_on={multi}: detections "
                  f"{len(got['scores'])} vs {len(want['scores'])}, {len(distinct)} distinct "
                  f"masks, {partial} box pairs overlapping in part; max|score err|, min mask "
                  f"IoU: {res}", flush=True)
            if res is None or len(distinct) < 5 or partial == 0:
                fail(f"the card's COCO post-processing disagrees with the CPU path on "
                     f"object-like masks (multi_cls_on={multi})")
    finally:
        meta.detr_apply_coco = forward


def box_iou(a, b):
    """IoU of two xyxy boxes (numpy)."""
    inter = np.prod(np.clip(np.minimum(a[2:], b[2:]) - np.maximum(a[:2], b[:2]), 0, None))
    return inter / (np.prod(a[2:] - a[:2]) + np.prod(b[2:] - b[:2]) - inter)


def tool_paths(da, tdk, pbp, pmk):
    """The three kernel tools' sweeps, each problem driven with the launch
    counts set to 0 just before it and read just after (a tuning level, a
    probe problem; tc_kdepth counts per shape). Returns their rows, each with
    the launches of its own problem."""
    from mdqe_cvpr2023_tpu_torch.ops import tc_kdepth as tc
    tune_rows = []
    for h, w in tdk.LEVELS:
        da.reset_launches()
        rows = tdk.sweep(iters=20, levels=((h, w),))
        counts = dict(da.BLOCK_LAUNCHES)
        print(f"tune {h}x{w} launches {json.dumps(counts)}", flush=True)
        for r in rows:
            r["launches"] = counts[f"{r['value']}_t{r['threads']}"]
            if r["launches"] == 0:
                fail(f"the tuning sweep never launched {r['value']} at {r['threads']} "
                     f"threads at level {h}x{w}")
        tune_rows += rows
    for r in tune_rows:
        print(f"tune {r['level']:6s} {r['value']:4s} threads {r['threads']:3d}: "
              f"{r['ms']:.4f} ms, {r['gb_per_s']:.1f} GB/s, {r['share_of_bound']:.1%} of "
              f"bound ({r['bound_ms'] * 1e3:.1f} us by {r['bound_by']}); plain "
              f"{r['plain_ms']:.3f} ms, grid_sample {r['library_ms']:.3f} ms", flush=True)

    probe_rows = []
    for problem in pbp.problems():
        da.reset_launches()
        (r,) = pbp.sweep(iters=20, only=[problem])
        r["launches"] = da.BLOCK_LAUNCHES[da.block_variant(torch.bfloat16, pbp.THREADS)]
        if r["launches"] == 0:
            fail(f"the gather probe never launched the kernel at {problem}")
        probe_rows.append(r)
    for r in probe_rows:
        print(f"probe {r['spread']:5s} {r['size']:8s}: {r['ms']:.4f} ms (graph replay "
              f"{r['device_ms']:.4f} ms, {r['device_gb_per_s']:.1f} GB/s), "
              f"{r['gb_per_s']:.1f} GB/s, {r['share_of_bound']:.1%} of bound "
              f"({r['bound_ms'] * 1e3:.1f} us by {r['bound_by']}); plain {r['plain_ms']:.3f} "
              f"ms, grid_sample {r['library_ms']:.4f} ms; {r['launches']} launches",
              flush=True)

    tc.reset_launches()
    tc_rows = pmk.sweep(iters=10)
    tc_launches = dict(tc.LAUNCHES)
    for r in tc_rows:
        print(f"tc_kdepth K={r['K']:3d} N={r['N']:4d}: {r['ms']:.4f} ms/launch, "
              f"{r['tflop_per_s']:.1f} TFLOP/s ({r['share_of_peak']:.1%} of 989); graph replay "
              f"{r['device_ms']:.4f} ms, {r['device_tflop_per_s']:.1f} TFLOP/s "
              f"({r['device_share_of_peak']:.1%}), "
              f"{r['us_per_product']:.2f} us/product | cuBLAS stacked "
              f"{r['cublas_stacked_ms']:.4f} ms ({r['cublas_stacked_tflop_per_s']:.1f} "
              f"TFLOP/s), one product {r['library_ms']:.4f} ms "
              f"({r['library_tflop_per_s']:.1f} TFLOP/s; graph replay "
              f"{r['library_device_ms']:.4f} ms) | plain {r['plain_ms']:.3f} ms",
              flush=True)
    print(f"tc_kdepth launches {json.dumps(tc_launches)}", flush=True)
    if len(tc_launches) != len(tc_rows) or min(tc_launches.values()) == 0:
        fail(f"the depth sweep did not launch tc_kdepth at every shape: {tc_launches}")
    return tune_rows, probe_rows, tc_rows, tc_launches


def fwd_sites():
    """Every timed call site of the forward kernel, on the timing phases'
    inputs: (name, [(shapes, value, locations, weights), ...]); the COCO
    temporal site has one problem per pyramid level."""
    for k, (site, (B, Q, H, D, P, shapes, mode, vdt, _)) in enumerate(VIS_SITES.items()):
        yield f"vis_{site}", [(shapes, *make_inputs(torch, B, Q, H, D, P, shapes, mode, vdt,
                                                    seed=100 + k))]
    for k, (site, B, Q, H, D, P, shapes, mode) in enumerate(BWD_CHECKS[:3]):
        yield f"train_{site}", [(shapes, *make_inputs(torch, B, Q, H, D, P, shapes, mode,
                                                      torch.float32, seed=300 + k))]
    for site in ("encoder", "decoder_box", "decoder_inst"):
        yield f"coco_{site}", coco_site_inputs(site)


def kernel_times():
    """``--kernel-times``: the kernels' times alone, one JSON line each: the
    forward kernel at every site of ``fwd_sites`` (ms per launch from CUDA
    events, wrapper included, and from a CUDA-graph replay; and by graph
    replay at every block size of ``msda_fwd_*_block``), the backward kernel
    at the training step's three sites (eager, the wrapper's zeroed d(value)
    included, and graph replay), msda_bwd_bf16 at BWD_BF16_SITES (eager,
    graph replay, msda_bwd_f32 on the fp32 upcast by graph replay, and the
    bound) and tc_kdepth at every (K, N) of the depth
    sweep (graph replay). It calls only wrappers that
    every checkout of the port has, so a copy of this script placed in another
    checkout (the parent commit's) times that checkout's kernels on the same
    inputs: run the two in turns (A, B, B, A) on one card."""
    from mdqe_cvpr2023_tpu_torch.ops import deform_attn as da
    from mdqe_cvpr2023_tpu_torch.ops import tc_kdepth as tc
    from mdqe_cvpr2023_tpu_torch.tools import probe_mxu_kdepth as pmk
    card = measure.card()
    for name, problems in fwd_sites():
        eager, graph, blocks = [], [], {t: [] for t in da.BLOCK_THREADS}
        for shapes, v, lo, aw in problems:
            eager.append(measure.time_ms(lambda: da.ms_deform_attn_cuda(v, shapes, lo, aw), 50))
            graph.append(measure.graph_ms(lambda: da.ms_deform_attn_cuda(v, shapes, lo, aw), 50))
            for t in da.BLOCK_THREADS:
                blocks[t].append(measure.graph_ms(lambda: da.ms_deform_attn_cuda_block(
                    v, shapes, lo, aw, t, count=False), 50))
        del problems
        print(json.dumps({"kernel": "msda_fwd", "site": name, "eager_ms": np.mean(eager),
                          "graph_ms": np.mean(graph),
                          "block_graph_ms": {t: np.mean(ms) for t, ms in blocks.items()},
                          "card": card}), flush=True)
    for k, (site, B, Q, H, D, P, shapes, mode) in enumerate(BWD_CHECKS[:3]):
        v, lo, aw, gout = bwd_inputs(torch, B, Q, H, D, P, shapes, mode, seed=300 + k)
        eager = measure.time_ms(lambda: da.ms_deform_attn_bwd_cuda(v, shapes, lo, aw, gout), 20)
        graph = measure.graph_ms(lambda: da.ms_deform_attn_bwd_cuda(v, shapes, lo, aw, gout),
                                 20)
        print(json.dumps({"kernel": "msda_bwd", "site": f"train_{site}", "eager_ms": eager,
                          "graph_ms": graph, "card": card}), flush=True)
        del v, lo, aw, gout
    for k, (path, site, B, Q, shapes) in enumerate(BWD_BF16_SITES):
        vb, lo, aw, gout = bf16_site_inputs(k, site, B, Q, shapes)
        eager = measure.time_ms(lambda: da.ms_deform_attn_bwd_cuda(vb, shapes, lo, aw, gout), 20)
        graph = measure.graph_ms(lambda: da.ms_deform_attn_bwd_cuda(vb, shapes, lo, aw, gout),
                                 20)
        v32 = vb.float()
        f32_graph = measure.graph_ms(
            lambda: da.ms_deform_attn_bwd_cuda(v32, shapes, lo, aw, gout), 20)
        bound_ms, bound_by, _, _ = measure.msda_bwd_bound(vb, shapes, lo, aw)
        print(json.dumps({"kernel": "msda_bwd_bf16", "site": f"{path}_{site}",
                          "B": B, "Q": Q, "shapes": shapes[0], "eager_ms": eager,
                          "graph_ms": graph, "f32_upcast_graph_ms": f32_graph,
                          "bound_ms": bound_ms, "bound_by": bound_by, "card": card}), flush=True)
        del vb, v32, lo, aw, gout
    for N in pmk.NS:
        for K in pmk.KS:
            a, b = pmk.operands(K, N)
            ms = measure.graph_ms(lambda: tc.tc_kdepth_cuda(a, b, pmk.REPS, count=False), 50)
            print(json.dumps({"kernel": "tc_kdepth", "K": K, "N": N, "graph_ms": ms,
                              "card": card}), flush=True)


# The backward kernels' d(value) scatter as it stands in the source, and what
# ``--bwd-split`` puts in its place: plain stores (a wrong result; time only)
# and nothing. One entry per design: the vector reductions (msda_bwd_f32,
# and msda_bwd_bf16 while it shared its template), the earlier
# lane-per-channel fp32 atomics, so that an older checkout's source splits
# too, and msda_bwd_bf16's merged rows.
SCATTERS = (
    ('asm volatile("red.global.add.v4.f32 [%0]', 'asm volatile("st.global.v4.f32 [%0]',
     'if (0) asm volatile("red.global.add.v4.f32 [%0]'),
    ("atomicAdd(grow + d, wc * g[k]);", "grow[d] = wc * g[k];", ";"),
    ('asm volatile("red.relaxed.gpu.global.add.v4.f32 [%0]',
     'asm volatile("st.global.v4.f32 [%0]',
     'if (0) asm volatile("red.relaxed.gpu.global.add.v4.f32 [%0]'),
)
# msda_bwd_bf16's query tile and merge window as the source sets them, and the
# alternatives ``--bwd-split`` also times: name: (query tile, replacements in
# the source); the first is counted too (PERF.md records the choice)
BF16_TILE_TEXT = "constexpr int kTileH = 4;\nconstexpr int kTileW = 8;\nconstexpr int kRoundP = 4;\n" \
                 "constexpr int kWindow = 512;"
BF16_VARIANTS = {
    "tile8x16": ((8, 16), {"kTileH = 4;": "kTileH = 8;", "kTileW = 8;": "kTileW = 16;"}),
    "tile8x8": ((8, 8), {"kTileH = 4;": "kTileH = 8;"}),
    "tile2x16": ((2, 16), {"kTileH = 4;": "kTileH = 2;", "kTileW = 8;": "kTileW = 16;"}),
    "window256": ((4, 8), {"kWindow = 512;": "kWindow = 256;"}),
    "slots8": ((4, 8), {"kSlots = 4 * kRoundTaps;": "kSlots = 8 * kRoundTaps;"}),
}
# the entry point since msda_bwd_bf16 took its own kernels (an fp32 scratch, the
# Q == N flag and the block count); older sources take an fp32 d(value)
BF16_ENTRY = "return launch_bwd_bf16("


def n_tiles(shapes, tile):
    return sum(-(-h // tile[0]) * -(-w // tile[1]) for h, w in shapes)


def bwd_split(source):
    """``--bwd-split [SOURCE]``: the backward kernels' time split into their
    d(value) scatter and the rest. Builds libraries from SOURCE (by default
    this checkout's ms_deform_attn.cu; another checkout's copy splits that
    one's kernels): as it is, with the scatters' atomics turned into plain
    stores, and without the scatters; from a source with msda_bwd_bf16's own
    kernels also its BF16_VARIANTS (other query tiles, merge window, slots)
    and two debug builds (-DMSDA_COUNT_REDS, its own tile and the first
    variant's) that count its vector reductions.
    Times ``msda_bwd_f32`` at the training step's three sites and
    ``msda_bwd_bf16`` at its AMP sites (BWD_BF16_SITES) by CUDA-graph
    replay, the variants in turns (A, B, C, C, B, A); one JSON line per site,
    with the reductions counted at the Q == N sites beside their model
    (measure.msda_bf16_reds) and the one per 4 channels of every tap that
    msda_bwd_f32 sends."""
    import ctypes
    import tempfile
    from pathlib import Path
    from mdqe_cvpr2023_tpu_torch.ops import _build
    from mdqe_cvpr2023_tpu_torch.ops import deform_attn as da
    path = Path(source) if source else _build.CSRC / "ms_deform_attn.cu"
    src = path.read_text()
    found = [sc for sc in SCATTERS if sc[0] in src]
    if not found:
        fail(f"{path} holds no d(value) scatter that --bwd-split knows")
    own_bf16 = BF16_ENTRY in src
    if own_bf16 and BF16_TILE_TEXT not in src:
        fail(f"{path}: msda_bwd_bf16's tile constants are not as BF16_TILE_TEXT has them")
    def variant(changes):
        text = src
        for old, new in changes.items():
            text = text.replace(old, new)
        return text

    variants = {"kernel": (src, []), "stores": (src, []), "no_scatter": (src, [])}
    for sc, stores, nothing in found:
        variants["stores"] = (variants["stores"][0].replace(sc, stores), [])
        variants["no_scatter"] = (variants["no_scatter"][0].replace(sc, nothing), [])
    tiles = {name: da.BF16_TILE for name in variants}
    if own_bf16:
        first = next(iter(BF16_VARIANTS))
        for name, (tile, changes) in BF16_VARIANTS.items():
            variants[name], tiles[name] = (variant(changes), []), tile
        variants["count"], tiles["count"] = (src, ["-DMSDA_COUNT_REDS"]), da.BF16_TILE
        variants[f"count_{first}"] = (variant(BF16_VARIANTS[first][1]), ["-DMSDA_COUNT_REDS"])
        tiles[f"count_{first}"] = BF16_VARIANTS[first][0]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(prefix="bwd_split_", dir=_build.BUILD_DIR))
    procs = {}
    for name, (text, flags) in variants.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc failed for the {name} variant of {path}: {err[-2000:]}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
        libs[name].msda_bwd_f32.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
        libs[name].msda_bwd_bf16.argtypes = ([ptr] * 9 + [i32] * 9 + [ptr] if own_bf16
                                             else [ptr] * 8 + [i32] * 7 + [ptr])
        if name.startswith("count"):
            libs[name].msda_red_count_take.restype = ctypes.c_ulonglong
    card = measure.card()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def check(err, fn):
        if err:
            fail(f"{fn} launch failed ({err})")

    for k, (site, B, Q, H, D, P, shapes, mode) in enumerate(BWD_CHECKS[:3]):
        v, lo, aw, gout = bwd_inputs(torch, B, Q, H, D, P, shapes, mode, seed=300 + k)
        meta = da._level_meta(tuple(shapes), str(v.device))
        gv, gl, ga = torch.zeros_like(v), torch.empty_like(lo), torch.empty_like(aw)
        ptrs = [t.data_ptr() for t in (v, meta, lo, aw, gout, gv, gl, ga)]
        dims = (B, v.shape[1], Q, H, D, len(shapes), P)
        names = [n for n in libs if n in ("kernel", "stores", "no_scatter")]
        ms = {name: [] for name in names}
        for name in names + names[::-1]:
            ms[name].append(measure.graph_ms(
                lambda: check(libs[name].msda_bwd_f32(*ptrs, *dims, stream()), "msda_bwd_f32"),
                20))
        print(json.dumps({"kernel": "msda_bwd_split", "site": f"train_{site}", "graph_ms": ms,
                          "source": str(path), "card": card}), flush=True)
        del v, lo, aw, gout, gv, gl, ga
    for k, (path_, site, B, Q, shapes) in enumerate(BWD_BF16_SITES):
        vb, lo, aw, gout = bf16_site_inputs(k, site, B, Q, shapes)
        H, D, P = vb.shape[2], vb.shape[3], lo.shape[4]
        meta = da._level_meta(tuple(shapes), str(vb.device))
        gl, ga = torch.empty_like(lo), torch.empty_like(aw)
        dims = (B, vb.shape[1], Q, H, D, len(shapes), P)
        tiled = Q == vb.shape[1]
        if own_bf16:
            gv = torch.empty_like(vb)
            work = torch.empty(vb.shape, dtype=torch.float32, device=vb.device)  # either path
            ptrs = [t.data_ptr() for t in (vb, meta, lo, aw, gout, gv, gl, ga, work)]

            def launch(lib, tile):
                blocks = (n_tiles(shapes, tile) if tiled
                          else len(da.bwd_bf16_plan(tuple(shapes), False)))
                check(lib.msda_bwd_bf16(*ptrs, *dims, int(tiled), blocks, stream()),
                      "msda_bwd_bf16")
        else:
            gv = torch.zeros(vb.shape, dtype=torch.float32, device=vb.device)
            ptrs = [t.data_ptr() for t in (vb, meta, lo, aw, gout, gv, gl, ga)]

            def launch(lib, tile):
                check(lib.msda_bwd_bf16(*ptrs, *dims, stream()), "msda_bwd_bf16")
        names = [n for n in libs if not n.startswith("count")]
        ms = {name: [] for name in names}
        for name in names + names[::-1]:
            ms[name].append(measure.graph_ms(lambda: launch(libs[name], tiles[name]), 20))
        row = {"kernel": "msda_bwd_bf16_split", "site": f"{path_}_{site}",
               "shapes": shapes[0], "graph_ms": ms}
        if own_bf16 and tiled:
            reds = {}
            for name in (n for n in libs if n.startswith("count")):
                libs[name].msda_red_count_take()
                launch(libs[name], tiles[name])
                reds[name] = int(libs[name].msda_red_count_take())
                reds[f"model_{name[6:] or 'own'}"], reds["per_tap"] = measure.msda_bf16_reds(
                    vb, shapes, lo, tiles[name])
            row["reds"] = reds
        print(json.dumps({**row, "source": str(path), "card": card}), flush=True)
        del vb, lo, aw, gout, gv, gl, ga


def vis_full_width(da, card, cfg, inf, n_frames, H, W, seed=0):
    """``inference_vis`` at full width on a synthetic video of ``n_frames``
    HxW frames, random weights from ``seed``: a warm-up run, a timed run with
    stage timers (clips/s, host seconds per stage, peak memory, launches per
    call site, all > 0), then the crowded tracker (gates off, threshold 0:
    the tracker fills to max_num_instances). Returns the timed run's
    launches."""
    from mdqe_cvpr2023_tpu_torch.models import meta
    from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel
    from mdqe_cvpr2023_tpu_torch.tools.profile_vis import crowded
    t0 = time.perf_counter()
    model = MDQEModel(cfg, device="cuda", seed=seed)
    print(f"model ({cfg.backbone}) built on the card in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters)")
    video = np.random.default_rng(0).integers(0, 255, (n_frames, H, W, 3)).astype(np.uint8)
    frames, _ = meta.preprocess_frames(video)
    print(f"video {n_frames}x{H}x{W} padded to {frames.shape[1:3]}; levels "
          f"{meta.spatial_shapes_for(cfg, frames.shape[1:3])}", flush=True)
    t0 = time.perf_counter()
    meta.inference_vis(model, inf, frames, (H, W), (H, W))
    torch.cuda.synchronize()
    print(f"warm-up run {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    timers = {}
    da.reset_launches()
    t0 = time.perf_counter()
    out = meta.inference_vis(model, inf, frames, (H, W), (H, W), timers=timers)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(da.LAUNCHES)
    n_clips = (n_frames - inf.n_frames_test) // inf.clip_stride + 1
    stages = {k: round(v, 4) for k, v in timers.items() if not k.endswith("_n")}
    print(f"timed run {wall:.3f} s, {n_clips} clips -> {n_clips / wall:.3f} clips/s "
          f"({card})")
    print(f"stage host seconds (each ends in synchronize): {json.dumps(stages)}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches per call site: {json.dumps(launches)}")
    print(f"tracks {out['num_tracks']}, outputs {len(out['pred_scores'])}, "
          f"top scores {[round(s, 4) for s in out['pred_scores'][:5]]}", flush=True)
    for site, n in launches.items():
        if n == 0:
            fail(f"the main path never launched the kernel at {site}")
    check_outputs(out, n_frames, (H, W), cfg.num_classes)

    # Random weights make near-identical detections, which the reference gates
    # (0.99 dedup, repeat suppression) collapse to a few tracks. With the gates
    # off and threshold 0 the tracker fills to max_num_instances, so the
    # occupancy-dependent work (assignment, finalize) is exercised too.
    crowd = crowded(inf)
    meta.inference_vis(model, crowd, frames, (H, W), (H, W))
    crowd_timers = {}
    t0 = time.perf_counter()
    out_c = meta.inference_vis(model, crowd, frames, (H, W), (H, W),
                               timers=crowd_timers)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    print(f"crowded tracker: {out_c['num_tracks']} tracks, {wall_c:.3f} s -> "
          f"{n_clips / wall_c:.3f} clips/s; stage host seconds "
          f"{json.dumps({k: round(v, 4) for k, v in crowd_timers.items() if not k.endswith('_n')})}",
          flush=True)
    check_outputs(out_c, n_frames, (H, W), cfg.num_classes)
    del model
    torch.cuda.empty_cache()
    return launches


def vis_small_card_vs_cpu(da, tiny):
    """``inference_vis`` of a small video (9 frames of 60x62) with the tiny
    configuration ``tiny`` on the card and on the port's CPU path, fp32
    encode: the same tracks and labels, scores within 5e-3, mask IoU >= 0.99;
    every call site launched on the card."""
    from mdqe_cvpr2023_tpu_torch.models import meta
    from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel
    tiny_inf = meta.InferenceCfg(clip_stride=2, n_frames_test=2, n_frames_window_test=4,
                                 max_num_instances=20, apply_cls_thres=0.05,
                                 clip_topk=8, encode_chunk=2, num_classes=tiny.num_classes,
                                 bf16_encode=False)
    hw = (60, 62)
    small = np.random.default_rng(1).integers(0, 255, (9,) + hw + (3,)).astype(np.uint8)
    small_frames, _ = meta.preprocess_frames(small)
    m_gpu = MDQEModel(tiny, device="cuda", seed=3)
    m_cpu = MDQEModel(tiny, device="cpu", seed=3)
    da.reset_launches()
    got = meta.inference_vis(m_gpu, tiny_inf, small_frames, hw, hw)
    if min(da.LAUNCHES.values()) == 0:
        fail(f"small run did not reach every kernel call site: {da.LAUNCHES}")
    want = meta.inference_vis(m_cpu, tiny_inf, small_frames, hw, hw, device="cpu")
    check_outputs(got, 9, hw, tiny.num_classes)
    ious = [np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1)
            for a, b in zip(got["pred_masks"], want["pred_masks"])]
    score_err = float(np.max(np.abs(np.subtract(got["pred_scores"], want["pred_scores"])))) \
        if len(got["pred_scores"]) == len(want["pred_scores"]) else float("inf")
    print(f"{tiny.backbone}: tracks {got['num_tracks']} vs {want['num_tracks']}, outputs "
          f"{len(got['pred_scores'])} vs {len(want['pred_scores'])}, max|score err| "
          f"{score_err:.2e}, min mask IoU {min(ious) if ious else 1.0:.4f}", flush=True)
    if (got["num_tracks"] != want["num_tracks"] or got["pred_labels"] != want["pred_labels"]
            or score_err > 5e-3 or (ious and min(ious) < 0.99)):
        fail("the card's output disagrees with the CPU path on the small input")
    del m_gpu, m_cpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Swin-L: the three paths at full width, the kernel at their call shapes
# ---------------------------------------------------------------------------

# a tiny Swin for the card-vs-CPU checks: 4 stages (strides 8 / 16 / 32 as
# Swin-L's), embed 32, heads 2-4-8-16, window 4
SWIN_TINY = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16), window_size=4)
SWINL_VIS_HW = (480, 854)  # configs/swinl_ovis.yaml's test size of a 16:9 video


def swin_tiny_cfg(n_frames, num_classes):
    from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModelCfg
    from mdqe_cvpr2023_tpu_torch.models.swin import SwinCfg
    return MDQEModelCfg(backbone="swin_tiny", swin=SwinCfg(**SWIN_TINY),
                        num_classes=num_classes, hidden_dim=64, n_heads=4, enc_layers=1,
                        dec_layers=1, n_frames=n_frames, n_query=16, query_embed_dim=8,
                        window_inter_frame_asso=5, dec_temporal=True)


@contextlib.contextmanager
def recorded_sites(da):
    """While active, the forward and backward kernels' call shapes per site,
    as {"fwd": {site: Counter(key)}, "bwd": ...} with key (B, Q, H, D, P,
    shapes, value type): the shapes the main path gives each kernel."""
    seen = {"fwd": {}, "bwd": {}}
    fwd, bwd = da.ms_deform_attn_cuda, da.ms_deform_attn_bwd_cuda

    def record(kind, site, value, shapes, loc):
        if site is not None:
            B, _, H, D = value.shape
            key = (B, loc.shape[1], H, D, loc.shape[4],
                   tuple((int(h), int(w)) for h, w in shapes), str(value.dtype)[6:])
            seen[kind].setdefault(site, collections.Counter())[key] += 1

    def fwd_spy(value, shapes, loc, attw, site=None):
        record("fwd", site, value, shapes, loc)
        return fwd(value, shapes, loc, attw, site)

    def bwd_spy(value, shapes, loc, attw, gout, site=None):
        record("bwd", site, value, shapes, loc)
        return bwd(value, shapes, loc, attw, gout, site)

    da.ms_deform_attn_cuda, da.ms_deform_attn_bwd_cuda = fwd_spy, bwd_spy
    try:
        yield seen
    finally:
        da.ms_deform_attn_cuda, da.ms_deform_attn_bwd_cuda = fwd, bwd


def site_inputs(site, key, seed, grad=False):
    """Inputs of the kernel at a recorded call shape: encoder-like locations
    (each query's pixel centre plus offsets) at the encoder, uniform ones at
    the decoder sites; with ``grad`` an output gradient too (fp32)."""
    B, Q, H, D, P, shapes, vdt = key
    mode = "local" if site == "encoder" else "uniform"
    if grad:
        return bwd_inputs(torch, B, Q, H, D, P, shapes, mode, seed)
    return make_inputs(torch, B, Q, H, D, P, shapes, mode, getattr(torch, vdt), seed)


def _weighted(rows):
    """Launch-weighted means of the per-shape timings of one site."""
    n = sum(c for c, _ in rows)
    out = {k: sum(c * t[k] for c, t in rows) / n
           for k in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")}
    out["bound_by"] = max(rows, key=lambda r: r[0])[1]["bound_by"]
    return out


def swin_fwd_sites(da, path, seen, card):
    """The forward kernel at every call shape ``seen`` on a Swin-L path,
    against its plain version (1e-4 with an fp32 value, 1e-3 with bf16, as at
    the R50 shapes) and timed (CUDA events, wrapper included; CUDA-graph
    replay) beside the plain version, the grid_sample form and the bound.
    Returns max |err| and the launch-weighted timings per site."""
    errs, timings = {}, {}
    for i, (site, keys) in enumerate(sorted(seen.items())):
        rows = []
        for j, (key, count) in enumerate(keys.most_common()):
            B, Q, H, D, P, shapes, vdt = key
            v, lo, aw = site_inputs(site, key, seed=500 + 10 * i + j)
            got = da.ms_deform_attn_cuda(v, shapes, lo, aw)
            want = da.ms_deform_attn_plain(v, shapes, lo, aw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            tol = 1e-3 if vdt == "bfloat16" else 1e-4
            errs[site] = max(errs.get(site, 0.0), err)
            if not (err <= tol and bool(torch.isfinite(got).all())):
                fail(f"forward kernel disagrees with its plain version at {path} {site} "
                     f"{key}: {err:.2e}")
            t = dict(ms=measure.time_ms(lambda: da.ms_deform_attn_cuda(v, shapes, lo, aw), 20),
                     device_ms=measure.graph_ms(
                         lambda: da.ms_deform_attn_cuda(v, shapes, lo, aw), 20),
                     plain_ms=measure.time_ms(
                         lambda: da.ms_deform_attn_plain(v, shapes, lo, aw), 2),
                     library_ms=measure.time_ms(
                         lambda: measure.grid_sample_msda(v, shapes, lo, aw), 2))
            t["bound_ms"], t["bound_by"], nbytes = measure.msda_bound(v, shapes, lo, aw)
            rows.append((count, t))
            print(f"{path} fwd {site:12s} B={B} Q={Q} H={H} D={D} P={P} L={len(shapes)} "
                  f"{shapes[0][0]}x{shapes[0][1]}.. {vdt}: {count} launches | max|err| "
                  f"{err:.2e} (tol {tol:.0e}) | kernel {t['ms']:.4f} ms (graph replay "
                  f"{t['device_ms']:.4f} ms) | plain {t['plain_ms']:.3f} ms | grid_sample "
                  f"form {t['library_ms']:.3f} ms | bound {t['bound_ms'] * 1e3:.1f} us by "
                  f"{t['bound_by']} ({nbytes / 1e6:.1f} MB) ({card})", flush=True)
            del got, want, v, lo, aw
        timings[site] = _weighted(rows)
    return errs, timings


def swin_bwd_sites(da, seen, card, path="swinl_train"):
    """The backward kernel at every call shape of a training step (the
    Swin-L one unless ``path`` names another),
    against autograd of the plain version (1e-4 of each gradient's largest
    entry, at least 1e-4, as at the R50 shapes), timed (eager with its zeroed
    d(value), and graph replay) beside the plain backward, the grid_sample
    form's backward and the bound. Returns max |err| and the timings per
    site."""
    errs, timings = {}, {}
    for i, (site, keys) in enumerate(sorted(seen.items())):
        rows = []
        for j, (key, count) in enumerate(keys.most_common()):
            B, Q, H, D, P, shapes, _ = key
            v, lo, aw, gout = site_inputs(site, key, seed=600 + 10 * i + j, grad=True)
            got = da.ms_deform_attn_bwd_cuda(v, shapes, lo, aw, gout)
            leaves, out, want = grads_of(
                torch, lambda a, b, c: da.ms_deform_attn_plain(a, shapes, b, c),
                v, lo, aw, gout, retain=True)
            torch.cuda.synchronize()
            worst = 0.0
            for name, g, w in zip(("value", "loc", "attw"), got, want):
                err = float((g - w).abs().max())
                tol = 1e-4 * max(1.0, float(w.abs().max()))
                worst = max(worst, err)
                if not (err <= tol and bool(torch.isfinite(g).all())):
                    fail(f"backward kernel disagrees with autograd of the plain version at "
                         f"{path} {site} {key}: d{name} {err:.2e} (tol {tol:.1e})")
            errs[site] = max(errs.get(site, 0.0), worst)
            del got, want
            t = dict(ms=measure.time_ms(
                         lambda: da.ms_deform_attn_bwd_cuda(v, shapes, lo, aw, gout), 10),
                     device_ms=measure.graph_ms(
                         lambda: da.ms_deform_attn_bwd_cuda(v, shapes, lo, aw, gout), 10),
                     plain_ms=measure.time_ms(lambda: torch.autograd.grad(
                         out, leaves, gout, retain_graph=True), 2))
            del out, leaves
            leaves, out, _ = grads_of(
                torch, lambda a, b, c: measure.grid_sample_msda(a, shapes, b, c),
                v, lo, aw, gout, retain=True)
            t["library_ms"] = measure.time_ms(lambda: torch.autograd.grad(
                out, leaves, gout, retain_graph=True), 2)
            del out, leaves
            t["bound_ms"], t["bound_by"], nbytes, _ = measure.msda_bwd_bound(v, shapes, lo, aw)
            rows.append((count, t))
            print(f"{path} bwd {site:12s} B={B} Q={Q} L={len(shapes)} "
                  f"{shapes[0][0]}x{shapes[0][1]}..: {count} launches | max|err| {worst:.2e} | "
                  f"kernel {t['ms']:.4f} ms (graph replay {t['device_ms']:.4f} ms) | plain "
                  f"backward {t['plain_ms']:.3f} ms | grid_sample form backward "
                  f"{t['library_ms']:.3f} ms | bound {t['bound_ms'] * 1e3:.1f} us by "
                  f"{t['bound_by']} ({nbytes / 1e6:.1f} MB) ({card})", flush=True)
            del v, lo, aw, gout
        timings[site] = _weighted(rows)
    return errs, timings


def check_bwd_bf16(da, label, vb, shapes, lo, aw, gout):
    """msda_bwd_bf16 (through its wrapper: the tiled kernel where Q == N)
    against its oracle, autograd of the plain version on f64 copies of the
    same bf16 value, locations, weights and output gradient, with the bounds
    bf16_sites states; prints one line after ``label`` and fails on a
    mismatch. Returns the largest error."""
    got = da.ms_deform_attn_bwd_cuda(vb, shapes, lo, aw, gout)
    _, _, plain = grads_of(torch, lambda a, b, c: da.ms_deform_attn_plain(a, shapes, b, c),
                           vb, lo, aw, gout)
    _, _, oracle = grads_of(
        torch, lambda a, b, c: da.ms_deform_attn_plain(a, shapes, b, c),
        vb.double(), lo.double(), aw.double(), gout.double())
    torch.cuda.synchronize()
    scale = float(oracle[0].abs().max())
    err = float((got[0].double() - oracle[0]).abs().max())
    err_plain = float((plain[0].double() - oracle[0]).abs().max())
    ok = (got[0].dtype == torch.bfloat16 and err <= 2.0 ** -8 * scale
          and err <= err_plain and bool(torch.isfinite(got[0]).all()))
    msgs = [f"dvalue bf16 {err:.2e} (plain bf16 {err_plain:.2e}, tol {2.0 ** -8 * scale:.1e}"
            f" and no larger than plain)"]
    worst = err
    for name, g, w, o in zip(("loc", "attw"), got[1:], plain[1:], oracle[1:]):
        e = float((g - w).abs().max())
        tol = 1e-4 * max(1.0, float(w.abs().max()))
        msgs.append(f"d{name} {e:.2e} (tol {tol:.1e}; from f64 "
                    f"{float((g.double() - o).abs().max()):.2e})")
        ok = ok and e <= tol and bool(torch.isfinite(g).all())
        worst = max(worst, e)
    print(f"{label} max|err| {', '.join(msgs)} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"msda_bwd_bf16 disagrees with its oracle at {label}")
    return worst


# msda_bwd_bf16's other checks against its oracle: BWD_CHECKS' odd rows (the
# decoder sites' kernels), Q == N problems whose levels are no multiple of the
# 4x8 query tile (tail tiles; D = 16 / 48, odd P), and a crowded input:
# name, B, H, D, P, level shapes, loc mode (Q == N unless the row gives Q)
BWD_BF16_CASES = [
    *((f"odd_q{Q}", B, H, D, P, shapes, mode, Q)
      for site, B, Q, H, D, P, shapes, mode in BWD_CHECKS if site == "odd"),
    ("tail_tiles", 2, 8, 32, 4, ((13, 21), (7, 11), (3, 5)), "local", None),
    ("tail_tiles_d16_p3", 3, 3, 16, 3, ((10, 6), (7, 13), (3, 5)), "far", None),
    ("tail_tiles_d48_p5", 2, 2, 48, 5, ((9, 4), (2, 11), (5, 9)), "local", None),
    ("crowded", 2, 8, 32, 4, TRAIN_SHAPES, "crowded", None),
]


def bf16_cases(da):
    """BWD_BF16_CASES through check_bwd_bf16. The crowded input: every query
    of a level samples inside one 2x2 patch of it (the middle pixel and its
    right and lower neighbours), so each of those rows sums Q * P taps of a
    (b, head), 34016 at the training encoder's levels, about 10^4 and more."""
    errs = {}
    for k, (name, B, H, D, P, shapes, mode, Q) in enumerate(BWD_BF16_CASES):
        Q = Q or sum(h * w for h, w in shapes)
        v, lo, aw, gout = bwd_inputs(torch, B, Q, H, D, P, shapes,
                                     "uniform" if mode == "crowded" else mode, seed=900 + k)
        if mode == "crowded":
            u = np.random.default_rng(950 + k).uniform(0.05, 0.95, tuple(lo.shape))
            size = np.array([[w, h] for h, w in shapes], dtype=np.float64)  # (L, 2): x, y
            mid = size // 2
            lo = torch.from_numpy(((mid[:, None] + u + 0.5) / size[:, None]).astype(np.float32)
                                  ).to(lo.device)
        errs[name] = check_bwd_bf16(
            da, f"bf16 case {name:18s} B={B} Q={Q} H={H} D={D} P={P} L={len(shapes)} {mode}:",
            v.bfloat16(), shapes, lo, aw, gout)
    return errs


def bf16_sites(da, path, seen, card):
    """The kernels the AMP step runs, at every call shape ``seen`` ({site:
    Counter(key)}, keys as ``recorded_sites`` makes them) with a bf16 value:
    the forward (msda_fwd_bf16) against its plain version (1e-3, as at the
    bf16 inference shapes) and msda_bwd_bf16 against its oracle
    (check_bwd_bf16): autograd of the plain version on f64 copies of the
    same bf16 value, locations, weights and output gradient. d(value): the
    kernel sums in fp32 and rounds once, so its error must be within one bf16
    step of the largest entry (2^-8 of it) and no larger than the plain
    version's in bf16 (its index backward sums in bf16). d(loc) and
    d(weights), fp32, against the plain version on the same bf16 value (fp32
    arithmetic that picks the kernel's corners; the f64 oracle picks others
    where a location's product sits on a pixel boundary, and its distance is
    printed), 1e-4 of the largest entry as for fp32. Each timed (CUDA events,
    wrapper included: for the backward at Q == N its zeroed fp32 scratch and
    the cast; and CUDA-graph replay) beside
    msda_bwd_f32 on the fp32 upcast (graph replay), the plain version, the
    grid_sample form and the bound. Returns the forward's and the backward's
    max |err| and launch-weighted timings per site."""
    errs = {"fwd": {}, "bwd": {}}
    rows = {"fwd": {}, "bwd": {}}
    for i, (site, keys) in enumerate(sorted(seen.items())):
        for j, (key, count) in enumerate(keys.most_common()):
            B, Q, H, D, P, shapes, _ = key
            v, lo, aw, gout = site_inputs(site, key, seed=700 + 10 * i + j, grad=True)
            vb = v.bfloat16()
            del v
            got = da.ms_deform_attn_cuda(vb, shapes, lo, aw)
            want = da.ms_deform_attn_plain(vb, shapes, lo, aw)
            torch.cuda.synchronize()
            f_err = float((got - want).abs().max())
            if not (f_err <= 1e-3 and bool(torch.isfinite(got).all())):
                fail(f"msda_fwd_bf16 disagrees with its plain version at {path} {site} {key}")
            errs["fwd"][site] = max(errs["fwd"].get(site, 0.0), f_err)
            del got, want
            errs["bwd"][site] = max(errs["bwd"].get(site, 0.0), check_bwd_bf16(
                da, f"{path} bwd bf16 {site:12s} B={B} Q={Q} H={H} D={D} P={P} L={len(shapes)} "
                f"{shapes[0][0]}x{shapes[0][1]}..: {count} launches |", vb, shapes, lo, aw, gout))
            tf = dict(ms=measure.time_ms(lambda: da.ms_deform_attn_cuda(vb, shapes, lo, aw), 20),
                      device_ms=measure.graph_ms(
                          lambda: da.ms_deform_attn_cuda(vb, shapes, lo, aw), 20),
                      plain_ms=measure.time_ms(
                          lambda: da.ms_deform_attn_plain(vb, shapes, lo, aw), 2),
                      library_ms=measure.time_ms(
                          lambda: measure.grid_sample_msda(vb, shapes, lo, aw), 2))
            tf["bound_ms"], tf["bound_by"], f_bytes = measure.msda_bound(vb, shapes, lo, aw)
            rows["fwd"].setdefault(site, []).append((count, tf))
            tb = dict(ms=measure.time_ms(
                          lambda: da.ms_deform_attn_bwd_cuda(vb, shapes, lo, aw, gout), 10),
                      device_ms=measure.graph_ms(
                          lambda: da.ms_deform_attn_bwd_cuda(vb, shapes, lo, aw, gout), 10))
            v32 = vb.float()
            f32_ms = measure.graph_ms(
                lambda: da.ms_deform_attn_bwd_cuda(v32, shapes, lo, aw, gout), 10)
            del v32
            leaves, out, _ = grads_of(
                torch, lambda a, b, c: da.ms_deform_attn_plain(a, shapes, b, c),
                vb, lo, aw, gout, retain=True)
            tb["plain_ms"] = measure.time_ms(lambda: torch.autograd.grad(
                out, leaves, gout, retain_graph=True), 2)
            del out, leaves
            leaves, out, _ = grads_of(
                torch, lambda a, b, c: measure.grid_sample_msda(a, shapes, b, c),
                vb, lo, aw, gout, retain=True)
            tb["library_ms"] = measure.time_ms(lambda: torch.autograd.grad(
                out, leaves, gout, retain_graph=True), 2)
            del out, leaves
            tb["bound_ms"], tb["bound_by"], b_bytes, _ = measure.msda_bwd_bound(
                vb, shapes, lo, aw)
            rows["bwd"].setdefault(site, []).append((count, tb))
            print(f"{path} bf16 {site:12s}: fwd kernel {tf['ms']:.4f} ms (graph replay "
                  f"{tf['device_ms']:.4f} ms) | plain {tf['plain_ms']:.3f} ms | grid_sample form "
                  f"{tf['library_ms']:.3f} ms | bound {tf['bound_ms'] * 1e3:.1f} us by "
                  f"{tf['bound_by']} ({f_bytes / 1e6:.1f} MB); bwd kernel {tb['ms']:.4f} ms "
                  f"(graph replay {tb['device_ms']:.4f} ms; msda_bwd_f32 on the fp32 upcast "
                  f"{f32_ms:.4f} ms) | plain backward {tb['plain_ms']:.3f} ms | grid_sample "
                  f"form backward {tb['library_ms']:.3f} ms | bound {tb['bound_ms'] * 1e3:.1f} "
                  f"us by {tb['bound_by']} ({b_bytes / 1e6:.1f} MB) ({card})", flush=True)
            del vb, lo, aw, gout
    return (errs["fwd"], errs["bwd"], {s_: _weighted(r) for s_, r in rows["fwd"].items()},
            {s_: _weighted(r) for s_, r in rows["bwd"].items()})


AMP_TRAIN_ITERS, AMP_TOTAL_ITERS = 3, 4


def amp_trainer(card):
    """``train_net --config-file configs/R50_ovis_360.yaml SOLVER.AMP.ENABLED
    True`` at full width with the cuts of TRAINER_CUTS: AMP_TRAIN_ITERS
    iterations with 2 loader threads, a checkpoint and ``test``; then a
    second process resumed from it to AMP_TOTAL_ITERS and ``test``. Holds the
    launches (the forward and msda_bwd_bf16 at every step, msda_bwd_f32
    never), finite losses, fp32 parameters and AdamW moments in the
    checkpoint, and an exact resume (iteration, step count). Returns the
    launches per call site: training forward, bf16 backward, the first test's
    forward."""
    tmp = tempfile.mkdtemp(prefix="mdqe_amp_trainer_")
    try:
        write_ovis_dataset(tmp, (360, 640), train_frames=(24, 30), dev_frames=36,
                           num_classes=25, seed=3)
        cuts = TRAINER_CUTS + [("SOLVER.AMP.ENABLED", "True", "the mixed-precision step")]
        print("reduced: " + "; ".join(f"{k} {v} ({why})" for k, v, why in cuts), flush=True)
        out = os.path.join(tmp, "out")
        opts = [x for k, v, _ in cuts for x in (k, v)] + ["OUTPUT_DIR", out]
        common = ["--config-file", "configs/R50_ovis_360.yaml", "--datasets-root", tmp,
                  "--max-videos", "1", "--log-every", "1"]
        run_train_net(common + ["--max-iter", str(AMP_TRAIN_ITERS)] + opts, out)
        first = os.path.join(out, f"ckpt_{AMP_TRAIN_ITERS:07d}.pth")
        rows = run_train_net(common + ["--resume", first, "--max-iter",
                                       str(AMP_TOTAL_ITERS)] + opts, out)
        train = [r for r in rows if "test" not in r]
        tests = [r for r in rows if "test" in r]
        if ([r["iteration"] for r in train] != list(range(1, AMP_TOTAL_ITERS + 1))
                or [r["iteration"] for r in tests] != [AMP_TRAIN_ITERS, AMP_TOTAL_ITERS]):
            fail(f"AMP metrics rows {[(r['iteration'], 'test' in r) for r in rows]}")
        launches = {d: {s_: sum(r["msda_launches"][d][s_] for r in train)
                        for s_ in train[0]["msda_launches"]["fwd"]}
                    for d in ("fwd", "bwd", "bwd_bf16")}
        t = tests[0]
        print(f"AMP Trainer ({card}): s/iter {[round(r['sec_per_iter'], 4) for r in train]}, "
              f"data_wait_frac {[round(r['data_wait_frac'], 4) for r in train]}, losses "
              f"{[round(r['total_loss'], 4) for r in train]}, peak device memory "
              f"{max(r['max_mem_gib'] for r in rows):.2f} GiB; launches in "
              f"{AMP_TOTAL_ITERS} steps {json.dumps(launches)}; test: {t['clips']} clips, "
              f"{t['predictions']} predictions, {t['clips_per_s']:.3f} clips/s, AP "
              f"{t['AP']:.4f}, launches {json.dumps(t['msda_launches'])}", flush=True)
        want = {k: AMP_TOTAL_ITERS * v
                for k, v in expected_train_launches(trainer_model_cfg()).items()}
        if (launches["fwd"] != want or launches["bwd_bf16"] != want
                or any(launches["bwd"].values())):
            fail(f"AMP trainer launches {launches}, want {want} forward and msda_bwd_bf16")
        for tr in tests:
            if min(tr["msda_launches"]["fwd"].values()) == 0 or any(
                    n for d in ("bwd", "bwd_bf16") for n in tr["msda_launches"][d].values()):
                fail(f"AMP test launches {tr['msda_launches']}")
        if not all(np.isfinite(r["total_loss"]) for r in train) or not all(
                np.isfinite(tr["AP"]) and 0.0 <= tr["AP"] <= 100.0 for tr in tests):
            fail("non-finite AMP training loss or AP out of [0, 100]")
        for it in (AMP_TRAIN_ITERS, AMP_TOTAL_ITERS):
            ck = torch.load(os.path.join(out, f"ckpt_{it:07d}.pth"), map_location="cpu",
                            weights_only=True)
            dtypes = {str(v.dtype) for v in ck["model"].values() if v.is_floating_point()}
            dtypes |= {str(m.dtype) for st in ck["optimizer"]["state"].values()
                       for k, m in st.items() if k in ("exp_avg", "exp_avg_sq")}
            steps = {float(st["step"]) for st in ck["optimizer"]["state"].values()}
            print(f"AMP checkpoint {it}: iteration {ck['iteration']}, step_count "
                  f"{ck['step_count']}, AdamW steps {sorted(steps)}, floating types "
                  f"{sorted(dtypes)}", flush=True)
            if (ck["iteration"] != it or ck["step_count"] != it or steps != {float(it)}
                    or dtypes != {"torch.float32"}):
                fail(f"AMP checkpoint {it}: {ck['iteration']}, {ck['step_count']}, {steps}, "
                     f"{dtypes}")
        return launches["fwd"], launches["bwd_bf16"], t["msda_launches"]["fwd"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the Swin-L Trainer's cuts: those of TRAINER_CUTS (one card, the repository's
# data, random weights) on configs/swinl_ovis.yaml
SWIN_TRAINER_CUTS = [
    cut if cut[0] != "SOLVER.IMS_PER_BATCH" else
    (cut[0], cut[1], "8 clips of 2 frames at up to 736x1024 do not fit one card: the "
     "step of 2 clips peaks at 50.8 GiB on an 80 GB H100") for cut in TRAINER_CUTS]
SWIN_TRAINER_ITERS = 2


def swin_trainer(card):
    """``train_net --config-file configs/swinl_ovis.yaml`` at full width with
    the cuts of SWIN_TRAINER_CUTS: SWIN_TRAINER_ITERS iterations with 2
    loader threads on a synthetic OVIS dataset of 360x640 frames (resized to
    the 608 / 736 x 1024 buckets), a checkpoint, then ``test`` on the
    36-frame dev video (resized to 480x853). Returns the launches per call
    site: training forward, backward, test forward."""
    from mdqe_cvpr2023_tpu_torch.engine.build import build_model_cfg
    from mdqe_cvpr2023_tpu_torch.engine.config import load_config
    config = "configs/swinl_ovis.yaml"
    tmp = tempfile.mkdtemp(prefix="mdqe_swin_trainer_")
    try:
        write_ovis_dataset(tmp, (360, 640), train_frames=(24, 30), dev_frames=36,
                           num_classes=25, seed=2)
        print("reduced: " + "; ".join(f"{k} {v} ({why})" for k, v, why in SWIN_TRAINER_CUTS),
              flush=True)
        out = os.path.join(tmp, "out")
        opts = [x for k, v, _ in SWIN_TRAINER_CUTS for x in (k, v)] + ["OUTPUT_DIR", out]
        rows = run_train_net(["--config-file", config, "--datasets-root", tmp,
                              "--max-videos", "1", "--log-every", "1", "--max-iter",
                              str(SWIN_TRAINER_ITERS)] + opts, out)
        train = [r for r in rows if "test" not in r]
        tests = [r for r in rows if "test" in r]
        if [r["iteration"] for r in train] != list(range(1, SWIN_TRAINER_ITERS + 1)) \
                or len(tests) != 1:
            fail(f"metrics rows {[(r['iteration'], 'test' in r) for r in rows]}")
        fwd = {s: sum(r["msda_launches"]["fwd"][s] for r in train)
               for s in train[0]["msda_launches"]["fwd"]}
        bwd = {s: sum(r["msda_launches"]["bwd"][s] for r in train) for s in fwd}
        test_fwd = tests[0]["msda_launches"]["fwd"]
        t = tests[0]
        print(f"Swin-L Trainer ({card}): s/iter {[round(r['sec_per_iter'], 4) for r in train]}, "
              f"data_wait_frac {[round(r['data_wait_frac'], 4) for r in train]}, losses "
              f"{[round(r['total_loss'], 4) for r in train]}, peak device memory "
              f"{max(r['max_mem_gib'] for r in rows):.2f} GiB; launches forward "
              f"{json.dumps(fwd)}, backward {json.dumps(bwd)}; test: {t['clips']} clips, "
              f"{t['predictions']} predictions, {t['clips_per_s']:.3f} clips/s, RLE "
              f"{t['rle_s']:.4f} s, evaluate {t['evaluate_s']:.4f} s, AP {t['AP']:.4f}, "
              f"launches {json.dumps(test_fwd)}", flush=True)
        want = {k: SWIN_TRAINER_ITERS * v for k, v in
                expected_train_launches(build_model_cfg(load_config(config, opts))).items()}
        if fwd != want or bwd != want:
            fail(f"Swin-L trainer launches {fwd} / {bwd}, want {want} each")
        if min(test_fwd.values()) == 0 or any(t["msda_launches"]["bwd"].values()):
            fail(f"Swin-L test launches {t['msda_launches']}")
        if not all(np.isfinite(r["total_loss"]) for r in train) or not (
                np.isfinite(t["AP"]) and 0.0 <= t["AP"] <= 100.0):
            fail("non-finite Swin-L training loss or AP out of [0, 100]")
        return fwd, bwd, test_fwd
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def swin_paths(da, card):
    """Swin-L through the port's three paths at full width, each driven with
    the launch counts set to 0 just before it and read just after, the
    kernels' call shapes recorded; the small Swin checks against the CPU
    path; the Trainer; then the kernels at the recorded shapes. Returns the
    kernels line's Swin-L entries."""
    from mdqe_cvpr2023_tpu_torch import configs
    phase(f"main path: Swin-L inference_vis at full width ({card})")
    with recorded_sites(da) as vis_seen:
        vis_launches = vis_full_width(da, card, configs.SWINL_OVIS, configs.SWINL_OVIS_INF,
                                      36, *SWINL_VIS_HW)
    phase("small Swin input: the card's VIS path against the port's CPU path")
    vis_small_card_vs_cpu(da, swin_tiny_cfg(2, 5))

    phase(f"main path: Swin-L COCO image inference at full width ({card})")
    with recorded_sites(da) as coco_seen:
        coco_launches = coco_full_width(da, card, swin=True, n_images=1)

    phase(f"main path: the Swin-L training step at full width ({card})")
    with recorded_sites(da) as train_seen:
        train_fwd, train_bwd, fp32_first = train_full_width(torch, da, card, swin=True)
    phase(f"main path: the Swin-L AMP training step at full width ({card})")
    with recorded_sites(da) as amp_seen:
        amp_fwd, amp_bwd, _ = train_full_width(torch, da, card, swin=True, amp=True,
                                               fp32_losses=fp32_first)
    phase("tiny Swin training step: the card's path against the port's CPU path")
    tiny_train_card_vs_cpu(torch, swin_tiny_cfg(2, 5))

    phase(f"main path: the Swin-L Trainer at full width ({card})")
    trainer_fwd, trainer_bwd, trainer_test = swin_trainer(card)

    phase(f"forward kernel at the Swin-L call shapes ({card})")
    entries = []
    for path, seen, launches in (("swinl_vis", vis_seen, vis_launches),
                                 ("swinl_coco", coco_seen, coco_launches),
                                 ("swinl_train", train_seen, train_fwd)):
        errs, timings = swin_fwd_sites(da, path, seen["fwd"], card)
        for site, t in timings.items():
            line = 569 if site == "encoder" and path != "swinl_train" else 121
            entries.append(kernel_entry(f"ms_deform_attn_fwd[{site},{path}]", SOURCE,
                                        f"{PALLAS}:{line}", launches[site], errs[site], t))
            if path == "swinl_train":
                entries.append(kernel_entry(f"ms_deform_attn_fwd[{site},swinl_trainer]",
                                            SOURCE, f"{PALLAS}:{line}", trainer_fwd[site],
                                            errs[site], t))
            if path == "swinl_vis":
                entries.append(kernel_entry(f"ms_deform_attn_fwd[{site},swinl_trainer_test]",
                                            SOURCE, f"{PALLAS}:{line}", trainer_test[site],
                                            errs[site], t))
    phase(f"backward kernel at the Swin-L training call shapes ({card})")
    errs, timings = swin_bwd_sites(da, train_seen["bwd"], card)
    for site, t in timings.items():
        entries.append(kernel_entry(f"ms_deform_attn_bwd[{site},swinl_train]", SOURCE,
                                    BWD_REPLACES, train_bwd[site], errs[site], t))
        entries.append(kernel_entry(f"ms_deform_attn_bwd[{site},swinl_trainer]", SOURCE,
                                    BWD_REPLACES, trainer_bwd[site], errs[site], t))
    phase(f"bf16 kernels at the Swin-L AMP training call shapes ({card})")
    f_err, b_err, f_t, b_t = bf16_sites(da, "swinl_train_amp", amp_seen["bwd"], card)
    for site, t in b_t.items():
        entries.append(kernel_entry(f"ms_deform_attn_fwd[{site},swinl_train_amp]", SOURCE,
                                    f"{PALLAS}:121", amp_fwd[site], f_err[site], f_t[site]))
        entries.append(kernel_entry(f"ms_deform_attn_bwd_bf16[{site},swinl_train_amp]",
                                    SOURCE, BWD_BF16_REPLACES, amp_bwd[site], b_err[site], t))
    return entries


# ---------------------------------------------------------------------------
# 6d. data parallelism: ranks as subprocesses, the frame-sharded encode
# ---------------------------------------------------------------------------

RANK_TIMEOUT_S = 300


def start_ranks(args, n):
    """Start ``python -m torch.distributed.run --nproc_per_node n args`` from
    the checkout on 127.0.0.1 (a free port); ``run_ranks`` waits for it."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n),
           "--master_addr", "127.0.0.1", "--master_port", str(port), *args]
    print("$ " + " ".join(cmd), flush=True)
    return subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def run_ranks(args, n, expect_fail=False, proc=None):
    """Wait for ``proc`` (or start the ranks first), killed at
    RANK_TIMEOUT_S; a non-zero exit or a timeout fails the run (unless
    ``expect_fail``: then a zero exit does). Returns the output."""
    t0 = time.perf_counter()
    proc = proc or start_ranks(args, n)
    try:
        out = proc.communicate(timeout=RANK_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        print(proc.communicate()[0][-6000:], flush=True)
        fail(f"{n} ranks timed out after {RANK_TIMEOUT_S} s")
    if (proc.returncode != 0) != expect_fail:
        print(out[-6000:], flush=True)
        fail(f"{n} ranks exited with {proc.returncode}")
    print(f"{n} ranks: waited {time.perf_counter() - t0:.1f} s for them", flush=True)
    return out


def _update_quantiles(state, ref_state, trainable, lr):
    """|state - ref_state| / lr over the trainable entries: q90, q99, q99.9,
    max; and the frozen entries' largest difference."""
    diffs = np.concatenate([(state[k].double() - ref_state[k].double()).abs().flatten()
                            .numpy() for k in state if k in trainable]) / lr
    frozen = max(float((state[k].double() - ref_state[k].double()).abs().max())
                 for k in state if k not in trainable)
    return (*np.quantile(diffs, [0.9, 0.99, 0.999]), float(diffs.max())), frozen


def _step_checks(name, reports, ref, ref_state, world, amp_noise=None):
    """Each rank's report of a case against the one-process step on the same
    global batch, from the same weights. fp32 (``amp_noise`` None): the first
    step's all-reduced total and every loss rtol 1e-4, rank 0's parameters
    after it within the update bounds of tiny_train_card_vs_cpu (99% within
    0.01 lr, 99.9% within 0.05 lr, all within lr). AMP: a rank's bf16
    products over one clip round otherwise than the one process's over two
    (other cuDNN and cuBLAS algorithms at another batch), and a rounding can
    flip an argmax (the query selection), so the first step is held as the
    tiny AMP step is (the total within 1e-2, the loss vector within 5e-2 of
    its norm), and the parameters after it to ``amp_noise``, the distance
    between the one-process AMP and fp32 steps (q90 and q99 no larger, all
    within 2.1 lr). Both: frozen leaves equal; the ranks bit-equal after the
    last step; 6 / 6 / 24 launches a step of the forward and of the case's
    backward kernel (msda_bwd_bf16 under AMP), none of the other. Returns
    rank 0's launches over its steps."""
    from mdqe_cvpr2023_tpu_torch.parallel import train as ptrain
    want_s = ref["steps"][0]
    keys = sorted(want_s["losses"])
    b = np.array([want_s["losses"][k] for k in keys])
    worst, worst_key, vec, tot = 0.0, None, 0.0, 0.0
    for r in reports:
        s0 = r["steps"][0]
        a = np.array([s0["losses"][k] for k in keys])
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-12)
        if rel.max() > worst:
            worst, worst_key = float(rel.max()), keys[int(rel.argmax())]
        vec = max(vec, float(np.linalg.norm(a - b) / np.linalg.norm(b)))
        tot = max(tot, abs(s0["total"] - want_s["total"]) / abs(want_s["total"]))
    state = torch.load(reports[0]["step1_path"], map_location="cpu", weights_only=True)
    (q90, q99, q999, dmax), frozen = _update_quantiles(state, ref_state, ref["trainable"],
                                                       ptrain.TrainCfg().base_lr)
    amp = amp_noise is not None
    bwd_kind, other = ("bwd_bf16", "bwd") if amp else ("bwd", "bwd_bf16")
    per_step = expected_train_launches(ptrain.TRAIN_CFG)
    launches = {d: {s_: sum(st["launches"][d][s_] for st in reports[0]["steps"])
                    for s_ in per_step} for d in ("fwd", "bwd", "bwd_bf16")}
    for r in reports:
        for st in r["steps"]:
            if (st["launches"]["fwd"] != per_step or st["launches"][bwd_kind] != per_step
                    or any(st["launches"][other].values())):
                fail(f"{name}: rank {r['rank']} launches {st['launches']}, want {per_step}")
    same = len({r["sha256_final"] for r in reports}) == 1
    print(f"{name}: {world} ranks of {reports[0]['clips']} clip(s) against one process on "
          f"{ref['clips']}: first step total rel err {tot:.2e}, loss vector rel distance "
          f"{vec:.2e}, worst loss rel err {worst:.2e} ({worst_key}) (tol "
          f"{'1e-2 / 5e-2' if amp else '1e-4 each'}); after it |dparam|/lr q90 {q90:.2e} "
          f"q99 {q99:.2e} q99.9 {q999:.2e} max {dmax:.3f}"
          + (f" (one-process AMP against fp32: q90 {amp_noise[0]:.2e} q99 "
             f"{amp_noise[1]:.2e} max {amp_noise[3]:.3f})" if amp else "")
          + f", frozen max diff {frozen:.1e}; ranks bit-equal after "
          f"{len(reports[0]['steps'])} steps: {same} "
          f"({', '.join(r['sha256_final'][:12] for r in reports)})", flush=True)
    for r in reports:
        print(f"  rank {r['rank']} ({r['backend']}, {r['device']}): s/step "
              f"{[round(st['s'], 4) for st in r['steps']]}, gradient all-reduce "
              f"{r['steps'][0]['allreduce_bytes'] / 2 ** 20:.1f} MiB a step in "
              f"{[round(st['allreduce_s'], 4) for st in r['steps']]} s, peak "
              f"{r.get('peak_mem_gib', float('nan')):.2f} GiB, totals "
              f"{[round(st['total'], 5) for st in r['steps']]}", flush=True)
    if amp:
        bad = (tot > 1e-2 or vec > 5e-2 or q90 > amp_noise[0] or q99 > amp_noise[1]
               or dmax > 2.1)
    else:
        bad = worst > 1e-4 or q99 > 0.01 or q999 > 0.05 or dmax > 1.0
    if bad or frozen != 0 or not same:
        fail(f"{name}: the data-parallel step disagrees with the one-process step")
    return launches


def batch_size_witness(device, cfg, crit, batch, pri):
    """Whether the batch's size alone moves the step's losses, with no
    process group: for each clip k of ``batch`` and in fp32 and AMP, the
    loss (dropout 0, no gradient) of clip k alone against that of clip k
    twice. Twice the clip doubles every sum and every count of the
    criterion and leaves its means, so the two are one loss computed at
    batch 1 and at batch 2, as a rank of two and the one process compute
    theirs. Returns {(k, amp): (total rel err, loss vector rel distance,
    worst loss rel err, its key)}."""
    from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel
    from mdqe_cvpr2023_tpu_torch.parallel import train as ptrain
    model = MDQEModel(cfg, device=device, seed=0)
    B = batch["valid"].shape[0]
    full = {**batch, "reid_priorities": pri}
    out = {}
    with torch.no_grad():
        for k in range(B):
            one = ptrain.shard_rows(full, k, B)
            two = {key: np.concatenate([v, v]) for key, v in one.items()}
            for amp in (False, True):
                losses = []
                for rows in (one, two):
                    rows = ptrain.to_device(rows, torch.device(device))
                    p_ = rows.pop("reid_priorities")
                    total, ldict = ptrain.loss_fn(model, crit, rows, None, 0.0, p_, amp=amp)
                    losses.append((float(total), {n: float(v) for n, v in ldict.items()}))
                (t1, l1), (t2, l2) = losses
                keys = sorted(l1)
                a, b = np.array([l2[n] for n in keys]), np.array([l1[n] for n in keys])
                rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-12)
                out[k, amp] = (abs(t2 - t1) / abs(t1),
                               float(np.linalg.norm(a - b) / np.linalg.norm(b)),
                               float(rel.max()), keys[int(rel.argmax())])
    del model
    return out


def ddp_reference(spec, case, trainable, group=None):
    """The case in this process (no group: the one-process step on the whole
    global batch), with the names of the trainable parameters."""
    from mdqe_cvpr2023_tpu_torch.tools import ddp_step
    report, state = ddp_step.run_case(spec, case, "cuda:0", group)
    report["trainable"] = trainable
    torch.cuda.empty_cache()
    return report, state


def ddp_spec(world, tmp):
    """The data-parallel step's cases at full width: ``TRAIN_CFG``, seed-0
    weights, dropout 0, a synthetic global batch of ``world`` clips (one a
    rank) and one draw of its reid priorities, written under ``tmp``; fp32
    and AMP, 3 steps."""
    from mdqe_cvpr2023_tpu_torch.parallel import train as ptrain
    batch = ptrain.synthetic_batch(seed=0, clips=world)
    B, N = batch["valid"].shape
    crit = ptrain.TRAIN_CRIT
    g = torch.Generator().manual_seed(0)
    pri = torch.rand((B, N, 2, crit.n_frames * crit.n_query), generator=g).numpy()
    np.savez(os.path.join(tmp, "batch.npz"), **batch)
    np.save(os.path.join(tmp, "pri.npy"), pri)
    return {"model": dataclasses.asdict(ptrain.TRAIN_CFG),
            "crit": dataclasses.asdict(crit), "train": {}, "state": None,
            "cases": [{"name": name, "batch": os.path.join(tmp, "batch.npz"),
                       "priorities": os.path.join(tmp, "pri.npy"),
                       "amp": name == "ddp_amp", "steps": 3}
                      for name in ("ddp", "ddp_amp")]}


def ddp_references(spec):
    """The one-process first steps of ``spec``'s cases on cuda:0, the
    trainable parameters' names, and the distance between the AMP and fp32
    steps (``_step_checks``' AMP bound)."""
    from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel
    from mdqe_cvpr2023_tpu_torch.parallel import train as ptrain
    model = MDQEModel(ptrain.TRAIN_CFG, device="cpu")
    model.set_trainable(ptrain.TrainCfg().freeze_at)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    del model
    refs = {c["name"]: ddp_reference(spec, dict(c, steps=1), trainable)
            for c in spec["cases"]}
    amp_noise = _update_quantiles(refs["ddp_amp"][1], refs["ddp"][1], trainable,
                                  ptrain.TrainCfg().base_lr)[0]
    return refs, trainable, amp_noise


def ddp_ranks(tag, spec, refs, amp_noise, tmp, n, args):
    """``tools/ddp_step.py`` over ``n`` ranks (with ``args``) on ``spec``,
    each case checked against ``refs`` (``_step_checks``). Returns rank 0's
    launches per case."""
    path, out = os.path.join(tmp, f"spec_{tag}.json"), os.path.join(tmp, tag)
    with open(path, "w") as f:
        json.dump(spec, f)
    run_ranks(["-m", "mdqe_cvpr2023_tpu_torch.tools.ddp_step", "--spec", path, "--out", out,
               *args], n)
    launches = {}
    for c in spec["cases"]:
        reps = [json.load(open(os.path.join(out, f"{c['name']}_rank{r}.json")))
                for r in range(n)]
        reps[0]["step1_path"] = os.path.join(out, f"{c['name']}_step1.pt")
        if [g[0] for g in reps[0]["gathered"]] != list(range(n)):
            fail(f"all_gather_objects gave {reps[0]['gathered']}")
        launches[c["name"]] = _step_checks(f"{c['name']} {tag}", reps, *refs[c["name"]], n,
                                           amp_noise if c["amp"] else None)
    return launches


def ddp_paths(card):
    """The data-parallel step (``tools/ddp_step.py``) at full width
    (``ddp_spec``), fp32 and AMP: two ranks on the one card over gloo
    against the one-process 2-clip step; the same step in a one-rank NCCL
    group against the step without a group; and NCCL asked for with two
    ranks on one card, which must fail with the port's own error. Returns
    rank 0's launches of the gloo run, per case."""
    import torch.distributed as tdist
    tmp = tempfile.mkdtemp(prefix="mdqe_ddp_")
    bad_ranks = None
    try:
        spec = ddp_spec(2, tmp)
        with open(os.path.join(tmp, "spec.json"), "w") as f:
            json.dump(spec, f)
        # NCCL asked for with two ranks on one card: they fail at the start, so
        # they run beside this process's reference steps
        nccl_args = ["-m", "mdqe_cvpr2023_tpu_torch.tools.ddp_step", "--spec",
                     os.path.join(tmp, "spec.json"), "--out", os.path.join(tmp, "x"),
                     "--device", "cuda:0", "--dist-backend", "nccl"]
        bad_ranks = start_ranks(nccl_args, 2)
        refs, trainable, amp_noise = ddp_references(spec)
        # the witness to the AMP bound of _step_checks: the batch's size alone,
        # with no collective, moves the AMP losses and not the fp32 ones
        from mdqe_cvpr2023_tpu_torch.parallel import train as ptrain
        from mdqe_cvpr2023_tpu_torch.tools import ddp_step
        witness = batch_size_witness("cuda:0", ptrain.TRAIN_CFG, ptrain.TRAIN_CRIT,
                                     *ddp_step.case_inputs(spec["cases"][0]))
        torch.cuda.empty_cache()
        for (k, amp), (tot, vec, worst, key) in sorted(witness.items()):
            print(f"batch-size witness, no process group, {'AMP' if amp else 'fp32'}: clip {k} "
                  f"alone against clip {k} twice: total rel err {tot:.2e}, loss vector rel "
                  f"distance {vec:.2e}, worst loss rel err {worst:.2e} ({key})", flush=True)

        # one rank in an NCCL group, in this process: the same step
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                                 world_size=1, device_id=torch.device("cuda", 0))
        try:
            for c in spec["cases"]:
                rep, state = ddp_reference(spec, dict(c, steps=1), trainable,
                                           tdist.group.WORLD)
                path = os.path.join(tmp, f"{c['name']}_nccl1_step1.pt")
                torch.save(state, path)
                rep["step1_path"] = path
                equal = rep["steps"][0]["losses"] == refs[c["name"]][0]["steps"][0]["losses"]
                print(f"one-rank NCCL group ({rep['backend']}): first-step losses bit-equal to "
                      f"the step without a group: {equal}", flush=True)
                _step_checks(f"{c['name']} nccl world 1", [rep], *refs[c["name"]], 1,
                             amp_noise if c["amp"] else None)
        finally:
            tdist.destroy_process_group()

        text = run_ranks(nccl_args, 2, expect_fail=True, proc=bad_ranks)
        if "one rank per card" not in text:
            fail(f"nccl with two ranks on one card did not raise the port's error:\n"
                 f"{text[-3000:]}")
        print("nccl with two ranks on one card raised the port's error (one rank per card)",
              flush=True)

        launches = ddp_ranks("gloo", spec, refs, amp_noise, tmp, 2,
                             ["--device", "cuda:0", "--dist-backend", "gloo"])
        print("(two ranks share one card over gloo: their times measure gloo's host "
              "staging of the gradients, not NCCL)", flush=True)
        return launches
    finally:
        if bad_ranks is not None and bad_ranks.poll() is None:
            bad_ranks.kill()
            bad_ranks.communicate()
        shutil.rmtree(tmp, ignore_errors=True)


def nccl_across_cards():
    """The step of ``ddp_paths`` over NCCL, one rank a card on min(4,
    count) cards (``cuda:<LOCAL_RANK>``), against the one-process step on
    the same global batch of one clip a card; not run on one card."""
    n = min(4, torch.cuda.device_count())
    if n < 2:
        print(f"NCCL across cards: not run: {torch.cuda.device_count()} card", flush=True)
        return
    tmp = tempfile.mkdtemp(prefix="mdqe_nccl_")
    try:
        spec = ddp_spec(n, tmp)
        refs, _, amp_noise = ddp_references(spec)
        ddp_ranks(f"nccl_x{n}", spec, refs, amp_noise, tmp, n, [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _decode_masks(pred):
    from mdqe_cvpr2023_tpu_torch.data import rle
    return np.stack([rle.decode(s) for s in pred["segmentations"]]).astype(bool)


def trainer_ddp(card):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    mdqe_cvpr2023_tpu_torch.train_net --device cuda:0 --dist-backend gloo``
    at full width with the cuts of TRAINER_CUTS (global batch 2: one clip a
    rank), LR 1e-8 and class threshold 0: 3 iterations, one checkpoint (the
    ranks' checksums compared at it), test on 3 dev videos split between the
    ranks and gathered, rank 0 alone writing; then ``--eval-only`` of that
    checkpoint in one process,
    whose predictions and AP the gathered test must equal (the same tracks
    and labels, scores within 5e-3, mask IoU >= 0.99). Returns rank 0's
    launches: training forward, backward, test forward."""
    tmp = tempfile.mkdtemp(prefix="mdqe_trainer_ddp_")
    try:
        write_ovis_dataset(tmp, (360, 640), train_frames=(24, 30), dev_frames=(12, 12, 12),
                           num_classes=25, seed=5)
        out, single = os.path.join(tmp, "out"), os.path.join(tmp, "single")
        # the random weights' masks go blank within a few steps at the
        # config's learning rate, and a blank track is no prediction: at LR
        # 1e-8 the three steps leave the weights near their seed, whose tracks
        # (threshold 0) give the two tests predictions to compare
        opts = [x for k, v, _ in TRAINER_CUTS for x in (k, v)] + [
            "SOLVER.BASE_LR", "1e-8", "MODEL.MDQE.APPLY_CLS_THRES", "0.0"]
        common = ["--config-file", "configs/R50_ovis_360.yaml", "--datasets-root", tmp,
                  "--log-every", "1"]
        text = run_ranks(["-m", "mdqe_cvpr2023_tpu_torch.train_net", *common, "--max-iter",
                          "3", "--device", "cuda:0", "--dist-backend", "gloo", *opts,
                          "OUTPUT_DIR", out], 2)
        print("\n".join(l for l in text.splitlines() if l.startswith(("iter", "saved", "{"))),
              flush=True)
        rows = [json.loads(l) for l in open(os.path.join(out, "metrics.jsonl"))]
        train = [r for r in rows if "total_loss" in r]
        ckpts = sorted(f for f in os.listdir(out) if f.startswith("ckpt_"))
        marks = [r for r in rows if "checkpoint" in r]
        tests = [r for r in rows if "test" in r]
        results = [f for f in os.listdir(out) if f.startswith("results_")]
        if (ckpts != ["ckpt_0000003.pth"] or [r["iteration"] for r in marks] != [3]
                or len(tests) != 1 or results != ["results_ytvis_ovis_dev.json"]
                or [r["iteration"] for r in train] != [1, 2, 3]):
            fail(f"train_net over 2 ranks wrote {ckpts}, {results}, rows "
                 f"{[(r['iteration'], sorted(r)[:3]) for r in rows]}")
        t = tests[0]
        if t["videos_per_rank"] != [[3, 5], [4]] or t["world_size"] != 2:
            fail(f"the test's videos were not split: {t['videos_per_rank']}")
        fwd = {s_: sum(r["msda_launches"]["fwd"][s_] for r in train)
               for s_ in train[0]["msda_launches"]["fwd"]}
        bwd = {s_: sum(r["msda_launches"]["bwd"][s_] for r in train) for s_ in fwd}
        want = {k: 3 * v for k, v in expected_train_launches(trainer_model_cfg()).items()}
        print(f"train_net over 2 ranks on one card ({card}): s/iter "
              f"{[round(r['sec_per_iter'], 4) for r in train]}, all-reduce s "
              f"{[round(r['allreduce_s'], 4) for r in train]}, losses "
              f"{[round(r['total_loss'], 4) for r in train]}, rank 0 peak "
              f"{max(r.get('max_mem_gib', float('nan')) for r in train):.2f} GiB; the "
              f"replicas' checksum at "
              f"the checkpoint {marks[0]['state_sha256'][:16]}; rank 0's launches in 3 steps "
              f"{json.dumps(fwd)} / {json.dumps(bwd)}; test: videos per rank "
              f"{t['videos_per_rank']}, {t['clips']} clips, {t['predictions']} predictions, "
              f"{t['clips_per_s']:.3f} clips/s (both ranks on one card), AP {t['AP']:.4f}",
              flush=True)
        if fwd != want or bwd != want or min(t["msda_launches"]["fwd"].values()) == 0:
            fail(f"train_net over 2 ranks launched {fwd} / {bwd} / {t['msda_launches']}, "
                 f"want {want}")
        run_train_net(common + ["--eval-only", "--resume", os.path.join(out, ckpts[0]),
                                "--device", "cuda:0"] + opts + ["OUTPUT_DIR", single], single)
        got = json.load(open(os.path.join(out, results[0])))
        ref = json.load(open(os.path.join(single, results[0])))
        one = [r for r in (json.loads(l) for l in open(os.path.join(single, "metrics.jsonl")))
               if "test" in r][0]
        same = got == ref
        ok = len(got) == len(ref) and all(
            (a["video_id"], a["category_id"]) == (b["video_id"], b["category_id"])
            and abs(a["score"] - b["score"]) <= 5e-3 for a, b in zip(got, ref))
        ious = [1.0]
        if ok and not same:
            for a, b in zip(got, ref):
                ma, mb = _decode_masks(a), _decode_masks(b)
                union = np.logical_or(ma, mb).sum()
                ious.append(np.logical_and(ma, mb).sum() / union if union else 1.0)
        print(f"gathered test against one process's --eval-only of the checkpoint: "
              f"{len(got)} vs {len(ref)} predictions, identical {same}, min mask IoU "
              f"{min(ious):.4f}, AP {t['AP']:.4f} vs {one['AP']:.4f}", flush=True)
        if not got or not ok or min(ious) < 0.99 or (same and t["AP"] != one["AP"]) or (
                abs(t["AP"] - one["AP"]) > 0.5):
            fail("the two-rank test disagrees with the one-process test")
        return fwd, bwd, t["msda_launches"]["fwd"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def vis_sharded(da, card, cfg, inf, n_frames=36, H=360, W=640):
    """``inference_vis`` with the window encode sharded by frames over
    ``["cuda:0", "cuda:0"]`` (every card where there are several) against
    ``devices=None``, on vis_full_width's video (36 frames of 360x640): the
    same tracks and labels, scores within 5e-3, mask IoU >= 0.99; clips/s
    of both. Returns the sharded run's launches and the encoder's call
    shapes (each device's share)."""
    from mdqe_cvpr2023_tpu_torch.models import meta
    from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel
    n = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(n)] if n > 1 else ["cuda:0", "cuda:0"]
    model = MDQEModel(cfg, device="cuda:0", seed=0)
    video = np.random.default_rng(0).integers(0, 255, (n_frames, H, W, 3)).astype(np.uint8)
    frames, _ = meta.preprocess_frames(video)
    n_clips = (n_frames - inf.n_frames_test) // inf.clip_stride + 1
    outs, rates, stages, first = {}, {}, {}, {}
    for name, devs in (("unsharded", None), ("sharded", devices)):
        first[name] = {}
        meta.inference_vis(model, inf, frames, (H, W), (H, W), device="cuda:0",
                           devices=devs, timers=first[name])
        da.reset_launches()
        with recorded_sites(da) as seen:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = meta.inference_vis(model, inf, frames, (H, W), (H, W),
                                            device="cuda:0", devices=devs)
            torch.cuda.synchronize()
            rates[name] = n_clips / (time.perf_counter() - t0)
        launches = dict(da.LAUNCHES)
        stages[name] = {}
        meta.inference_vis(model, inf, frames, (H, W), (H, W), device="cuda:0",
                           devices=devs, timers=stages[name])
        print(f"{name}: first call's encode_weights {first[name]['encode_weights']:.4f} s "
              f"(the sharded run builds the other devices' copies there); a later call's "
              f"stage host seconds (each ends in a synchronize) "
              f"{json.dumps({k: round(v, 4) for k, v in stages[name].items() if not k.endswith('_n')})}",
              flush=True)
    got, want = outs["sharded"], outs["unsharded"]
    check_outputs(got, n_frames, (H, W), cfg.num_classes)
    ious = [np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1)
            for a, b in zip(got["pred_masks"], want["pred_masks"])]
    score_err = float(np.max(np.abs(np.subtract(got["pred_scores"], want["pred_scores"])))) \
        if len(got["pred_scores"]) == len(want["pred_scores"]) else float("inf")
    print(f"frame-sharded inference_vis over {devices} ({card}): {rates['sharded']:.3f} "
          f"clips/s against {rates['unsharded']:.3f} unsharded; tracks {got['num_tracks']} "
          f"vs {want['num_tracks']}, max|score err| {score_err:.2e}, min mask IoU "
          f"{min(ious) if ious else 1.0:.4f}; launches {json.dumps(launches)}; encoder call "
          f"shapes {dict(seen['fwd'].get('encoder', {}))}", flush=True)
    if (got["num_tracks"] != want["num_tracks"] or got["pred_labels"] != want["pred_labels"]
            or score_err > 5e-3 or (ious and min(ious) < 0.99) or min(launches.values()) == 0):
        fail("the frame-sharded inference_vis disagrees with the unsharded run")
    del model
    torch.cuda.empty_cache()
    return launches, {"encoder": seen["fwd"]["encoder"]}


def rank_sites(world):
    """The training step's call shapes on one rank of ``world`` (each holds
    1 / world of TRAIN_CFG's 2-clip batch): BWD_CHECKS' training rows with B
    divided by ``world``."""
    return {site: collections.Counter({(B // world, Q, H, D, P, shapes, "float32"): 1})
            for site, B, Q, H, D, P, shapes, _ in BWD_CHECKS[:3]}


def ddp_entries(da, card, ddp_launches, trainer_launches, vis, vis_timings, vis_err):
    """Phase 6d's kernels-line entries: the kernels at one rank's call shapes
    (fp32, and bf16 for the AMP step) and at the sharded encoder's, each
    against its plain version and timed, with rank 0's launches."""
    entries = []
    seen = rank_sites(2)
    f_err, f_t = swin_fwd_sites(da, "ddp", seen, card)
    b_err, b_t = swin_bwd_sites(da, seen, card, path="ddp")
    a_ferr, a_berr, a_ft, a_bt = bf16_sites(da, "ddp_amp", seen, card)
    t_fwd, t_bwd, t_test = trainer_launches
    for site in f_t:
        for path, fwd_n, bwd_n in (("ddp", ddp_launches["ddp"]["fwd"],
                                    ddp_launches["ddp"]["bwd"]),
                                   ("trainer_ddp", t_fwd, t_bwd)):
            entries.append(kernel_entry(f"ms_deform_attn_fwd[{site},{path}]", SOURCE,
                                        f"{PALLAS}:121", fwd_n[site], f_err[site], f_t[site]))
            entries.append(kernel_entry(f"ms_deform_attn_bwd[{site},{path}]", SOURCE,
                                        BWD_REPLACES, bwd_n[site], b_err[site], b_t[site]))
        entries.append(kernel_entry(f"ms_deform_attn_fwd[{site},ddp_amp]", SOURCE,
                                    f"{PALLAS}:121", ddp_launches["ddp_amp"]["fwd"][site],
                                    a_ferr[site], a_ft[site]))
        entries.append(kernel_entry(f"ms_deform_attn_bwd_bf16[{site},ddp_amp]", SOURCE,
                                    BWD_BF16_REPLACES, ddp_launches["ddp_amp"]["bwd_bf16"][site],
                                    a_berr[site], a_bt[site]))
    vis_launches, enc_seen = vis
    e_err, e_t = swin_fwd_sites(da, "vis_sharded", enc_seen, card)
    for site, t in vis_timings.items():
        entries.append(kernel_entry(f"ms_deform_attn_fwd[{site},trainer_ddp_test]", SOURCE,
                                    t["replaces"], t_test[site], vis_err[site], t))
        t_, err = (e_t[site], e_err[site]) if site == "encoder" else (t, vis_err[site])
        entries.append(kernel_entry(f"ms_deform_attn_fwd[{site},vis_sharded]", SOURCE,
                                    t["replaces"], vis_launches[site], err, t_))
    return entries


# ---------------------------------------------------------------------------
# 6e. the demos, the host tracker and the model tools
# ---------------------------------------------------------------------------

# where phase 6e runs; its subprocesses get it as --device
DEMO_DEVICE = "cuda:0"
# the random weights' class scores (the focal prior, about 0.01) fall below
# every threshold: at 0 the videos keep tracks and the images detections
DEMO_OPTS = ["MODEL.MDQE.APPLY_CLS_THRES", "0.0"]
DEMO_VIDEOS, DEMO_FRAMES, DEMO_HW = 2, 36, (360, 640)
CLIP_IMAGES, CLIP_HW = 3, (480, 640)
ANALYZE_SIZE = ("384", "640")  # analyze_model's FLOP count: frames of 384x640
# the host tracker's stream at the VIS path's shapes: 36 frames, 4-frame
# clips, 30-frame windows, stride 1, K = clip_topk 32, M = 120, masks at
# stride 4 of 360x640, embedding 256, 25 classes; a pool of 160 instances
TRACK = dict(frames=36, T=4, window=30, K=32, M=120, hw=(90, 160), C=256, classes=25,
             pool=160)
MODULE_TIMEOUT_S = 600


def run_module(module, args):
    """``python -m <module> args`` from the checkout with a timeout; fails
    on a non-zero exit. Returns (its standard output, its wall seconds)."""
    cmd = [sys.executable, "-m", module, *args]
    print("$ " + " ".join(cmd), flush=True)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=MODULE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"{module} timed out after {MODULE_TIMEOUT_S} s")
    if proc.returncode != 0:
        print(proc.stdout[-6000:], proc.stderr[-6000:], file=sys.stderr, flush=True)
        fail(f"{module} exited with {proc.returncode}")
    took = time.perf_counter() - t0
    print(f"{module} took {took:.1f} s", flush=True)
    return proc.stdout, took


def json_lines(text):
    return [json.loads(l) for l in text.splitlines() if l.startswith("{")]


def write_demo_images(root, n, hw, seed):
    """``n`` synthetic images of ``hw`` (ellipses moving over noise: image t
    is frame t of a video) as PNG files under ``root`` (OpenCV); returns the
    paths."""
    import cv2
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W]
    objs = [(rng.uniform(0.2, 0.8, 2) * (H, W), rng.uniform(0.06, 0.2, 2) * (H, W),
             rng.uniform(-0.01, 0.01, 2) * (H, W), rng.integers(60, 255, 3)) for _ in range(5)]
    paths = []
    for t in range(n):
        img = rng.integers(0, 50, (H, W, 3)).astype(np.uint8)
        for c, r, v, col in objs:
            cy, cx = np.clip(c + t * v, r, (H, W) - r)
            img[((yy - cy) / r[0]) ** 2 + ((xx - cx) / r[1]) ** 2 <= 1.0] = col
        paths.append(os.path.join(root, f"f{t:03d}.png"))
        cv2.imwrite(paths[-1], img[:, :, ::-1])
    return paths


def vis_launches(inf, cfg, n_frames):
    """The forward kernel's launches per call site in ``inference_vis`` of an
    ``n_frames`` video: each window encoded ``encode_chunk`` frames at a time,
    its clips decoded 8 at a time."""
    T, W, s = inf.n_frames_test, inf.n_frames_window_test, inf.clip_stride
    chunks = groups = in_window = wend = 0
    for start in range(0, n_frames, s):
        if min(start + T, n_frames) > wend:
            wend = min(start + W, n_frames)
            chunks += -(-(wend - start) // inf.encode_chunk)
            in_window = 0
        groups += in_window % 8 == 0
        in_window += 1
        if start + T >= n_frames:
            break
    return {"encoder": cfg.enc_layers * chunks, "decoder_box": cfg.dec_layers * groups,
            "decoder_inst": cfg.dec_layers * cfg.n_feature_levels * groups}


def image_launches(cfg):
    return {"encoder": cfg.enc_layers, "decoder_box": cfg.dec_layers,
            "decoder_inst": cfg.dec_layers * cfg.n_feature_levels}


def vis_agree(got, want):
    """(max |score err|, min mask IoU) of two inference_vis outputs, or None
    where the tracks or labels differ."""
    if len(got["pred_scores"]) != len(want["pred_scores"]) \
            or list(got["pred_labels"]) != list(want["pred_labels"]):
        return None
    err = max([abs(a - b) for a, b in zip(got["pred_scores"], want["pred_scores"])] or [0.0])
    ious = [np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1)
            for a, b in zip(got["pred_masks"], want["pred_masks"])]
    return err, min(ious or [1.0])


def vis_key(site):
    """VIS_SITES[site] as a recorded call shape (recorded_sites' key)."""
    B, Q, H, D, P, shapes, _, vdt, _ = VIS_SITES[site]
    return (B, Q, H, D, P, shapes, str(vdt)[6:])


def demo_trainer(config, tmp, datasets_root=None):
    """The Trainer a demo builds from ``config`` with DEMO_OPTS (seed 0)."""
    from mdqe_cvpr2023_tpu_torch.engine.config import load_config
    from mdqe_cvpr2023_tpu_torch.engine.trainer import Trainer
    cfg = load_config(config, DEMO_OPTS + ["OUTPUT_DIR", os.path.join(tmp, "ref")])
    return Trainer(cfg, datasets_root=datasets_root, device=DEMO_DEVICE)


def video_demo(da, card, tmp, trainer):
    """``python -m mdqe_cvpr2023_tpu_torch.demo.demo`` on DEMO_VIDEOS synthetic
    videos (directories of PNG frames) with DEMO_OPTS: an mp4 of DEMO_FRAMES
    frames of DEMO_HW each; each video's tracks equal to ``inference_vis``
    in this process on the same resized frames (``trainer``'s model, the
    demo's seed: the same tracks and labels, scores within 5e-3, mask IoU >=
    0.99); each video's launches ``vis_launches``. Returns (the launches of
    all videos, the call shapes of this process's runs, the demo's last
    line)."""
    import cv2
    from mdqe_cvpr2023_tpu_torch.data import rle
    from mdqe_cvpr2023_tpu_torch.data.image import resize_image, size_for_test
    from mdqe_cvpr2023_tpu_torch.demo.demo import read_frames
    from mdqe_cvpr2023_tpu_torch.models import meta
    dirs = [os.path.join(tmp, f"video{k}") for k in range(DEMO_VIDEOS)]
    for k, d in enumerate(dirs):
        write_demo_images(d, DEMO_FRAMES, DEMO_HW, seed=20 + k)
    out_dir = os.path.join(tmp, "demo_out")
    text, proc_s = run_module("mdqe_cvpr2023_tpu_torch.demo.demo", [
        "--config-file", "configs/R50_ovis_360.yaml", "--input", *dirs, "--output", out_dir,
        "--device", DEMO_DEVICE, "--confidence-threshold", "0", *DEMO_OPTS])
    lines = json_lines(text)
    for line in lines:
        print(json.dumps(line), flush=True)
    videos, run = lines[:-1], lines[-1]
    if len(videos) != DEMO_VIDEOS or run.get("videos") != DEMO_VIDEOS:
        fail(f"the video demo printed {lines}")
    inf = trainer.inf_cfg
    want_launches = vis_launches(inf, trainer.model_cfg, DEMO_FRAMES)
    total, direct_s = collections.Counter(), []
    with recorded_sites(da) as seen:
        for d, line in zip(dirs, videos):
            name = os.path.basename(d)
            cap = cv2.VideoCapture(os.path.join(out_dir, f"{name}.mp4"))
            n_read, shapes = 0, set()
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                n_read += 1
                shapes.add(frame.shape[:2])
            cap.release()
            if n_read != DEMO_FRAMES or shapes != {DEMO_HW}:
                fail(f"{name}.mp4 holds {n_read} frames of {shapes}, want {DEMO_FRAMES} of "
                     f"{DEMO_HW}")
            if line["video"] != name or line["msda_launches"] != want_launches:
                fail(f"the demo launched {line['msda_launches']} for {line['video']}, want "
                     f"{want_launches} for {name}")
            total.update(line["msda_launches"])
            frames = read_frames(d)
            t0 = time.perf_counter()  # the work of the demo's predict, with no renderer beside it
            th, tw = size_for_test(*DEMO_HW, trainer.cfg.INPUT.MIN_SIZE_TEST,
                                   trainer.cfg.INPUT.MAX_SIZE_TEST)
            proc, _ = meta.preprocess_frames(np.stack([resize_image(f, th, tw) for f in frames]))
            want = meta.inference_vis(trainer.model, inf, proc, (th, tw), DEMO_HW,
                                      pixel_mean=tuple(trainer.cfg.MODEL.PIXEL_MEAN),
                                      pixel_std=tuple(trainer.cfg.MODEL.PIXEL_STD),
                                      device=DEMO_DEVICE)
            direct_s.append(time.perf_counter() - t0)
            saved = json.load(open(os.path.join(out_dir, f"{name}.json")))
            got = {"pred_scores": [r["score"] for r in saved],
                   "pred_labels": [r["category_id"] - 1 for r in saved],
                   "pred_masks": [np.stack([rle.decode(s) for s in r["segmentations"]]
                                           ).astype(bool) for r in saved]}
            res = vis_agree(got, want)
            print(f"{name}: the demo's {line['tracks']} tracks against inference_vis here: "
                  f"{len(want['pred_scores'])}; max|score err|, min mask IoU {res}", flush=True)
            if line["tracks"] != len(want["pred_scores"]) or res is None or res[0] > 5e-3 \
                    or res[1] < 0.99 or not got["pred_scores"]:
                fail(f"the video demo's tracks of {name} disagree with inference_vis")
    busy = sum(run[f"{k}_s"] for k in ("read", "infer", "render", "json"))

    def each(key):
        return [round(v[key], 4) for v in videos]

    print(f"video demo ({card}): {run['videos_per_s']:.4f} videos/s ({run['wall_s']:.3f} s "
          f"wall for {run['videos']}, from the first read); the process {proc_s:.1f} s: "
          f"setup (imports, Trainer) {run['setup_s']:.3f}, the videos {run['wall_s']:.3f}, "
          f"the rest (interpreter start, exit) {proc_s - run['main_s']:.3f}", flush=True)
    print(f"video demo, host s a video: read {each('read_s')}, inference {each('infer_s')}, "
          f"render {each('render_s')}, json {each('json_s')}; spans from the first read: "
          f"inference {[[round(t, 3) for t in v['infer_at']] for v in videos]}, render "
          f"{[[round(t, 3) for t in v['render_at']] for v in videos]}", flush=True)
    print(f"video demo, AsyncPredictor: inference beside the main thread's work "
          f"{run['infer_hidden_s']:.4f} of {run['infer_s']:.4f} s, inside rendering "
          f"{run['infer_in_render_s']:.4f} s ({run['infer_in_render_s'] / run['render_s']:.4f} "
          f"of render time); wall {run['wall_s']:.3f} = busy {busy:.3f} - hidden "
          f"{run['infer_hidden_s']:.3f} + idle {run['wall_s'] - busy + run['infer_hidden_s']:.3f}",
          flush=True)
    print(f"video demo, contention: video 1's inference beside video 0's render "
          f"{videos[1]['infer_s']:.4f} s against the same work alone in this process "
          f"{direct_s[1]:.4f} s (video 0 here {direct_s[0]:.4f}); render of video 0 (beside "
          f"inference) {videos[0]['render_s']:.4f} s, of video 1 (alone) "
          f"{videos[1]['render_s']:.4f} s", flush=True)
    return dict(total), seen["fwd"], run


def clip_demo_paths(da, card, tmp, trainer):
    """``python -m mdqe_cvpr2023_tpu_torch.demo.clip_demo`` on CLIP_IMAGES
    synthetic images, with ``--no-aug`` and with the seeded augmentation: a
    ``_vis.jpg`` an image; each image's detections equal to
    ``inference_image`` in this process on the same pseudo-clip
    (``match_detections``); each image's launches ``image_launches``.
    Returns (the launches of all images, the call shapes here, s/image)."""
    from mdqe_cvpr2023_tpu_torch.data import rle
    from mdqe_cvpr2023_tpu_torch.data.image import read_image
    from mdqe_cvpr2023_tpu_torch.demo import clip_demo
    from mdqe_cvpr2023_tpu_torch.models import meta
    cfg = trainer.cfg
    paths = write_demo_images(os.path.join(tmp, "images"), CLIP_IMAGES, CLIP_HW, seed=30)
    want_launches = image_launches(trainer.model_cfg)
    total, per_image = collections.Counter(), []
    with recorded_sites(da) as seen:
        for aug in (False, True):
            out_dir = os.path.join(tmp, f"clip_out_{'aug' if aug else 'noaug'}")
            text, proc_s = run_module("mdqe_cvpr2023_tpu_torch.demo.clip_demo", [
                "--config-file", "configs/R50_coco.yaml", "--input", *paths, "--output",
                out_dir, "--device", DEMO_DEVICE, "--confidence-threshold", "0",
                *([] if aug else ["--no-aug"]), *DEMO_OPTS])
            *lines, run = json_lines(text)
            if len(lines) != len(paths) or run.get("images") != len(paths):
                fail(f"the clip demo printed {len(lines)} image lines for {len(paths)} images")
            rest = run["main_s"] - sum(run[k] for k in ("setup_s", "infer_s", "draw_s", "json_s"))
            print(f"clip demo ({'aug' if aug else 'no aug'}, {card}): the process {proc_s:.1f} "
                  f"s: setup (imports, Trainer) {run['setup_s']:.3f}, inference "
                  f"{run['infer_s']:.3f}, drawing {run['draw_s']:.3f}, json {run['json_s']:.3f}, "
                  f"the rest of main {rest:.3f}, outside main (interpreter start, exit) "
                  f"{proc_s - run['main_s']:.3f}", flush=True)
            rng = np.random.default_rng(0)
            pipe = clip_demo.clip_pipeline(cfg, not aug)
            for path, line in zip(paths, lines):
                print(json.dumps(line), flush=True)
                name = os.path.splitext(os.path.basename(path))[0]
                vis = os.path.join(out_dir, f"{name}_vis.jpg")
                if not os.path.exists(vis) or not os.path.getsize(vis):
                    fail(f"the clip demo wrote no {name}_vis.jpg")
                if line["msda_launches"] != want_launches:
                    fail(f"the clip demo launched {line['msda_launches']} for {name}, want "
                         f"{want_launches}")
                total.update(line["msda_launches"])
                per_image.append(line["infer_s"])
                batch, size = clip_demo.pseudo_clip(pipe, rng, read_image(path),
                                                    cfg.INPUT.SAMPLING_FRAME_NUM)
                want = meta.inference_image(trainer.model, trainer.inf_cfg, batch, size, CLIP_HW,
                                            pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
                                            pixel_std=tuple(cfg.MODEL.PIXEL_STD),
                                            device=DEMO_DEVICE)
                saved = json.load(open(os.path.join(out_dir, f"{name}.json")))
                got = {"scores": saved["scores"], "classes": saved["classes"],
                       "boxes": np.asarray(saved["boxes"], np.float32).reshape(-1, 4),
                       "masks": [rle.decode(m).astype(bool) for m in saved["masks"]]}
                res = match_detections(got, want)
                print(f"{name} ({'aug' if aug else 'no aug'}, {list(size)}): the demo's "
                      f"{len(got['scores'])} detections against inference_image here; "
                      f"max|score err|, min mask IoU {res}", flush=True)
                if res is None or not got["scores"] or list(size) != line["size"]:
                    fail(f"the clip demo's detections of {name} disagree with inference_image")
    s_img = float(np.mean(per_image))
    print(f"clip demo ({card}): {s_img:.4f} s/image (inference host s "
          f"{[round(s, 4) for s in per_image]})", flush=True)
    return dict(total), seen["fwd"], s_img


def tracker_stream(seed):
    """TRACK's clip stream, numpy: a persistent pool of instances (separated
    boxes, distinct embeddings), each clip a random subset of it with noise
    (tests/test_device_tracker.py's stream at full width). Yields
    (frame_idx, scores, cls_probs, masks, embeds, valid, is_output,
    is_last), windows as ``inference_vis`` closes them."""
    K, T, (H, W), C, KC = TRACK["K"], TRACK["T"], TRACK["hw"], TRACK["C"], TRACK["classes"]
    rng = np.random.default_rng(seed)
    n_pool, cols = TRACK["pool"], 16
    pool_embeds = rng.standard_normal((n_pool, C)).astype(np.float32)
    pool_embeds *= 6.0 / np.linalg.norm(pool_embeds, axis=1, keepdims=True)
    bh, bw = H // (n_pool // cols), W // cols
    n_clips = TRACK["frames"] - T + 1
    saved = 0
    for ci in range(n_clips):
        n = int(rng.integers(K // 2, K))
        take = rng.choice(n_pool, size=n, replace=False)
        masks = np.full((K, T, H, W), -8.0, np.float32)
        embeds = np.zeros((K, C), np.float32)
        for i, p in enumerate(take):
            y, x = (p // cols) * bh, (p % cols) * bw
            masks[i, :, y:y + bh - 1, x:x + bw - 1] = 8.0
            masks[i] += rng.standard_normal((T, H, W)).astype(np.float32) * 0.2
            embeds[i] = pool_embeds[p] + rng.standard_normal(C).astype(np.float32) * 0.05
        scores = np.sort(rng.random(K).astype(np.float32))[::-1].copy()
        cls_probs = rng.random((K, KC)).astype(np.float32)
        last = ci == n_clips - 1
        out = ci + 1 >= TRACK["window"] * (saved + 1)
        saved += out and not last
        yield (list(range(ci, ci + T)), scores, cls_probs, masks, embeds, np.arange(K) < n,
               out, last)


def host_tracker(card):
    """The port's OverTracker with its mask memory on the card against the
    device tracker (tracker_step / tracker_window_output) and against the
    OverTracker on the CPU, on TRACK's stream: the same matched IDs every
    clip; at every window output class averages within 1e-5 and equal packed
    masks. Returns the host ms a clip of each."""
    from mdqe_cvpr2023_tpu_torch.tracking import ClipResults, OverTracker
    from mdqe_cvpr2023_tpu_torch.tracking import device_tracker as dt
    M, hw = TRACK["M"], TRACK["hw"]
    kw = dict(num_max_inst=M, num_frames=TRACK["T"], window_frames=TRACK["window"],
              clip_stride=1, num_classes=TRACK["classes"], embed_dim=TRACK["C"],
              apply_cls_thres=0.05)
    dev = torch.device(DEMO_DEVICE)
    host = {DEMO_DEVICE: OverTracker(**kw, mask_size=hw, device=dev),
            "cpu": OverTracker(**kw, mask_size=hw, device="cpu")}
    cfg = dt.TrackerCfg(**kw, mask_hw=hw)
    state = dt.tracker_state_init(cfg, dev)
    ori = (4 * hw[0], 4 * hw[1])
    ms = collections.defaultdict(list)
    windows = 0

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms[name].append(1e3 * (time.perf_counter() - t0))
        return r

    t0 = time.perf_counter()
    stream = list(tracker_stream(seed=0))
    stream_s = time.perf_counter() - t0
    for fidx, scores, probs, masks, embeds, valid, out, last in stream:
        on_card = torch.from_numpy(masks).to(dev)
        slots = {}
        for d, tr in host.items():
            clip = ClipResults(frame_idx=fidx, scores=scores, classes=np.zeros(len(scores)),
                               cls_probs=probs, query_embeds=embeds, valid=valid,
                               mask_logits=torch.from_numpy(masks) if d == "cpu" else on_card)
            slots[d] = timed(f"OverTracker[{d}]", lambda: tr.update(clip))
        f0, overlap = host["cpu"].clip_offsets(fidx)
        args = [torch.from_numpy(a).to(dev) for a in (scores, probs)] + [on_card] + [
            torch.from_numpy(a).to(dev) for a in (embeds, valid)]
        ov = torch.from_numpy(overlap).to(dev)
        state = timed("device_tracker", lambda: dt.tracker_step(state, cfg, *args, f0, ov))
        dev_slots = state["slots"].cpu().numpy()
        if not all(np.array_equal(s, dev_slots) for s in slots.values()):
            fail(f"matched IDs differ at clip {fidx[0]}: OverTracker {slots}, device tracker "
                 f"{dev_slots}")
        if out or last:
            res = {d: timed(f"window OverTracker[{d}]", functools.partial(
                tr.get_result, is_last_clip=last, finalize_args=(4, ori, ori)))
                for d, tr in host.items()}
            cls_d, n, packed_d, state = timed("window device_tracker", lambda: (
                dt.tracker_window_output(state, cfg, 4, ori, ori, last)))
            n = int(n)
            cls_c, packed_c, _ = res[DEMO_DEVICE]
            errs = [float(np.abs(cls_d.cpu().numpy()[:n] - cls_c).max()),
                    float(np.abs(res["cpu"][0] - cls_c).max())]
            same = [torch.equal(packed_d.cpu(), packed_c.cpu()),
                    torch.equal(res["cpu"][1], packed_c.cpu())]
            print(f"window {windows}: {n} instances; class averages of the device tracker and "
                  f"of the CPU OverTracker against the card's: max|err| {errs}; packed masks "
                  f"{tuple(packed_c.shape)} equal {same}", flush=True)
            if n != cls_c.shape[0] or max(errs) > 1e-5 or not all(same):
                fail("the trackers' window outputs disagree")
            windows += 1
    n_inst = host[DEMO_DEVICE].num_inst
    print(f"host tracker ({card}): {len(ms['device_tracker'])} clips, {windows} windows, "
          f"{n_inst} of {M} instances; host ms a clip, mean (median): "
          + ", ".join(f"{k} {np.mean(v):.3f} ({np.median(v):.3f})" for k, v in ms.items()
                      if not k.startswith("window"))
          + "; ms a window output, mean: "
          + ", ".join(f"{k[7:]} {np.mean(v):.3f}" for k, v in ms.items() if k.startswith("window"))
          + f"; the stream (numpy) {stream_s:.3f} s", flush=True)
    if windows != 2 or n_inst != M:
        fail(f"the stream gave {windows} windows and {n_inst} instances, want 2 and {M}")
    return {k: float(np.mean(v)) for k, v in ms.items() if not k.startswith("window")}


def eval_parity_cli(argv):
    """``tools/eval_parity.py``'s command line in this process; fails unless it
    exits with 0. Returns what it printed."""
    import io
    from mdqe_cvpr2023_tpu_torch.tools import eval_parity
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        try:
            eval_parity.main(argv)
            code = None
        except SystemExit as e:
            code = e.code
    if code != 0:
        print(printed.getvalue()[-6000:], flush=True)
        fail(f"eval_parity {argv[0]} exited with {code}")
    print(f"eval_parity {argv[0]} took {time.perf_counter() - t0:.1f} s", flush=True)
    return printed.getvalue()


def tool_checks(card, tmp, trainer):
    """The model tools: analyze_model (R50 at 4x384x640, Swin-L v2 at
    2x384x640: ANALYZE_SIZE) on the card; ``eval_parity run`` on the synthetic OVIS dataset
    under ``trainer.datasets_root`` and ``eval_parity diff`` of its results
    against ``trainer.test``'s on the same weights (exit 0, every track
    matched; both in this process); ``convert_weights inflate`` of a
    checkpoint written here, loaded back by ``load_torch_checkpoint``."""
    from mdqe_cvpr2023_tpu_torch.engine.checkpoint import load_torch_checkpoint
    from mdqe_cvpr2023_tpu_torch.tools import analyze_model, convert_weights
    for config in ("configs/R50_ovis_360.yaml", "configs/swinl_ovis.yaml"):
        res = analyze_model.main(["--config-file", config, "--device", DEMO_DEVICE,
                                  "--size", *ANALYZE_SIZE, *DEMO_OPTS])
        f = res["flops"]
        print(f"analyze_model {config} ({card}): {res['total']} parameters "
              f"{json.dumps(res['groups'])}; {f['total'] / 1e9:.3f} GFLOP (counted "
              f"{f['counted'] / 1e9:.3f} + sampling {f['sampling'] / 1e9:.3f})", flush=True)
        if sum(res["groups"].values()) != res["total"] or not f["sampling"] > 0 \
                or not f["counted"] > 0:
            fail(f"analyze_model's counts of {config} do not add up")
        torch.cuda.empty_cache()
    out = os.path.join(tmp, "parity")
    eval_parity_cli(["run", "--config", "configs/R50_ovis_360.yaml", "--dataset",
                     "ytvis_ovis_dev", "--datasets-root", trainer.datasets_root, "--output", out,
                     "--device", DEMO_DEVICE, *DEMO_OPTS])
    _, preds = trainer.test("ytvis_ovis_dev")
    report = eval_parity_cli([
        "diff", os.path.join(out, "results_ytvis_ovis_dev.json"),
        os.path.join(trainer.output_dir, "results_ytvis_ovis_dev.json"), "--gt",
        os.path.join(trainer.datasets_root, "ovis", "valid_sub.json")])
    print(report.strip(), flush=True)
    if not preds or json.loads(report)["matched_tracks"] != len(preds):
        fail(f"eval_parity diff matched {report} of {len(preds)} predictions")
    ckpt = os.path.join(tmp, "r50.pth")
    torch.save({"model": trainer.model.state_dict()}, ckpt)
    frames = trainer.cfg.INPUT.SAMPLING_FRAME_NUM
    path = convert_weights.main(["inflate", "--source", ckpt, "--num-frames", str(2 * frames),
                                 "--pretrain-frames", str(frames)])
    loaded = load_torch_checkpoint(path)
    key = next(k for k in loaded if k.endswith("temp_attn_inst.attention_weights.weight"))
    before = trainer.model.state_dict()[key].shape[0]
    print(f"convert_weights inflate: {len(loaded)} tensors loaded; {key} {before} -> "
          f"{loaded[key].shape[0]} rows", flush=True)
    if loaded[key].shape[0] != 2 * before:
        fail(f"the inflated checkpoint's temporal weights did not grow from {frames} to "
             f"{2 * frames} frames")


def demo_paths(da, card, vis_timings, vis_err):
    """Phase 6e: the video and clip demos, the host tracker, the model tools,
    then the kernel at the demos' call shapes against its plain version and
    timed; a site whose one call shape is phase 4's VIS_SITES shape keeps
    phase 3's error and phase 4's timing (``vis_err``, ``vis_timings``).
    Returns the kernels-line entries ``[<site>,demo]`` and
    ``[<site>,clip_demo]``."""
    tmp = tempfile.mkdtemp(prefix="mdqe_demo_")
    t0 = time.perf_counter()

    def took(what):
        print(f"{what}: {time.perf_counter() - t0:.1f} s into phase 6e", flush=True)

    try:
        write_ovis_dataset(tmp, DEMO_HW, train_frames=(), dev_frames=12, num_classes=25,
                           seed=7)
        phase(f"main path: the video demo ({card})")
        vis_trainer = demo_trainer("configs/R50_ovis_360.yaml", tmp, datasets_root=tmp)
        vis_launched, vis_seen, _ = video_demo(da, card, tmp, vis_trainer)
        took("the video demo")
        phase(f"main path: the clip demo ({card})")
        coco_trainer = demo_trainer("configs/R50_coco.yaml", tmp)
        clip_launched, clip_seen, _ = clip_demo_paths(da, card, tmp, coco_trainer)
        del coco_trainer
        torch.cuda.empty_cache()
        took("the clip demo")
        phase(f"the host OverTracker on the card against the device tracker ({card})")
        host_tracker(card)
        took("the host tracker")
        phase(f"the model tools ({card})")
        tool_checks(card, tmp, vis_trainer)
        del vis_trainer
        torch.cuda.empty_cache()
        took("the model tools")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase(f"kernels at the demos' call shapes ({card})")
    entries = []
    for path, seen, launched in (("demo", vis_seen, vis_launched),
                                 ("clip_demo", clip_seen, clip_launched)):
        timed_before = {site for site, keys in seen.items()
                        if path == "demo" and site in VIS_SITES and set(keys) == {vis_key(site)}}
        errs, timings = swin_fwd_sites(
            da, path, {k: v for k, v in seen.items() if k not in timed_before}, card)
        for site in sorted(timed_before):
            errs[site], timings[site] = vis_err[site], vis_timings[site]
            print(f"{path} fwd {site}: {seen[site][vis_key(site)]} launches at phase 4's "
                  f"{site} shape: its check and timing are this entry's", flush=True)
        for site, t in timings.items():
            line = 569 if site == "encoder" else 121
            entries.append(kernel_entry(f"ms_deform_attn_fwd[{site},{path}]", SOURCE,
                                        f"{PALLAS}:{line}", launched[site], errs[site], t))
    took("the kernels")
    return entries


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if sys.argv[1:] == ["--kernel-times"]:
        kernel_times()
        return
    if sys.argv[1:2] == ["--bwd-split"] and len(sys.argv) <= 3:
        bwd_split(sys.argv[2] if len(sys.argv) == 3 else None)
        return
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}: run with none, with --kernel-times or "
             "with --bwd-split [SOURCE]")
    from mdqe_cvpr2023_tpu_torch.ops import _build
    from mdqe_cvpr2023_tpu_torch.ops import deform_attn as da
    from mdqe_cvpr2023_tpu_torch.models import meta
    from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModelCfg
    from mdqe_cvpr2023_tpu_torch.tools import probe_band_primitives as pbp
    from mdqe_cvpr2023_tpu_torch.tools import probe_mxu_kdepth as pmk
    from mdqe_cvpr2023_tpu_torch.tools import tune_deform_kernel as tdk

    # ---- 1. device -------------------------------------------------------
    phase("device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    print(f"device: {kind} | {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- 2. build --------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    _build.build_all(["ms_deform_attn", "tc_kdepth"])  # one nvcc each, in parallel
    print(f"nvcc build {time.perf_counter() - t0:.1f} s (sm_90a)")
    for name in ("ms_deform_attn", "tc_kdepth"):
        print(_build.ptxas_report(name).strip(), flush=True)
    check_wgmma(_build)
    check_vector_red(_build)

    # ---- 3. kernel against plain -------------------------------------------
    phase("kernel against plain version")
    # fp32: the two differ only in summation order (1e-4 absolute on O(1)
    # outputs); bf16 value: both read the same bf16 numbers exactly, but sum
    # more terms of larger magnitude (1e-3)
    checks = [
        ("encoder", 10, 5100, 8, 32, 4, ENC_SHAPES, "local", torch.bfloat16, 1e-3),
        ("encoder", 10, 5100, 8, 32, 4, ENC_SHAPES, "uniform", torch.bfloat16, 1e-3),
        ("encoder", 10, 5100, 8, 32, 4, ENC_SHAPES, "local", torch.float32, 1e-4),
        ("encoder", 10, 5100, 8, 32, 4, ENC_SHAPES, "uniform", torch.float32, 1e-4),
        ("decoder_box", 32, 196, 8, 32, 4, ENC_SHAPES, "uniform", torch.float32, 1e-4),
        ("decoder_inst", 8, 196, 8, 32, 4, ((48, 80),) * 4, "uniform", torch.float32, 1e-4),
        ("odd", 3, 70, 3, 16, 3, ((10, 6), (7, 13), (3, 5)), "uniform", torch.float32, 1e-4),
        ("odd", 2, 45, 2, 48, 2, ((9, 4), (2, 11)), "uniform", torch.float32, 1e-4),
    ]
    max_err = {}
    for k, (site, B, Q, H, D, P, shapes, mode, vdt, tol) in enumerate(checks):
        v, lo, aw = make_inputs(torch, B, Q, H, D, P, shapes, mode, vdt, seed=k)
        got = da.ms_deform_attn_cuda(v, shapes, lo, aw)
        want = da.ms_deform_attn_plain(v, shapes, lo, aw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = err <= tol and bool(torch.isfinite(got).all())
        print(f"{site:12s} B={B} Q={Q} H={H} D={D} P={P} L={len(shapes)} "
              f"{str(vdt)[6:]:8s} {mode:7s} max|err|={err:.3e} tol={tol:.0e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"kernel disagrees with its plain version at {site} ({mode}, {vdt})")
        max_err[site] = max(max_err.get(site, 0.0), err)
        del got, want, v, lo, aw

    phase("backward kernel against autograd of the plain version")
    bwd_max_err, train_fwd_err = check_backward(torch, da)

    phase("block-size launchers against the plain version")
    block_err = check_block_variants(da, tdk)
    phase("gather probe against the tool's oracle")
    probe_err = check_probe(pbp)
    phase("tc_kdepth against its plain version")
    tc_err = check_tc(pmk)

    # ---- 4. kernel timing ----------------------------------------------------
    phase(f"kernel timing ({card})")
    timings = {}
    for k, (site, spec) in enumerate(VIS_SITES.items()):
        B, Q, H, D, P, shapes, mode, vdt, line = spec
        v, lo, aw = make_inputs(torch, B, Q, H, D, P, shapes, mode, vdt, seed=100 + k)
        ms = measure.time_ms(lambda: da.ms_deform_attn_cuda(v, shapes, lo, aw), 50)
        dev_ms = measure.graph_ms(lambda: da.ms_deform_attn_cuda(v, shapes, lo, aw), 50)
        plain_ms = measure.time_ms(lambda: da.ms_deform_attn_plain(v, shapes, lo, aw), 5)
        lib_ms = measure.time_ms(lambda: measure.grid_sample_msda(v, shapes, lo, aw), 5)
        lib_err = float((measure.grid_sample_msda(v, shapes, lo, aw)
                         - da.ms_deform_attn_plain(v, shapes, lo, aw)).abs().max())
        bound_ms, bound_by, nbytes = measure.msda_bound(v, shapes, lo, aw)
        timings[site] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             replaces=f"{PALLAS}:{line}")
        print(f"{site:12s} B={B} Q={Q} {str(vdt)[6:]:8s} kernel {ms:.4f} ms (graph replay "
              f"{dev_ms:.4f} ms) | plain "
              f"{plain_ms:.3f} ms | grid_sample form {lib_ms:.3f} ms "
              f"(max|diff| {lib_err:.1e}) | bound {bound_ms * 1e3:.1f} us by "
              f"{bound_by} ({nbytes / 1e6:.1f} MB) | {bound_ms / ms:.1%} of bound",
              flush=True)
        if lib_err > 1e-3:
            fail(f"grid_sample composition disagrees at {site}")
        del v, lo, aw

    phase(f"backward kernel timing ({card})")
    bwd_timings, train_fwd_timings = time_backward(torch, da)

    phase(f"forward kernel at the COCO sites ({card})")
    coco_err, coco_timings = coco_kernel_sites(da)

    # ---- 5. main path ----------------------------------------------------------
    phase("main path: inference_vis at full width")
    cfg = MDQEModelCfg(backbone="resnet50", num_classes=25, hidden_dim=256,
                       n_heads=8, enc_layers=6, dec_layers=6, n_frames=4,
                       n_query=196, query_embed_dim=64, dec_temporal=True)
    inf = meta.InferenceCfg(clip_stride=1, n_frames_test=4, n_frames_window_test=30,
                            max_num_instances=120, apply_cls_thres=0.1,
                            clip_topk=150, encode_chunk=10, num_classes=25)
    launches = vis_full_width(da, card, cfg, inf, 36, 360, 640)

    phase("small input: the card's path against the port's CPU path")
    tiny = MDQEModelCfg(backbone="resnet50", num_classes=5, hidden_dim=64, n_heads=4,
                        enc_layers=1, dec_layers=1, n_frames=2, n_query=16,
                        query_embed_dim=8, dec_temporal=True)
    vis_small_card_vs_cpu(da, tiny)

    # ---- 5b. COCO image inference -------------------------------------------
    phase(f"main path: COCO image inference at full width ({card})")
    coco_launches = coco_full_width(da, card)
    phase("small image: the card's COCO path against the port's CPU path")
    coco_small_card_vs_cpu(da)

    # ---- 6. training -------------------------------------------------------------
    phase(f"main path: the training step at full width ({card})")
    train_fwd_launches, train_bwd_launches, fp32_first = train_full_width(
        torch, da, card, bwd_timings)
    phase("tiny training step: the card's path against the port's CPU path")
    tiny_train_card_vs_cpu(torch)

    # ---- 6b. the train/test entry point ------------------------------------------
    phase(f"main path: the Trainer at full width ({card})")
    trainer_fwd, trainer_bwd, trainer_test_fwd = trainer_full_width(card)
    phase("tiny Trainer: the card's path against the port's CPU path")
    tiny_trainer_card_vs_cpu()

    # ---- 6a. mixed precision (AMP) ---------------------------------------------------
    phase(f"bf16 kernels at the R50 training call shapes against their oracles ({card})")
    r50_seen = {site: collections.Counter({(B, Q, H, D, P, shapes, "bfloat16"): 1})
                for site, B, Q, H, D, P, shapes, _ in BWD_CHECKS[:3]}
    amp_ferr, amp_berr, amp_ft, amp_bt = bf16_sites(da, "train_amp", r50_seen, card)
    phase("msda_bwd_bf16 at odd shapes, tail tiles and a crowded input against its oracle")
    bf16_cases(da)
    phase(f"main path: the AMP training step at full width ({card})")
    amp_fwd, amp_bwd, _ = train_full_width(torch, da, card, amp=True, fp32_losses=fp32_first)
    phase("tiny AMP training step: the card's path against the port's CPU path")
    tiny_train_card_vs_cpu(torch, amp=True)
    phase(f"main path: the Trainer with SOLVER.AMP.ENABLED True ({card})")
    amp_tr_fwd, amp_tr_bwd, amp_tr_test = amp_trainer(card)

    # ---- 6c. Swin-L -----------------------------------------------------------------
    swin_entries = swin_paths(da, card)

    # ---- 6d. data parallelism and the frame-sharded encode -----------------------------
    phase(f"main path: the data-parallel step, 2 ranks on one card over gloo; NCCL at "
          f"world size 1 ({card})")
    ddp_launches = ddp_paths(card)
    phase(f"main path: the data-parallel step over NCCL across cards ({card})")
    nccl_across_cards()
    phase(f"main path: train_net over 2 ranks under torch.distributed.run ({card})")
    trainer_ddp_launches = trainer_ddp(card)
    phase(f"main path: inference_vis with the window encode sharded by frames ({card})")
    vis = vis_sharded(da, card, cfg, inf)
    phase(f"kernels at one rank's call shapes and the sharded encoder's ({card})")
    ddp_kernel_entries = ddp_entries(da, card, ddp_launches, trainer_ddp_launches, vis,
                                     timings, max_err)

    # ---- 6e. the demos, the host tracker and the model tools -------------------------
    demo_kernel_entries = demo_paths(da, card, timings, max_err)

    # ---- 7. the kernel tools ------------------------------------------------------
    phase(f"main path: the kernel tools' sweeps ({card})")
    tune_rows, probe_rows, tc_rows, tc_launches = tool_paths(da, tdk, pbp, pmk)

    # ---- 8. results ------------------------------------------------------------
    kernels = []
    for site, t in timings.items():
        kernels.append(kernel_entry(f"ms_deform_attn_fwd[{site}]", SOURCE, t["replaces"],
                                    launches[site], max_err[site], t))
    for site, t in train_fwd_timings.items():
        kernels.append(kernel_entry(f"ms_deform_attn_fwd[{site},train]", SOURCE,
                                    f"{PALLAS}:121", train_fwd_launches[site],
                                    train_fwd_err[site], t))
    for site, t in bwd_timings.items():
        kernels.append(kernel_entry(f"ms_deform_attn_bwd[{site}]", SOURCE, BWD_REPLACES,
                                    train_bwd_launches[site], bwd_max_err[site], t))
    # the Trainer's steps (buckets up to 512x800: timed at 512x800) and its test
    # (the VIS sites' shapes)
    for site, t in train_fwd_timings.items():
        kernels.append(kernel_entry(f"ms_deform_attn_fwd[{site},trainer]", SOURCE,
                                    f"{PALLAS}:121", trainer_fwd[site], train_fwd_err[site], t))
    for site, t in bwd_timings.items():
        kernels.append(kernel_entry(f"ms_deform_attn_bwd[{site},trainer]", SOURCE,
                                    BWD_REPLACES, trainer_bwd[site], bwd_max_err[site], t))
    for site, t in timings.items():
        kernels.append(kernel_entry(f"ms_deform_attn_fwd[{site},trainer_test]", SOURCE,
                                    t["replaces"], trainer_test_fwd[site], max_err[site], t))
    # the AMP step's kernels (bf16 value): the synthetic step and the Trainer's
    # steps (buckets up to 512x800: timed at 512x800), and the Trainer's tests
    for site, t in amp_bt.items():
        for path, fwd_n, bwd_n in (("train_amp", amp_fwd, amp_bwd),
                                   ("trainer_amp", amp_tr_fwd, amp_tr_bwd)):
            kernels.append(kernel_entry(f"ms_deform_attn_fwd[{site},{path}]", SOURCE,
                                        f"{PALLAS}:121", fwd_n[site], amp_ferr[site],
                                        amp_ft[site]))
            kernels.append(kernel_entry(f"ms_deform_attn_bwd_bf16[{site},{path}]", SOURCE,
                                        BWD_BF16_REPLACES, bwd_n[site], amp_berr[site], t))
    for site, t in timings.items():
        kernels.append(kernel_entry(f"ms_deform_attn_fwd[{site},trainer_amp_test]", SOURCE,
                                    t["replaces"], amp_tr_test[site], max_err[site], t))
    for site, t in coco_timings.items():
        line = 569 if site == "encoder" else 121
        kernels.append(kernel_entry(f"ms_deform_attn_fwd[{site},coco]", SOURCE,
                                    f"{PALLAS}:{line}", coco_launches[site], coco_err[site], t))
    kernels += swin_entries
    kernels += ddp_kernel_entries
    kernels += demo_kernel_entries
    for r in tune_rows:  # each level's own launches and error
        key = f"{r['value']}_t{r['threads']}"
        kernels.append(kernel_entry(f"ms_deform_attn_fwd[tune,{r['level']},{key}]", SOURCE,
                                    tdk.REPLACES, r["launches"],
                                    block_err[r["level"], key], r))
    for r in probe_rows:
        kernels.append(kernel_entry(f"ms_deform_attn_fwd[probe,{r['spread']},{r['size']}]",
                                    SOURCE, pbp.REPLACES, r["launches"],
                                    probe_err[r["spread"], r["size"]], r))
    for r in tc_rows:
        key = f"K{r['K']}_N{r['N']}"
        kernels.append(kernel_entry(f"tc_kdepth[{key}]", TC_SOURCE, pmk.REPLACES,
                                    tc_launches[key], tc_err[key], r))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
