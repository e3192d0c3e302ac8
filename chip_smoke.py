#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

Phases (each exits non-zero on failure; none is caught and continued):
  1. device: the card's name and power limit;
  2. build: compile the CUDA kernel from the checkout with nvcc (sm_90a) and
     print ptxas's register / shared-memory / spill report;
  3. kernel against its plain PyTorch version at every call shape of the main
     path (encoder, decoder box level, decoder temporal) and at odd shapes;
  4. kernel timing (CUDA events) beside the plain version, the grid_sample
     composition (a yardstick the port never calls) and the least time the
     card could take for the same work;
  5. windowed VIS inference (inference_vis) at full width (R50, hidden 256,
     6+6 layers, 196 queries, 4-frame clips, 30-frame windows, 360x640) on a
     36-frame synthetic video with random weights from a seed: launch counts
     per call site, output checks, and on a small input the card's output
     against the port's CPU path (plain versions);
  6. the kernel list as one JSON line; the card line; the result line.

Usage: python3 chip_smoke.py   (needs one CUDA card; runs from the checkout)
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
ENC_SHAPES = ((48, 80), (24, 40), (12, 20), (6, 10))  # 384x640 padded frames
PALLAS = "mdqe_cvpr2023_tpu/ops/deform_attn_pallas.py"
SOURCE = "mdqe_cvpr2023_tpu_torch/ops/csrc/ms_deform_attn.cu"


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(msg):
    print(f"== {msg}", flush=True)


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
    else:
        loc = rng.uniform(-0.1, 1.1, (B, Q, H, L, P, 2)).astype(np.float32)
    attw = rng.random((B, Q, H, L * P), dtype=np.float32)
    attw /= attw.sum(-1, keepdims=True)
    dev = torch.device("cuda")
    v = torch.from_numpy(value).to(dev).to(vdtype)
    return (v, torch.from_numpy(loc).to(dev),
            torch.from_numpy(attw.reshape(B, Q, H, L, P)).to(dev))


def grid_sample_msda(torch, value, shapes, loc, attw):
    """The reference's PyTorch oracle form: one F.grid_sample per level on
    (B*H, D, h, w), then the weighted sum. Timed as a yardstick only."""
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


def bound_of(torch, value, shapes, loc, attw):
    """Least time for this call on an H100: the larger of (bytes it must move:
    the value rows its in-range taps touch, locations, weights, output) over
    HBM bandwidth and (2*D flops per in-range tap) over fp32 peak."""
    B, N, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
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
    touched = int(torch.unique(torch.cat(rows)).numel())
    nbytes = (touched * D * value.element_size() + loc.numel() * 4
              + attw.numel() * 4 + B * Q * H * D * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * D * taps / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def time_ms(torch, fn, iters, warmup=2):
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


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mdqe_cvpr2023_tpu_torch")):
        fail("the mdqe_cvpr2023_tpu_torch package is not beside this script")
    sys.path.insert(0, here)
    from mdqe_cvpr2023_tpu_torch.ops import _build
    from mdqe_cvpr2023_tpu_torch.ops import deform_attn as da
    from mdqe_cvpr2023_tpu_torch.models import meta
    from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel, MDQEModelCfg

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
    _build.build("ms_deform_attn")
    print(f"nvcc build {time.perf_counter() - t0:.1f} s (sm_90a)")
    print(_build.ptxas_report("ms_deform_attn").strip(), flush=True)

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

    # ---- 4. kernel timing ----------------------------------------------------
    phase(f"kernel timing ({card})")
    timing_shapes = {
        # site: shapes, loc mode, value type, line of the TPU kernel replaced
        # (_deform_attn_banded for the encoder, _deform_attn_fused otherwise)
        "encoder": (10, 5100, 8, 32, 4, ENC_SHAPES, "local", torch.bfloat16, 569),
        "decoder_box": (32, 196, 8, 32, 4, ENC_SHAPES, "uniform", torch.float32, 121),
        "decoder_inst": (8, 196, 8, 32, 4, ((48, 80),) * 4, "uniform", torch.float32,
                         121),
    }
    timings = {}
    for k, (site, spec) in enumerate(timing_shapes.items()):
        B, Q, H, D, P, shapes, mode, vdt, line = spec
        v, lo, aw = make_inputs(torch, B, Q, H, D, P, shapes, mode, vdt, seed=100 + k)
        ms = time_ms(torch, lambda: da.ms_deform_attn_cuda(v, shapes, lo, aw), 50)
        plain_ms = time_ms(torch, lambda: da.ms_deform_attn_plain(v, shapes, lo, aw), 5)
        lib_ms = time_ms(torch, lambda: grid_sample_msda(torch, v, shapes, lo, aw), 5)
        lib_err = float((grid_sample_msda(torch, v, shapes, lo, aw)
                         - da.ms_deform_attn_plain(v, shapes, lo, aw)).abs().max())
        bound_ms, bound_by, nbytes = bound_of(torch, v, shapes, lo, aw)
        timings[site] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             replaces=f"{PALLAS}:{line}")
        print(f"{site:12s} B={B} Q={Q} {str(vdt)[6:]:8s} kernel {ms:.4f} ms | plain "
              f"{plain_ms:.3f} ms | grid_sample form {lib_ms:.3f} ms "
              f"(max|diff| {lib_err:.1e}) | bound {bound_ms * 1e3:.1f} us by "
              f"{bound_by} ({nbytes / 1e6:.1f} MB) | {bound_ms / ms:.1%} of bound",
              flush=True)
        if lib_err > 1e-3:
            fail(f"grid_sample composition disagrees at {site}")
        del v, lo, aw

    # ---- 5. main path ----------------------------------------------------------
    phase("main path: inference_vis at full width")
    cfg = MDQEModelCfg(backbone="resnet50", num_classes=25, hidden_dim=256,
                       n_heads=8, enc_layers=6, dec_layers=6, n_frames=4,
                       n_query=196, query_embed_dim=64, dec_temporal=True)
    inf = meta.InferenceCfg(clip_stride=1, n_frames_test=4, n_frames_window_test=30,
                            max_num_instances=120, apply_cls_thres=0.1,
                            clip_topk=150, encode_chunk=10, num_classes=25)
    t0 = time.perf_counter()
    model = MDQEModel(cfg, device="cuda", seed=0)
    print(f"model built on the card in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters)")
    n_frames, H, W = 36, 360, 640
    video = np.random.default_rng(0).integers(0, 255, (n_frames, H, W, 3)).astype(np.uint8)
    frames, _ = meta.preprocess_frames(video)
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
    crowd = dataclasses.replace(inf, apply_cls_thres=0.0, dedup_sim=2.0,
                                suppress_siou=2.0, suppress_ctt=2.0)
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

    phase("small input: the card's path against the port's CPU path")
    tiny = MDQEModelCfg(backbone="resnet50", num_classes=5, hidden_dim=64, n_heads=4,
                        enc_layers=1, dec_layers=1, n_frames=2, n_query=16,
                        query_embed_dim=8, dec_temporal=True)
    tiny_inf = meta.InferenceCfg(clip_stride=2, n_frames_test=2, n_frames_window_test=4,
                                 max_num_instances=20, apply_cls_thres=0.05,
                                 clip_topk=8, encode_chunk=2, num_classes=5,
                                 bf16_encode=False)
    small = np.random.default_rng(1).integers(0, 255, (9, 60, 62, 3)).astype(np.uint8)
    small_frames, _ = meta.preprocess_frames(small)
    m_gpu = MDQEModel(tiny, device="cuda", seed=3)
    m_cpu = MDQEModel(tiny, device="cpu", seed=3)
    da.reset_launches()
    got = meta.inference_vis(m_gpu, tiny_inf, small_frames, (60, 62), (60, 62))
    if min(da.LAUNCHES.values()) == 0:
        fail(f"small run did not reach every kernel call site: {da.LAUNCHES}")
    want = meta.inference_vis(m_cpu, tiny_inf, small_frames, (60, 62), (60, 62),
                              device="cpu")
    check_outputs(got, 9, (60, 62), tiny.num_classes)
    ious = [np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1)
            for a, b in zip(got["pred_masks"], want["pred_masks"])]
    score_err = float(np.max(np.abs(np.subtract(got["pred_scores"], want["pred_scores"])))) \
        if len(got["pred_scores"]) == len(want["pred_scores"]) else float("inf")
    print(f"tracks {got['num_tracks']} vs {want['num_tracks']}, outputs "
          f"{len(got['pred_scores'])} vs {len(want['pred_scores'])}, max|score err| "
          f"{score_err:.2e}, min mask IoU {min(ious) if ious else 1.0:.4f}", flush=True)
    if (got["num_tracks"] != want["num_tracks"] or got["pred_labels"] != want["pred_labels"]
            or score_err > 5e-3 or (ious and min(ious) < 0.99)):
        fail("the card's output disagrees with the CPU path on the small input")

    # ---- 6. results ------------------------------------------------------------
    kernels = []
    for site, t in timings.items():
        kernels.append({
            "name": f"ms_deform_attn_fwd[{site}]", "route": "cuda", "source": SOURCE,
            "replaces": t["replaces"], "launches": launches[site],
            "max_abs_err": max_err[site], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
