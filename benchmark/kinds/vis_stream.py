"""Traffic kind ``vis_stream``: one closed-loop stream of videos into the
port's near-online VIS, ``models/meta.py::inference_vis``, one call a video,
each video handed over when the one before has returned.

Traffic parameters (``traffic/<name>.json``): ``frames`` a video, ``pool``
distinct videos made in set-up and visited in a seeded order (as many as a
window runs: a video's cost, the tracker's host assignment above all, is
as good as random from one video to the next, so a run's mean needs many
distinct videos), ``objects`` drifting ellipses a video, ``gates`` ("config": the
configuration's threshold, dedup and repeat suppression; "off": all open, so
that the tracker fills to its capacity). Frames are the configuration's
``test_size``.

End-to-end metrics: ``vis_clips_per_s`` (clips of the videos completed in the
window over the window) and ``vis_video_p95_s`` (the 95th percentile of the
videos' latency from the call to its result on the host). A traced run adds
CUDA-event spans around the window encode (``encode_window``), the batched
clip decode (``decode_clips_batched``), the tracker (``tracker_step``,
``tracker_window_average``) and the tail of ``inference_vis`` after the last
window average; after the window, one video three times over: profiled
with the host's activity and ranges around the stages and the deformable
attention (the breakdown and the kernels' device time), profiled for the
device's activity alone (the busy and idle time; second, so that the
profiler's first start is not in it), and unprofiled with the deformable
attention's inputs kept (its bounds).

``correct``: each of ``CHECK_VIDEOS`` videos of the window, sampled from
the seed, against the reference
(``reference/models/meta.py::inference_vis``, bf16 encode and fp32 decode as
the configuration states, on the same frames and
weights): ``score_gap``, the widest gap between the result's scores in rank
order and the reference's merged (track, class) scores in rank order, and
between each result's score and the reference's score of its best-matching
track (by mask IoU) in the result's class; ``mask_gap``, the widest margin
by which the reference's mask logit lies on the other side of 0 at a pixel
where a result's mask disagrees with its best-matching track's (the
reference's confidence in the pixels the result gets wrong: a sound
program disagrees only where the reference's logit is within its rounding,
a wrong track or mask where the reference is sure).
"""
from __future__ import annotations

import random
import statistics
import time

import numpy as np
import torch
import torch.nn.functional as F

import flops
from benchlib import common, msda, spans, trace, weights


LAYOUT_SEED = 0x56495321   # the pool's scenes, the same for every seed
CHECK_VIDEOS = 2           # videos of the window the comparison samples


def make_videos(traffic: dict, size, seed: int, device, n: int):
    """``n`` videos, one at a time, each (frames, H, W, 3) uint8 on the host: a smooth random
    background, ``objects`` ellipses of random size, colour and drift, drawn
    in order (later ones occlude), and pixel noise; made on ``device``. The
    scenes (background, the ellipses' sizes, paths and colours) are the same
    set for every seed (``LAYOUT_SEED``); the seed draws each video's colour
    shift (up to 1/20 of the range) and its pixel noise, and ``run`` the
    order in which the stream visits them."""
    T, K = int(traffic["frames"]), int(traffic["objects"])
    H, W = size
    g = torch.Generator(device=device).manual_seed(LAYOUT_SEED)
    gs = torch.Generator(device=device).manual_seed(common.salted(seed, 11))
    yy = torch.arange(H, device=device, dtype=torch.float32).view(1, H, 1)
    xx = torch.arange(W, device=device, dtype=torch.float32).view(1, 1, W)
    tt = torch.arange(T, device=device, dtype=torch.float32).view(T, 1, 1)
    for _ in range(n):
        bg = torch.rand(1, 3, 6, 10, generator=g, device=device) * 255
        frames = F.interpolate(bg, size=(H, W), mode="bilinear",
                               align_corners=False)[0].permute(1, 2, 0)
        frames = frames.expand(T, H, W, 3).clone()
        p = torch.rand(K, 9, generator=g, device=device)
        for k in range(K):
            ry, rx = (0.04 + 0.16 * p[k, 0]) * H, (0.04 + 0.16 * p[k, 1]) * W
            cy = (ry + p[k, 2] * (H - 2 * ry) + tt * (p[k, 4] - 0.5) * 0.03 * H).clamp(ry, H - ry)
            cx = (rx + p[k, 3] * (W - 2 * rx) + tt * (p[k, 5] - 0.5) * 0.03 * W).clamp(rx, W - rx)
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            frames = torch.where(inside[..., None], p[k, 6:9] * 255, frames)
        shift = (torch.rand(3, generator=gs, device=device) * 2 - 1) * 255 / 20
        frames = frames + shift + torch.randn(frames.shape, generator=gs, device=device) * 6
        yield frames.clamp(0, 255).to(torch.uint8).cpu().numpy()


def n_clips(video_len: int, T_clip: int, stride: int) -> int:
    """Clips of a video, as ``inference_vis`` schedules them."""
    n = 0
    for start in range(0, max(video_len, T_clip), stride):
        n += 1
        if start + T_clip >= max(video_len, T_clip):
            break
    return n


def compare_video(out: dict, ref: dict, device) -> dict:
    """``score_gap`` and ``mask_gap`` of one video's result against the
    reference's (see the module's docstring), and under ``detail`` each
    result's 1 - IoU with its matched track and the results' count."""
    scores = np.asarray(out["pred_scores"], np.float64)
    ref_flat = np.sort(ref["row_scores"].reshape(-1).astype(np.float64))[::-1]
    n = len(scores)
    rows = sorted(ref["row_logits"])
    shape = tuple(ref["row_logits"][rows[0]].shape)
    if n == 0 or n > len(ref_flat) or len(out["pred_masks"]) != n \
            or any(m.shape != shape for m in out["pred_masks"]):
        return {"score_gap": float("inf"), "mask_gap": float("inf"), "detail": {}}
    score_gap = float(np.abs(np.sort(scores)[::-1] - ref_flat[:n]).max())
    ref_bin = torch.stack([ref["row_logits"][r] > 0 for r in rows]).reshape(len(rows), -1)
    ref_area = ref_bin.sum(-1, dtype=torch.float64)
    mask_gap, ious = 0.0, []
    for s, label, m in zip(scores, out["pred_labels"], out["pred_masks"]):
        mt = torch.from_numpy(np.ascontiguousarray(m)).to(device).reshape(1, -1)
        inter = (ref_bin & mt).sum(-1, dtype=torch.float64)
        union = ref_area + mt.sum(dtype=torch.float64) - inter
        iou = torch.where(union > 0, inter / union.clamp(min=1), torch.ones_like(union))
        best = int(torch.argmax(iou))
        ious.append(round(1.0 - float(iou[best]), 6))
        logits = ref["row_logits"][rows[best]].reshape(-1)
        wrong = mt[0] != (logits > 0)
        if bool(wrong.any()):
            mask_gap = max(mask_gap, float(logits[wrong].abs().max()))
        score_gap = max(score_gap, abs(float(s) - float(ref["row_scores"][rows[best], int(label)])))
    return {"score_gap": score_gap, "mask_gap": mask_gap,
            "detail": {"one_minus_iou": sorted(ious, reverse=True)[:3], "results": n}}


def _reference(ctx, size):
    """The reference's model with the run's weights, its config and its
    meta module."""
    from reference.models import detr as rdetr, meta as rmeta, swin as rswin
    cfg = ctx.cell.config
    rmodel = rdetr.MDQEModel(common.model_cfg(cfg, rdetr, rswin), device=ctx.device)
    weights.load(rmodel, weights.make_weights(weights.param_shapes(rmodel), cfg["model"],
                                              ctx.seed, ctx.device))
    rinf = common.inference_cfg(cfg, ctx.cell.traffic["gates"], rmeta.InferenceCfg)
    return rmodel, rinf, rmeta


def run(ctx: common.Ctx) -> dict:
    cell, dev = ctx.cell, ctx.device
    cfg, tr = cell.config, cell.traffic
    size = tuple(cfg["test_size"])
    pool = int(tr["pool"])
    from mdqe_cvpr2023_tpu_torch.models import meta
    if ctx.sut == "program":
        from mdqe_cvpr2023_tpu_torch.models import detr, swin
        model = detr.MDQEModel(common.model_cfg(cfg, detr, swin), device=dev, seed=0)
        weights.load(model, weights.make_weights(weights.param_shapes(model), cfg["model"],
                                                 ctx.seed, dev))
        inf = common.inference_cfg(cfg, tr["gates"], meta.InferenceCfg)
        videos = [meta.preprocess_frames(v)[0]
                  for v in make_videos(tr, size, ctx.seed, dev, pool)]

        def run_video(frames):
            return meta.inference_vis(model, inf, frames, size, size, device=dev)
    else:
        model, inf, rmeta = _reference(ctx, size)
        videos = [rmeta.preprocess_frames(v)[0]
                  for v in make_videos(tr, size, ctx.seed, dev, pool)]

        def run_video(frames):
            return rmeta.inference_vis(model, inf, frames, size, size, encode="fp8", tf32=True)
    clips = n_clips(int(tr["frames"]), inf.n_frames_test, inf.clip_stride)
    order_rng = random.Random(common.salted(ctx.seed, 12))
    cycles = []

    def order(i):  # a seeded permutation of the pool in every cycle
        while len(cycles) <= i // pool:
            cycles.append(order_rng.sample(range(pool), pool))
        return cycles[i // pool][i % pool]

    for k in range(2):  # warm-up: every shape the window uses, twice
        run_video(videos[k % pool])
    if dev != "cpu":
        torch.cuda.synchronize()

    n_check = CHECK_VIDEOS
    sample_rng = random.Random(common.salted(ctx.seed, 13))
    sampled = []    # reservoir of (video index, pool index, result, encode calls)
    lat = []
    # the encode calls of the video in flight, kept by reference (no copy)
    # for the comparison: (frames, outputs) of each call
    held = {"calls": []}
    enc_module = meta if ctx.sut == "program" else rmeta
    orig_encode = enc_module.encode_window

    def encode_window(detr, frames_u8, *a, **k):
        out = orig_encode(detr, frames_u8, *a, **k)
        held["calls"].append((frames_u8, out))
        return out
    enc_module.encode_window = encode_window

    sp = spans.Spans(dev) if ctx.trace else None
    patches = []
    if sp is not None:
        tail = {}

        def window_average(*a, **k):
            with sp("track"):
                res = orig_wa(*a, **k)
            tail["start"] = sp.mark()
            return res
        orig_wa = meta.tracker_window_average
        patches = [("encode_window", sp.wrap("encode", meta.encode_window)),
                   ("decode_clips_batched", sp.wrap("decode", meta.decode_clips_batched)),
                   ("tracker_step", sp.wrap("track", meta.tracker_step)),
                   ("tracker_window_average", window_average)]
    originals = {name: getattr(meta, name) for name, _ in patches}
    for name, fn in patches:
        setattr(meta, name, fn)
    try:
        t_start = time.perf_counter()
        i = 0
        while True:
            if time.perf_counter() - t_start >= ctx.seconds and i >= n_check:
                break
            p = order(i)
            held["calls"] = []
            t0 = time.perf_counter()
            out = run_video(videos[p])
            lat.append(time.perf_counter() - t0)
            if sp is not None:
                sp.add("tail", tail.pop("start"), sp.mark())
            if len(sampled) < n_check:
                sampled.append((i, p, out, held["calls"]))
            else:
                j = sample_rng.randrange(i + 1)
                if j < n_check:
                    sampled[j] = (i, p, out, held["calls"])
            i += 1
        t_end = time.perf_counter()
    finally:
        for name, fn in originals.items():
            setattr(meta, name, fn)
        enc_module.encode_window = orig_encode
    window_s = t_end - t_start
    res = {"attempted": i, "window_start": t_start,
           "e2e": {"vis_clips_per_s": i * clips / window_s,
                   "vis_video_p95_s": float(np.percentile(lat, 95))},
           "notes": {"videos": i, "clips_a_video": clips, "window_s": window_s,
                     "latency_median_s": statistics.median(lat),
                     "latency_s": [round(x, 4) for x in lat]}}

    res["memory_peak_bytes"] = (torch.cuda.max_memory_allocated() if dev != "cpu" else 0)
    if ctx.trace:
        totals = sp.totals_ms()
        enc_flops = flops.vis_video(cfg, inf, int(tr["frames"]), videos[0].shape[1:3])
        obs = {"clips": i * clips, "videos": i, "window_s": window_s, "spans_ms": totals,
               "flops": {k: v * i for k, v in enc_flops.items()}}
        video = videos[order(0)]
        rf = torch.profiler.record_function
        stage_fns = {name: getattr(meta, name) for name in (
            "encode_window", "decode_clips_batched", "tracker_step", "tracker_window_average")}
        for name, label in (("encode_window", "bench.encode"), ("decode_clips_batched", "bench.decode"),
                            ("tracker_step", "bench.track"), ("tracker_window_average", "bench.track")):
            setattr(meta, name, (lambda f, lb: lambda *a, **k: _ranged(rf, lb, f, a, k))(
                stage_fns[name], label))
        try:
            with msda.installed(fwd=True), trace.profiled(dev) as full:
                with rf("bench.video"):
                    run_video(video)
        finally:
            for name, fn in stage_fns.items():
                setattr(meta, name, fn)
        with trace.profiled(dev, host=False) as quiet:   # after the first: the profiler warm
            run_video(video)
        kept = {"fwd": [], "bwd": []}
        with msda.installed(fwd=True, keep=kept):
            run_video(video)
        quiet_s = trace.summarize(quiet)
        full_s = trace.summarize(full)
        fwd_s, fwd_ranges = trace.launched_in(full["kineto"], msda.FWD_RANGE)
        obs["profile"] = {"busy_s": quiet_s["busy_s"], "window_s": quiet_s["window_s"],
                          "msda_fwd": {"device_ms": fwd_s * 1e3, "calls": fwd_ranges,
                                       "bound_ms": msda.bound_ms(kept["fwd"], "fwd"),
                                       "bound_calls": len(kept["fwd"])}}
        res["obs"] = obs
        res["device_extra"] = {"busy_s": quiet_s["busy_s"], "window_s": quiet_s["window_s"]}
        res["breakdown"] = {"device_ops": full_s["device_ops"],
                            "idle_gaps": full_s["idle_gaps"]}
        res["notes"]["profiled_video_s"] = {"device_only": quiet_s["window_s"],
                                            "with_host": full_s["window_s"]}
        del quiet, full, kept

    del model, run_video
    common.free_device(dev)

    # the comparison, after the window and the memory reading
    rmodel, rinf, rmeta = _reference(ctx, size)
    worst = {"enc_gap": 0.0, "score_gap": 0.0, "mask_gap": 0.0}
    failed = 0
    per_video = []
    for idx, p, out, enc in sampled:
        raw = np.ascontiguousarray(videos[p][:, :size[0], :size[1]])
        ref = rmeta.inference_vis(rmodel, rinf, rmeta.preprocess_frames(raw)[0], size, size,
                                  extra_rows=2 * len(out["pred_scores"]), given=enc)
        gaps = {"enc_gap": max(max(g) for g in ref["enc_gaps"]), **compare_video(out, ref, dev)}
        per_video.append({"video": idx, **gaps})
        gaps.pop("detail")
        bad = False
        for k, v in gaps.items():
            worst[k] = max(worst[k], v)
            limit = cell.limits.get(k)
            bad |= limit is None or not v <= limit
        failed += bad
    res["checks"] = [common.check(k, v, cell.limits) for k, v in worst.items()]
    res["failed"] = failed
    res["notes"]["checked"] = per_video
    return res


def _ranged(rf, label, fn, args, kwargs):
    with rf(label):
        return fn(*args, **kwargs)
