"""Traffic kind ``train_clips``: closed-loop training steps of the port's
``parallel/train.py::make_train_step`` on one card, each step's batch copied
from pinned host memory to the card as the Trainer's loader hands it over.

Traffic parameters (``traffic/<name>.json``): ``pool_per_bucket`` batches
made from the seed for each of the configuration's resolution buckets
(``train.buckets``), ``inst_min`` valid instances a clip at the least (at
most ``train.slots``; the pool's counts spread evenly between the two, the
same for every seed, shuffled by it). A batch is the configuration's
``IMS_PER_BATCH`` clips of ``train.n_frames`` frames: drifting ellipses
(their masks, boxes, classes and track ids are the targets) on a smooth
background with pixel noise. The steps go round by round; each round takes
every bucket once, in an order drawn from the seed, so the first round is
one batch of each bucket.

End-to-end metric: ``train_clips_per_s``, the clips stepped in the window
over the window. A traced run adds CUDA-event spans around each step and
around ``loss_fn`` (forward, matcher, criterion); after the window,
``PROFILE_STEPS`` steps three times over from the same state: profiled
with the host's activity and ranges around the loss and the deformable
attention's backward (the breakdown and the kernels' device time),
profiled for the device's activity alone (the busy and idle time; second,
so that the profiler's first start is not in it), and unprofiled with the
backward's inputs kept (its bounds).

``correct``: set-up drives the step through its first round, a step of
each bucket (the window's own call and feed), and the reference
(``reference/parallel/train.py``, fp32, TF32 off, as the configuration
states) follows them from the same weights, batches and dropout draws:
``loss1_gap``, the relative gap of the first step's loss (the later
steps' losses, which a matcher's tie flipped by the first update's
rounding can move, are reported beside it and not compared);
``grad_gap``, the worst leaf's gap between the norms of the first gradient
as AdamW got it (its first moment after one step over 1 - beta1);
``update_gap``, the worst leaf's gap between the norms of the parameters'
change over the first round. A leaf's gap is taken against the larger of
the reference's norm of that leaf and of the median leaf; leaves whose
reference gradient is under a thousandth of the median leaf's (nought to
rounding, as a key bias under softmax) are left out of ``update_gap``.
The query initialisation takes each grid cell's peak score, and a peak
whose runner-up lies within rounding of it may go either way on either
side: where the comparison fails, the reference follows its first step
again with the runner-up taken at each such peak in turn (``PeakTies``),
and the run is correct if one of these passes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import statistics
import time

import torch
import torch.nn.functional as F

import flops
from benchlib import common, msda, spans, trace, weights

BETA1 = 0.9          # AdamW's first-moment decay in the port and the reference
PROFILE_STEPS = 2    # steps a traced run profiles after its window
# A query peak whose runner-up lies within this share of it is a tie to
# rounding: the program's fp32 encoder and the reference's differ by a few
# units in the last place of the scores (about 0.01 at the heads' initial
# bias), and may pick either side.
TIE_REL = 2e-6
MAX_TIE_VARIANTS = 8  # near-tied peaks the reference follows, nearest first


def make_batch(gen, counts, frames: int, hw, slots: int, num_classes: int, device):
    """One batch as the port's training step takes it, with ``counts[b]``
    valid instances in clip b, made on ``device`` from ``gen``."""
    Hp, Wp = hw
    clips = len(counts)
    yy = torch.arange(Hp, device=device, dtype=torch.float32).view(1, Hp, 1)
    xx = torch.arange(Wp, device=device, dtype=torch.float32).view(1, 1, Wp)
    tt = torch.arange(frames, device=device, dtype=torch.float32).view(frames, 1, 1)
    images = torch.empty((clips, frames, Hp, Wp, 3), device=device)
    masks = torch.zeros((clips, slots, frames, Hp, Wp), dtype=torch.bool, device=device)
    boxes = torch.zeros((clips, slots, frames, 4), device=device)
    ids = torch.full((clips, slots, frames), -1, dtype=torch.int32, device=device)
    labels = torch.zeros((clips, slots), dtype=torch.int32, device=device)
    valid = torch.zeros((clips, slots), dtype=torch.bool, device=device)
    for b in range(clips):
        bg = torch.rand(1, 3, 6, 10, generator=gen, device=device) * 255
        img = F.interpolate(bg, size=(Hp, Wp), mode="bilinear",
                            align_corners=False)[0].permute(1, 2, 0).expand(frames, Hp, Wp, 3)
        p = torch.rand(counts[b], 10, generator=gen, device=device)
        for n in range(counts[b]):
            ry, rx = (0.05 + 0.15 * p[n, 0]) * Hp, (0.05 + 0.15 * p[n, 1]) * Wp
            cy = (ry + p[n, 2] * (Hp - 2 * ry) + tt * (p[n, 4] - 0.5) * 0.04 * Hp).clamp(ry, Hp - ry)
            cx = (rx + p[n, 3] * (Wp - 2 * rx) + tt * (p[n, 5] - 0.5) * 0.04 * Wp).clamp(rx, Wp - rx)
            m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0        # (T, Hp, Wp)
            img = torch.where(m[..., None], p[n, 6:9] * 255, img)
            masks[b, n] = m
            rows, cols = m.any(2), m.any(1)                                  # (T,Hp), (T,Wp)
            r0 = rows.float().argmax(1)
            r1 = Hp - rows.flip(1).float().argmax(1)
            c0 = cols.float().argmax(1)
            c1 = Wp - cols.flip(1).float().argmax(1)
            boxes[b, n] = torch.stack([c0 / Wp, r0 / Hp, c1 / Wp, r1 / Hp], -1)
            labels[b, n] = int(p[n, 9] * num_classes) % num_classes
            ids[b, n] = n
            valid[b, n] = True
        images[b] = img + torch.randn(img.shape, generator=gen, device=device) * 6
    return {"images": images.clamp(0, 255).to(torch.uint8).reshape(clips * frames, Hp, Wp, 3),
            "image_sizes": torch.tensor([[Hp, Wp]] * (clips * frames), dtype=torch.int32,
                                        device=device),
            "labels": labels, "ids": ids, "boxes": boxes, "masks": masks, "valid": valid}


def _train_geometry(cfg):
    t = cfg["train"]
    return int(cfg["IMS_PER_BATCH"]), int(t["n_frames"]), int(t["slots"]), \
        [tuple(b) for b in t["buckets"]]


def make_pool(ctx):
    """{(bucket, k): batch in host memory (pinned on the card's machine)}
    and the step schedule: round r takes every bucket once in a seeded
    order, batch r % pool_per_bucket of each."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    clips, frames, slots, buckets = _train_geometry(cfg)
    per = int(tr["pool_per_bucket"])
    gen = torch.Generator(device=ctx.device).manual_seed(common.salted(ctx.seed, 22))
    rng = random.Random(common.salted(ctx.seed, 23))
    # every seed the same instance counts, spread evenly over [inst_min,
    # slots], in another order
    lo, n = int(tr["inst_min"]), len(buckets) * per * clips
    counts = [round(lo + (slots - lo) * k / max(n - 1, 1)) for k in range(n)]
    rng.shuffle(counts)
    pool = {}
    for bi, hw in enumerate(buckets):
        for k in range(per):
            first = (bi * per + k) * clips
            batch = make_batch(gen, counts[first:first + clips], frames, hw, slots,
                               int(cfg["model"]["num_classes"]), ctx.device)
            pool[(bi, k)] = {name: (v.cpu().pin_memory() if ctx.device != "cpu" else v.clone())
                             for name, v in batch.items()}
    orders = []

    def schedule(step: int):
        r, j = divmod(step, len(buckets))
        while len(orders) <= r:
            orders.append(rng.sample(range(len(buckets)), len(buckets)))
        return (orders[r][j], r % per)
    return pool, schedule


def _leaf_norms(named) -> dict:
    return {n: float(torch.linalg.vector_norm(t.detach().double())) for n, t in named}


def _first_grads(model, adamw) -> dict:
    """Each trainable leaf's first gradient as AdamW got it: its first
    moment after one step over 1 - beta1."""
    return _leaf_norms((n, adamw.state[p]["exp_avg"] / (1.0 - BETA1))
                       for n, p in model.named_parameters() if p in adamw.state)


def _changes(model, w0) -> dict:
    return _leaf_norms((n, p - w0[n]) for n, p in model.named_parameters() if p.requires_grad)


def _worst_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    names = [n for n in ref if keep is None or n in keep]
    if set(prog) != set(ref):
        return float("inf")
    med = statistics.median([ref[n] for n in names])
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def _worst_leaves(prog: dict, ref: dict, keep=None, n: int = 3):
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median([ref[k] for k in names])
    gaps = sorted(((abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30), k)
                   for k in names), reverse=True)[:n]
    return [[k, g, ref[k] / med] for g, k in gaps]


def readings(model, adamw, do_step, w0, n: int):
    """Drive ``do_step`` (returning the total and the weighted losses by
    name) through the first ``n`` steps; the totals, the first step's
    weighted losses, the first gradient's leaf norms and the leaves' change
    norms after them."""
    losses = []
    for k in range(n):
        total, ldict = do_step(k)
        losses.append(total)
        if k == 0:
            grads = _first_grads(model, adamw)
            terms = {name: float(v) for name, v in ldict.items()}
    losses = [float(x) for x in losses]
    return {"losses": losses, "terms": terms, "grads": grads,
            "changes": _changes(model, w0)}


def run(ctx: common.Ctx) -> dict:
    cell, dev = ctx.cell, ctx.device
    cfg, tr = cell.config, cell.traffic
    clips, frames, slots, buckets = _train_geometry(cfg)
    tcfg = cfg["train"]
    n_check = len(buckets)
    pool, schedule = make_pool(ctx)

    def feed(step):
        return {k: v.to(dev, non_blocking=True) for k, v in pool[schedule(step)].items()}

    from mdqe_cvpr2023_tpu_torch.parallel import train as ptrain
    if ctx.sut == "program":
        from mdqe_cvpr2023_tpu_torch.losses.criterion import CriterionCfg
        from mdqe_cvpr2023_tpu_torch.models import detr, swin
        model = detr.MDQEModel(common.model_cfg(cfg, detr, swin), device=dev, seed=0)
        w0 = weights.make_weights(weights.param_shapes(model), cfg["model"], ctx.seed, dev)
        weights.load(model, w0)
        opt = ptrain.make_optimizer(model, _train_cfg(ptrain.TrainCfg, tcfg))
        adamw = opt.adamw
        step_fn = ptrain.make_train_step(_crit(CriterionCfg, cfg), dropout_rate=tcfg["dropout"])
        gen = torch.Generator(device=dev).manual_seed(common.salted(ctx.seed, 21))

        def run_step(batch):
            return step_fn(model, opt, batch, gen)
    else:
        model, opt, rcrit, rtrain, w0 = _reference(ctx)
        adamw = opt.adamw
        gen = torch.Generator(device=dev).manual_seed(common.salted(ctx.seed, 21))

        def run_step(batch):
            return rtrain.train_step(model, opt, rcrit, batch, gen, tcfg["dropout"], tf32=True)

    def do_step(k):
        return run_step(feed(k))

    # set-up: the first steps, one of each bucket, are the ones the reference follows
    got = readings(model, adamw, do_step, w0, n_check)
    del w0
    if dev != "cpu":
        torch.cuda.synchronize()

    sp = spans.Spans(dev) if ctx.trace else None
    orig_loss = ptrain.loss_fn
    if sp is not None:
        ptrain.loss_fn = sp.wrap("loss", orig_loss)
    try:
        t_start = time.perf_counter()
        k = n_check
        while time.perf_counter() - t_start < ctx.seconds or k == n_check:
            batch = feed(k)
            if sp is not None:
                with sp("step"):
                    run_step(batch)
            else:
                run_step(batch)
            k += 1
        if dev != "cpu":
            torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        ptrain.loss_fn = orig_loss
    steps = k - n_check
    window_s = t_end - t_start
    res = {"attempted": steps, "window_start": t_start,
           "e2e": {"train_clips_per_s": steps * clips / window_s},
           "notes": {"steps": steps, "window_s": window_s, "losses": got["losses"]}}

    res["memory_peak_bytes"] = (torch.cuda.max_memory_allocated() if dev != "cpu" else 0)
    if ctx.trace:
        per_step = {}
        for s in range(n_check, k):
            b = schedule(s)[0]
            for prec, f in flops.train_step(cfg, buckets[b]).items():
                per_step[prec] = per_step.get(prec, 0.0) + f
        obs = {"steps": steps, "clips": steps * clips, "window_s": window_s,
               "spans_ms": sp.totals_ms(), "flops": per_step}
        rf = torch.profiler.record_function
        state = [t for t in (*model.parameters(), *model.buffers(), *(
            v for st in adamw.state.values() for v in st.values())) if torch.is_tensor(t)]
        saved = ([t.detach().clone() for t in state], opt.step_count, gen.get_state())

        def steps_from_saved(ranged: bool):
            """The same steps from the same state (weights, AdamW's moments,
            the schedule's count, the dropout draws) each time."""
            with torch.no_grad():
                for t, v in zip(state, saved[0]):
                    t.copy_(v)
            opt.step_count = saved[1]
            gen.set_state(saved[2])
            for s in range(k, k + PROFILE_STEPS):
                batch = feed(s)
                with rf("bench.step") if ranged else contextlib.nullcontext():
                    run_step(batch)

        def loss_ranged(*a, **kw):
            with rf("bench.loss"):
                return orig_loss(*a, **kw)
        ptrain.loss_fn = loss_ranged
        try:
            with msda.installed(fwd=False, bwd=True), trace.profiled(dev) as full:
                steps_from_saved(True)
        finally:
            ptrain.loss_fn = orig_loss
        with trace.profiled(dev, host=False) as quiet:   # after the first: the profiler warm
            steps_from_saved(False)
        kept = {"fwd": [], "bwd": []}
        with msda.installed(fwd=False, bwd=True, keep=kept):
            steps_from_saved(False)
        quiet_s = trace.summarize(quiet)
        full_s = trace.summarize(full)
        bwd_s, bwd_ranges = trace.launched_in(full["kineto"], msda.BWD_RANGE)
        obs["profile"] = {"busy_s": quiet_s["busy_s"], "window_s": quiet_s["window_s"],
                          "msda_bwd": {"device_ms": bwd_s * 1e3, "calls": bwd_ranges,
                                       "bound_ms": msda.bound_ms(kept["bwd"], "bwd"),
                                       "bound_calls": len(kept["bwd"])}}
        res["obs"] = obs
        res["device_extra"] = {"busy_s": quiet_s["busy_s"], "window_s": quiet_s["window_s"]}
        res["breakdown"] = {"device_ops": full_s["device_ops"],
                            "idle_gaps": full_s["idle_gaps"]}
        res["notes"]["profiled_steps_s"] = {"device_only": quiet_s["window_s"],
                                            "with_host": full_s["window_s"]}
        del quiet, full, kept, saved, state

    del model, opt, adamw, run_step
    common.free_device(dev)

    # the reference follows the first steps, after the window and the memory
    # reading; where that fails, once more for each of its first forward's
    # near-tied query peaks, nearest first, with the peak's runner-up taken
    def follow(ties):
        rdecoder.peak_choice = ties
        try:
            rmodel, ropt, rcrit, rtrain, rw0 = _reference(ctx)
            rgen = torch.Generator(device=dev).manual_seed(common.salted(ctx.seed, 21))

            def ref_step(s):
                return rtrain.train_step(rmodel, ropt, rcrit, feed(s), rgen, tcfg["dropout"])
            return readings(rmodel, ropt.adamw, ref_step, rw0, n_check)
        finally:
            rdecoder.peak_choice = None

    from reference.models import decoder as rdecoder
    base = PeakTies()
    checks, notes = _compare(got, follow(base), cell.limits)
    tried = []
    if not all(c["ok"] for c in checks):
        for gap, where in base.ties[:MAX_TIE_VARIANTS]:
            common.free_device(dev)
            alt_checks, alt_notes = _compare(got, follow(PeakTies(flip=where)), cell.limits)
            tried.append({"peak": list(where), "gap": gap,
                          "compared": {c["name"]: c["value"] for c in alt_checks}})
            if all(c["ok"] for c in alt_checks):
                checks, notes = alt_checks, alt_notes
                break
    res["checks"] = checks
    res["failed"] = sum(not c["ok"] for c in checks)
    res["notes"].update(notes, near_tied_peaks=base.ties[:MAX_TIE_VARIANTS],
                        tie_variants_tried=tried)
    return res


class PeakTies:
    """The reference's choice of each cell's query peak (decoder.py's
    ``peak_choice``): the argmax, as the plain reference takes it. In the
    first forward (the first step, which ``loss1_gap`` and ``grad_gap``
    read) it records the peaks whose runner-up lies within ``TIE_REL`` of
    them, ``(gap, (frame, row, col))`` nearest first, and where ``flip``
    names one, takes that cell's runner-up. A cell is (frame of the batch,
    row, col)."""

    def __init__(self, flip=None):
        self.flip = None if flip is None else tuple(flip)
        self.calls = 0
        self.ties = []

    def __call__(self, cells):
        cells = cells.detach()
        sel = cells.argmax(-1)
        if self.calls == 0:
            top = cells.gather(-1, sel[..., None])[..., 0]
            rest = cells.scatter(-1, sel[..., None], float("-inf"))
            second = rest.argmax(-1)
            gap = top - rest.gather(-1, second[..., None])[..., 0]
            near = (gap <= TIE_REL * top.abs()).nonzero().tolist()
            self.ties = sorted((float(gap[tuple(w)]), tuple(w)) for w in near)
            if self.flip is not None:
                sel = sel.clone()
                sel[self.flip] = second[self.flip]
        self.calls += 1
        return sel


def _compare(got: dict, ref: dict, limits: dict):
    """The compared numbers of the program's readings against the
    reference's (each beside its limit), and the notes that explain them."""
    med_g = statistics.median(list(ref["grads"].values()))
    moving = {n for n, g in ref["grads"].items() if g >= 1e-3 * med_g}
    loss_gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], ref["losses"])]
    gaps = {"loss1_gap": loss_gaps[0],
            "grad_gap": _worst_leaf_gap(got["grads"], ref["grads"]),
            "update_gap": _worst_leaf_gap(got["changes"], ref["changes"], moving)}
    med_c = statistics.median([ref["changes"][n] for n in moving])
    notes = dict(
        ref_losses=ref["losses"], loss_gaps=loss_gaps,
        leaves_left_out=sorted(set(ref["grads"]) - moving),
        worst_leaves={k: _worst_leaves(got[k], ref[k], moving if k == "changes" else None)
                      for k in ("grads", "changes")},
        worst_terms=_worst_leaves(got["terms"], ref["terms"], n=6),
        median_leaf_change_gap=abs(statistics.median([got["changes"][n] for n in moving]) - med_c)
        / med_c)
    return [common.check(n, v, limits) for n, v in gaps.items()], notes


def _train_cfg(cls, tcfg: dict):
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in tcfg.items() if k in fields}
    return cls(**kw)


def _crit(cls, cfg):
    return cls(num_classes=cfg["model"]["num_classes"], n_frames=cfg["train"]["n_frames"],
               n_query=cfg["model"]["n_query"],
               window_inter_frame_asso=cfg["model"]["window_inter_frame_asso"])


def _reference(ctx):
    """The reference's model with the run's weights, its optimizer and
    criterion config, its train module, and the initial weights."""
    from reference.losses.criterion import CriterionCfg
    from reference.models import detr as rdetr, swin as rswin
    from reference.parallel import train as rtrain
    cfg = ctx.cell.config
    rmodel = rdetr.MDQEModel(common.model_cfg(cfg, rdetr, rswin), device=ctx.device)
    w0 = weights.make_weights(weights.param_shapes(rmodel), cfg["model"], ctx.seed, ctx.device)
    weights.load(rmodel, w0)
    ropt = rtrain.make_optimizer(rmodel, _train_cfg(rtrain.TrainCfg, cfg["train"]))
    return rmodel, ropt, _crit(CriterionCfg, cfg), rtrain, w0
