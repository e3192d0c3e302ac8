#!/usr/bin/env python3
"""The data-parallel training step, one rank of it, against the same step in
one process.

Each case of a spec (a JSON file) is a global batch, its reid priorities and
a number of optimizer steps, dropout 0. Every rank builds the same model
(seed 0, or the spec's ``state``, then ``broadcast_parameters``), takes its
rows of the global batch and of the priorities (``shard_rows``) and runs the
steps with ``make_train_step(group=...)``; it writes
``<out>/<case>_rank<r>.json``: each step's all-reduced total and losses, its
kernel launches per call site (forward, fp32 backward, bf16 backward), its
host seconds (ending in a synchronize), and from the tracer's
``train.allreduce`` span ``allreduce_s`` (the card's time, each step in the
tracer's full mode with device timing; the host's on the CPU) and the
gradient bytes reduced (``train.allreduce_bytes``); the SHA-256 of the rank's whole state after the first and the
last step; the rank's peak device memory. Rank 0 also writes its state
after the first step (``<case>_step1.pt``). Run with no
process group (``run_case(group=None)``) it is the one-process step on the
whole global batch, the reference of the comparison.

Spec: {"model": MDQEModelCfg fields, "crit": CriterionCfg fields, "train":
TrainCfg fields, "state": a ``torch.save``d state dict or null, "cases":
[{"name", "batch": an .npz of the global batch (``synthetic_batch``'s
arrays), "priorities": an .npy of its reid priorities (B, N, 2, T*Q), "amp",
"steps"}]}.

Usage: python -m torch.distributed.run --nproc_per_node 2 -m
           mdqe_cvpr2023_tpu_torch.tools.ddp_step --spec SPEC.json --out DIR
           [--device cuda:0|cpu] [--dist-backend nccl|gloo]
       (each rank runs on ``cuda:<LOCAL_RANK>`` unless ``--device`` names one)
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..losses.criterion import CriterionCfg
from ..models.detr import MDQEModel, MDQEModelCfg
from ..ops import deform_attn
from ..parallel import train as ptrain
from ..utils import dist, tracing
from ..utils.misc import resolve_device


def configs_of(spec, case):
    return (MDQEModelCfg(**spec["model"]), CriterionCfg(**spec["crit"]),
            ptrain.TrainCfg(**{**spec.get("train", {}), "amp": bool(case.get("amp"))}))


def case_inputs(case):
    """The case's global batch and reid priorities (B, N, 2, T*Q), numpy."""
    with np.load(case["batch"]) as f:
        batch = {k: f[k] for k in f.files}
    return batch, np.load(case["priorities"])


def _launches():
    return {"fwd": dict(deform_attn.LAUNCHES), "bwd": dict(deform_attn.BWD_LAUNCHES),
            "bwd_bf16": dict(deform_attn.BWD_BF16_LAUNCHES)}


def run_case(spec, case, device, group=None):
    """One case on this rank (the whole global batch with no ``group``).
    Returns (report, the state dict after the first step on the host)."""
    device = resolve_device(device)
    model_cfg, crit, train_cfg = configs_of(spec, case)
    batch, pri = case_inputs(case)
    rank, world = (torch.distributed.get_rank(group), torch.distributed.get_world_size(group)) \
        if group is not None else (0, 1)
    model = MDQEModel(model_cfg, device=device, seed=0)
    if spec.get("state"):
        model.load_state_dict(torch.load(spec["state"], map_location="cpu", weights_only=True))
    if group is not None:
        ptrain.broadcast_parameters(model, group)
    opt = ptrain.make_optimizer(model, train_cfg)
    step = ptrain.make_train_step(crit, dropout_rate=0.0, amp=train_cfg.amp, group=group)
    rows = ptrain.shard_rows({**batch, "reid_priorities": pri}, rank, world)
    rows = ptrain.to_device(rows, device)
    pri_dev = rows.pop("reid_priorities")
    gen = torch.Generator(device=device).manual_seed(1000 + rank)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    steps, first = [], None
    for i in range(int(case["steps"])):
        deform_attn.reset_launches()
        t0 = time.perf_counter()
        with tracing.full_mode(device=True):
            total, ldict = step(model, opt, rows, gen, pri_dev)
        total = float(total)  # waits for the step
        s = time.perf_counter() - t0
        req = tracing.last("train.step")
        stats = {}
        if group is not None:
            stats = {"allreduce_s": tracing.span_s(req, "train.allreduce"),
                     "allreduce_bytes": req.counters.get("train.allreduce_bytes", 0)}
        tracing.clear_events()
        steps.append({"total": total, "losses": {k: float(v) for k, v in ldict.items()},
                      "launches": _launches(), "s": s, **stats})
        if i == 0:
            first = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            sha_step1 = ptrain.state_sha256(model)
    report = {"case": case["name"], "rank": rank, "world": world,
              "backend": dist.backend() if group is not None else None,
              "device": str(device), "clips": int(rows["valid"].shape[0]),
              "steps": steps, "sha256_step1": sha_step1,
              "sha256_final": ptrain.state_sha256(model)}
    if device.type == "cuda":
        report["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    del model, opt
    return report, first


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--spec", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default=None)
    p.add_argument("--dist-backend", default=None, choices=dist.BACKENDS)
    args = p.parse_args()
    with open(args.spec) as f:
        spec = json.load(f)
    os.makedirs(args.out, exist_ok=True)
    device = torch.device(args.device or f"cuda:{os.environ.get('LOCAL_RANK', '0')}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    group = None
    if "WORLD_SIZE" in os.environ:
        dist.init_from_env(device, args.dist_backend)
        group = dist.default_group()
    try:
        # all_gather_objects over payloads of unequal size, in rank order
        gathered = dist.all_gather_objects({"rank": dist.rank(),
                                            "blob": "x" * (10 + 1000 * dist.rank())})
        for case in spec["cases"]:
            report, first = run_case(spec, case, device, group)
            report["gathered"] = [[g["rank"], len(g["blob"])] for g in gathered]
            with open(os.path.join(args.out, f"{case['name']}_rank{report['rank']}.json"),
                      "w") as f:
                json.dump(report, f)
            if report["rank"] == 0:
                torch.save(first, os.path.join(args.out, f"{case['name']}_step1.pt"))
            print(f"rank {report['rank']}/{report['world']} {case['name']}: totals "
                  f"{[round(s['total'], 6) for s in report['steps']]}, s/step "
                  f"{[round(s['s'], 4) for s in report['steps']]}", flush=True)
    finally:
        dist.destroy()


if __name__ == "__main__":
    main()
