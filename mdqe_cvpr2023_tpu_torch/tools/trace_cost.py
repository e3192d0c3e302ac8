#!/usr/bin/env python3
"""What the port's tracer (``utils/tracing.py``) costs the host.

1. Host ns a span, a wait and a counter, inside a request, in the default
   mode and in full mode (and full mode with device timing where a card is
   present), over ``--n`` empty spans each, the least of 7 rounds taken in
   turn (3 in full mode); and an empty ``with`` of a plain object for the
   interpreter's own cost.
2. With a card: ``inference_vis`` at the full-width R50 geometry of
   ``profile_vis.py`` (crowded tracker, 36 frames of 360x640, random weights
   from seed 0), clips/s in the default mode against full mode with device
   timing, the two alternated over ``--runs`` rounds, and the spans and
   syncs one video records.

Prints one JSON line per part. Usage:
    python3 -m mdqe_cvpr2023_tpu_torch.tools.trace_cost [--n N] [--runs R]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..utils import tracing


class _Plain:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _ns_each(fns: dict, n: int, rounds: int = 7) -> dict:
    """{name: the least host ns a call of ``fns[name](n)`` took per
    iteration}, the functions taken in turn each round."""
    best = {k: float("inf") for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            t0 = time.perf_counter_ns()
            fn(n)
            best[k] = min(best[k], (time.perf_counter_ns() - t0) / n)
    return best


def span_costs(n: int) -> dict:
    plain = _Plain()

    def empty(k):
        for _ in range(k):
            with plain:
                pass

    def spans(k):
        with tracing.request("cost.req", device="cuda" if torch.cuda.is_available() else None):
            for _ in range(k):
                with tracing.span("cost.span"):
                    pass

    def waits(k):
        with tracing.request("cost.req"):
            for _ in range(k):
                with tracing.wait("cost.wait"):
                    pass

    def counts(k):
        with tracing.request("cost.req"):
            for _ in range(k):
                tracing.count("cost.n")

    def outside(k):
        for _ in range(k):
            with tracing.span("cost.span"):
                pass

    out = _ns_each({"empty_with_ns": empty, "span_ns": spans, "wait_ns": waits,
                    "count_ns": counts, "span_outside_request_ns": outside}, n)
    with tracing.full_mode():
        out.update(_ns_each({"span_full_ns": spans}, n, 3))
    tracing.clear_events()
    if torch.cuda.is_available():
        with tracing.full_mode(device=True):
            out.update(_ns_each({"span_full_device_ns": spans}, min(n, 20000), 3))
        torch.cuda.synchronize()
        tracing.clear_events()
    return out


def vis_costs(runs: int) -> dict:
    from ..models import meta
    from ..models.detr import MDQEModel
    from .profile_vis import CFG, INF, crowded
    H, W, n_frames = 360, 640, 36
    inf = crowded(INF)
    model = MDQEModel(CFG, device="cuda", seed=0)
    video = np.random.default_rng(0).integers(0, 255, (n_frames, H, W, 3)).astype(np.uint8)
    frames, _ = meta.preprocess_frames(video)

    def run():
        return meta.inference_vis(model, inf, frames, (H, W), (H, W))
    for _ in range(2):
        run()
    clips = tracing.last("vis.video").attrs["clips"]
    rates = {"default": [], "full_device": []}
    for _ in range(runs):
        for mode in rates:
            torch.cuda.synchronize()
            with tracing.full_mode(device=True) if mode == "full_device" else _Plain():
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                rates[mode].append(clips / (time.perf_counter() - t0))
            tracing.clear_events()
    req = tracing.last("vis.video")
    return {"clips": clips, "clips_per_s": rates,
            "median_clips_per_s": {k: statistics.median(v) for k, v in rates.items()},
            "spans_a_video": sum(s[0] for s in req.spans.values()),
            "syncs_a_video": req.counters.get("vis.syncs", 0),
            "host_ms": {k: round(v * 1e3, 3) for k, v in req.seconds().items()}}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=200000, help="spans a round")
    parser.add_argument("--runs", type=int, default=10, help="rounds of the VIS comparison")
    args = parser.parse_args()
    card = "cpu"
    if torch.cuda.is_available():
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", "-i", "0"],
                              capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "span_costs": span_costs(args.n)}), flush=True)
    if torch.cuda.is_available():
        print(json.dumps({"card": card, "vis": vis_costs(args.runs)}), flush=True)


if __name__ == "__main__":
    main()
