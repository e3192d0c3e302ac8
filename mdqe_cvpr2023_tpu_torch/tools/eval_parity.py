#!/usr/bin/env python3
"""AP / prediction parity runner (counterpart of the repository's
``tools/eval_parity.py``): one command to compare the port against the
reference (or the JAX package) on real weights and data.

  run   -- the port's evaluation of a checkpoint on a registered dataset,
           writing results_<name>.json (the per-track records the reference's
           YTVISEvaluator writes, ytvis_eval.py:136-140) through
           ``Trainer.test``, on the card unless --device cpu:
             python3 -m mdqe_cvpr2023_tpu_torch.tools.eval_parity run
                 --config configs/R50_ovis_360.yaml --weights R50_ovis.pth
                 --dataset ytvis_ovis_dev --datasets-root /data --output out_ours
                 [--max-videos N] [--device cuda|cpu] [KEY VALUE ...]

  diff  -- compare two results files video by video:
             python3 -m mdqe_cvpr2023_tpu_torch.tools.eval_parity diff ours.json ref.json
                 [--gt valid_sub.json] [--iou-match 0.5] [--ap-tol 0.3] [--per-video]
           Greedy per-video matching by video mask IoU (frame-RLE intersection
           over union summed over the track: the reference's iou_seq,
           pycocotools/ytvoseval.py:200-214); reports unmatched counts, matched
           IoU / score / category deltas and, with --gt, both sides' AP through
           the port's YTVIS evaluator with the delta held to --ap-tol.

Exit status: 0 on parity (AP delta <= tol and no structural mismatch), 1 otherwise.
"""
import argparse
import json
import os
import sys
from collections import defaultdict

import numpy as np

def _video_iou(segs_a, segs_b, rle):
    """Video IoU: per-frame intersections and unions summed over the track,
    then divided (``rle.video_iou``, by interval arithmetic on the runs; the
    JAX tool rasterizes each intersection). Tracks with differing frame
    counts (one side wrote fewer frames) treat the missing frames as empty
    on the shorter side: a silent zip truncation would inflate the IoU and
    hide a structural mismatch in a tool whose exit code gates parity."""
    n = max(len(segs_a), len(segs_b))
    return rle.video_iou(list(segs_a) + [None] * (n - len(segs_a)),
                         list(segs_b) + [None] * (n - len(segs_b)))


def cmd_run(args):
    from ..engine.config import load_config
    from ..engine.trainer import Trainer

    cfg = load_config(args.config, args.opts or None)
    if args.weights:
        cfg.MODEL.WEIGHTS = args.weights
    cfg.OUTPUT_DIR = args.output
    tr = Trainer(cfg, datasets_root=args.datasets_root, device=args.device)
    metrics, _ = tr.test(args.dataset, max_videos=args.max_videos)
    if metrics:
        print(json.dumps({k: round(v, 3) for k, v in metrics.items()
                          if not isinstance(v, dict)}))
    print(f"wrote {os.path.join(args.output, f'results_{args.dataset}.json')}")
    return 0


def cmd_diff(args):
    from ..data import rle

    with open(args.a) as f:
        preds_a = json.load(f)
    with open(args.b) as f:
        preds_b = json.load(f)

    by_vid_a, by_vid_b = defaultdict(list), defaultdict(list)
    for p in preds_a:
        by_vid_a[p["video_id"]].append(p)
    for p in preds_b:
        by_vid_b[p["video_id"]].append(p)

    vids = sorted(set(by_vid_a) | set(by_vid_b))
    n_match = n_only_a = n_only_b = n_cat_mismatch = 0
    ious, dscores = [], []
    per_video = {}
    for v in vids:
        pa = sorted(by_vid_a.get(v, []), key=lambda p: -p["score"])
        pb = list(by_vid_b.get(v, []))
        matched_b = set()
        v_ious = []
        for a in pa:
            best_j, best_iou = -1, 0.0
            for j, b in enumerate(pb):
                if j in matched_b:
                    continue
                i = _video_iou(a["segmentations"], b["segmentations"], rle)
                if i > best_iou:
                    best_j, best_iou = j, i
            if best_j >= 0 and best_iou >= args.iou_match:
                matched_b.add(best_j)
                n_match += 1
                ious.append(best_iou)
                v_ious.append(best_iou)
                dscores.append(abs(a["score"] - pb[best_j]["score"]))
                n_cat_mismatch += a["category_id"] != pb[best_j]["category_id"]
            else:
                n_only_a += 1
        n_only_b += len(pb) - len(matched_b)
        per_video[v] = {"a": len(pa), "b": len(pb),
                        "matched": len(matched_b),
                        "mean_iou": round(float(np.mean(v_ious)), 4)
                        if v_ious else None}

    report = {
        "videos": len(vids),
        "matched_tracks": n_match,
        "only_in_a": n_only_a,
        "only_in_b": n_only_b,
        "category_mismatches": n_cat_mismatch,
        "mean_matched_iou": round(float(np.mean(ious)), 4) if ious else None,
        "min_matched_iou": round(float(np.min(ious)), 4) if ious else None,
        "max_abs_score_delta": round(float(np.max(dscores)), 4) if dscores else None,
    }

    ok = True
    if args.gt:
        from ..data.ytvis_eval import YTVISEvaluator
        with open(args.gt) as f:
            gt_json = json.load(f)
        ev = YTVISEvaluator(gt_json)
        m_a = ev.evaluate(preds_a)
        m_b = ev.evaluate(preds_b)
        deltas = {k: round(m_a[k] - m_b[k], 3) for k in m_a
                  if not isinstance(m_a[k], dict) and k in m_b}
        report["AP_a"] = round(m_a.get("AP", float("nan")), 3)
        report["AP_b"] = round(m_b.get("AP", float("nan")), 3)
        report["AP_deltas"] = deltas
        ok &= abs(m_a.get("AP", 0.0) - m_b.get("AP", 0.0)) <= args.ap_tol

    if args.per_video:
        report["per_video"] = per_video
    print(json.dumps(report, indent=1))
    # structural parity: every track matched with a counterpart
    ok &= n_only_a == 0 and n_only_b == 0 and n_cat_mismatch == 0
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run our eval -> results json")
    r.add_argument("--config", required=True)
    r.add_argument("--weights", default=None)
    r.add_argument("--dataset", required=True)
    r.add_argument("--datasets-root", default=None)
    r.add_argument("--output", default="eval_parity_out")
    r.add_argument("--max-videos", type=int, default=None)
    r.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain PyTorch path)")
    r.add_argument("opts", nargs=argparse.REMAINDER, help="config overrides: KEY VALUE pairs")

    d = sub.add_parser("diff", help="diff two results.json files")
    d.add_argument("a", help="ours results.json")
    d.add_argument("b", help="reference results.json")
    d.add_argument("--gt", default=None, help="GT annotations json (enables AP)")
    d.add_argument("--iou-match", type=float, default=0.5)
    d.add_argument("--ap-tol", type=float, default=0.3,
                   help="BASELINE.md north-star: AP within 0.3")
    d.add_argument("--per-video", action="store_true")

    args = ap.parse_args(argv)
    sys.exit(cmd_run(args) if args.cmd == "run" else cmd_diff(args))


if __name__ == "__main__":
    main()
