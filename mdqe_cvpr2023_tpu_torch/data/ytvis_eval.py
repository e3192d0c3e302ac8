"""Video instance segmentation evaluation (the YTVIS/OVIS protocol), the
port's own copy of ``mdqe_cvpr2023_tpu/data/ytvis_eval.py``: COCO-style AP over
videos with the video-level IoU (per-frame intersections and unions summed
over the track), IoU thresholds .5:.05:.95, maxDets (1, 10, 100), the area
ranges all / [0, 128^2] / [128^2, 256^2] / [256^2, 1e10] on the GT's average
per-frame area, and the greedy score-ordered matching with the
precision/recall accumulation. Host numpy; the RLE ops come from ``.rle``.
Polygon GT is rasterized with Pillow, which only polygon annotations need.
"""
from __future__ import annotations

import copy
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

from . import rle as rle_util

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = (1, 10, 100)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 128.0 ** 2),
    "medium": (128.0 ** 2, 256.0 ** 2),
    "large": (256.0 ** 2, 1e10),
}


def _video_iou_matrix(dts: List[dict], gts: List[dict]) -> np.ndarray:
    ious = np.zeros((len(dts), len(gts)))
    for i, d in enumerate(dts):
        for j, g in enumerate(gts):
            ious[i, j] = rle_util.video_iou(d["segmentations"], g["segmentations"],
                                            iscrowd=bool(g.get("iscrowd", 0)))
    return ious


def _avg_area(gt: dict) -> float:
    areas = [a for a in gt.get("areas", []) if a]
    if not areas:
        segs = [s for s in gt["segmentations"] if s]
        areas = [rle_util.area(s) for s in segs]
    return float(np.mean(areas)) if areas else 0.0


def _evaluate_video(dts, gts, ious, area_rng, max_det):
    """Greedy matching for one (video, category, areaRng, maxDet) cell."""
    T = len(IOU_THRS)
    for g in gts:
        out_of_range = not (area_rng[0] <= g["_avg_area"] <= area_rng[1])
        g["_ignore"] = 1 if (g.get("iscrowd", 0) or out_of_range) else 0
    gt_order = np.argsort([g["_ignore"] for g in gts], kind="stable")
    gts = [gts[i] for i in gt_order]
    dts = dts[:max_det]
    ious_s = ious[:, gt_order] if ious.size else ious

    G, D = len(gts), len(dts)
    gtm = np.zeros((T, G), dtype=np.int64)
    dtm = np.zeros((T, D), dtype=np.int64)
    gt_ig = np.array([g["_ignore"] for g in gts])
    dt_ig = np.zeros((T, D))

    for t, thr in enumerate(IOU_THRS):
        for di, d in enumerate(dts):
            best_iou = min(thr, 1 - 1e-10)
            best = -1
            for gi, g in enumerate(gts):
                if gtm[t, gi] > 0 and not g.get("iscrowd", 0):
                    continue
                if best > -1 and gt_ig[best] == 0 and gt_ig[gi] == 1:
                    break  # passed all non-ignored gts
                if ious_s[di, gi] < best_iou:
                    continue
                best_iou = ious_s[di, gi]
                best = gi
            if best == -1:
                continue
            dt_ig[t, di] = gt_ig[best]
            dtm[t, di] = gts[best]["id"]
            gtm[t, best] = d["id"]
    # unmatched dts outside the area range are ignored
    a = np.array([not (area_rng[0] <= d["_avg_area"] <= area_rng[1]) for d in dts])
    dt_ig = np.logical_or(dt_ig, np.logical_and(dtm == 0, np.tile(a, (T, 1))))
    return {
        "dtMatches": dtm,
        "dtScores": np.array([d["score"] for d in dts]),
        "dtIgnore": dt_ig,
        "gtIgnore": gt_ig,
        "num_gt": int((gt_ig == 0).sum()),
    }


class YTVISEvaluator:
    """Collects per-video predictions and computes the VIS AP table.

    gt: dict in YTVIS json format (videos, annotations, categories).
    predictions: list of {'video_id', 'category_id', 'score', 'segmentations'}
    where segmentations is a per-frame list of RLE dicts (or None).
    """

    def __init__(self, gt_json: Dict):
        self.gt = gt_json
        self.cat_ids = sorted(c["id"] for c in gt_json["categories"])
        self.vid_ids = [v["id"] for v in gt_json["videos"]]
        self._gts = defaultdict(list)
        next_id = 1
        for ann in gt_json["annotations"]:
            ann = dict(ann)
            if "id" not in ann:
                ann["id"] = next_id
            next_id = max(next_id, ann["id"] + 1)
            ann["_avg_area"] = _avg_area(ann)
            # polygon / uncompressed-counts support
            segs = []
            for s in ann["segmentations"]:
                segs.append(_ensure_rle(s, gt_json, ann["video_id"]))
            ann["segmentations"] = segs
            self._gts[(ann["video_id"], ann["category_id"])].append(ann)

    def evaluate(self, predictions: Sequence[dict]) -> Dict[str, float]:
        dts = defaultdict(list)
        for i, p in enumerate(predictions):
            p = dict(p)
            p["id"] = i + 1
            segs = [s for s in p["segmentations"] if s]
            areas = [rle_util.area(s) for s in segs]
            p["_avg_area"] = float(np.mean(areas)) if areas else 0.0
            dts[(p["video_id"], p["category_id"])].append(p)

        cells = {}
        for v in self.vid_ids:
            for c in self.cat_ids:
                gt = self._gts.get((v, c), [])
                dt = sorted(dts.get((v, c), []), key=lambda d: -d["score"])
                if not gt and not dt:
                    continue
                ious = _video_iou_matrix(dt[:MAX_DETS[-1]], gt)
                for aname, arng in AREA_RNG.items():
                    for md in MAX_DETS:
                        cells[(v, c, aname, md)] = _evaluate_video(
                            copy.deepcopy(dt[:MAX_DETS[-1]]), copy.deepcopy(gt),
                            ious, arng, md)

        T, R = len(IOU_THRS), len(REC_THRS)
        precision = -np.ones((T, R, len(self.cat_ids), len(AREA_RNG), len(MAX_DETS)))
        recall = -np.ones((T, len(self.cat_ids), len(AREA_RNG), len(MAX_DETS)))
        for ci, c in enumerate(self.cat_ids):
            for ai, aname in enumerate(AREA_RNG):
                for mi, md in enumerate(MAX_DETS):
                    es = [cells[(v, c, aname, md)] for v in self.vid_ids
                          if (v, c, aname, md) in cells]
                    if not es:
                        continue
                    scores = np.concatenate([e["dtScores"] for e in es])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate([e["dtMatches"] for e in es], axis=1)[:, order]
                    dtig = np.concatenate([e["dtIgnore"] for e in es], axis=1)[:, order]
                    npig = sum(e["num_gt"] for e in es)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm > 0, np.logical_not(dtig))
                    fps = np.logical_and(dtm == 0, np.logical_not(dtig))
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[t, ci, ai, mi] = rc[-1] if len(rc) else 0
                        # precision envelope
                        q = np.zeros(R)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[t, :, ci, ai, mi] = q

        def _ap(t=None, area="all", md=100):
            ai = list(AREA_RNG).index(area)
            mi = MAX_DETS.index(md)
            p = precision[:, :, :, ai, mi]
            if t is not None:
                p = p[[t]]
            p = p[p > -1]
            return float(p.mean()) if p.size else float("nan")

        def _ar(area="all", md=100):
            ai = list(AREA_RNG).index(area)
            mi = MAX_DETS.index(md)
            r = recall[:, :, ai, mi]
            r = r[r > -1]
            return float(r.mean()) if r.size else float("nan")

        per_cat = {}
        mi = MAX_DETS.index(100)
        ai = list(AREA_RNG).index("all")
        names = {c["id"]: c["name"] for c in self.gt["categories"]}
        for ci, c in enumerate(self.cat_ids):
            p = precision[:, :, ci, ai, mi]
            p = p[p > -1]
            per_cat[names.get(c, str(c))] = float(p.mean()) * 100 if p.size else float("nan")

        return {
            "AP": _ap() * 100,
            "AP50": _ap(t=0) * 100,
            "AP75": _ap(t=5) * 100,
            "APs": _ap(area="small") * 100,
            "APm": _ap(area="medium") * 100,
            "APl": _ap(area="large") * 100,
            "AR1": _ar(md=1) * 100,
            "AR10": _ar(md=10) * 100,
            "AR100": _ar(md=100) * 100,
            "per_category": per_cat,
        }


def _ensure_rle(seg, gt_json, video_id):
    if seg is None:
        return None
    if isinstance(seg, dict):
        if isinstance(seg["counts"], list):  # uncompressed RLE
            return {"size": seg["size"],
                    "counts": rle_util.counts_to_string(seg["counts"])}
        return seg
    # polygon -> rasterize
    video = next(v for v in gt_json["videos"] if v["id"] == video_id)
    h, w = video["height"], video["width"]
    return rle_util.encode(_polys_to_mask(seg, h, w))


def _polys_to_mask(polys, h, w):
    try:
        from PIL import Image, ImageDraw
    except ImportError:
        raise RuntimeError("polygon annotations require Pillow")
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polys:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly), 2)]
        draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, dtype=bool)
