"""Draw a VIS results file on its frames (counterpart of the repository's
``demo/visualizer_from_json.py``; the reference
demo/clip/visualizer_from_json.py:16-126) with the port's RLE codec.

Reads the results format ([{video_id, score, category_id, segmentations:
[RLE ...]}]) and the dataset's annotation json (file names, sizes, category
names), drops near-identical tracks by mask IoU (the multi-class expansion
emits one entry a class for the same mask), and writes overlay frames a video.

Usage:
  python -m mdqe_cvpr2023_tpu_torch.demo.visualizer_from_json --results results.json
      --annotations datasets/ovis/valid.json --images datasets/ovis/valid
      --output OUT_DIR [--score-threshold 0.1] [--frame-step 2] [--max-videos N]
"""
from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np

from .clip_demo import color_for


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="draw a VIS results file")
    p.add_argument("--results", required=True)
    p.add_argument("--annotations", required=True)
    p.add_argument("--images", required=True, help="root dir of video frames")
    p.add_argument("--output", required=True)
    p.add_argument("--score-threshold", type=float, default=0.1)
    p.add_argument("--frame-step", type=int, default=2,
                   help="draw every k-th frame (the reference draws every 2nd)")
    p.add_argument("--max-videos", type=int, default=None)
    return p.parse_args(argv)


def dedup_tracks(masks, scores):
    """Indices of the tracks to keep, in order: a track is kept if its mask
    IoU on subsampled frames against every kept one has mean < 0.75 and max
    < 0.98 (reference visualizer_from_json.py:73-86). ``scores`` is unused:
    the caller sorts by score."""
    if not masks:
        return []
    step = max(masks[0].shape[0] // 25, 1)
    subs = [m[::step].astype(np.float32) for m in masks]
    keep = [0]
    for i in range(1, len(masks)):
        m = subs[i]
        ok = True
        for j in keep:
            inter = (subs[j] * m).sum(axis=(-1, -2))
            union = np.clip((subs[j] + m - subs[j] * m).sum(axis=(-1, -2)), 1, None)
            siou = inter / union
            if siou.mean() >= 0.75 or siou.max() >= 0.98:
                ok = False
                break
        if ok:
            keep.append(i)
    return keep


def main(argv=None):
    import cv2
    from ..data import rle as rle_codec

    args = parse_args(argv)
    with open(args.results) as f:
        results = json.load(f)
    with open(args.annotations) as f:
        anno = json.load(f)
    videos = {v["id"]: v for v in anno["videos"]}
    cats = {c["id"]: c.get("name", str(c["id"])) for c in anno.get("categories", [])}
    os.makedirs(args.output, exist_ok=True)

    by_video = defaultdict(list)
    for r in results:
        if r["score"] > args.score_threshold:
            by_video[r["video_id"]].append(r)

    for n_done, (vid, rs) in enumerate(sorted(by_video.items())):
        if args.max_videos is not None and n_done >= args.max_videos:
            break
        if vid not in videos:
            continue
        info = videos[vid]
        rs = sorted(rs, key=lambda r: -r["score"])
        masks = []
        for r in rs:
            ms = np.stack([rle_codec.decode(s) if s else
                           np.zeros((info["height"], info["width"]), np.uint8)
                           for s in r["segmentations"]])
            masks.append(ms.astype(bool))
        keep = dedup_tracks(masks, [r["score"] for r in rs])

        vdir = os.path.join(args.output, f"video_{vid}")
        os.makedirs(vdir, exist_ok=True)
        for t in range(0, info["length"], args.frame_step):
            frame = cv2.imread(os.path.join(args.images, info["file_names"][t]))
            if frame is None:
                frame = np.zeros((info["height"], info["width"], 3), np.uint8)
            for k, i in enumerate(keep):
                m = masks[i][t]
                col = color_for(k)
                frame[m] = (0.5 * frame[m] + 0.5 * col[::-1]).astype(np.uint8)
                ys, xs = np.nonzero(m)
                if len(ys):
                    label = cats.get(rs[i]["category_id"], str(rs[i]["category_id"]))
                    cv2.putText(frame, f"{label}:{rs[i]['score']:.2f}",
                                (int(xs.min()), max(int(ys.min()) - 4, 10)),
                                cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                                tuple(int(c) for c in col[::-1]), 1)
            cv2.imwrite(os.path.join(vdir, f"f{t:04d}.jpg"), frame)
        print(f"video {vid}: {len(keep)}/{len(rs)} tracks after dedup", flush=True)


if __name__ == "__main__":
    main()
