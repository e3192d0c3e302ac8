#!/usr/bin/env python3
"""Dataset conversion (counterpart of the repository's
``tools/convert_dataset.py``; the reference convert_dataset.py:17-118), on
the port's category tables:

1. ``coco2vis``: keep the COCO annotations of a VIS dataset's categories
   (-> coco2{ytvis19,ytvis21,ovis}_train.json), their ids remapped;
2. ``split``: split a VIS train.json into train_sub (90%) / valid_sub (10%)
   by the first category of each video, for local evaluation (the valid
   annotations are server-only).

Usage:
  python3 -m mdqe_cvpr2023_tpu_torch.tools.convert_dataset coco2vis
      --coco-json .../instances_train2017.json --target {ytvis19,ytvis21,ovis}
      --out coco2ovis_train.json
  python3 -m mdqe_cvpr2023_tpu_torch.tools.convert_dataset split
      --train-json .../train.json --out-dir datasets/ovis/ [--ratio 0.1] [--seed 0]
"""
import argparse
import json
import os
import random

from ..data.categories import COCO_TO_OVIS, COCO_TO_YTVIS_2019, COCO_TO_YTVIS_2021

MAPS = {"ytvis19": COCO_TO_YTVIS_2019, "ytvis21": COCO_TO_YTVIS_2021,
        "ovis": COCO_TO_OVIS}


def coco2vis(coco_json, target, out):
    cmap = MAPS[target]
    with open(coco_json) as f:
        data = json.load(f)
    anns = [dict(a, category_id=cmap[a["category_id"]])
            for a in data["annotations"] if a["category_id"] in cmap]
    img_ids = {a["image_id"] for a in anns}
    images = [im for im in data["images"] if im["id"] in img_ids]
    out_data = {"images": images, "annotations": anns,
                "categories": data["categories"]}
    with open(out, "w") as f:
        json.dump(out_data, f)
    print(f"kept {len(images)} images / {len(anns)} annotations -> {out}")


def split(train_json, out_dir, ratio=0.1, seed=0):
    with open(train_json) as f:
        data = json.load(f)
    rng = random.Random(seed)
    # group videos by their (first) category so each category is represented
    by_cat = {}
    vid_cat = {}
    for ann in data["annotations"]:
        vid_cat.setdefault(ann["video_id"], ann["category_id"])
    for v in data["videos"]:
        by_cat.setdefault(vid_cat.get(v["id"], -1), []).append(v["id"])
    valid_ids = set()
    for cat, vids in by_cat.items():
        vids = sorted(vids)
        rng.shuffle(vids)
        n_val = max(1, int(len(vids) * ratio)) if cat != -1 else 0
        valid_ids.update(vids[:n_val])

    def subset(ids):
        return {
            "videos": [v for v in data["videos"] if v["id"] in ids],
            "annotations": [a for a in data["annotations"]
                            if a["video_id"] in ids],
            "categories": data["categories"],
        }

    train_ids = {v["id"] for v in data["videos"]} - valid_ids
    os.makedirs(out_dir, exist_ok=True)
    for name, ids in [("train_sub", train_ids), ("valid_sub", valid_ids)]:
        path = os.path.join(out_dir, f"{name}.json")
        with open(path, "w") as f:
            json.dump(subset(ids), f)
        print(f"{name}: {len(ids)} videos -> {path}")


def main(argv=None):
    p = argparse.ArgumentParser(description="VIS dataset conversion")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("coco2vis")
    c.add_argument("--coco-json", required=True)
    c.add_argument("--target", required=True, choices=list(MAPS))
    c.add_argument("--out", required=True)
    s = sub.add_parser("split")
    s.add_argument("--train-json", required=True)
    s.add_argument("--out-dir", required=True)
    s.add_argument("--ratio", type=float, default=0.1)
    s.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.cmd == "coco2vis":
        coco2vis(args.coco_json, args.target, args.out)
    else:
        split(args.train_json, args.out_dir, args.ratio, args.seed)


if __name__ == "__main__":
    main()
