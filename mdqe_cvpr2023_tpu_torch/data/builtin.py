"""Dataset split registry, the port's own copy of
``mdqe_cvpr2023_tpu/data/builtin.py``: each split resolves to (image root, json)
under $MDQE_DATASETS_ROOT (default ./datasets), in the layout the YTVIS, OVIS
and COCO releases unpack to.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

from .categories import COCO_TO_OVIS, COCO_TO_YTVIS_2019, COCO_TO_YTVIS_2021

_ROOT = os.environ.get("MDQE_DATASETS_ROOT", "datasets")

# name -> (image_root, json_path)
DATASET_SPLITS: Dict[str, Tuple[str, str]] = {
    "ytvis_2019_train": ("ytvis_2019/train/JPEGImages", "ytvis_2019/train.json"),
    "ytvis_2019_val": ("ytvis_2019/valid/JPEGImages", "ytvis_2019/valid.json"),
    "ytvis_2019_dev": ("ytvis_2019/train/JPEGImages", "ytvis_2019/valid_sub.json"),
    "ytvis_2019_train_sub": ("ytvis_2019/train/JPEGImages", "ytvis_2019/train_sub.json"),
    "ytvis_2021_train": ("ytvis_2021/train/JPEGImages", "ytvis_2021/train.json"),
    "ytvis_2021_val": ("ytvis_2021/valid/JPEGImages", "ytvis_2021/valid.json"),
    "ytvis_2021_dev": ("ytvis_2021/train/JPEGImages", "ytvis_2021/valid_sub.json"),
    "ytvis_2021_train_sub": ("ytvis_2021/train/JPEGImages", "ytvis_2021/train_sub.json"),
    "ytvis_ovis_train": ("ovis/train", "ovis/annotations_train.json"),
    "ytvis_ovis_val": ("ovis/valid", "ovis/annotations_valid.json"),
    "ytvis_ovis_dev": ("ovis/train", "ovis/valid_sub.json"),
    "ytvis_ovis_train_sub": ("ovis/train", "ovis/train_sub.json"),
    "coco2ytvis2019_train": ("coco/train2017", "coco/annotations/coco2ytvis2019_train.json"),
    "coco2ytvis2021_train": ("coco/train2017", "coco/annotations/coco2ytvis2021_train.json"),
    "coco2ovis_train": ("coco/train2017", "coco/annotations/coco2ovis_train.json"),
    "coco_2017_train": ("coco/train2017", "coco/annotations/instances_train2017.json"),
    "coco_2017_val": ("coco/val2017", "coco/annotations/instances_val2017.json"),
}

CATEGORY_MAPS = {
    "ytvis_2019": COCO_TO_YTVIS_2019,
    "ytvis_2021": COCO_TO_YTVIS_2021,
    "ovis": COCO_TO_OVIS,
}


def get_dataset(name: str, root: str | None = None):
    """Returns video records for a registered split (COCO splits are returned as
    pseudo-video records)."""
    from .dataset import load_coco_json_as_pseudo_videos, load_ytvis_json

    root = root or _ROOT
    image_root, json_path = DATASET_SPLITS[name]
    image_root = os.path.join(root, image_root)
    json_path = os.path.join(root, json_path)
    if name.startswith("coco"):
        return load_coco_json_as_pseudo_videos(json_path, image_root)
    return load_ytvis_json(json_path, image_root)
