"""Dataset loading, the clip mapper, collation and the mixing loader (host
side), the port's own copy of ``mdqe_cvpr2023_tpu/data/dataset.py``:

  - ``load_ytvis_json``: per-video records with per-frame annotation lists;
  - ``load_coco_json_as_pseudo_videos``: COCO images as one-frame videos;
  - ``ClipMapper``: in training, SAMPLING_FRAME_NUM frames around a random
    reference frame within +-SAMPLING_FRAME_RANGE, clip-consistent
    augmentations, annotations aligned by instance id (ids of instances empty
    in a frame become -1);
  - ``collate_clips``: the fixed-shape batch that ``parallel/train.py``'s step
    eats (images uint8, image_sizes, labels, ids, boxes, masks, valid);
  - ``CombinedClipLoader``: batch k is a pure function of (seed, k).

The random draws are those of the JAX package, in its order, so one seed gives
bit-equal batches in both.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from . import rle as rle_util
from .augmentation import AugmentationPipeline, apply_transforms
from .image import read_image


def load_ytvis_json(json_file: str, image_root: str = "") -> List[Dict]:
    """Returns per-video records: {video_id, file_names, height, width, length,
    annotations: list over frames of lists of {id, category_id, bbox(xyxy), mask}}."""
    with open(json_file) as f:
        data = json.load(f)
    anns_by_video: Dict[int, list] = {}
    for ann in data.get("annotations", []):
        anns_by_video.setdefault(ann["video_id"], []).append(ann)

    records = []
    for video in data["videos"]:
        length = len(video["file_names"])
        frames: List[list] = [[] for _ in range(length)]
        for ann in anns_by_video.get(video["id"], []):
            for fi in range(length):
                seg = ann["segmentations"][fi] if fi < len(ann["segmentations"]) else None
                bbox = ann["bboxes"][fi] if ann.get("bboxes") and fi < len(ann["bboxes"]) else None
                if seg is None and bbox is None:
                    continue
                frames[fi].append({
                    "id": ann["id"],
                    "category_id": ann["category_id"],
                    "bbox": bbox,            # xywh (COCO) or None
                    "segmentation": seg,     # RLE dict / polygon / None
                    "iscrowd": ann.get("iscrowd", 0),
                })
        records.append({
            "video_id": video["id"],
            "file_names": [os.path.join(image_root, f) for f in video["file_names"]],
            "height": video["height"],
            "width": video["width"],
            "length": length,
            "annotations": frames,
        })
    return records


def load_coco_json_as_pseudo_videos(json_file: str, image_root: str = "",
                                    category_map: Optional[Dict[int, int]] = None
                                    ) -> List[Dict]:
    """COCO instances json -> single-frame video records (for pseudo clips).
    category_map maps COCO ids to VIS ids; images with no mapped anns are dropped."""
    with open(json_file) as f:
        data = json.load(f)
    anns_by_img: Dict[int, list] = {}
    for ann in data.get("annotations", []):
        if ann.get("iscrowd", 0):
            continue
        cid = ann["category_id"]
        if category_map is not None:
            if cid not in category_map:
                continue
            cid = category_map[cid]
        anns_by_img.setdefault(ann["image_id"], []).append({**ann,
                                                           "category_id": cid})
    records = []
    for img in data["images"]:
        anns = anns_by_img.get(img["id"], [])
        if not anns:
            continue
        records.append({
            "video_id": img["id"],
            "file_names": [os.path.join(image_root, img["file_name"])],
            "height": img["height"],
            "width": img["width"],
            "length": 1,
            "annotations": [[{
                "id": a["id"], "category_id": a["category_id"],
                "bbox": a.get("bbox"), "segmentation": a.get("segmentation"),
                "iscrowd": 0,
            } for a in anns]],
        })
    return records


def _seg_to_mask(seg, h, w) -> np.ndarray:
    if seg is None:
        return np.zeros((h, w), bool)
    if isinstance(seg, dict):
        if isinstance(seg["counts"], list):
            seg = {"size": seg["size"],
                   "counts": rle_util.counts_to_string(seg["counts"])}
        return rle_util.decode(seg).astype(bool)
    # polygons
    from .ytvis_eval import _polys_to_mask
    return _polys_to_mask(seg, h, w)


class ClipMapper:
    """Maps a video record + frame selection to a training clip sample."""

    def __init__(self, augmentations: AugmentationPipeline, n_frames: int,
                 frame_range: int = 10, category_offset: int = -1,
                 is_train: bool = True, frame_shuffle: bool = False,
                 pseudo: bool = False):
        self.aug = augmentations
        self.n_frames = n_frames
        self.frame_range = frame_range
        self.is_train = is_train
        self.frame_shuffle = frame_shuffle
        self.pseudo = pseudo
        # category ids in jsons are 1-based; model classes are 0-based
        self.category_offset = category_offset

    def _select_frames(self, rng, video_length: int) -> List[int]:
        if not self.is_train:
            return list(range(video_length))
        if self.pseudo:
            return [0] * self.n_frames  # same image repeated (augs differ per frame)
        ref = int(rng.integers(0, video_length))
        lo = max(0, ref - self.frame_range)
        hi = min(video_length, ref + self.frame_range + 1)
        pool = [i for i in range(lo, hi) if i != ref]
        if not pool:
            pool = [ref]
        extra = rng.choice(np.asarray(pool), self.n_frames - 1).tolist() \
            if self.n_frames > 1 else []
        sel = sorted(extra + [ref])
        if self.frame_shuffle:
            rng.shuffle(sel)
        return sel

    def __call__(self, record: Dict, rng: np.random.Generator,
                 min_size: Optional[int] = None) -> Dict:
        sel = self._select_frames(rng, record["length"])
        T = len(sel)
        H, W = record["height"], record["width"]
        tfms = self.aug.sample(rng, (H, W), T, min_size=min_size)

        # instance-id registry across selected frames
        ids_present = []
        for fi in sel:
            for a in record["annotations"][fi]:
                if a["id"] not in ids_present:
                    ids_present.append(a["id"])
        id_slot = {aid: i for i, aid in enumerate(ids_present)}
        N = len(ids_present)

        images = []
        out_hw = None
        classes = np.full((N,), -1, np.int64)
        gt_ids = np.full((N, T), -1, np.int64)
        boxes_all = []
        masks_all = []
        for t, fi in enumerate(sel):
            img = read_image(record["file_names"][fi])
            anns = record["annotations"][fi]
            boxes = np.zeros((N, 4), np.float64)
            masks = np.zeros((N, H, W), bool)
            present = np.zeros((N,), bool)
            for a in anns:
                s = id_slot[a["id"]]
                m = _seg_to_mask(a.get("segmentation"), H, W)
                masks[s] = m
                if a.get("bbox") is not None:
                    x, y, w, h = a["bbox"]
                    boxes[s] = [x, y, x + w, y + h]
                elif m.any():
                    ys, xs = np.nonzero(m)
                    boxes[s] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
                classes[s] = a["category_id"] + self.category_offset
                present[s] = True

            img, boxes, masks = apply_transforms(tfms, img, boxes, masks, t)
            out_hw = img.shape[:2]
            # clip boxes to the transformed image and drop empties (-> id -1)
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, out_hw[1])
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, out_hw[0])
            nonempty = masks.reshape(N, -1).sum(-1) > 0 if N else np.zeros(0, bool)
            gt_ids[:, t] = np.where(present & nonempty,
                                    np.arange(N, dtype=np.int64), -1)
            boxes_all.append(boxes)
            masks_all.append(masks)
            images.append(img)

        return {
            "video_id": record["video_id"],
            "frame_idx": sel,
            "images": np.stack(images),                   # (T, h, w, 3) uint8
            "height": out_hw[0], "width": out_hw[1],
            "labels": classes,                            # (N,)
            "ids": gt_ids,                                # (N, T)
            "boxes": np.stack(boxes_all, axis=1) if N else np.zeros((0, T, 4)),
            "masks": np.stack(masks_all, axis=1) if N else np.zeros((0, T) + tuple(out_hw), bool),
        }


def collate_clips(samples: List[Dict], max_instances: int, size_divisibility=32,
                  pad_hw=None) -> Dict[str, np.ndarray]:
    """Pad a list of clip samples to a fixed-shape train batch (see
    parallel.train.make_train_step for the consumed layout)."""
    B = len(samples)
    T = samples[0]["images"].shape[0]
    if pad_hw is None:
        Hm = max(s["height"] for s in samples)
        Wm = max(s["width"] for s in samples)
        Hp = -(-Hm // size_divisibility) * size_divisibility
        Wp = -(-Wm // size_divisibility) * size_divisibility
    else:
        Hp, Wp = pad_hw
    N = max_instances

    # compact dtypes: uint8 images and bool masks are 4x smaller to copy to
    # the device than f32; the train step normalizes images and casts masks
    # there
    images = np.zeros((B * T, Hp, Wp, 3), np.uint8)
    sizes = np.zeros((B * T, 2), np.int32)
    labels = np.zeros((B, N), np.int32)
    ids = np.full((B, N, T), -1, np.int32)
    boxes = np.zeros((B, N, T, 4), np.float32)
    masks = np.zeros((B, N, T, Hp, Wp), bool)
    valid = np.zeros((B, N), bool)

    for b, s in enumerate(samples):
        h, w = s["height"], s["width"]
        images[b * T:(b + 1) * T, :h, :w] = s["images"][:, :h, :w]
        sizes[b * T:(b + 1) * T] = [h, w]
        n = min(s["labels"].shape[0], N)
        keep = np.argsort(-(s["ids"] >= 0).sum(-1))[:n]  # prefer most-present insts
        labels[b, :n] = s["labels"][keep]
        ids[b, :n] = s["ids"][keep]
        # normalized xyxy boxes (clip-invalid boxes become zeros)
        bx = s["boxes"][keep].astype(np.float32)
        bx[..., 0::2] /= Wp
        bx[..., 1::2] /= Hp
        boxes[b, :n] = bx.clip(0, 1)
        masks[b, :n, :, :h, :w] = s["masks"][keep][:, :, :h, :w] > 0
        valid[b, :n] = (s["labels"][keep] >= 0) & ((s["ids"][keep] >= 0).any(-1))
    return {"images": images, "image_sizes": sizes, "labels": labels, "ids": ids,
            "boxes": boxes, "masks": masks, "valid": valid}


class CombinedClipLoader:
    """Ratio-mixing loader over several (records, mapper) sources.

      - batch k is a pure function of (seed, k) (``batch_at``), so training
        resumes mid-stream bit-exactly and worker threads decode and augment
        future batches independently (``iter_from`` with num_workers > 0 keeps
        a bounded window of futures in flight; OpenCV, Pillow and torch release
        the GIL, so the threads overlap host decode with the device's steps);
      - one short-side draw per batch, so that the whole batch lands in one
        resolution bucket of ``size_buckets`` and the step sees few shapes.
    """

    def __init__(self, sources, ratios, batch_size: int, max_instances: int,
                 seed: int = 0, pad_hw=None, size_buckets=None,
                 num_workers: int = 0, prefetch_depth: int = 4, transfer=None):
        if len(sources) != len(ratios):
            raise ValueError(f"{len(sources)} sources but {len(ratios)} ratios")
        self.sources = sources
        self.ratios = np.asarray(ratios, np.float64) / np.sum(ratios)
        self.batch_size = batch_size
        self.max_instances = max_instances
        self.seed = seed
        self.pad_hw = pad_hw
        # sorted by area: smallest fitting bucket wins
        self.size_buckets = sorted(size_buckets, key=lambda b: b[0] * b[1]) \
            if size_buckets else None
        self.num_workers = num_workers
        self.prefetch_depth = max(prefetch_depth, num_workers)
        # optional callback run on each batch inside the worker threads (the
        # Trainer pins the batch's host memory there, so that the copy to the
        # card, made on the step's stream, need not stage it)
        self.transfer = transfer
        self.last_wait_s = 0.0  # host time the consumer blocked on the last batch

    def _bucket_for(self, maxh: int, maxw: int):
        pad32 = lambda v: -(-v // 32) * 32
        if self.size_buckets:
            for bh, bw in self.size_buckets:
                if maxh <= bh and maxw <= bw:
                    return bh, bw
        if self.pad_hw and maxh <= self.pad_hw[0] and maxw <= self.pad_hw[1]:
            return self.pad_hw
        return pad32(maxh), pad32(maxw)  # rare fallback (extreme aspect ratios)

    def batch_at(self, k: int) -> Dict:
        rng = np.random.default_rng([self.seed, k])
        si = int(rng.choice(len(self.sources), p=self.ratios))
        records, mapper = self.sources[si]
        min_size = None
        if mapper.aug.is_train and mapper.aug.min_sizes:
            min_size = int(rng.choice(list(mapper.aug.min_sizes)))
        samples = []
        while len(samples) < self.batch_size:
            rec = records[int(rng.integers(0, len(records)))]
            s = mapper(rec, rng, min_size=min_size)
            if (s["labels"] >= 0).any():
                samples.append(s)
        maxh = max(s["height"] for s in samples)
        maxw = max(s["width"] for s in samples)
        return collate_clips(samples, self.max_instances,
                             pad_hw=self._bucket_for(maxh, maxw))

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start: int = 0):
        """Infinite batch stream starting at index `start` (pass the resume
        iteration to continue an interrupted run on the exact same data)."""
        import time as _time
        produce = self.batch_at if self.transfer is None \
            else (lambda k: self.transfer(self.batch_at(k)))
        if self.num_workers <= 0:
            k = start
            while True:
                t0 = _time.perf_counter()
                b = produce(k)
                self.last_wait_s = _time.perf_counter() - t0
                yield b
                k += 1
            return
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        ex = ThreadPoolExecutor(self.num_workers,
                                thread_name_prefix="clip_loader")
        try:
            pending = deque(ex.submit(produce, start + i)
                            for i in range(self.prefetch_depth))
            k = start + self.prefetch_depth
            while True:
                t0 = _time.perf_counter()
                b = pending.popleft().result()
                self.last_wait_s = _time.perf_counter() - t0
                pending.append(ex.submit(produce, k))
                k += 1
                yield b
        finally:
            ex.shutdown(wait=False, cancel_futures=True)
