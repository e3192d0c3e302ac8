"""Clip demo (counterpart of the repository's ``demo/clip_demo.py``; the
reference demo/clip/demo.py and predictor.py:67-118): COCO-style instance
segmentation of single images, each repeated INPUT.SAMPLING_FRAME_NUM times
as a pseudo-clip under one clip-consistent augmentation, through
``inference_image`` on the ``Trainer``'s model, with the detections drawn
over the image into ``<name>_vis.jpg``.

The augmentation is the training one (random short side, crop, flip), one
transform list a clip drawn from ``np.random.default_rng(0)`` in input order;
``--no-aug`` resizes to INPUT.MIN_SIZE_TEST only. Runs on the card unless
``--device cpu``. Each image also gives ``<name>.json``: the detections'
scores, classes, boxes and RLE masks at the image's size. For each image it
prints one JSON line: detections, those above the confidence threshold, the
pseudo-clip's size, host seconds of inference, of drawing (with the jpg) and
of writing the JSON, and the deformable-attention launches per call site.
Then one line for the run: images, the sums, and the seconds of setup
(imports, the Trainer) and of ``main``.

Usage:
  python -m mdqe_cvpr2023_tpu_torch.demo.clip_demo --config-file configs/R50_coco.yaml
      --input IMG [...] --output OUT_DIR [--weights CKPT.pth] [--device cuda|cpu]
      [--confidence-threshold 0.3] [--no-aug] [KEY VALUE ...]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="MDQE clip demo (PyTorch)")
    p.add_argument("--config-file", required=True)
    p.add_argument("--input", nargs="+", required=True, help="image files")
    p.add_argument("--output", required=True)
    p.add_argument("--weights", default=None, help="a .pth checkpoint")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain PyTorch path)")
    p.add_argument("--confidence-threshold", type=float, default=0.3)
    p.add_argument("--no-aug", action="store_true",
                   help="the test-time resize only, no random augmentation")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="config overrides: KEY VALUE pairs")
    return p.parse_args(argv)


def color_for(i):
    rng = np.random.default_rng(i * 7 + 3)
    return rng.integers(60, 255, 3).astype(np.uint8)


def clip_pipeline(cfg, no_aug: bool):
    """The reference predictor augments the same image n_frames times with
    the training clip augmentation (predictor.py:80-84, 96-117); ``no_aug``
    keeps the test-time resize only."""
    from ..data.augmentation import AugmentationPipeline
    return AugmentationPipeline(
        min_sizes=[cfg.INPUT.MIN_SIZE_TEST] if no_aug else list(cfg.INPUT.MIN_SIZE_TRAIN),
        max_size=cfg.INPUT.MAX_SIZE_TRAIN,
        crop_enabled=not no_aug and cfg.INPUT.CROP.ENABLED,
        crop_type=cfg.INPUT.CROP.TYPE,
        crop_size=tuple(cfg.INPUT.CROP.SIZE),
        is_train=not no_aug,
    )


def pseudo_clip(pipe, rng, img, n_frames: int):
    """One transform list a clip, drawn from ``rng`` and reused across its
    frames (reference predictor.py:80-84: per-frame draws give frames of
    other sizes, whose zero padding would reach the model as image content),
    applied to ``img`` n_frames times; the frames zero-padded to a multiple
    of 32. Returns (batch (n_frames, Hp, Wp, 3) uint8, (h, w) before
    padding)."""
    from ..data.augmentation import apply_transforms
    H, W = img.shape[:2]
    tfms = pipe.sample(rng, (H, W), n_frames=n_frames)
    frames = [apply_transforms(tfms, img, np.zeros((0, 4)), np.zeros((0, H, W), bool), t)[0]
              for t in range(n_frames)]
    fh = max(f.shape[0] for f in frames)
    fw = max(f.shape[1] for f in frames)
    batch = np.zeros((n_frames, -(-fh // 32) * 32, -(-fw // 32) * 32, 3), np.uint8)
    for t, f in enumerate(frames):
        batch[t, :f.shape[0], :f.shape[1]] = f
    return batch, (fh, fw)


def overlay(img, out, threshold: float):
    """The detections scoring at least ``threshold`` drawn over ``img``
    (RGB): masks blended at 0.5, boxes and "class:score" labels."""
    import cv2
    vis = img.copy()
    kept = 0
    for i, s in enumerate(out["scores"]):
        if s < threshold:
            continue
        m = out["masks"][i]
        col = color_for(i)
        vis[m] = (0.5 * vis[m] + 0.5 * col).astype(np.uint8)
        x0, y0, x1, y1 = out["boxes"][i].astype(int)
        cv2.rectangle(vis, (x0, y0), (x1, y1), tuple(int(c) for c in col), 2)
        cv2.putText(vis, f"{out['classes'][i]}:{s:.2f}", (x0, max(y0 - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, tuple(int(c) for c in col), 1)
        kept += 1
    return vis, kept


def main(argv=None):
    t_main = time.perf_counter()
    import cv2
    from ..data import rle
    from ..data.image import read_image
    from ..engine.config import load_config
    from ..engine.trainer import Trainer
    from ..models.meta import inference_image
    from ..ops import deform_attn

    args = parse_args(argv)
    cfg = load_config(args.config_file, args.opts or None)
    if args.weights:
        if not os.path.exists(args.weights):
            raise FileNotFoundError(args.weights)
        cfg.MODEL.WEIGHTS = args.weights
    cfg.OUTPUT_DIR = args.output
    trainer = Trainer(cfg, device=args.device)
    t_start = time.perf_counter()

    n_frames = cfg.INPUT.SAMPLING_FRAME_NUM
    rng = np.random.default_rng(0)
    pipe = clip_pipeline(cfg, args.no_aug)
    done = []
    for path in args.input:
        try:
            img = read_image(path)
        except FileNotFoundError:
            print(f"unreadable image: {path}", flush=True)
            continue
        H, W = img.shape[:2]
        batch, size = pseudo_clip(pipe, rng, img, n_frames)
        before = dict(deform_attn.LAUNCHES)
        t0 = time.perf_counter()
        out = inference_image(trainer.model, trainer.inf_cfg, batch, image_size=size,
                              ori_size=(H, W), pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
                              pixel_std=tuple(cfg.MODEL.PIXEL_STD), device=trainer.device)
        t1 = time.perf_counter()
        launches = {k: n - before[k] for k, n in deform_attn.LAUNCHES.items()}
        vis, kept = overlay(img, out, args.confidence_threshold)
        name = os.path.splitext(os.path.basename(path))[0]
        cv2.imwrite(os.path.join(args.output, f"{name}_vis.jpg"), vis[:, :, ::-1])
        t2 = time.perf_counter()
        with open(os.path.join(args.output, f"{name}.json"), "w") as f:
            json.dump({"scores": out["scores"], "classes": out["classes"],
                       "boxes": out["boxes"].tolist(),
                       "masks": [rle.encode(m) for m in out["masks"]]}, f)
        done.append({"infer_s": t1 - t0, "draw_s": t2 - t1,
                     "json_s": time.perf_counter() - t2})
        print(json.dumps({"image": name, "detections": len(out["scores"]), "kept": kept,
                          "size": list(size), **done[-1], "msda_launches": launches}),
              flush=True)
    print(json.dumps({"images": len(done),
                      **{k: sum(d[k] for d in done) for k in ("infer_s", "draw_s", "json_s")},
                      "setup_s": t_start - t_main, "main_s": time.perf_counter() - t_main}),
          flush=True)


if __name__ == "__main__":
    main()
