"""Video demo (counterpart of the repository's ``demo/demo.py``): VIS
inference of each input video and an mp4 of its tracks drawn on its frames.

Each input is a directory of frames (.jpg / .png, in name order) or a video
file (read with OpenCV). ``predict`` resizes the frames to the test size
(INPUT.MIN_SIZE_TEST / MAX_SIZE_TEST), pads them and runs ``inference_vis``
on the ``Trainer``'s model; an ``AsyncPredictor`` thread infers video k+1
while the main thread renders video k, and at most two videos are held.
Runs on the card unless ``--device cpu``.

Each video gives ``<name>.mp4`` and ``<name>.json``, its tracks in the
results-file format that ``visualizer_from_json`` reads (``video_id`` is the
input's 1-based position). For each video it prints one JSON line: the track
count (tracks above the confidence threshold drawn), host seconds of reading
the frames, of inference, of rendering and of writing the JSON, the spans of
inference and rendering (seconds from the first read), and the
deformable-attention kernel launches of its inference per call site. Then one
line for the run: videos, wall seconds from the first read, videos/s, the
sums, the seconds of setup (imports, the Trainer), and how much inference ran
while the main thread worked (``infer_hidden_s``) and while it rendered
(``infer_in_render_s``).

Usage:
  python -m mdqe_cvpr2023_tpu_torch.demo.demo --config-file configs/R50_ovis_360.yaml
      --input VIDEO_DIR_OR_FILE [...] --output OUT_DIR [--weights CKPT.pth]
      [--device cuda|cpu] [--confidence-threshold 0.3] [--fps 10] [KEY VALUE ...]
"""
from __future__ import annotations

import argparse
import functools
import glob
import json
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="MDQE video demo (PyTorch)")
    p.add_argument("--config-file", required=True)
    p.add_argument("--input", nargs="+", required=True,
                   help="directories of frames, or video files")
    p.add_argument("--output", required=True)
    p.add_argument("--weights", default=None, help="a .pth checkpoint")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain PyTorch path)")
    p.add_argument("--confidence-threshold", type=float, default=0.3)
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="config overrides: KEY VALUE pairs")
    return p.parse_args(argv)


def build_metadata(dataset_names):
    """thing_classes / thing_colors of the configured dataset family (the
    reference demo reads them from Detectron2's MetadataCatalog)."""
    from ..data.categories import (OVIS_CATEGORIES, YTVIS_CATEGORIES_2019,
                                   YTVIS_CATEGORIES_2021)
    name = (dataset_names or [""])[0]
    cats = (OVIS_CATEGORIES if "ovis" in name else
            YTVIS_CATEGORIES_2019 if "2019" in name else YTVIS_CATEGORIES_2021)
    cats = sorted(cats, key=lambda c: c["id"])
    return {"thing_classes": [c["name"] for c in cats],
            "thing_colors": [c.get("color", (130, 130, 130)) for c in cats]}


def read_frames(vid_path):
    """RGB uint8 frames of a directory of .jpg / .png files (name order) or of
    a video file."""
    if os.path.isdir(vid_path):
        from ..data.image import read_image
        files = sorted(glob.glob(os.path.join(vid_path, "*.jpg"))
                       + glob.glob(os.path.join(vid_path, "*.png")))
        return [read_image(f) for f in files]
    import cv2
    cap = cv2.VideoCapture(vid_path)
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame[:, :, ::-1])
    finally:
        cap.release()
    return frames


def predict(trainer, frames):
    """``inference_vis`` of one video's RGB uint8 frames on the Trainer's model
    at the test size, masks at the frames' size. Returns (its output, {host
    seconds ``infer_s``, its ``infer_span`` (perf_counter), ``msda_launches``
    per call site})."""
    from ..data.image import resize_image, size_for_test
    from ..models.meta import inference_vis, preprocess_frames
    from ..ops import deform_attn
    cfg = trainer.cfg
    before = dict(deform_attn.LAUNCHES)
    t0 = time.perf_counter()
    H, W = frames[0].shape[:2]
    th, tw = size_for_test(H, W, cfg.INPUT.MIN_SIZE_TEST,
                           cfg.INPUT.get("MAX_SIZE_TEST", 1333))
    proc, _ = preprocess_frames(np.stack([resize_image(f, th, tw) for f in frames]))
    out = inference_vis(trainer.model, trainer.inf_cfg, proc, image_size=(th, tw),
                        ori_size=(H, W), pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
                        pixel_std=tuple(cfg.MODEL.PIXEL_STD), device=trainer.device)
    t1 = time.perf_counter()
    stats = {"infer_s": t1 - t0, "infer_span": (t0, t1),
             "msda_launches": {k: n - before[k] for k, n in deform_attn.LAUNCHES.items()}}
    return out, stats


def track_results(out, video_id: int):
    """The tracks of ``inference_vis``'s output in the results-file format
    (1-based category ids, one RLE a frame)."""
    from ..data import rle
    return [{"video_id": video_id, "category_id": int(label) + 1, "score": float(score),
             "segmentations": [rle.encode(m) for m in mask]}
            for score, label, mask in zip(out["pred_scores"], out["pred_labels"],
                                          out["pred_masks"])]


def render(viz, path, frames, out, fps: int, threshold: float) -> None:
    """An mp4 of the tracks scoring above ``threshold`` drawn on ``frames``."""
    import cv2
    H, W = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    if not writer.isOpened():
        raise RuntimeError(f"OpenCV cannot write {path}")
    try:
        for vis in viz.draw_video(frames, out["pred_masks"], out["pred_labels"],
                                  out["pred_scores"], score_threshold=threshold):
            writer.write(np.ascontiguousarray(vis[:, :, ::-1]))
    finally:
        writer.release()


def overlap_s(spans, others) -> float:
    """Seconds during which a span of ``spans`` and one of ``others`` both
    run (each list's spans disjoint, as one thread's are)."""
    return sum(max(0.0, min(a1, b1) - max(a0, b0)) for a0, a1 in spans for b0, b1 in others)


def main(argv=None):
    t_main = time.perf_counter()
    from ..engine.config import load_config
    from ..engine.trainer import Trainer
    from .predictor import AsyncPredictor
    from .visualizer import TrackVisualizer

    args = parse_args(argv)
    cfg = load_config(args.config_file, args.opts or None)
    if args.weights:
        if not os.path.exists(args.weights):
            raise FileNotFoundError(args.weights)
        cfg.MODEL.WEIGHTS = args.weights
    cfg.OUTPUT_DIR = args.output
    trainer = Trainer(cfg, device=args.device)
    viz = TrackVisualizer(metadata=build_metadata(cfg.DATASETS.TEST))
    spans = {"read": [], "infer": [], "render": [], "json": []}
    t_start = time.perf_counter()

    def timed(kind, fn, *a):
        t0 = time.perf_counter()
        r = fn(*a)
        spans[kind].append((t0, time.perf_counter()))
        return r, spans[kind][-1][1] - t0

    def write_json(path, out, video_id):
        with open(path, "w") as f:
            json.dump(track_results(out, video_id), f)

    def finish(k, vid_path, frames, read_s, result):
        out, stats = result
        spans["infer"].append(stats.pop("infer_span"))
        name = os.path.splitext(os.path.basename(vid_path.rstrip("/")))[0]
        _, stats["render_s"] = timed("render", render, viz,
                                     os.path.join(args.output, f"{name}.mp4"), frames, out,
                                     args.fps, args.confidence_threshold)
        _, stats["json_s"] = timed("json", write_json,
                                   os.path.join(args.output, f"{name}.json"), out, k + 1)
        shown = sum(1 for s in out["pred_scores"] if s > args.confidence_threshold)
        inf, ren = spans["infer"][-1], spans["render"][-1]
        print(json.dumps({"video": name, "frames": len(frames),
                          "tracks": len(out["pred_scores"]), "shown": shown, "read_s": read_s,
                          **stats, "infer_at": [inf[0] - t_start, inf[1] - t_start],
                          "render_at": [ren[0] - t_start, ren[1] - t_start]}), flush=True)
        return dict(stats, read_s=read_s)

    # inference of video k+1 overlaps rendering of video k; at most two
    # videos are held
    predictor = AsyncPredictor(functools.partial(predict, trainer))
    done, pending = [], []
    try:
        for k, vid_path in enumerate(args.input):
            frames, read_s = timed("read", read_frames, vid_path)
            if not frames:
                print(f"no frames in {vid_path}", flush=True)
                continue
            predictor.put(frames)
            pending.append((k, vid_path, frames, read_s))
            if len(pending) > 1:
                done.append(finish(*pending.pop(0), predictor.get()))
        while pending:
            done.append(finish(*pending.pop(0), predictor.get()))
    finally:
        predictor.shutdown()
    wall = time.perf_counter() - t_start
    main_thread = spans["read"] + spans["render"] + spans["json"]
    print(json.dumps({"videos": len(done), "wall_s": wall, "videos_per_s": len(done) / wall,
                      **{f"{kind}_s": sum(s[f"{kind}_s"] for s in done)
                         for kind in ("read", "infer", "render", "json")},
                      "setup_s": t_start - t_main,
                      "infer_hidden_s": overlap_s(spans["infer"], main_thread),
                      "infer_in_render_s": overlap_s(spans["infer"], spans["render"]),
                      "main_s": time.perf_counter() - t_main}), flush=True)


if __name__ == "__main__":
    main()
