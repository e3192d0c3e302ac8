"""Training and evaluation on one card (counterpart of
``mdqe_cvpr2023_tpu/engine/trainer.py``): the dataset loader with its
resolution buckets, the training loop with its ``metrics.jsonl`` rows,
periodic checkpoints and dev-split evaluation, full-state checkpoints with
``torch.save`` and their restore, and VIS / COCO testing scored with the
YTVIS video-mask AP.

One process drives one device (the card unless ``device="cpu"``); under a
``torch.distributed`` group (``train_net`` started by
``torch.distributed.run``) each of W processes does, with the weights
broadcast from rank 0 at the start. The loader's worker threads pin each
batch's host memory; the copy to the card is issued on the training step's
own stream just before the step, so the step cannot read a batch before it
lands. SOLVER.IMS_PER_BATCH is the global batch, as in the JAX package: every
rank maps the whole ``batch_at(k)`` (so the bucket, the augmentation draws
and the padded size are the global batch's) and keeps its clips
(``shard_rows``). The reid priorities of iteration i are drawn on the host
for the global batch from a generator seeded from (17, i)
(``iteration_seed``) and cut to the rank's clips, and the dropout masks come
from a generator on the device seeded from (17, i) on rank 0 and (17, i, r)
on rank r: a resumed run replays the same draws, the card and the CPU draw
the same priorities, and with dropout 0 W ranks step as one process on the
global batch. Rank 0 alone writes checkpoints, ``metrics.jsonl`` and the
results files; ``test`` splits the videos over the ranks and gathers the
predictions.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import rle as rle_util
from ..data.augmentation import AugmentationPipeline
from ..data.builtin import DATASET_SPLITS, get_dataset
from ..data.dataset import ClipMapper, CombinedClipLoader
from ..data.image import read_image, resize_image, size_for_test
from ..data.ytvis_eval import YTVISEvaluator
from ..models.detr import MDQEModel
from ..models.meta import inference_image, inference_vis, preprocess_frames
from ..ops import deform_attn
from ..parallel.train import (broadcast_parameters, make_optimizer, make_train_step,
                              shard_rows, state_sha256)
from ..utils import dist, tracing
from ..utils.misc import resolve_device
from .build import (build_criterion_cfg, build_inference_cfg, build_model_cfg,
                    build_train_cfg)
from .checkpoint import load_torch_checkpoint, merge_state_dict


def iteration_seed(iteration: int, rank: int = 0) -> int:
    """The seed of iteration ``iteration``'s random draws, from (17,
    iteration) (the JAX package folds ``iteration`` into ``PRNGKey(17)``),
    and from (17, iteration, rank) for a rank other than 0."""
    entropy = [17, iteration] + ([rank] if rank else [])
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


def _host_tensors(batch: Dict[str, np.ndarray], pin: bool) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory() if pin else t
    return out


def _launch_counts() -> Dict[str, Dict[str, int]]:
    """The deformable-attention kernels' launch counts per call site: forward,
    fp32 backward and bf16 backward (the AMP step's); they stay 0 on the CPU,
    where the plain version runs."""
    return {"fwd": dict(deform_attn.LAUNCHES), "bwd": dict(deform_attn.BWD_LAUNCHES),
            "bwd_bf16": dict(deform_attn.BWD_BF16_LAUNCHES)}


def _launches_since(before: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    now = _launch_counts()
    return {d: {site: n - before[d][site] for site, n in now[d].items()} for d in now}


def _dataset_paths(root: Optional[str], name: str):
    root = root or os.environ.get("MDQE_DATASETS_ROOT", "datasets")
    image_root, json_path = DATASET_SPLITS[name]
    return root, os.path.join(root, image_root), os.path.join(root, json_path)


def build_train_loader(cfg, datasets_root: Optional[str] = None,
                       pin: bool = False) -> CombinedClipLoader:
    """The training loader of ``cfg``: one (records, mapper) source per
    DATASETS.TRAIN split, the resolution buckets, SOLVER.IMS_PER_BATCH clips a
    batch (the global batch: each rank keeps its clips of it) and
    DATALOADER.NUM_WORKERS threads, which turn each batch into tensors
    (pinned when ``pin``)."""
    n_frames = cfg.INPUT.SAMPLING_FRAME_NUM
    sources = []
    buckets = set()
    pad = lambda v: -(-v // 32) * 32
    for name in cfg.DATASETS.TRAIN:
        records = get_dataset(name, datasets_root)
        pseudo = name.startswith("coco")
        inp = cfg.INPUT.PSEUDO if pseudo else cfg.INPUT
        lsj = cfg.INPUT.LSJ_AUG
        aug = AugmentationPipeline(
            min_sizes=list(inp.MIN_SIZE_TRAIN),
            max_size=inp.MAX_SIZE_TRAIN,
            crop_enabled=inp.CROP.ENABLED,
            crop_type=inp.CROP.TYPE,
            crop_size=tuple(inp.CROP.SIZE),
            rotation="rotation" in inp.AUGMENTATIONS,
            color_kinds=[a for a in inp.AUGMENTATIONS if a != "rotation"],
            lsj_enabled=bool(lsj.ENABLED) and not pseudo,
            lsj_image_size=lsj.IMAGE_SIZE,
            lsj_min_scale=lsj.MIN_SCALE,
            lsj_max_scale=lsj.MAX_SCALE,
        )
        mapper = ClipMapper(aug, n_frames, cfg.INPUT.SAMPLING_FRAME_RANGE,
                            pseudo=pseudo)
        sources.append((records, mapper))
        # resolution buckets per source: {median, max} short side x
        # {16:9-bound, max-size} width; a batch that fits none of them
        # falls back to its exact pad-32 shape
        ms = sorted(inp.MIN_SIZE_TRAIN)
        for m in {ms[(len(ms) - 1) // 2], ms[-1]}:
            wide = min(inp.MAX_SIZE_TRAIN, -(-16 * m // 9))
            buckets.add((pad(m), pad(wide)))
            buckets.add((pad(m), pad(inp.MAX_SIZE_TRAIN)))
        if cfg.INPUT.LSJ_AUG.ENABLED and not pseudo:
            sz = pad(cfg.INPUT.LSJ_AUG.IMAGE_SIZE)
            buckets.add((sz, sz))
    ratios = cfg.DATASETS.DATASET_RATIO
    if not ratios or len(ratios) != len(sources):
        ratios = [1.0] * len(sources)
    return CombinedClipLoader(sources, ratios, cfg.SOLVER.IMS_PER_BATCH,
                              cfg.MODEL.MDQE.MAX_NUM_INSTANCES // 6 or 20,
                              seed=cfg.get("SEED", 0),
                              size_buckets=sorted(buckets),
                              num_workers=cfg.DATALOADER.NUM_WORKERS,
                              transfer=lambda b: _host_tensors(b, pin))


class Trainer:
    def __init__(self, cfg, datasets_root: Optional[str] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model_cfg = build_model_cfg(cfg)
        self.crit_cfg = build_criterion_cfg(cfg)
        self.train_cfg = build_train_cfg(cfg)
        self.inf_cfg = build_inference_cfg(cfg)
        self.datasets_root = datasets_root
        self.output_dir = cfg.OUTPUT_DIR
        os.makedirs(self.output_dir, exist_ok=True)

        # the process group the ranks train and test over (None: one process)
        self.group = dist.default_group()
        self.rank, self.world = dist.rank(), dist.world_size()
        self.model = self._init_or_load_params(cfg)
        if self.group is not None:
            broadcast_parameters(self.model, self.group)
        self.optimizer = make_optimizer(self.model, self.train_cfg)
        self.step_fn = make_train_step(
            self.crit_cfg, dropout_rate=float(cfg.MODEL.MDQE.DROPOUT),
            match_stride=cfg.MODEL.MDQE.MATCH_STRIDE,
            pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN), pixel_std=tuple(cfg.MODEL.PIXEL_STD),
            amp=self.train_cfg.amp, group=self.group)
        self.iteration = 0
        # the last ``test``: clips, predictions, host seconds of predict_s,
        # rle_s (RLE encoding of the predicted masks) and evaluate_s, kernel
        # launches
        self.test_stats: Dict = {}

    # ------------------------------------------------------------------
    def _init_or_load_params(self, cfg) -> MDQEModel:
        model = MDQEModel(self.model_cfg, self.device, seed=cfg.get("SEED", 0))
        weights = cfg.MODEL.WEIGHTS
        if weights and os.path.exists(weights):
            merge_state_dict(model, load_torch_checkpoint(
                weights, f_pretrain=cfg.INPUT.PRETRAIN_FRAME_NUM,
                f_target=cfg.INPUT.SAMPLING_FRAME_NUM))
        return model

    # ------------------------------------------------------------------
    def build_train_loader(self) -> CombinedClipLoader:
        return build_train_loader(self.cfg, self.datasets_root,
                                  pin=self.device.type == "cuda")

    def _draws(self, iteration: int, batch: Dict[str, torch.Tensor]):
        """Iteration ``iteration``'s dropout generator (on the device, this
        rank's) and the reid priorities of the global ``batch`` (on the
        host)."""
        gen = torch.Generator(device=self.device).manual_seed(
            iteration_seed(iteration, self.rank))
        B, N = batch["valid"].shape
        shape = (B, N, 2, self.crit_cfg.n_frames * self.crit_cfg.n_query)
        pri = torch.rand(shape, generator=torch.Generator().manual_seed(
            iteration_seed(iteration)))
        return gen, pri

    # ------------------------------------------------------------------
    def train(self, max_iter: Optional[int] = None, log_every: int = 20,
              profile_at: Optional[int] = None):
        source = self.build_train_loader()
        loader = source.iter_from(self.iteration)  # resume-exact data stream
        max_iter = max_iter or self.train_cfg.max_iter
        ckpt_period = self.cfg.SOLVER.CHECKPOINT_PERIOD
        eval_period = self.cfg.TEST.EVAL_PERIOD
        data_wait = 0.0
        prof = None
        launches = _launch_counts()
        try:
            t_last = time.perf_counter()
            while self.iteration < max_iter:
                if profile_at is not None and self.iteration == profile_at:
                    prof = _start_profile(self.device)
                host = next(loader)
                data_wait += source.last_wait_s
                gen, pri = self._draws(self.iteration, host)
                if self.group is not None:  # this rank's clips of the global batch
                    host = shard_rows({**host, "reid_priorities": pri}, self.rank, self.world)
                    pri = host.pop("reid_priorities")
                # the copy is queued on the step's stream: the step reads the
                # batch only after it lands
                batch = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
                # the logged step keeps its spans with the card's times
                logged = (self.iteration + 1) % log_every == 0
                with tracing.full_mode(device=True) if logged else contextlib.nullcontext():
                    total, ldict = self.step_fn(self.model, self.optimizer, batch, gen,
                                                pri.to(self.device))
                self.iteration += 1
                if prof is not None and self.iteration == profile_at + 3:
                    _stop_profile(prof, self.device, self.output_dir)
                    prof = None
                if self.iteration % log_every == 0:
                    total = float(total)  # waits for the step
                    dt = (time.perf_counter() - t_last) / log_every
                    t_last = time.perf_counter()
                    row = {"iteration": self.iteration,
                           "total_loss": total, "sec_per_iter": dt,
                           "data_wait_sec_per_iter": data_wait / log_every,
                           "data_wait_frac": data_wait / max(dt * log_every, 1e-9)}
                    data_wait = 0.0
                    row.update({k: float(v) for k, v in ldict.items()})
                    row.update(self._device_stats(launches))
                    row.update(world_size=self.world, dist_backend=dist.backend(),
                               allreduce_s=tracing.span_s(tracing.last("train.step"),
                                                          "train.allreduce"))
                    tracing.clear_events()
                    launches = _launch_counts()
                    self._log(row)
                    if self.rank == 0:
                        print(f"iter {self.iteration}  loss {total:.4f}  {dt:.2f}s/it",
                              flush=True)
                if self.iteration % ckpt_period == 0 or self.iteration == max_iter:
                    self.save_checkpoint()
                if eval_period > 0 and self.iteration % eval_period == 0:
                    self.test()
        finally:
            if prof is not None:
                _stop_profile(prof, self.device, self.output_dir)
            loader.close()  # stops the loader's worker threads

    def _device_stats(self, launches_before) -> Dict:
        """The kernels' launches since ``launches_before`` and, on the card,
        the peak device memory so far (GiB)."""
        stats = {"msda_launches": _launches_since(launches_before)}
        if self.device.type == "cuda":
            stats["max_mem_gib"] = torch.cuda.max_memory_allocated(self.device) / 2 ** 30
        return stats

    def _log(self, row: Dict) -> None:
        """Append ``row`` to ``metrics.jsonl`` (rank 0's rows only)."""
        if self.rank != 0:
            return
        with open(os.path.join(self.output_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")

    # ------------------------------------------------------------------
    def save_checkpoint(self) -> str:
        """Full training state: the model's state dict, AdamW's state, the
        optimizer's step count (it drives the LR schedule) and the
        iteration, written to ``ckpt_{iteration:07d}.pth`` by rank 0 while
        the other ranks wait. Over several ranks the replicas' checksums are
        compared first (``state_sha256``): they step alike, so a difference
        is a fault, and rank 0's state would not stand for the others'."""
        path = os.path.abspath(os.path.join(self.output_dir,
                                            f"ckpt_{self.iteration:07d}.pth"))
        if self.group is not None:
            sums = dist.all_gather_objects(state_sha256(self.model))
            if len(set(sums)) != 1:
                raise RuntimeError(f"the ranks' parameters differ at iteration "
                                   f"{self.iteration}: {sums}")
            self._log({"iteration": self.iteration, "checkpoint": path,
                       "state_sha256": sums[0], "world_size": self.world})
        if self.rank == 0:
            state = {"model": self.model.state_dict(),
                     "optimizer": self.optimizer.adamw.state_dict(),
                     "step_count": self.optimizer.step_count,
                     "iteration": self.iteration}
            tmp = path + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, path)
            print(f"saved checkpoint {path}", flush=True)
        dist.barrier()
        return path

    def load_checkpoint(self, path: str, params_only: bool = False):
        """Restore the full training state {model, optimizer, step_count,
        iteration}.

        A checkpoint that does not match the live state (another model
        configuration, a corrupted file, a params-only save) raises and names
        the key, instead of silently dropping the optimizer state: a silent
        optimizer restart changes training results without any sign of it.
        ``params_only=True`` restores just the model (still checked key by key
        and shape by shape) and loudly re-initializes the optimizer."""
        path = os.path.abspath(path)
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        if params_only:
            _check_model_state(self.model.state_dict(), ckpt, path)
            self.model.load_state_dict(ckpt["model"])
            self.optimizer = make_optimizer(self.model, self.train_cfg)
            self.iteration = int(ckpt.get("iteration", 0))
            print(f"[checkpoint] params-only restore from {path}: optimizer "
                  "state RE-INITIALIZED", flush=True)
            return
        try:
            _check_model_state(self.model.state_dict(), ckpt, path)
            missing = [k for k in ("optimizer", "step_count", "iteration") if k not in ckpt]
            if missing:
                raise KeyError(f"no {missing} entries (a params-only save)")
            _check_optimizer_state(self.optimizer, ckpt["optimizer"])
        except (KeyError, ValueError) as e:
            raise RuntimeError(
                f"checkpoint {path} does not match the current training state "
                "(model/optimizer config changed, or a params-only save). Use "
                "load_checkpoint(path, params_only=True) to restore just the "
                f"params with a fresh optimizer. Original error: {e}") from e
        self.model.load_state_dict(ckpt["model"])
        self.optimizer.adamw.load_state_dict(ckpt["optimizer"])
        self.optimizer.step_count = int(ckpt["step_count"])
        self.iteration = int(ckpt["iteration"])

    # ------------------------------------------------------------------
    def test(self, dataset_name: Optional[str] = None, max_videos: Optional[int] = None):
        """VIS inference over a test split and its AP (when the GT has
        annotations). Over W ranks rank r predicts ``records[r::W]`` and the
        predictions are gathered to every rank, in the order of the records;
        rank 0 alone evaluates and writes ``results_<name>.json`` and a
        ``metrics.jsonl`` row (clips, clips/s, the host seconds of RLE
        encoding and of the evaluation, its own kernel launches, the AP
        table; over several ranks the clips and RLE seconds of all ranks, the
        slowest rank's predict seconds and each rank's video ids). Returns
        (metrics, or None on the other ranks, predictions)."""
        cfg = self.cfg
        name = dataset_name or cfg.DATASETS.TEST[0]
        if name.startswith("coco"):
            return self.test_coco(name, max_videos)
        root, _, json_path = _dataset_paths(self.datasets_root, name)
        with open(json_path) as f:
            gt_json = json.load(f)
        records = get_dataset(name, root)
        if max_videos:
            records = records[:max_videos]
        mine = records[self.rank::self.world]
        self.test_stats = {"clips": 0, "predict_s": 0.0, "rle_s": 0.0, "evaluate_s": 0.0}
        launches = _launch_counts()
        t0 = time.perf_counter()
        per_video = self.predict_videos(mine, self.test_stats)
        self.test_stats["predict_s"] = time.perf_counter() - t0
        self.test_stats.update(self._device_stats(launches))
        if self.world > 1:
            parts = dist.all_gather_objects((per_video, self.test_stats,
                                             [r["video_id"] for r in mine]))
            # back into the order of the records: video i was rank i % W's
            per_video = [parts[i % self.world][0][i // self.world]
                         for i in range(len(records))]
            self.test_stats.update(
                clips=sum(p[1]["clips"] for p in parts),
                rle_s=sum(p[1]["rle_s"] for p in parts),
                predict_s=max(p[1]["predict_s"] for p in parts),
                videos_per_rank=[p[2] for p in parts])
        predictions = [p for video in per_video for p in video]
        self.test_stats["predictions"] = len(predictions)
        metrics = None
        if self.rank != 0:
            return metrics, predictions
        if gt_json.get("annotations"):
            t0 = time.perf_counter()
            metrics = YTVISEvaluator(gt_json).evaluate(predictions)
            self.test_stats["evaluate_s"] = time.perf_counter() - t0
            print({k: round(v, 2) for k, v in metrics.items()
                   if not isinstance(v, dict)}, flush=True)
        with open(os.path.join(self.output_dir, f"results_{name}.json"), "w") as f:
            json.dump(predictions, f)
        st = self.test_stats
        self._log({"iteration": self.iteration, "test": name, "videos": len(records),
                   **st, "clips_per_s": st["clips"] / max(st["predict_s"], 1e-9),
                   "world_size": self.world,
                   **{k: v for k, v in (metrics or {}).items() if not isinstance(v, dict)}})
        return metrics, predictions

    def predict_videos(self, records: List[Dict], stats: Optional[Dict] = None
                       ) -> List[List[Dict]]:
        """VIS predictions of each of ``records``, a list per record in the
        results-file format; adds the clip count and the RLE host seconds to
        ``stats`` when given."""
        cfg = self.cfg
        stats = {"clips": 0, "rle_s": 0.0} if stats is None else stats
        min_test = cfg.INPUT.MIN_SIZE_TEST
        max_test = cfg.INPUT.get("MAX_SIZE_TEST", 1333)
        T, stride = self.inf_cfg.n_frames_test, self.inf_cfg.clip_stride
        videos = []
        for rec in records:
            H, W = rec["height"], rec["width"]
            th, tw = size_for_test(H, W, min_test, max_test)
            video = np.stack([resize_image(read_image(fp), th, tw)
                              for fp in rec["file_names"]])
            proc, _ = preprocess_frames(video)
            out = inference_vis(self.model, self.inf_cfg, proc, image_size=(th, tw),
                                ori_size=(H, W), pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
                                pixel_std=tuple(cfg.MODEL.PIXEL_STD), device=self.device)
            stats["clips"] += -(-max(len(video) - T, 0) // stride) + 1
            t0 = time.perf_counter()
            videos.append([{
                "video_id": rec["video_id"],
                "category_id": int(label) + 1,  # back to 1-based json ids
                "score": float(score),
                "segmentations": [rle_util.encode(m) for m in mask],
            } for score, label, mask in zip(out["pred_scores"], out["pred_labels"],
                                            out["pred_masks"])])
            stats["rle_s"] += time.perf_counter() - t0
        return videos

    def test_coco(self, name: str, max_images: Optional[int] = None):
        """COCO image instance segmentation over a split, scored as one-frame
        videos by the VIS evaluator (video IoU is image IoU at T = 1). Over
        several ranks each rank predicts and scores every image, as the JAX
        package's processes do; it writes no file, and only rank 0 prints the
        AP."""
        _, image_root, json_path = _dataset_paths(self.datasets_root, name)
        with open(json_path) as f:
            gt_json = json.load(f)
        images = gt_json["images"]
        if max_images:
            images = images[:max_images]
        cfg = self.cfg
        min_test = cfg.INPUT.MIN_SIZE_TEST
        max_test = cfg.INPUT.get("MAX_SIZE_TEST", 1333)
        predictions = []
        for im in images:
            img = read_image(os.path.join(image_root, im["file_name"]))
            H, W = img.shape[:2]
            th, tw = size_for_test(H, W, min_test, max_test)
            proc, _ = preprocess_frames(resize_image(img, th, tw)[None])
            out = inference_image(self.model, self.inf_cfg, proc, (th, tw), (H, W),
                                  pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
                                  pixel_std=tuple(cfg.MODEL.PIXEL_STD),
                                  device=self.device)
            for s, c, m in zip(out["scores"], out["classes"], out["masks"]):
                predictions.append({"video_id": im["id"], "category_id": int(c) + 1,
                                    "score": float(s),
                                    "segmentations": [rle_util.encode(m)]})
        metrics = None
        if gt_json.get("annotations"):
            ids = {i["id"] for i in images}
            ev = YTVISEvaluator(coco_gt_as_videos(
                {**gt_json, "images": images,
                 "annotations": [a for a in gt_json["annotations"] if a["image_id"] in ids]}))
            metrics = ev.evaluate(predictions)
            if self.rank == 0:
                print({k: round(v, 2) for k, v in metrics.items()
                       if not isinstance(v, dict)}, flush=True)
        return metrics, predictions


def _start_profile(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, device: torch.device, output_dir: str) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    prof.export_chrome_trace(os.path.join(output_dir, "trace.json"))


def _check_model_state(template: Dict[str, torch.Tensor], ckpt, path: str) -> None:
    """A checkpoint's model state against the live one, key by key and shape
    by shape, so that a mismatch names the key."""
    if not isinstance(ckpt, dict) or not isinstance(ckpt.get("model"), dict):
        raise ValueError(f"checkpoint {path} has no 'model' state dict; keys: "
                         f"{sorted(ckpt) if isinstance(ckpt, dict) else type(ckpt)}")
    loaded = ckpt["model"]
    missing = sorted(set(template) - set(loaded))
    unexpected = sorted(set(loaded) - set(template))
    if missing or unexpected:
        raise ValueError(f"checkpoint {path} keys do not match the model: missing "
                         f"{missing[:5]} ({len(missing)}), unexpected {unexpected[:5]} "
                         f"({len(unexpected)})")
    for k, t in template.items():
        if tuple(loaded[k].shape) != tuple(t.shape):
            raise ValueError(f"checkpoint {path} entry {k} has shape "
                             f"{tuple(loaded[k].shape)}, model expects {tuple(t.shape)}")


def _check_optimizer_state(optimizer, saved) -> None:
    """AdamW's saved state against the live parameter groups: the same group
    sizes, and moment tensors of each parameter's shape."""
    groups = optimizer.adamw.param_groups
    saved_groups = saved["param_groups"]
    if [len(g["params"]) for g in saved_groups] != [len(g["params"]) for g in groups]:
        raise ValueError(f"optimizer groups of {[len(g['params']) for g in saved_groups]} "
                         f"parameters, the model has {[len(g['params']) for g in groups]}")
    for sg, g in zip(saved_groups, groups):
        for idx, p in zip(sg["params"], g["params"]):
            for name, v in saved["state"].get(idx, {}).items():
                if name != "step" and tuple(v.shape) != tuple(p.shape):
                    raise ValueError(f"optimizer state {name} of parameter {idx} has "
                                     f"shape {tuple(v.shape)}, parameter {tuple(p.shape)}")


def coco_gt_as_videos(gt_json):
    """A COCO instances json as one-frame videos, so that the VIS evaluator
    computes the standard mask AP."""
    videos = [{"id": im["id"], "height": im["height"], "width": im["width"],
               "length": 1, "file_names": [im.get("file_name", "")]}
              for im in gt_json["images"]]
    anns = []
    for a in gt_json.get("annotations", []):
        anns.append({
            "id": a["id"], "video_id": a["image_id"],
            "category_id": a["category_id"],
            "segmentations": [a.get("segmentation")],
            "areas": [a.get("area")], "iscrowd": a.get("iscrowd", 0),
        })
    return {"videos": videos, "annotations": anns,
            "categories": gt_json["categories"]}
