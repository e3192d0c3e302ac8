"""The training step, plain PyTorch: the benchmark's reference copy of
``parallel/train.py`` of the port (the training forward, the criterion, the
backward through autograd of the plain deformable attention, and AdamW with
the backbone at x0.1 LR, the frozen set and the global-norm clip), fp32 on
one device, without the port's mixed precision or data parallelism.
``train_step(tf32=True)`` takes the products in TF32 (the control).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from ..losses.criterion import CriterionCfg, criterion_apply
from ..models.decoder import query_relpos_grid
from ..models.detr import MDQEModel, detr_apply_backbone
from ..utils.misc import interpolate_bilinear


@dataclass(frozen=True)
class TrainCfg:
    base_lr: float = 1e-4
    weight_decay: float = 1e-4
    backbone_multiplier: float = 0.1
    clip_norm: float = 0.01
    steps: Tuple[int, ...] = (10000,)
    max_iter: int = 12000
    warmup_iters: int = 10
    warmup_factor: float = 1.0
    gamma: float = 0.1
    # Detectron2's MODEL.BACKBONE.FREEZE_AT: 1 freezes the ResNet stem, 2 the
    # stem and res2 (``models/detr.py::is_frozen``)
    freeze_at: int = 2


def lr_factor(tc: TrainCfg, step: int) -> float:
    """Warm-up and multi-step decay at optimizer step ``step`` (from 0, as
    optax counts): the learning rate is base_lr times this."""
    warm = (tc.warmup_factor + (1 - tc.warmup_factor) * step / max(tc.warmup_iters, 1)
            if step < tc.warmup_iters else 1.0)
    decay = 1.0
    for s in tc.steps:
        decay *= tc.gamma if step >= s else 1.0
    return warm * decay


def clip_by_global_norm_(grads, max_norm: float):
    """optax's ``clip_by_global_norm`` in place: with n the global L2 norm,
    each g becomes g if n < max_norm, else (g / n) * max_norm. (Not
    ``clip_grad_norm_``, whose 1e-6 in the divisor changes the numbers.)"""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class _Optimizer:
    """AdamW in two groups, ``backbone`` (x``backbone_multiplier`` LR: every
    ResNet or Swin leaf) and the rest, weight decay on both (as optax's
    adamw, on every leaf: norms, biases, Swin's logit scales and bias tables
    too). The model is put in its training form
    (``MDQEModel.set_trainable``): the frozen set (the ResNet stages frozen
    at ``TrainCfg.freeze_at``; the JAX package's other frozen leaves are
    buffers here) is in neither group and never changes. ``step`` first gives
    every trainable parameter without a gradient a zero one (optax decays
    those weights too), clips the global norm, sets the scheduled LR, then
    steps AdamW."""

    def __init__(self, model: MDQEModel, tc: TrainCfg):
        self.tc = tc
        model.set_trainable(tc.freeze_at)
        backbone, rest = [], []
        for name, p in model.named_parameters():
            if p.requires_grad:
                (backbone if name.startswith("detr.backbone.") else rest).append(p)
        self.params = backbone + rest
        self.base_lrs = (tc.base_lr * tc.backbone_multiplier, tc.base_lr)
        self.adamw = torch.optim.AdamW(
            [{"params": backbone, "lr": self.base_lrs[0]},
             {"params": rest, "lr": self.base_lrs[1]}],
            betas=(0.9, 0.999), eps=1e-8, weight_decay=tc.weight_decay)
        self.step_count = 0

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def step(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.tc.clip_norm > 0:
            clip_by_global_norm_([p.grad for p in self.params], self.tc.clip_norm)
        f = lr_factor(self.tc, self.step_count)
        for group, base in zip(self.adamw.param_groups, self.base_lrs):
            group["lr"] = base * f
        self.adamw.step()
        self.step_count += 1


def make_optimizer(model: MDQEModel, tc: TrainCfg) -> _Optimizer:
    """Put ``model`` in its training form and build its optimizer."""
    return _Optimizer(model, tc)


def prepare_targets_device(masks_full, padded_hw, match_stride: int):
    """masks_full (B,N,T,Hp,Wp) float or bool -> (match_masks (B,N,T,h4,w4),
    masks8 (B,N,T,P8) bool): the reference's target mask transforms and the
    peak matcher's stride-8 downsample."""
    Hp, Wp = padded_hw
    h4, w4 = -(-Hp // match_stride), -(-Wp // match_stride)
    h8, w8 = -(-Hp // 8), -(-Wp // 8)
    masks_full = masks_full.float()
    match_masks = interpolate_bilinear(masks_full, (h4, w4))
    masks8 = interpolate_bilinear(masks_full, (h8, w8)) > 0.5
    B, N, T = masks8.shape[:3]
    return match_masks, masks8.reshape(B, N, T, h8 * w8)


MATCH_STRIDE = 4  # the mask losses' resolution: stride 4, the proto features'
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


@functools.lru_cache(maxsize=8)
def _relpos(n_query: int, device: str) -> torch.Tensor:
    return torch.from_numpy(query_relpos_grid(int(round(n_query ** 0.5)))).to(device)


def loss_fn(model: MDQEModel, crit_cfg: CriterionCfg, batch, generator=None,
            dropout_rate: float = 0.1, reid_priorities=None,
            match_stride: int = MATCH_STRIDE, pixel_mean=PIXEL_MEAN, pixel_std=PIXEL_STD):
    """The loss of ``make_train_step``: images (BT,Hp,Wp,3) raw uint8 (or
    float) normalized on the device, the training forward with dropout from
    ``generator``, the criterion. Returns (total, the weighted losses),
    fp32."""
    images = batch["images"]
    dev = images.device
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=dev)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=dev)
    images = (images.float() - mean) / std
    out = detr_apply_backbone(model.detr, images, batch["image_sizes"],
                              crit_cfg.n_frames, dropout_rate, generator)
    match_masks, masks8 = prepare_targets_device(batch["masks"], images.shape[1:3],
                                                 match_stride)
    targets = {"labels": batch["labels"], "ids": batch["ids"], "boxes": batch["boxes"],
               "valid": batch["valid"], "match_masks": match_masks, "masks8": masks8}
    return criterion_apply(crit_cfg, out, targets, _relpos(crit_cfg.n_query, str(dev)),
                           generator, reid_priorities)


def train_step(model: MDQEModel, optimizer: _Optimizer, crit_cfg: CriterionCfg, batch,
               generator, dropout_rate: float = 0.1, tf32: bool = False):
    """One optimizer step on ``batch`` (tensors on the model's device) with
    dropout and reid priorities from ``generator``. Returns (total, the
    weighted losses by name), fp32."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    optimizer.zero_grad()
    total, ldict = loss_fn(model, crit_cfg, batch, generator, dropout_rate)
    total.backward()
    optimizer.step()
    return total.detach(), {k: v.detach() for k, v in ldict.items()}
