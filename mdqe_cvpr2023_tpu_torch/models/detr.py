"""Inner detection model: backbone, input projections, encoder, decoder
(counterpart of ``mdqe_cvpr2023_tpu/models/detr.py``), and ``MDQEModel``, which
owns them under the Detectron2 names (``detr.backbone.0.backbone.*``,
``detr.input_proj.{i}.{0,1}.*``, ``detr.transformer_enc.*``,
``detr.transformer_dec.*``).

Public tensors keep the JAX layouts: images (BT, Hp, Wp, 3), encoded
(BT, N, C), mask features (BT, h4, w4, M). Convolutions run NCHW inside; the
transposes are at the boundaries noted below.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..utils.misc import resolve_device
from ..utils.nn import GroupNorm, position_embedding_sine
from .decoder import DecoderCfg, TransformerDecoder, encoded_to_maps
from .encoder import EncoderCfg, TransformerEncoder, flatten_levels
from .resnet import ResNet
from .swin import SWIN_PRESETS, SwinCfg, SwinTransformer


@dataclass(frozen=True)
class MDQEModelCfg:
    backbone: str = "resnet50"  # resnet50 / resnet101 or swin_{tiny,small,base,large}
    swin: Optional[SwinCfg] = None  # the Swin configuration (the preset otherwise)
    num_classes: int = 80
    hidden_dim: int = 256
    n_heads: int = 8
    n_feature_levels: int = 4
    enc_layers: int = 6
    dec_layers: int = 6
    enc_points: int = 4
    dec_points: int = 4
    n_frames: int = 1
    n_query: int = 196
    query_embed_dim: int = 64
    window_inter_frame_asso: int = 5
    mlp_ratio: float = 4.0
    dec_temporal: bool = True
    mask_on: bool = True

    @property
    def backbone_channels(self) -> Tuple[int, ...]:
        if self.backbone in ("resnet50", "resnet101"):
            return (512, 1024, 2048)  # res3, res4, res5
        if self.backbone.startswith("swin"):
            sc = self.swin_cfg
            return tuple(sc.stage_dim(i) for i in sc.emit_stages)
        raise ValueError(f"unknown backbone {self.backbone}")

    @property
    def swin_cfg(self) -> SwinCfg:
        if self.swin is not None:
            return self.swin
        return SWIN_PRESETS[self.backbone[len("swin_"):]]

    @property
    def feature_strides(self) -> Tuple[int, ...]:
        if self.backbone.startswith("swin"):
            sc = self.swin_cfg
            return tuple(sc.patch_size * 2 ** i for i in sc.emit_stages)
        return (8, 16, 32)

    @property
    def level_strides(self) -> Tuple[int, ...]:
        """The strides of the ``n_feature_levels`` pyramid levels: the
        backbone's, then each extra level at twice the one before."""
        strides = list(self.feature_strides)[:self.n_feature_levels]
        while len(strides) < self.n_feature_levels:
            strides.append(strides[-1] * 2)
        return tuple(strides)

    @property
    def encoder_cfg(self) -> EncoderCfg:
        return EncoderCfg(self.hidden_dim, self.n_heads, self.n_feature_levels,
                          self.enc_points, self.enc_layers, self.mlp_ratio)

    @property
    def decoder_cfg(self) -> DecoderCfg:
        return DecoderCfg(self.num_classes, self.hidden_dim, self.n_heads,
                          self.n_feature_levels, self.n_frames, self.dec_points,
                          self.dec_layers, self.mlp_ratio, self.n_query,
                          self.query_embed_dim, self.window_inter_frame_asso,
                          use_tca=self.dec_temporal, mask_on=self.mask_on)


def padding_masks(image_sizes, padded_hw: Tuple[int, int], strides: Sequence[int]):
    """image_sizes (BT, 2) true [h, w] -> per-stride (BT, Hs, Ws) bool masks,
    True on padded pixels (valid extent ceil(h / s))."""
    Hp, Wp = padded_hw
    h = image_sizes[:, 0][:, None]
    w = image_sizes[:, 1][:, None]
    masks = []
    for s in strides:
        Hs, Ws = -(-Hp // s), -(-Wp // s)
        rows = torch.arange(Hs, device=image_sizes.device)[None] >= -(-h // s)
        cols = torch.arange(Ws, device=image_sizes.device)[None] >= -(-w // s)
        masks.append(rows[:, :, None] | cols[:, None, :])
    return masks


class MaskedBackbone(nn.Module):
    def __init__(self, cfg: MDQEModelCfg):
        super().__init__()
        cfg.backbone_channels  # raises for an unknown backbone
        if cfg.backbone.startswith("swin"):
            self.backbone = SwinTransformer(cfg.swin_cfg)
        else:
            self.backbone = ResNet(int(cfg.backbone[len("resnet"):]))


class DeformableDETR(nn.Module):
    """``forward`` is ``detr_encode``, or the training forward with
    ``n_frames``; ``torch.func.functional_call`` runs it with bf16 copies of
    the weights (the bf16 encode of inference, the AMP training forward)."""

    def __init__(self, cfg: MDQEModelCfg):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        chans = list(cfg.backbone_channels)
        self.backbone = nn.ModuleList([MaskedBackbone(cfg)])
        proj = []
        for i in range(cfg.n_feature_levels):
            if i < len(chans):
                conv = nn.Conv2d(chans[i], d, 1)
            else:  # extra level: 3x3 stride-2 conv from the last backbone map
                conv = nn.Conv2d(chans[-1], d, 3, stride=2, padding=1)
            proj.append(nn.Sequential(conv, GroupNorm(32, d)))
        self.input_proj = nn.ModuleList(proj)
        self.transformer_enc = TransformerEncoder(cfg.encoder_cfg)
        self.transformer_dec = TransformerDecoder(cfg.decoder_cfg)

    def forward(self, images, image_sizes, n_frames: Optional[int] = None,
                drop_rate: float = 0.0, generator=None):
        """``detr_encode`` of a batch of frames; with ``n_frames``, encode and
        the decoder's ``forward_train`` (``detr_apply_backbone``), in the
        type of the images and weights it is given."""
        if n_frames is None:
            return detr_encode(self, images, image_sizes)
        encoded, mask_flat, spatial_shapes = detr_encode(self, images, image_sizes,
                                                         drop_rate, generator)
        return self.transformer_dec.forward_train(encoded, mask_flat, spatial_shapes,
                                                  n_frames, drop_rate, generator)


def detr_backbone_features(detr: DeformableDETR, images, image_sizes, generator=None):
    """images (BT,Hp,Wp,3) normalized; image_sizes (BT,2). Returns per-level
    projected features (BT,h,w,C), padding masks (BT,h,w) and sine positions
    (BT,h,w,C), all channel-last. ``generator`` (training) draws a Swin
    backbone's stochastic depth."""
    cfg = detr.cfg
    x = images.permute(0, 3, 1, 2)                  # NHWC -> NCHW for cuDNN
    backbone = detr.backbone[0].backbone
    feats = backbone(x, generator) if isinstance(backbone, SwinTransformer) else backbone(x)
    masks = padding_masks(image_sizes, tuple(images.shape[1:3]), cfg.level_strides)
    srcs = []
    for i, proj in enumerate(detr.input_proj):
        if i < len(feats):
            srcs.append(proj(feats[i]))
        else:
            srcs.append(proj(feats[-1] if i == len(feats) else srcs[-1]))
    pos = [position_embedding_sine(~m, cfg.hidden_dim // 2).to(images.dtype)
           for m in masks]
    return [s.permute(0, 2, 3, 1) for s in srcs], masks, pos  # NCHW -> NHWC


def detr_encode(detr: DeformableDETR, images, image_sizes, drop_rate: float = 0.0,
                generator=None):
    """Backbone + input projections + deformable encoder for a batch of frames.
    Returns (encoded (BT,N,C), mask_flat (BT,N), spatial_shapes). With a
    ``generator`` (training) the encoder's dropout draws from it at
    ``drop_rate``, and a Swin backbone's stochastic depth at its own rates
    whatever ``drop_rate`` is, as the JAX package's step does."""
    srcs, masks, pos = detr_backbone_features(detr, images, image_sizes, generator)
    encoded = detr.transformer_enc(srcs, masks, pos, drop_rate, generator)
    _, mask_flat, _, spatial_shapes = flatten_levels(srcs, masks)
    return encoded, mask_flat, spatial_shapes


def detr_mask_feats(detr: DeformableDETR, encoded, spatial_shapes):
    """Proto mask features (BT, h4, w4, M) of encoded frames."""
    maps = encoded_to_maps(encoded, spatial_shapes)
    return detr.transformer_dec.mask_head(maps[2], [maps[1], maps[0]])


def detr_apply_backbone(detr: DeformableDETR, images, image_sizes, n_frames: int,
                        drop_rate: float = 0.0, generator=None, amp: bool = False):
    """The training forward, encode + decode (``detr_apply_backbone(...,
    training=True, amp=amp)`` of the JAX package). images (BT,Hp,Wp,3)
    normalized. Returns the decoder's training dict
    (``TransformerDecoder.forward_train``); dropout at ``drop_rate`` and a
    Swin backbone's stochastic depth draw from ``generator`` and are off
    without one.

    ``amp`` (mixed precision, SOLVER.AMP.ENABLED): the images and every
    float32 parameter and buffer are cast to bf16 inside the autograd graph,
    so the gradients reach the fp32 masters, and backbone, encoder and
    decoder run on the bf16 copies (``torch.func.functional_call``), as the
    JAX package casts its whole tree. The encoding stays bf16 into the
    decoder. The fp32 islands are the JAX package's: norm statistics,
    softmaxes, sampling locations and weights, the box path, and every
    linear that meets an fp32 input (``utils.nn.linear``): the decoder's
    query stream is fp32, since its queries are sampled from the bf16
    encoding with fp32 weights."""
    if not amp:
        return detr(images, image_sizes, n_frames, drop_rate, generator)
    named = itertools.chain(detr.named_parameters(), detr.named_buffers())
    bf16 = {n: t.to(torch.bfloat16) for n, t in named if t.dtype == torch.float32}
    return torch.func.functional_call(
        detr, bf16, (images.to(torch.bfloat16), image_sizes, n_frames, drop_rate,
                     generator))


def detr_apply_coco(detr: DeformableDETR, images, image_sizes, n_frames: int):
    """The eval forward of COCO image inference (``detr_apply_backbone(...,
    training=False, is_coco=True)`` of the JAX package, ``amp=False``):
    backbone, encoder and decoder in fp32. images (BT,Hp,Wp,3) normalized.
    Returns the decoder's ``is_coco`` dict (``TransformerDecoder.forward``)."""
    encoded, mask_flat, spatial_shapes = detr_encode(detr, images, image_sizes)
    return detr.transformer_dec(encoded.float(), mask_flat, spatial_shapes, n_frames,
                                is_coco=True)


# The ResNet stages frozen in training, by Detectron2's MODEL.BACKBONE.FREEZE_AT
# (``frozen_leaf_mask(params, freeze_at)`` of the JAX package): 0 or less
# freezes none, 1 the stem, 2 or more the stem and res2. The other leaves that
# the JAX mask freezes (FrozenBN statistics, the decoder's sampling grid,
# ``lvl_spatial_scales``) are buffers here and never train. A Swin backbone
# has no such stage: nothing of it is frozen.
FROZEN_STAGES = ("stem", "res2")


def is_frozen(name: str, freeze_at: int = 2) -> bool:
    """Whether the parameter ``name`` (under ``MDQEModel``) is frozen in
    training at ``freeze_at``: it lies in one of the first
    ``clip(freeze_at, 0, 2)`` stages of ``FROZEN_STAGES``."""
    stages = FROZEN_STAGES[:max(min(int(freeze_at), 2), 0)]
    return any(name.startswith(f"detr.backbone.0.backbone.{s}.") for s in stages)


class MDQEModel(nn.Module):
    """The model's parameters under their Detectron2 names, initialized from a
    seed as ``detr_init`` does. Built on ``device`` (the card unless the caller
    passes ``device="cpu"``), frozen (no gradients) until ``set_trainable``."""

    def __init__(self, cfg: MDQEModelCfg, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.detr = DeformableDETR(cfg)
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.eval().requires_grad_(False)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def set_trainable(self, freeze_at: int = 2) -> None:
        """Training form: every parameter takes gradients except the ResNet
        stages frozen at ``freeze_at`` (``is_frozen``). The model stays usable
        for inference (``inference_vis`` runs under ``torch.inference_mode``)."""
        for name, p in self.named_parameters():
            p.requires_grad_(not is_frozen(name, freeze_at))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        detr = self.detr
        detr.backbone[0].backbone.reset_parameters(gen)
        for proj in detr.input_proj:
            conv = proj[0]
            bound = 1.0 / math.sqrt(conv.weight[0].numel())
            conv.weight.uniform_(-bound, bound, generator=gen)
            conv.bias.uniform_(-bound, bound, generator=gen)
        enc = detr.transformer_enc
        enc.level_embed.normal_(generator=gen)
        for layer in enc.encoder.layers:
            layer.self_attn.reset_parameters(gen)
            for lin in (layer.linear1, layer.linear2):
                bound = 1.0 / math.sqrt(lin.in_features)
                lin.weight.uniform_(-bound, bound, generator=gen)
                lin.bias.uniform_(-bound, bound, generator=gen)
        detr.transformer_dec.reset_parameters(gen)
