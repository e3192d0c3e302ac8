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

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
from torch import nn

from ..utils.misc import resolve_device
from ..utils.nn import GroupNorm, position_embedding_sine
from .decoder import DecoderCfg, TransformerDecoder, encoded_to_maps
from .encoder import EncoderCfg, TransformerEncoder, flatten_levels
from .resnet import ResNet


@dataclass(frozen=True)
class MDQEModelCfg:
    backbone: str = "resnet50"  # resnet50 / resnet101 (Swin is not ported yet)
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
        raise NotImplementedError(f"backbone {self.backbone} is not ported")

    @property
    def feature_strides(self) -> Tuple[int, ...]:
        return (8, 16, 32)

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
        cfg.backbone_channels  # raises for backbones that are not ported
        self.backbone = ResNet(int(cfg.backbone[len("resnet"):]))


class DeformableDETR(nn.Module):
    """``forward`` is ``detr_encode``; ``torch.func.functional_call`` runs it
    with bf16 copies of the encode weights."""

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

    def forward(self, images, image_sizes):
        return detr_encode(self, images, image_sizes)


def detr_backbone_features(detr: DeformableDETR, images, image_sizes):
    """images (BT,Hp,Wp,3) normalized; image_sizes (BT,2). Returns per-level
    projected features (BT,h,w,C), padding masks (BT,h,w) and sine positions
    (BT,h,w,C), all channel-last."""
    cfg = detr.cfg
    x = images.permute(0, 3, 1, 2)                  # NHWC -> NCHW for cuDNN
    feats = detr.backbone[0].backbone(x)
    strides = list(cfg.feature_strides)
    for _ in range(cfg.n_feature_levels - len(feats)):
        strides.append(strides[-1] * 2)
    masks = padding_masks(image_sizes, tuple(images.shape[1:3]), strides)
    srcs = []
    for i, proj in enumerate(detr.input_proj):
        if i < len(feats):
            srcs.append(proj(feats[i]))
        else:
            srcs.append(proj(feats[-1] if i == len(feats) else srcs[-1]))
    pos = [position_embedding_sine(~m, cfg.hidden_dim // 2).to(images.dtype)
           for m in masks]
    return [s.permute(0, 2, 3, 1) for s in srcs], masks, pos  # NCHW -> NHWC


def detr_encode(detr: DeformableDETR, images, image_sizes):
    """Backbone + input projections + deformable encoder for a batch of frames.
    Returns (encoded (BT,N,C), mask_flat (BT,N), spatial_shapes)."""
    srcs, masks, pos = detr_backbone_features(detr, images, image_sizes)
    encoded = detr.transformer_enc(srcs, masks, pos)
    _, mask_flat, _, spatial_shapes = flatten_levels(srcs, masks)
    return encoded, mask_flat, spatial_shapes


def detr_mask_feats(detr: DeformableDETR, encoded, spatial_shapes):
    """Proto mask features (BT, h4, w4, M) of encoded frames."""
    maps = encoded_to_maps(encoded, spatial_shapes)
    return detr.transformer_dec.mask_head(maps[2], [maps[1], maps[0]])


class MDQEModel(nn.Module):
    """The model's parameters under their Detectron2 names, initialized from a
    seed as ``detr_init`` does. Built on ``device`` (the card unless the caller
    passes ``device="cpu"``)."""

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
