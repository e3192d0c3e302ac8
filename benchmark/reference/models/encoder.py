"""Deformable transformer encoder (counterpart of
``mdqe_cvpr2023_tpu/models/encoder.py``): flattened pyramid levels plus a
learned level embedding, per-pixel reference boxes (w/h 0.1), n layers of
spatial MSDeformAttn (Q == N) + FFN, final LayerNorm. Frames are the batch.
Training adds three dropouts per layer (``drop_rate`` with a generator)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.misc import make_reference_points
from ..utils.nn import LayerNorm, Linear, dropout
from .attention import MSDeformAttn, MSDeformAttnCfg


@dataclass(frozen=True)
class EncoderCfg:
    dim: int = 256
    n_heads: int = 8
    n_levels: int = 4
    n_points: int = 4
    n_layers: int = 6
    mlp_ratio: float = 4.0

    @property
    def attn_cfg(self) -> MSDeformAttnCfg:
        return MSDeformAttnCfg(self.dim, self.n_levels, self.n_heads, self.n_points,
                               n_frames=1, pred_offsets=True, mode="spatial")


def flatten_levels(srcs: List[torch.Tensor], masks: Optional[Sequence] = None,
                   pos: Optional[Sequence] = None, level_embed=None):
    """srcs/pos: per-level (B,H,W,C) channel-last; masks: per-level (B,H,W) bool
    (True on padded). Returns (B,N,C) src, (B,N) mask, (B,N,C) pos + level
    embedding, and the static shapes."""
    spatial_shapes = tuple((int(s.shape[1]), int(s.shape[2])) for s in srcs)
    src_flat = torch.cat([s.reshape(s.shape[0], -1, s.shape[-1]) for s in srcs], 1)
    mask_flat = None
    if masks is not None:
        mask_flat = torch.cat([m.reshape(m.shape[0], -1) for m in masks], 1)
    pos_flat = None
    if pos is not None:
        parts = []
        for lvl, p in enumerate(pos):
            pf = p.reshape(p.shape[0], -1, p.shape[-1])
            if level_embed is not None:
                pf = pf + level_embed[lvl][None, None]
            parts.append(pf)
        pos_flat = torch.cat(parts, 1)
    return src_flat, mask_flat, pos_flat, spatial_shapes


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderCfg):
        super().__init__()
        d_ffn = int(cfg.dim * cfg.mlp_ratio)
        self.self_attn = MSDeformAttn(cfg.attn_cfg, site="encoder")
        self.norm1 = LayerNorm(cfg.dim)
        self.linear1 = Linear(cfg.dim, d_ffn)
        self.linear2 = Linear(d_ffn, cfg.dim)
        self.norm2 = LayerNorm(cfg.dim)

    def forward(self, x, x_pos, ref_boxes, spatial_shapes, padding_mask,
                drop_rate: float = 0.0, generator=None):
        x2 = self.self_attn(x + x_pos, ref_boxes, x, spatial_shapes, padding_mask)
        x = self.norm1(x + dropout(x2, drop_rate, generator))
        h = dropout(F.gelu(self.linear1(x)), drop_rate, generator)
        x = self.norm2(x + dropout(self.linear2(h), drop_rate, generator))
        return x


class Encoder(nn.Module):
    """Holds ``layers`` and ``norm`` (Detectron2 ``transformer_enc.encoder``)."""

    def __init__(self, cfg: EncoderCfg):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.n_layers))
        self.norm = LayerNorm(cfg.dim)


class TransformerEncoder(nn.Module):
    """Detectron2 ``transformer_enc``: ``level_embed`` and ``encoder``."""

    def __init__(self, cfg: EncoderCfg):
        super().__init__()
        self.cfg = cfg
        self.level_embed = nn.Parameter(torch.zeros(cfg.n_levels, cfg.dim))
        self.encoder = Encoder(cfg)

    def forward(self, srcs, masks, pos, drop_rate: float = 0.0, generator=None):
        """``encoder_apply``: per-level lists (BT leading) -> (BT,N,C). Dropout
        only with a generator (training)."""
        src, mask, lvl_pos, spatial_shapes = flatten_levels(srcs, masks, pos,
                                                            self.level_embed)
        B = src.shape[0]
        ref_pts = torch.cat([make_reference_points(s, src.device)
                             for s in spatial_shapes])                 # (N, 2)
        ref_boxes = torch.cat([ref_pts, torch.full_like(ref_pts, 0.1)], -1)
        ref_boxes = ref_boxes[None].expand(B, -1, -1)
        x = src
        for layer in self.encoder.layers:
            x = layer(x, lvl_pos, ref_boxes, spatial_shapes, mask, drop_rate,
                      generator)
        return self.encoder.norm(x)
