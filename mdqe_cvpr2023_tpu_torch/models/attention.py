"""MSDeformAttn: projections and the sampling-offset / attention-weight heads
around the deformable-attention op (counterpart of
``mdqe_cvpr2023_tpu/models/attention.py``).

Two modes:
  - 'spatial':  pyramid levels are the attention levels (encoder self-attention,
                decoder box-level cross-attention);
  - 'temporal': clip frames are the attention levels, one op call per pyramid
                level, averaged over pyramid levels (decoder instance level).
Two offset schemes:
  - pred_offsets=True:  learned offsets with a rotational-grid bias init;
  - pred_offsets=False: a fixed rotational-grid buffer scaled by the reference
                        box w/h plus a learned correction clamped to +-8*wh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.deform_attn import ms_deform_attn
from ..utils.nn import Linear

SCALE = 8.0


@dataclass(frozen=True)
class MSDeformAttnCfg:
    d_model: int = 256
    n_levels: int = 4      # pyramid levels
    n_heads: int = 8
    n_points: int = 4
    n_frames: int = 1
    pred_offsets: bool = True
    mode: str = "spatial"  # 'spatial' | 'temporal'

    @property
    def lvl(self) -> int:
        """Number of attention levels (pyramid levels or frames)."""
        return self.n_levels if self.mode == "spatial" else self.n_frames


def rot_grid(cfg: MSDeformAttnCfg) -> np.ndarray:
    """Rotational grid (H, lvl, P, 2): head h points at angle 2*pi*h/H, the ring
    radius grows with the point index; max-abs normalized, then scaled."""
    thetas = np.arange(cfg.n_heads, dtype=np.float32) * (2.0 * math.pi / cfg.n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, cfg.lvl, cfg.n_points, 1)).copy()
    for k in range(cfg.n_points):
        grid[:, :, k, :] *= k + 1
    return grid / cfg.n_points * SCALE


def lvl_spatial_scales(cfg: MSDeformAttnCfg) -> np.ndarray:
    if cfg.mode == "spatial":
        return np.arange(1, cfg.lvl + 1, dtype=np.float32)
    return np.full((cfg.lvl,), 2.0, dtype=np.float32)


class MSDeformAttn(nn.Module):
    """``site`` names the deformable-attention call site for launch counts
    (``encoder``, ``decoder_box`` or ``decoder_inst``)."""

    def __init__(self, cfg: MSDeformAttnCfg, site: str):
        super().__init__()
        self.cfg = cfg
        self.site = site
        d = cfg.d_model
        n_out = cfg.n_heads * cfg.lvl * cfg.n_points * 2
        self.value_proj = Linear(d, d)
        self.output_proj = Linear(d, d)
        self.attention_weights = Linear(d, cfg.n_heads * cfg.lvl * cfg.n_points)
        self.register_buffer("lvl_spatial_scales",
                             torch.from_numpy(lvl_spatial_scales(cfg)))
        if cfg.pred_offsets:
            self.sampling_offsets = Linear(d, n_out)
        else:
            self.register_buffer("sampling_offsets",
                                 torch.from_numpy(rot_grid(cfg)[None, None]))
            self.sampling_grid_offsets = Linear(d, n_out)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        """Init of ``ms_deform_attn_module_init``."""
        cfg = self.cfg
        for lin in (self.value_proj, self.output_proj):
            nn.init.xavier_uniform_(lin.weight, generator=gen)
            lin.bias.zero_()
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()
        if cfg.pred_offsets:
            bias = rot_grid(cfg) * 0.05 * lvl_spatial_scales(cfg).reshape(1, -1, 1, 1)
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(torch.from_numpy(bias.reshape(-1)))
        else:
            self.sampling_grid_offsets.weight.zero_()
            self.sampling_grid_offsets.bias.zero_()

    def sampling_locations(self, query, reference_points):
        """query (B,Q,C); reference_points (B,Q,4) cxcywh -> (B,Q,H,lvl,P,2) fp32."""
        cfg = self.cfg
        B, Q, _ = query.shape
        shape = (B, Q, cfg.n_heads, cfg.lvl, cfg.n_points, 2)
        ref = reference_points.float()[:, :, None, None, None, :]
        if cfg.pred_offsets:
            off = self.sampling_offsets(query).float().reshape(shape)
        else:
            off = self.sampling_offsets.float() * 0.5 * ref[..., 2:]
            corr = self.sampling_grid_offsets(query).float().reshape(shape)
            lim = ref[..., 2:] * SCALE
            off = off + torch.minimum(torch.maximum(corr, -lim), lim)
        return ref[..., :2] + off / SCALE

    def attention_weights_of(self, query):
        cfg = self.cfg
        B, Q, _ = query.shape
        w = self.attention_weights(query).float()
        w = torch.softmax(w.reshape(B, Q, cfg.n_heads, cfg.lvl * cfg.n_points), -1)
        return w.reshape(B, Q, cfg.n_heads, cfg.lvl, cfg.n_points)

    def forward(self, query, reference_points, input_flatten,
                spatial_shapes: Sequence[Tuple[int, int]], padding_mask=None,
                value_rows=None):
        """query (B,Q,C), reference_points (B,Q,4) cxcywh; the input is F
        frames, input_flatten (F,N,C) and padding_mask (F,N) True on padded,
        projected and masked once each. ``value_rows`` (a long tensor on the
        device) names the frame of each value row: (B,) spatial, (B*lvl,)
        temporal (a clip's levels in order); the rows are gathered from the
        masked projection. The temporal mode always takes it; the spatial
        mode takes none where its rows are the F frames (the encoder)."""
        cfg = self.cfg
        H = cfg.n_heads
        D = cfg.d_model // H
        value = self.value_proj(input_flatten)
        if padding_mask is not None:
            value = value.masked_fill(padding_mask[..., None], 0.0)
        loc = self.sampling_locations(query, reference_points)
        attw = self.attention_weights_of(query)

        if cfg.mode == "spatial":
            if value_rows is not None:
                value = value.index_select(0, value_rows)
            B, N, _ = value.shape
            out = ms_deform_attn(value.reshape(B, N, H, D), spatial_shapes, loc,
                                 attw, self.site)
        else:
            B, T = query.shape[0], cfg.lvl
            outs, start = [], 0
            for h_l, w_l in spatial_shapes:
                hw = int(h_l) * int(w_l)
                # the clips' levels gathered from the frames' slice, into a
                # new contiguous (B*T, hw, C): frames stacked as levels
                v_l = value[:, start:start + hw].index_select(0, value_rows) \
                    .reshape(B, T * hw, H, D)
                start += hw
                outs.append(ms_deform_attn(v_l, [(h_l, w_l)] * T, loc, attw,
                                           self.site))
            out = torch.stack(outs).mean(0)
        return self.output_proj(out.to(query.dtype))
