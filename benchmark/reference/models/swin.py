"""Swin backbone, v2 (default) and v1 (counterpart of
``mdqe_cvpr2023_tpu/models/swin.py``).

v2: cosine window attention with a clamped learned logit scale, a continuous
position bias (CPB) MLP on log-scaled relative coordinates, q and v biases (no
k bias), post-norm blocks (x = shortcut + norm1(attn(x))), PatchMerging that
reduces then norms, the last stage at half the window. v1: scaled dot-product
attention with a learned relative-position-bias table, a full qkv bias,
pre-norm blocks, PatchMerging that norms then reduces, one window for every
stage. Both: shifted windows by a cyclic roll with the -100 cross-window mask
on the padded grid, per-stage output LayerNorms, and the optional absolute
position embedding (APE), resized bicubically to the patch grid.

Parameter names are the Detectron2 ones under ``detr.backbone.0.backbone.``
(``patch_embed.{proj,norm}``, ``layers.{i}.blocks.{j}.{attn.*,norm1,mlp.fc1,
mlp.fc2,norm2}``, ``layers.{i}.downsample.{reduction,norm}``, ``norm{i}``,
``absolute_pos_embed``). The relative-position index, the CPB coordinate
table, the shift masks and the resize matrices are computed from shapes
(numpy, cached per device) and are not buffers: a bf16 copy of the encode
weights leaves them fp32, as the JAX package's fp32 constants are, and the
state dict holds exactly the JAX tree's leaves.

Blocks run channel-last (B, H, W, C); ``SwinTransformer.forward`` takes and
returns NCHW like ``ResNet``. Stochastic depth draws from a
``torch.Generator`` in training and is off without one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.nn import LayerNorm, drop_path


@dataclass(frozen=True)
class SwinCfg:
    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window_size: int = 12
    mlp_ratio: float = 4.0
    patch_size: int = 4
    out_stages: Tuple[int, ...] = (1, 2, 3)  # strides 8 / 16 / 32
    version: int = 2             # 1: swin_transformer.py, 2: swin_transformer_v2.py
    drop_path_rate: float = 0.0  # the configs train with 0.2 (MODEL.SWIN.DROP_PATH_RATE)
    ape: bool = False            # absolute position embedding (off in every preset)
    pretrain_img_size: int = 224

    @property
    def emit_stages(self) -> Tuple[int, ...]:
        """out_stages restricted to the stages that exist; when most are
        absent (fewer than 4 stages), the last min(3, n_stages) stages."""
        n = len(self.depths)
        valid = tuple(i for i in self.out_stages if i < n)
        if len(valid) < min(len(self.out_stages), n):
            valid = tuple(range(max(0, n - len(self.out_stages)), n))
        return valid

    def stage_dim(self, i):
        return self.embed_dim * 2 ** i

    def stage_window(self, i):
        if self.version == 1:
            return self.window_size
        return self.window_size // 2 if i == len(self.depths) - 1 else self.window_size

    def block_drop_path(self, i, j):
        """Stochastic-depth rate of block j of stage i: linearly spaced from 0
        to drop_path_rate over all blocks."""
        total = sum(self.depths)
        if total <= 1 or self.drop_path_rate <= 0.0:
            return 0.0
        return self.drop_path_rate * (sum(self.depths[:i]) + j) / (total - 1)


# the presets of the reference's backbone/config.py; 'large' keeps the window
# the released swinl configs use (configs/swinl_*.yaml WINDOW_SIZE 12)
SWIN_PRESETS = {
    "tiny": SwinCfg(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                    window_size=8),
    "small": SwinCfg(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24),
                     window_size=16),
    "base": SwinCfg(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                    window_size=16),
    "large": SwinCfg(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                     window_size=12),
}


# ---------------------------------------------------------------------------
# constants computed from shapes
# ---------------------------------------------------------------------------

def coords_table(wh: int, ww: int) -> np.ndarray:
    """(2wh-1, 2ww-1, 2) log-scaled relative coordinates, the CPB MLP's input."""
    rh = np.arange(-(wh - 1), wh, dtype=np.float64)
    rw = np.arange(-(ww - 1), ww, dtype=np.float64)
    table = np.stack(np.meshgrid(rh, rw, indexing="ij"), axis=-1)
    table[..., 0] /= max(wh - 1, 1)
    table[..., 1] /= max(ww - 1, 1)
    table *= 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.astype(np.float32)


def rel_pos_index(wh: int, ww: int) -> np.ndarray:
    """(wh*ww * wh*ww,) index of each (query, key) pair of a window into the
    (2wh-1)(2ww-1) relative positions."""
    ch, cw = np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    coords = np.stack([ch.reshape(-1), cw.reshape(-1)])
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[..., 0] += wh - 1
    rel[..., 1] += ww - 1
    rel[..., 0] *= 2 * ww - 1
    return rel.sum(-1).reshape(-1).astype(np.int64)


def shift_attn_mask(Hp: int, Wp: int, win: int, shift: int) -> np.ndarray:
    """(nW, win*win, win*win) additive mask (0 / -100) of the shifted windows
    of a padded Hp x Wp grid: a token sees only tokens of its own region."""
    img = np.zeros((Hp, Wp))
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    mw = img.reshape(Hp // win, win, Wp // win, win).transpose(0, 2, 1, 3)
    mw = mw.reshape(-1, win * win)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def bicubic_matrix(n_out: int, n_in: int, a: float = -0.75) -> np.ndarray:
    """(n_out, n_in) 1-D bicubic resize matrix with the semantics of
    ``F.interpolate(mode="bicubic", align_corners=False)``: half-pixel source
    positions, the Keys kernel at a = -0.75, taps clamped at the edges."""
    def k(t):
        t = abs(t)
        if t <= 1:
            return (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1
        if t < 2:
            return a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a
        return 0.0

    m = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(src))
        for tap in range(x0 - 1, x0 + 3):
            m[i, min(max(tap, 0), n_in - 1)] += k(src - tap)
    return m


@lru_cache(maxsize=64)
def _const(fn, args: tuple, device: str) -> torch.Tensor:
    """``fn(*args)`` as a tensor on ``device``, made once per (shape, device);
    never an inference tensor, so that a training step after an inference
    run may save it for its backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(fn(*args)).to(device)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    """std * a normal truncated at two standard deviations."""
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    t.mul_(std)


def _init_linear(lin: nn.Linear, gen: torch.Generator):
    bound = 1.0 / math.sqrt(lin.in_features)
    lin.weight.uniform_(-bound, bound, generator=gen)
    if lin.bias is not None:
        lin.bias.uniform_(-bound, bound, generator=gen)


class WindowAttentionV2(nn.Module):
    """Cosine attention over the tokens of a window with the CPB bias. The
    logits after the bias, the mask and the softmax are fp32 whatever the
    activation type (the CPB table is fp32); q.k and the value product run in
    the activation type."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.logit_scale = nn.Parameter(torch.empty(num_heads, 1, 1))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(),
                                     nn.Linear(512, num_heads, bias=False))
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = nn.Linear(dim, dim)

    @torch.no_grad()
    def reset_parameters(self, gen):
        self.logit_scale.fill_(math.log(10.0))
        _init_linear(self.cpb_mlp[0], gen)
        nn.init.xavier_uniform_(self.cpb_mlp[2].weight, generator=gen)
        nn.init.xavier_uniform_(self.qkv.weight, generator=gen)
        self.q_bias.zero_()
        self.v_bias.zero_()
        _init_linear(self.proj, gen)

    def forward(self, x, win: int, mask=None):
        """x (B_, N, C) windows of N = win*win tokens; mask (nW, N, N) or None."""
        B_, N, C = x.shape
        h = self.num_heads
        bias = torch.cat([self.q_bias, torch.zeros_like(self.v_bias), self.v_bias])
        qkv = F.linear(x, self.qkv.weight, bias)
        q, k, v = qkv.reshape(B_, N, 3, h, C // h).permute(2, 0, 3, 1, 4).unbind(0)
        q = q / q.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        k = k / k.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        attn = q @ k.transpose(-2, -1)
        attn = attn * torch.exp(self.logit_scale.clamp(max=math.log(100.0)))

        dev = str(x.device)
        l0, l2 = self.cpb_mlp[0], self.cpb_mlp[2]
        cpb = F.linear(_const(coords_table, (win, win), dev), l0.weight.float(),
                       l0.bias.float())
        cpb = F.linear(F.relu(cpb), l2.weight.float()).reshape(-1, h)
        bias = cpb[_const(rel_pos_index, (win, win), dev)].reshape(N, N, h)
        attn = attn.float() + 16.0 * torch.sigmoid(bias.permute(2, 0, 1))
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, h, N, N) + mask[None, :, None]).reshape(
                B_, h, N, N)
        out = torch.softmax(attn, dim=-1).to(v.dtype) @ v
        return self.proj(out.transpose(1, 2).reshape(B_, N, C).to(x.dtype))


class WindowAttentionV1(nn.Module):
    """Scaled dot-product attention over a window with a learned relative
    position bias; logits and softmax in fp32."""

    def __init__(self, dim: int, num_heads: int, win: int):
        super().__init__()
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * win - 1) ** 2, num_heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    @torch.no_grad()
    def reset_parameters(self, gen):
        _trunc_normal_(self.relative_position_bias_table, 0.02, gen)
        _init_linear(self.qkv, gen)
        _init_linear(self.proj, gen)

    def forward(self, x, win: int, mask=None):
        B_, N, C = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(B_, N, 3, h, C // h).permute(2, 0, 3, 1, 4).unbind(0)
        attn = (q * (C // h) ** -0.5).float() @ k.float().transpose(-2, -1)
        bias = self.relative_position_bias_table[_const(rel_pos_index, (win, win),
                                                        str(x.device))]
        attn = attn + bias.reshape(N, N, h).permute(2, 0, 1).float()
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, h, N, N) + mask[None, :, None]).reshape(
                B_, h, N, N)
        out = torch.softmax(attn, dim=-1).to(v.dtype) @ v
        return self.proj(out.transpose(1, 2).reshape(B_, N, C).to(x.dtype))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, win: int, mlp_ratio: float,
                 version: int):
        super().__init__()
        self.version = version
        self.attn = (WindowAttentionV1(dim, num_heads, win) if version == 1
                     else WindowAttentionV2(dim, num_heads))
        self.norm1 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.norm2 = LayerNorm(dim)

    @torch.no_grad()
    def reset_parameters(self, gen):
        self.attn.reset_parameters(gen)
        for norm in (self.norm1, self.norm2):
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)
        _init_linear(self.mlp.fc1, gen)
        _init_linear(self.mlp.fc2, gen)

    def forward(self, x, win: int, shift: int, dp_rate: float = 0.0, generator=None):
        """x (B, H, W, C): window attention on the grid padded to a multiple
        of ``win`` (rolled by ``shift`` when > 0), then the MLP; pre-norm
        (v1) or post-norm (v2) residuals, each branch under stochastic depth."""
        B, H, W, C = x.shape
        shortcut = x
        if self.version == 1:
            x = self.norm1(x)
        pad_b, pad_r = (win - H % win) % win, (win - W % win) % win
        xp = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if shift > 0:
            xp = torch.roll(xp, (-shift, -shift), (1, 2))
            mask = _const(shift_attn_mask, (Hp, Wp, win, shift), str(x.device))
        xw = xp.reshape(B, Hp // win, win, Wp // win, win, C).permute(0, 1, 3, 2, 4, 5)
        aw = self.attn(xw.reshape(-1, win * win, C), win, mask)
        xp = aw.reshape(B, Hp // win, Wp // win, win, win, C).permute(0, 1, 3, 2, 4, 5)
        xp = xp.reshape(B, Hp, Wp, C)
        if shift > 0:
            xp = torch.roll(xp, (shift, shift), (1, 2))
        x = xp[:, :H, :W]

        if self.version == 1:
            x = shortcut + drop_path(x, dp_rate, generator)
            return x + drop_path(self.mlp(self.norm2(x)), dp_rate, generator)
        x = shortcut + drop_path(self.norm1(x), dp_rate, generator)
        return x + drop_path(self.norm2(self.mlp(x)), dp_rate, generator)


class PatchMerging(nn.Module):
    """(B, H, W, C) -> (B, ceil(H/2), ceil(W/2), 2C): the four 2x2 neighbours
    concatenated in the order [0::2, 0::2], [1::2, 0::2], [0::2, 1::2],
    [1::2, 1::2]; v1 norms the 4C concatenation, then reduces; v2 reduces,
    then norms the 2C output."""

    def __init__(self, dim: int, version: int):
        super().__init__()
        self.version = version
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(4 * dim if version == 1 else 2 * dim)

    def forward(self, x):
        H, W = x.shape[1:3]
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        if self.version == 1:
            return self.reduction(self.norm(x))
        return self.norm(self.reduction(x))


class SwinLayer(nn.Module):
    """One stage: its blocks (even ones unshifted, odd ones shifted by half a
    window) and the PatchMerging after it (all stages but the last)."""

    def __init__(self, cfg: SwinCfg, i: int):
        super().__init__()
        dim = cfg.stage_dim(i)
        self.blocks = nn.ModuleList(
            SwinBlock(dim, cfg.num_heads[i], cfg.stage_window(i), cfg.mlp_ratio,
                      cfg.version) for _ in range(cfg.depths[i]))
        self.downsample = (PatchMerging(dim, cfg.version) if i < len(cfg.depths) - 1
                           else None)


class SwinTransformer(nn.Module):
    """A normalized NCHW image batch -> the NCHW outputs of ``cfg.emit_stages``
    (strides 8, 16, 32 for the presets), each after its stage's LayerNorm."""

    def __init__(self, cfg: SwinCfg):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size,
                                          stride=cfg.patch_size)
        self.patch_embed.norm = LayerNorm(cfg.embed_dim)
        if cfg.ape:
            r = cfg.pretrain_img_size // cfg.patch_size
            self.absolute_pos_embed = nn.Parameter(torch.zeros(1, cfg.embed_dim, r, r))
        self.layers = nn.ModuleList(SwinLayer(cfg, i) for i in range(len(cfg.depths)))
        for i in cfg.emit_stages:
            setattr(self, f"norm{i}", LayerNorm(cfg.stage_dim(i)))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        """The init of ``swin_init``: torch-default convolution and linears,
        xavier-uniform qkv, CPB output and reductions, unit norms, truncated
        normal (std 0.02) bias tables and APE, logit scale log(10)."""
        proj = self.patch_embed.proj
        bound = 1.0 / math.sqrt(proj.weight[0].numel())
        proj.weight.uniform_(-bound, bound, generator=gen)
        proj.bias.uniform_(-bound, bound, generator=gen)
        norms = [self.patch_embed.norm] + [getattr(self, f"norm{i}")
                                           for i in self.cfg.emit_stages]
        if self.cfg.ape:
            _trunc_normal_(self.absolute_pos_embed, 0.02, gen)
        for layer in self.layers:
            for blk in layer.blocks:
                blk.reset_parameters(gen)
            if layer.downsample is not None:
                nn.init.xavier_uniform_(layer.downsample.reduction.weight, generator=gen)
                norms.append(layer.downsample.norm)
        for norm in norms:
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)

    def forward(self, x, generator=None):
        """x (B, 3, H, W); ``generator`` turns stochastic depth on at the
        per-block rates of ``cfg.block_drop_path``."""
        cfg = self.cfg
        ps = cfg.patch_size
        H, W = x.shape[2:]
        x = F.pad(x, (0, (ps - W % ps) % ps, 0, (ps - H % ps) % ps))
        x = self.patch_embed.norm(self.patch_embed.proj(x).permute(0, 2, 3, 1))
        if cfg.ape:
            ape = self.absolute_pos_embed[0].float()  # (C, H0, W0)
            dev = str(x.device)
            ky = _const(bicubic_matrix, (x.shape[1], ape.shape[1]), dev)
            kx = _const(bicubic_matrix, (x.shape[2], ape.shape[2]), dev)
            x = x + torch.einsum("hH,cHW,wW->hwc", ky, ape, kx)[None].to(x.dtype)
        outs = []
        for i, layer in enumerate(self.layers):
            win = cfg.stage_window(i)
            for j, blk in enumerate(layer.blocks):
                x = blk(x, win, 0 if j % 2 == 0 else win // 2,
                        cfg.block_drop_path(i, j), generator)
            if i in cfg.emit_stages:
                outs.append(getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2))
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs
