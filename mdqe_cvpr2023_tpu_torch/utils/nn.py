"""Layer functions and the small modules that hold their parameters.

Counterpart of ``mdqe_cvpr2023_tpu/utils/nn.py``. Parameter shapes follow the
torch conventions the JAX tree already uses (Linear (out, in), Conv OIHW), so
weights move between the two by name alone; convolutions are torch's own
``nn.Conv2d`` and linears ``Linear``, an ``nn.Linear`` that computes in the
promoted type of its input and weight as the JAX package's einsum does
(``linear``). Convolutions and norms here take NCHW (cuDNN's layout); token
tensors are (..., C) as in the JAX package. Norm statistics and the attention
softmax are fp32 whatever the activation type (bf16-safe), as there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def linear(x, weight, bias=None):
    """x (..., in) @ weight (out, in)^T + bias in the promoted type of x and
    weight, as ``jnp.einsum`` promotes in the JAX package's ``linear``: under
    mixed precision an fp32 input meets bf16 weights in the decoder (its
    query stream is fp32 there) and is computed in fp32, where ``F.linear``
    would raise on the mixed types. The same as ``F.linear`` when the types
    agree."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    return F.linear(x.to(dt), weight.to(dt), None if bias is None else bias.to(dt))


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with fp32 statistics; output in x's type."""
    out = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return out.to(x.dtype)


def group_norm(x, weight, bias, num_groups: int, eps: float = 1e-5):
    """GroupNorm of NCHW x with fp32 statistics; output in x's type."""
    out = F.group_norm(x.float(), num_groups, weight.float(), bias.float(), eps)
    return out.to(x.dtype)


def frozen_batch_norm(x, weight, bias, running_mean, running_var,
                      eps: float = 1e-5):
    """FrozenBN of NCHW x folded to a per-channel scale and shift."""
    scale = weight * torch.rsqrt(running_var + eps)
    shift = bias - running_mean * scale
    return x * scale.to(x.dtype)[None, :, None, None] \
        + shift.to(x.dtype)[None, :, None, None]


def conv_transpose2d_up2(x, weight, bias):
    """Depthwise 1x1 transposed conv, stride 2, output_padding 1, on NCHW x:
    out[2i, 2j] = x[i, j] * w_c, every position + bias_c."""
    B, C, H, W = x.shape
    out = torch.zeros((B, C, 2 * H, 2 * W), dtype=x.dtype, device=x.device)
    out[:, :, ::2, ::2] = x * weight.reshape(1, C, 1, 1).to(x.dtype)
    return out + bias.to(x.dtype).reshape(1, C, 1, 1)


def mha(q, k, v, in_proj_weight, in_proj_bias, out_weight, out_bias,
        num_heads: int):
    """torch nn.MultiheadAttention (batch_first) as matmul + softmax.
    q, k, v (B, L, C); projections in the promoted type of input and weights
    (``linear``); softmax in fp32."""
    C = q.shape[-1]
    wq, wk, wv = in_proj_weight.chunk(3, dim=0)
    bq, bk, bv = in_proj_bias.chunk(3, dim=0)
    B, Lq, _ = q.shape
    Lk = k.shape[1]
    dh = C // num_heads
    qh = linear(q, wq, bq).reshape(B, Lq, num_heads, dh).transpose(1, 2)
    kh = linear(k, wk, bk).reshape(B, Lk, num_heads, dh).transpose(1, 2)
    vh = linear(v, wv, bv).reshape(B, Lk, num_heads, dh).transpose(1, 2)
    attn = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(dh)
    attn = torch.softmax(attn.float(), dim=-1).to(qh.dtype)
    out = torch.matmul(attn, vh).transpose(1, 2).reshape(B, Lq, C)
    return linear(out, out_weight, out_bias)


def position_embedding_sine(not_mask, num_pos_feats: int,
                            temperature: float = 10000.0,
                            scale: float = 2 * math.pi):
    """not_mask (B, H, W), 1 on valid pixels -> (B, H, W, 2F) channel-last
    (normalized cumulative sums, interleaved sin/cos; y features first)."""
    nm = not_mask.float()
    y_embed = nm.cumsum(1)
    x_embed = nm.cumsum(2)
    eps = 1e-6
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=nm.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    return torch.cat([pos_y, pos_x], dim=-1)


def dropout(x, rate: float, generator=None):
    """Inverted dropout drawing from ``generator`` (a ``torch.Generator`` on
    x's device): entries kept with probability 1 - rate and scaled by
    1 / (1 - rate). The mask is drawn in fp32 whatever x's type, so bf16 and
    fp32 activations draw the same mask from the same generator state, as
    ``jax.random.bernoulli`` does. Identity when the rate is 0 or no
    generator is given (eval), as the JAX package's ``dropout`` is without a
    key."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.empty(x.shape, dtype=torch.float32, device=x.device).bernoulli_(
        1.0 - rate, generator=generator)
    return x * keep.to(x.dtype) / (1.0 - rate)


def drop_path(x, rate: float, generator=None):
    """Stochastic depth (timm's DropPath): each sample of the batch axis keeps
    its whole residual branch with probability 1 - rate, scaled by
    1 / (1 - rate), or loses it. Draws from ``generator`` (a
    ``torch.Generator`` on x's device), in fp32 whatever x's type (as
    ``dropout``); identity when the rate is 0 or no generator is given
    (eval), as the JAX package's ``drop_path`` is without a key."""
    if generator is None or rate <= 0.0:
        return x
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    keep = torch.empty(shape, dtype=torch.float32, device=x.device).bernoulli_(
        1.0 - rate, generator=generator)
    return x * keep.to(x.dtype) / (1.0 - rate)


# ---------------------------------------------------------------------------
# parameter holders (state-dict names follow Detectron2 / torch.nn)
# ---------------------------------------------------------------------------

class Linear(nn.Linear):
    """``nn.Linear`` whose forward is ``linear``: the promoted type of its
    input and weight."""

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class GroupNorm(nn.GroupNorm):
    """NCHW GroupNorm with fp32 statistics."""

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)


class FrozenBatchNorm2d(nn.Module):
    """Detectron2 FrozenBatchNorm2d: all four statistics are buffers."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        return frozen_batch_norm(x, self.weight, self.bias, self.running_mean,
                                 self.running_var, self.eps)


class MLP(nn.Module):
    """GELU (exact) between layers, none after the last."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(Linear(dims[i], dims[i + 1])
                                    for i in range(num_layers))

    def forward(self, x):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1:
                x = F.gelu(x)
        return x


class MultiheadAttention(nn.Module):
    """Parameters of torch nn.MultiheadAttention; forward is ``mha``."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim)

    def forward(self, q, k, v):
        return mha(q, k, v, self.in_proj_weight, self.in_proj_bias,
                   self.out_proj.weight, self.out_proj.bias, self.num_heads)
