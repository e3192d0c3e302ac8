"""YOLACT-style proto-mask FPN head (counterpart of
``mdqe_cvpr2023_tpu/models/mask_head.py``). Runs NCHW inside; takes and
returns channel-last maps at its public boundary like the JAX head."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.misc import interpolate_nearest
from ..utils.nn import GroupNorm, conv_transpose2d_up2


@dataclass(frozen=True)
class MaskHeadCfg:
    hidden_dim: int = 256
    fpn_dims: tuple = (256, 256)

    @property
    def num_gen_params(self) -> int:
        return self.hidden_dim // 8


def gn_groups(cout: int) -> int:
    """32 groups if divisible, else 24, else one group per channel."""
    return 32 if cout % 32 == 0 else (24 if cout % 24 == 0 else cout)


def _kaiming_a1_(w, gen):
    bound = math.sqrt(3.0 / w[0].numel())
    w.uniform_(-bound, bound, generator=gen)


class DepthwiseSeparableConv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 5):
        super().__init__()
        self.depthwise = nn.Conv2d(cin, cin, k, padding=k // 2, groups=cin)
        self.pointwise = nn.Conv2d(cin, cout, 1)
        self.gn = GroupNorm(gn_groups(cout), cout)

    @torch.no_grad()
    def reset_parameters(self, gen):
        for conv in (self.depthwise, self.pointwise):
            _kaiming_a1_(conv.weight, gen)
            conv.bias.zero_()

    def forward(self, x):
        return F.relu(self.gn(self.pointwise(self.depthwise(x))))


class MaskHead(nn.Module):
    def __init__(self, cfg: MaskHeadCfg):
        super().__init__()
        d = cfg.hidden_dim
        self.lay1 = nn.Conv2d(d, d, 3, padding=1)
        self.gn1 = GroupNorm(8, d)
        self.lay2 = nn.Conv2d(d, d, 3, padding=1)
        self.gn2 = GroupNorm(8, d)
        self.lay3 = nn.Conv2d(d, d, 3, padding=1)
        self.gn3 = GroupNorm(8, d)
        self.out_lay1 = DepthwiseSeparableConv(d, d)
        self.out_uplay = nn.Module()
        self.out_uplay.weight = nn.Parameter(torch.zeros(d, 1, 1, 1))
        self.out_uplay.bias = nn.Parameter(torch.zeros(d))
        self.out_lay2 = DepthwiseSeparableConv(d, cfg.num_gen_params)
        self.adapter1 = nn.Conv2d(cfg.fpn_dims[0], d, 1)
        self.adapter2 = nn.Conv2d(cfg.fpn_dims[1], d, 1)

    @torch.no_grad()
    def reset_parameters(self, gen):
        for conv in (self.lay1, self.lay2, self.lay3, self.adapter1, self.adapter2):
            bound = 1.0 / math.sqrt(conv.weight[0].numel())
            conv.weight.uniform_(-bound, bound, generator=gen)
            conv.bias.uniform_(-bound, bound, generator=gen)
        self.out_lay1.reset_parameters(gen)
        self.out_lay2.reset_parameters(gen)
        _kaiming_a1_(self.out_uplay.weight, gen)

    def forward(self, x, fpns):
        """x: stride-32 (BT,H,W,C); fpns: [stride-16, stride-8] channel-last.
        Returns proto features (BT, h4, w4, M) channel-last at stride 4."""
        nchw = [t.permute(0, 3, 1, 2) for t in (x, *fpns)]
        x = F.gelu(self.gn1(self.lay1(nchw[0])))
        cur = self.adapter1(nchw[1])
        x = cur + interpolate_nearest(x, cur.shape[-2:])
        x = F.gelu(self.gn2(self.lay2(x)))
        cur = self.adapter2(nchw[2])
        x = cur + interpolate_nearest(x, cur.shape[-2:])
        x = F.gelu(self.gn3(self.lay3(x)))
        x = self.out_lay1(x)
        x = conv_transpose2d_up2(x, self.out_uplay.weight, self.out_uplay.bias)
        x = self.out_lay2(x)
        return x.permute(0, 2, 3, 1)
