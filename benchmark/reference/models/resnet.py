"""Detectron2 ResNet with FrozenBN and stride_in_1x1=False (counterpart of
``mdqe_cvpr2023_tpu/models/resnet.py``). Runs NCHW; the module names are the
Detectron2 ones (``stem.conv1.{weight,norm.*}``,
``res{2..5}.{i}.{conv1,conv2,conv3,shortcut}.*``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.nn import FrozenBatchNorm2d

RESNET_STAGES = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3]}


class ConvFrozenBN(nn.Conv2d):
    """Bias-free conv followed by FrozenBN (the ``norm`` child), optional ReLU."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, relu: bool = True):
        super().__init__(cin, cout, k, stride, padding, bias=False)
        self.norm = FrozenBatchNorm2d(cout)
        self.relu = relu

    @torch.no_grad()
    def reset_parameters_from(self, gen: torch.Generator):
        """msra fill (kaiming uniform, a=0), identity statistics."""
        fan_in = self.weight[0].numel()
        bound = math.sqrt(6.0 / fan_in)
        self.weight.uniform_(-bound, bound, generator=gen)

    def forward(self, x):
        y = self.norm(F.conv2d(x, self.weight, None, self.stride, self.padding))
        return F.relu(y) if self.relu else y


class Bottleneck(nn.Module):
    """stride_in_1x1=False: the stride lives in the 3x3 conv."""

    def __init__(self, cin: int, bottleneck: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = ConvFrozenBN(cin, bottleneck, 1)
        self.conv2 = ConvFrozenBN(bottleneck, bottleneck, 3, stride, 1)
        self.conv3 = ConvFrozenBN(bottleneck, cout, 1, relu=False)
        self.shortcut = (ConvFrozenBN(cin, cout, 1, stride, relu=False)
                         if cin != cout or stride != 1 else None)

    def forward(self, x):
        sc = self.shortcut(x) if self.shortcut is not None else x
        return F.relu(self.conv3(self.conv2(self.conv1(x))) + sc)


class ResNet(nn.Module):
    """Returns res3, res4, res5 (NCHW) of a normalized NCHW image batch."""

    def __init__(self, depth: int = 50):
        super().__init__()
        self.stem = nn.Module()
        self.stem.conv1 = ConvFrozenBN(3, 64, 7, 2, 3)
        cin = 64
        for si, nblock in enumerate(RESNET_STAGES[depth]):
            bottleneck = 64 * 2 ** si
            cout = bottleneck * 4
            blocks = []
            for bi in range(nblock):
                stride = 2 if (bi == 0 and si > 0) else 1
                blocks.append(Bottleneck(cin, bottleneck, cout, stride))
                cin = cout
            setattr(self, f"res{si + 2}", nn.ModuleList(blocks))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, ConvFrozenBN):
                m.reset_parameters_from(gen)

    def forward(self, x):
        y = self.stem.conv1(x)
        y = F.max_pool2d(y, 3, 2, 1)
        feats = []
        for stage in ("res2", "res3", "res4", "res5"):
            for blk in getattr(self, stage):
                y = blk(y)
            if stage != "res2":
                feats.append(y)
        return feats
