"""RegNetX without a stem (port of ``gga_tpu/models/backbones/regnet.py``,
mmdet3d's NoStemRegNet over mmdet's RegNet), NCHW.

Stage widths and depths come from the quantized linear rule of
`Designing Network Design Spaces <https://arxiv.org/abs/2003.13678>`_
(``generate_regnet``); a stage is a stack of X-blocks: a 1x1 conv, a 3x3
grouped conv (the stage's stride in its first block), a 1x1 conv without
an activation, each with BN, and a residual with a 1x1 projection where
the shape changes. The pillar scatter's 64-channel map enters stage 0
directly (strides (1, 2, 2, 2)); stages 1-3 are returned.

The grouped conv is ``groups = width // group_width``: torch and flax
(``feature_group_count``) both split the channels into contiguous groups.
Each block holds its convs and norms under mmdet's names (``conv1-3``,
``bn1-3``, ``downsample.0/1``), so a block is not built from
``layers.ConvModule2d`` (children ``conv``, ``bn``). Convs compute in the
input dtype and BN in f32 with the output in the input dtype, as gga_tpu's
flax modules do on a bf16 canvas.
"""
from __future__ import annotations

import numpy as np
import torch.nn.functional as F
from torch import nn

from ..layers import BatchNorm2d, Conv2d

# the stages' strides (stage 0 at the canvas' resolution) and the stages
# returned, as every shipped config builds them
STRIDES = (1, 2, 2, 2)
OUT_INDICES = (1, 2, 3)
# arch presets (mmcv regnet zoo; name -> w0, wa, wm, group_w, depth)
REGNET_ARCHS = {
    'regnetx_400mf': dict(w0=24, wa=24.48, wm=2.54, group_w=16, depth=22),
    'regnetx_800mf': dict(w0=56, wa=35.73, wm=2.28, group_w=16, depth=16),
    'regnetx_1.6gf': dict(w0=80, wa=34.01, wm=2.25, group_w=24, depth=18),
    'regnetx_3.2gf': dict(w0=88, wa=26.31, wm=2.25, group_w=48, depth=25),
}


def generate_regnet(w0, wa, wm, depth, group_w, *, divisor=8):
    """Per-stage (widths, depths, group widths): u_j = w0 + wa * j,
    quantized to powers of wm times w0 and rounded to the divisor; equal
    widths form a stage (non-decreasing, so ``np.unique``'s order is the
    stage order); each width snapped to a multiple of its group width."""
    cont = w0 + wa * np.arange(depth)
    ks = np.round(np.log(cont / w0) / np.log(wm))
    widths = (np.round(w0 * np.power(wm, ks) / divisor) *
              divisor).astype(int)
    stage_widths, stage_depths = np.unique(widths, return_counts=True)
    gws = np.minimum(group_w, stage_widths)
    stage_widths = (np.round(stage_widths / gws) * gws).astype(int)
    return (tuple(int(w) for w in stage_widths),
            tuple(int(d) for d in stage_depths),
            tuple(int(g) for g in gws))


class RegNetXBlock(nn.Module):
    """1x1 -> 3x3 grouped (the block's stride) -> 1x1 (no activation),
    BN after each, ReLU after the residual add; bottleneck ratio 1."""

    def __init__(self, in_channels, width, stride, group_width):
        super().__init__()
        self.conv1 = Conv2d(in_channels, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, stride, padding=1,
                            groups=width // group_width, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = Conv2d(width, width, 1, bias=False)
        self.bn3 = BatchNorm2d(width)
        self.downsample = (
            nn.Sequential(Conv2d(in_channels, width, 1, stride, bias=False),
                          BatchNorm2d(width))
            if stride != 1 or in_channels != width else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(y + shortcut)


class NoStemRegNet(nn.Module):
    """Four RegNetX stages (``layer1`` .. ``layer4``, at STRIDES) on an
    NCHW map of ``in_channels``; returns the stages of OUT_INDICES, whose
    widths are ``out_channels``."""

    def __init__(self, arch='regnetx_400mf', in_channels=64):
        super().__init__()
        widths, depths, gws = generate_regnet(**REGNET_ARCHS[arch])
        self.out_channels = tuple(widths[i] for i in OUT_INDICES)
        ch = in_channels
        for i, (w, d, g) in enumerate(zip(widths, depths, gws)):
            blocks = []
            for j in range(d):
                blocks.append(RegNetXBlock(ch, w, STRIDES[i] if j == 0 else 1,
                                           g))
                ch = w
            self.add_module(f'layer{i + 1}', nn.Sequential(*blocks))
        self.num_stages = len(widths)

    def forward(self, x):
        """x [B, C, H, W] -> tuple of the OUT_INDICES stages' maps."""
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
            if i in OUT_INDICES:
                outs.append(x)
        return tuple(outs)
