"""ResNet backbone of the monocular path, NCHW (the port of
``gga_tpu/models/backbones/resnet.py``; mmdet's ResNet as the reference's
FCOS3D / PGD configs use it: depth 101, caffe style, the four stages'
outputs at strides 4 / 8 / 16 / 32).

State_dict keys are mmdet's: ``conv1``, ``bn1``, ``layer{1-4}.{block}``
with ``conv{1-3}``, ``bn{1-3}`` and ``downsample.{0,1}``. Norms are the
port's ``layers.BatchNorm2d`` (flax's: eps 1e-3, momentum 0.01, biased
running variance). Caffe style puts a bottleneck's stride on its first
1x1 conv, pytorch style on its 3x3 conv.

gga_tpu pads its 3x3 convs 'SAME', which at stride 2 on an even size pads
(0, 1), one row and column at the end only, where ``nn.Conv2d(padding=1)``
pads (1, 1): ``Conv2dSame`` pads as flax does. The 1x1 stride-2 convs pad
nothing in either; the stem's 7x7 conv and its max-pool pad (3, 3) and
(1, 1) explicitly in both.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..layers import BatchNorm2d

ARCH = {18: ((2, 2, 2, 2), 'basic'), 34: ((3, 4, 6, 3), 'basic'),
        50: ((3, 4, 6, 3), 'bottleneck'), 101: ((3, 4, 23, 3), 'bottleneck')}


def same_padding(size, kernel, stride):
    """(before, after) padding of one spatial dim under TF/flax 'SAME'."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """Bias-free ``nn.Conv2d`` with flax's 'SAME' padding."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding=0, bias=False)

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        pad = (*same_padding(x.shape[-1], kw, sw),
               *same_padding(x.shape[-2], kh, sh))
        return super().forward(F.pad(x, pad) if any(pad) else x)


def _downsample(in_channels, out_channels, stride):
    return nn.Sequential(
        nn.Conv2d(in_channels, out_channels, 1, stride, bias=False),
        BatchNorm2d(out_channels))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels, planes, stride=1, style='caffe'):
        super().__init__()
        s1, s2 = (stride, 1) if style == 'caffe' else (1, stride)
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(in_channels, planes, 1, s1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2dSame(planes, planes, 3, s2)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.downsample = (_downsample(in_channels, out, stride)
                           if in_channels != out or stride != 1 else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels, planes, stride=1, style='caffe'):
        super().__init__()
        self.conv1 = Conv2dSame(in_channels, planes, 3, stride)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2dSame(planes, planes, 3)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (_downsample(in_channels, planes, stride)
                           if in_channels != planes or stride != 1 else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """[B, 3, H, W] -> the stages' outputs named by ``out_indices``."""

    def __init__(self, depth=101, out_indices=(0, 1, 2, 3), base_planes=64,
                 style='caffe'):
        super().__init__()
        stage_blocks, kind = ARCH[depth]
        block = Bottleneck if kind == 'bottleneck' else BasicBlock
        self.out_indices = tuple(out_indices)
        self.conv1 = nn.Conv2d(3, base_planes, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(base_planes)
        channels, planes = base_planes, base_planes
        self.out_channels = []
        for i, n_blocks in enumerate(stage_blocks):
            blocks = []
            for j in range(n_blocks):
                blocks.append(block(channels, planes,
                                    stride=2 if i and not j else 1,
                                    style=style))
                channels = planes * block.expansion
            self.add_module(f'layer{i + 1}', nn.Sequential(*blocks))
            self.out_channels.append(channels)
            planes *= 2

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs = []
        for i in range(len(self.out_channels)):
            x = getattr(self, f'layer{i + 1}')(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
