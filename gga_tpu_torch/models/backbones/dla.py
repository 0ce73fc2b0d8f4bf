"""DLA-34 backbone of the monocular KITTI detectors, NCHW (the port of
``gga_tpu/models/backbones/dla.py``; mmdet3d's DLANet, arch 34: a 7x7 stem,
two plain conv levels, then the hierarchical ``Tree`` stages whose roots
fuse their children through a 1x1 conv; levels (1, 1, 1, 2, 2, 1),
channels (16, 32, 64, 128, 256, 512)).

Norms are the port's ``layers.GroupNorm`` (flax's arithmetic, eps 1e-6)
with gga_tpu's group count: 32, or 16 where the channels are not a
multiple of 32, never more than the channels (``norm_groups``). The SMOKE
and MonoFlex configs run gn-all; BN is not offered (gga_tpu's ``norm='BN'``
is never configured).

State_dict keys are mmdet3d's: ``base_layer.{0,1}``, ``level{0,1}.{0,1}``
(conv, norm), ``level{2-5}`` trees with ``tree1`` / ``tree2`` (a
``BasicBlock``'s ``conv1``, ``norm1``, ``conv2``, ``norm2``, or a nested
tree), ``root.conv`` / ``root.norm`` and ``project.{0,1}``.

A tree of more than one level computes its ``project`` in gga_tpu (and in
mmdet3d) and discards it: its ``tree1`` projects its own input again. The
port keeps those parameters (the conversion is one to one) and skips the
discarded conv, so they take no gradient, as in gga_tpu, where theirs are
zero.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import GroupNorm

ARCH = {34: ((1, 1, 1, 2, 2, 1), (16, 32, 64, 128, 256, 512))}


def norm_groups(channels):
    """gga_tpu's ``_Norm`` group count: 32, or 16 where ``channels`` is not
    a multiple of 32, at most ``channels``."""
    return min(32 if channels % 32 == 0 else 16, channels)


def group_norm(channels):
    return GroupNorm(norm_groups(channels), channels)


def conv_norm(in_channels, out_channels, kernel, stride=1, relu=True):
    """Conv (no bias, padding ``kernel // 2``) + GroupNorm (+ ReLU):
    gga_tpu's ``_Conv``; children ``0`` conv, ``1`` norm."""
    layers = [nn.Conv2d(in_channels, out_channels, kernel, stride,
                        padding=kernel // 2, bias=False),
              group_norm(out_channels)]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu else []))


class BasicBlock(nn.Module):
    """Two 3x3 conv + GroupNorm, the given identity added before the last
    ReLU (gga_tpu ``DLABasicBlock``)."""

    def __init__(self, in_channels, out_channels, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, stride, 1,
                               bias=False)
        self.norm1 = group_norm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, 1, 1,
                               bias=False)
        self.norm2 = group_norm(out_channels)

    def forward(self, x, identity):
        out = F.relu(self.norm1(self.conv1(x)))
        return F.relu(self.norm2(self.conv2(out)) + identity)


class Root(nn.Module):
    """1x1 conv + GroupNorm over the concatenated children, then ReLU."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.norm = group_norm(out_channels)

    def forward(self, feats):
        return F.relu(self.norm(self.conv(torch.cat(feats, 1))))


class Tree(nn.Module):
    """Recursive aggregation tree (gga_tpu ``Tree``): ``root_extra`` is the
    channel count of the children handed down by the parent tree."""

    def __init__(self, levels, in_channels, out_channels, stride=1,
                 level_root=False, root_extra=0):
        super().__init__()
        self.levels = levels
        self.stride = stride
        self.level_root = level_root
        self.project = (conv_norm(in_channels, out_channels, 1, relu=False)
                        if in_channels != out_channels else None)
        extra = root_extra + (in_channels if level_root else 0)
        if levels == 1:
            self.tree1 = BasicBlock(in_channels, out_channels, stride)
            self.tree2 = BasicBlock(out_channels, out_channels)
            self.root = Root(2 * out_channels + extra, out_channels)
        else:
            self.tree1 = Tree(levels - 1, in_channels, out_channels, stride)
            self.tree2 = Tree(levels - 1, out_channels, out_channels,
                              root_extra=extra + out_channels)

    def forward(self, x, children=()):
        children = list(children)
        bottom = (F.max_pool2d(x, self.stride, self.stride)
                  if self.stride > 1 else x)
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            identity = bottom if self.project is None else self.project(bottom)
            x1 = self.tree1(x, identity)
            x2 = self.tree2(x1, x1)
            return self.root([x2, x1] + children)
        x1 = self.tree1(x)
        return self.tree2(x1, children + [x1])


class DLANet(nn.Module):
    """[B, 3, H, W] -> the six levels' maps at strides 1, 2, 4, 8, 16, 32."""

    def __init__(self, depth=34, channels=(),
                 level_with_root=(False, True, True, True)):
        super().__init__()
        levels, arch_channels = ARCH[depth]
        channels = tuple(channels) or arch_channels
        self.out_channels = channels
        self.base_layer = conv_norm(3, channels[0], 7)
        for i in range(2):      # arch 34's plain levels: one conv each
            self.add_module(f'level{i}', conv_norm(channels[0], channels[i],
                                                   3, i + 1))
        for i in range(2, len(levels)):
            self.add_module(f'level{i}', Tree(
                levels[i], channels[i - 1], channels[i], stride=2,
                level_root=level_with_root[i - 2]))

    def forward(self, x):
        x = self.base_layer(x)
        outs = []
        for i in range(len(self.out_channels)):
            x = getattr(self, f'level{i}')(x)
            outs.append(x)
        return tuple(outs)
