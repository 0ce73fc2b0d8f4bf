"""DLA neck, iterative deep aggregation, NCHW (the port of
``gga_tpu/models/necks/dla_neck.py``; mmdet3d's DLANeck): ``dla_up`` runs
one ``IDAUpsample`` a level pair over the pyramid from the deepest level
up (each projects a deeper map, upsamples it with a depthwise transposed
conv initialised bilinear and fuses it with the shallower one through a
node conv), then ``ida_up`` collapses the aggregated levels into ONE map
at the ``start_level`` stride (stride 4, 64 channels, for DLA-34).

As in gga_tpu, the project and node convs are plain 3x3 convs with a bias,
GroupNorm and ReLU (its documented delta from the reference's DCNv2).

gga_tpu writes the upsampler as ``jax.lax.conv_general_dilated`` of its
kernel ``w`` [2s, 2s, 1, C] with ``lhs_dilation`` s, padding 2s - 1 - s//2
on each side and ``feature_group_count`` C: a correlation of the dilated
input with ``w``. ``conv_transpose2d`` with stride s, padding s//2 and
groups C correlates the dilated input, padded 2s - 1 - s//2, with its
weight flipped in both spatial axes; so the port's weight [C, 1, 2s, 2s]
is ``w`` flipped (``convert.py`` ``depthwise_deconv2d``). The bilinear
kernel is symmetric, so a fresh upsampler is the same in both layouts.

State_dict keys are mmdet3d's: ``dla_up.ida_{i}`` and ``ida_up``, each
with ``projs.{k}`` / ``nodes.{k}`` (``conv``, ``gn``) and ``ups.{k}``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..backbones.dla import group_norm
from ..layers import GroupNorm


def bilinear_kernel(k):
    """mmdet3d's ``fill_up_weights``: the [k, k] bilinear kernel of a
    transposed conv of stride k / 2 (gga_tpu ``_bilinear_kernel``)."""
    f = int(np.ceil(k / 2))
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    w = np.zeros((k, k), np.float32)
    for i in range(k):
        for j in range(k):
            w[i, j] = (1 - abs(i / f - c)) * (1 - abs(j / f - c))
    return w


class ConvGN(nn.Module):
    """3x3 conv with a bias + GroupNorm + ReLU (mmcv ConvModule with a GN
    norm: children ``conv`` and ``gn``); ``groups`` defaults to the DLA
    rule (``norm_groups``)."""

    def __init__(self, in_channels, out_channels, groups=None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.gn = (group_norm(out_channels) if groups is None
                   else GroupNorm(groups, out_channels))

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))


class DepthwiseUp(nn.Module):
    """Depthwise transposed conv, kernel 2s, stride s, padding s // 2: an
    [H, W] map to [s H, s W] (s = 1: the identity, no weight)."""

    def __init__(self, channels, scale):
        super().__init__()
        self.scale = scale
        self.weight = (nn.Parameter(torch.from_numpy(np.tile(
            bilinear_kernel(2 * scale), (channels, 1, 1, 1))))
            if scale > 1 else None)

    def reset_bilinear(self):
        if self.weight is not None:
            with torch.no_grad():
                self.weight.copy_(torch.from_numpy(
                    bilinear_kernel(2 * self.scale)))

    def forward(self, x):
        if self.weight is None:
            return x
        s = self.scale
        # in f32 whatever the input's dtype, as gga_tpu's
        return F.conv_transpose2d(x.float(), self.weight.float(), stride=s,
                                  padding=s // 2,
                                  groups=x.shape[1]).to(x.dtype)


class IDAUpsample(nn.Module):
    """Fuse a list of maps in place, the deeper into the shallower:
    ``feats[k + 1] = node_k(up_k(proj_k(feats[k + 1])) + feats[k])``.
    ``in_channels`` are the maps' channels, ``scales[k]`` the up factor of
    map k (``scales[0]`` unused)."""

    def __init__(self, out_channels, in_channels, scales):
        super().__init__()
        n = len(in_channels) - 1
        self.projs = nn.ModuleList(ConvGN(c, out_channels)
                                   for c in in_channels[1:])
        self.ups = nn.ModuleList(DepthwiseUp(out_channels, int(scales[k + 1]))
                                 for k in range(n))
        self.nodes = nn.ModuleList(ConvGN(out_channels, out_channels)
                                   for _ in range(n))

    def forward(self, feats):
        feats = list(feats)
        for k, (proj, up, node) in enumerate(zip(self.projs, self.ups,
                                                 self.nodes)):
            feats[k + 1] = node(up(proj(feats[k + 1])) + feats[k])
        return feats


class DLAUpsample(nn.Module):
    """The ``IDAUpsample`` groups of gga_tpu's ``DLANeck`` loop
    (``ida_{i}``), from the two deepest levels to all of them."""

    def __init__(self, channels):
        super().__init__()
        n = len(channels)
        scales = np.array([2 ** i for i in range(n)], int)
        in_ch = list(channels)
        for i in range(n - 1):
            j = -i - 2
            self.add_module(f'ida_{i}', IDAUpsample(
                channels[j], in_ch[j:], scales[j:] // scales[j]))
            scales[j + 1:] = scales[j]
            in_ch[j + 1:] = [channels[j]] * len(in_ch[j + 1:])
        self.n = n

    def forward(self, feats):
        """feats: the levels from ``start_level`` on -> the aggregated
        maps, shallowest first (each group's last map)."""
        feats = list(feats)
        outs = [feats[-1]]
        for i in range(self.n - 1):
            j = -i - 2
            feats[self.n + j:] = getattr(self, f'ida_{i}')(feats[j:])
            outs.insert(0, feats[-1])
        return outs


class DLANeck(nn.Module):
    """The levels of ``DLANet`` -> one map at the ``start_level`` stride
    with ``in_channels[start_level]`` channels."""

    def __init__(self, in_channels=(16, 32, 64, 128, 256, 512),
                 start_level=2, end_level=5):
        super().__init__()
        self.start_level = start_level
        channels = list(in_channels[start_level:])
        m = end_level - start_level
        self.dla_up = DLAUpsample(channels)
        # aggregated map k comes from the group whose output width is
        # channels[k] (the deepest is the last level itself)
        self.ida_up = IDAUpsample(channels[0], channels[:m],
                                  [2 ** i for i in range(m)])

    def reset_upsamplers(self):
        """Every upsampler back to its bilinear kernel (the init)."""
        for m in self.modules():
            if isinstance(m, DepthwiseUp):
                m.reset_bilinear()

    def forward(self, feats):
        outs = self.dla_up(feats[self.start_level:])
        return self.ida_up(outs[:len(self.ida_up.projs) + 1])[-1]
