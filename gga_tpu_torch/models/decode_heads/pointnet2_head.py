"""PointNet++ semantic-segmentation decode head (port of
``gga_tpu/models/decode_heads/pointnet2_head.py``; mmdet3d's PointNet2Head
and, with ``paconv``, PAConvHead): feature propagation modules run
bottom-up from the deepest set abstraction back to the raw points, then
the ``pre_seg_conv`` ConvBN, the dropout and the ``conv_seg`` class layer.

mmdet3d's names: ``FP_modules.{i}.mlps.layer{k}``, ``pre_seg_conv.conv`` /
``.bn``, ``conv_seg.weight`` [K, C, 1] and ``.bias``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..backbones.pointnet2 import ConvBN, PointConv, PointFPModule


class PointNet2SegHead(nn.Module):
    """``level_channels``: the feature width of each level, the raw points'
    first. PointNet2Head drops the raw level's features (gga_tpu's
    ``sa_features[0] = None``, so the raw colour never reaches the last
    feature propagation) and zeroes the padded points' logits; PAConv's
    head (``paconv=True``) does neither, as gga_tpu's PAConvSegmentor."""

    def __init__(self, level_channels, num_classes, fp_channels=(
            (256, 256), (256, 256), (256, 128), (128, 128, 128)),
            channels=128, paconv=False):
        super().__init__()
        if len(fp_channels) != len(level_channels) - 1:
            raise ValueError(f'{len(fp_channels)} feature propagations for '
                             f'{len(level_channels)} levels')
        self.paconv = paconv
        self.FP_modules = nn.ModuleList()
        feat = level_channels[-1]
        for i, ch in enumerate(fp_channels):
            tgt = len(level_channels) - 2 - i
            skip = level_channels[tgt] if tgt or paconv else 0
            self.FP_modules.append(PointFPModule(feat + skip, ch))
            feat = ch[-1]
        self.pre_seg_conv = ConvBN(feat, channels)
        self.conv_seg = PointConv(channels, num_classes, bias=True)

    def forward(self, sa_xyz, sa_features, sa_valid, dropout):
        """The levels' xyz / features / valid lists (raw points first);
        ``dropout`` applied to the pre-seg features. Returns per-point
        logits [B, P, num_classes]."""
        sa_features = list(sa_features)
        if not self.paconv:
            sa_features[0] = None
        f = sa_features[-1]
        for i, fp in enumerate(self.FP_modules):
            tgt = len(sa_xyz) - 2 - i
            f = fp(sa_xyz[tgt], sa_features[tgt], sa_xyz[tgt + 1], f,
                   sa_valid[tgt + 1], sa_valid[tgt])
        f = dropout(self.pre_seg_conv(f, sa_valid[0]))
        logits = self.conv_seg(f)
        if self.paconv:
            return logits
        return torch.where(sa_valid[0][..., None], logits, 0.0)
