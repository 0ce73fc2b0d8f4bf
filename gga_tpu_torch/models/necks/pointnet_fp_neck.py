"""PointNet++ feature-propagation neck of PointRCNN (port of
``gga_tpu/models/necks/pointnet_fp_neck.py``; mmdet3d's PointNetFPNeck):
the encoder's levels are propagated back up, deepest first, until the
features live on the input points. ``fp_channels`` holds each
propagation's MLP widths; its input width (the interpolated features and
the target level's own) is inferred from ``level_channels``, the
encoder's width at each level, input level first.
"""
from __future__ import annotations

from torch import nn

from ..backbones.pointnet2 import PointFPModule


class PointNetFPNeck(nn.Module):
    def __init__(self, level_channels, fp_channels=(
            (512, 512), (512, 512), (256, 256), (128, 128))):
        super().__init__()
        if len(level_channels) != len(fp_channels) + 1:
            raise ValueError(f'{len(level_channels)} levels need '
                             f'{len(level_channels) - 1} propagations, got '
                             f'{len(fp_channels)}')
        self.FP_modules = nn.ModuleList()
        feat = level_channels[-1]
        for i, ch in enumerate(fp_channels):
            self.FP_modules.append(PointFPModule(
                feat + level_channels[-(i + 2)], ch))
            feat = ch[-1]
        self.out_channels = feat

    def forward(self, feat_dict):
        """feat_dict: ``PointNet2SAMSG``'s. Returns dict(fp_xyz,
        fp_features [B, P, C], fp_valid) on the input points."""
        sa_xyz = feat_dict['sa_xyz']
        sa_feats = feat_dict['sa_features']
        sa_valid = feat_dict['sa_valid']
        fp_f, fp_x, fp_v = sa_feats[-1], sa_xyz[-1], sa_valid[-1]
        for i, fp in enumerate(self.FP_modules):
            tgt = -(i + 2)
            fp_f = fp(sa_xyz[tgt], sa_feats[tgt], fp_x, fp_f, fp_v,
                      sa_valid[tgt])
            fp_x, fp_v = sa_xyz[tgt], sa_valid[tgt]
        return dict(fp_xyz=fp_x, fp_features=fp_f, fp_valid=fp_v)
