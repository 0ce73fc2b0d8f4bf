"""Voxel feature encoders (port of ``gga_tpu/models/voxel_encoders.py``
``HardSimpleVFE`` and ``PillarFeatureNet``) on the padded
[..., V, max_points, C] voxel buffers of ``ops.voxelize``."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MaskedBatchNorm


class HardSimpleVFE(nn.Module):
    """Mean of the points in each voxel. No parameters."""

    def __init__(self, num_features=4):
        super().__init__()
        self.num_features = num_features

    def forward(self, voxels, num_points):
        """voxels [..., V, T, C]; num_points [..., V] -> [..., V, C]."""
        s = voxels[..., :self.num_features].sum(dim=-2)
        return s / num_points.clamp(min=1)[..., None].to(s.dtype)


class PFNLayer(nn.Module):
    """Linear (no bias) + BN over the pillars' real points + ReLU, then a
    max over each pillar's points (mmdet3d's PFNLayer; children
    ``linear`` and ``norm``)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.linear = nn.Linear(in_channels, out_channels, bias=False)
        self.norm = MaskedBatchNorm(out_channels)

    def forward(self, x, pmask):
        """x [B, V, T, C]; pmask [B, V, T] -> (x [B, V, T, D], pooled
        [B, V, D], -inf where a pillar has no point)."""
        x = F.relu(self.norm(self.linear(x), pmask))
        return x, torch.where(pmask[..., None], x, -torch.inf).amax(-2)


class PillarFeatureNet(nn.Module):
    """PointPillars' feature net (mmdet3d pillar_encoder.py:13): each
    point gains its offset to its pillar's points mean (f_cluster) and to
    the pillar's centre in x and y (f_center), then PFN layers, the
    pooled features concatenated back between two layers. The points
    carry ``in_channels`` features ((x, y, z, intensity) on KITTI, plus
    the sweep's time lag on nuScenes), so the first layer takes
    ``in_channels`` + 5 channels."""

    def __init__(self, feat_channels: Tuple[int, ...] = (64,),
                 voxel_size: Tuple[float, float, float] = (0.16, 0.16, 4.0),
                 point_cloud_range: Sequence[float] = (
                     0, -39.68, -3, 69.12, 39.68, 1), in_channels=4):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        ch = in_channels + 5
        layers = []
        for out_ch in feat_channels:
            layers.append(PFNLayer(ch, out_ch))
            ch = 2 * out_ch
        self.pfn_layers = nn.ModuleList(layers)

    def forward(self, voxels, num_points, coords):
        """voxels [B, V, T, C]; num_points [B, V]; coords [B, V, 3]
        (z, y, x) -> [B, V, feat_channels[-1]] (0 for empty pillars)."""
        T = voxels.shape[-2]
        cnt = num_points.clamp(min=1)[..., None, None].float()
        pmask = (torch.arange(T, device=voxels.device)
                 < num_points[..., None])
        mean = voxels[..., :3].sum(-2, keepdim=True) / cnt
        f_cluster = voxels[..., :3] - mean
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        x0, y0 = self.point_cloud_range[0], self.point_cloud_range[1]
        cx = coords[..., 2:3].float() * vx + vx / 2 + x0
        cy = coords[..., 1:2].float() * vy + vy / 2 + y0
        f_center = torch.stack([voxels[..., 0] - cx, voxels[..., 1] - cy],
                               -1)
        x = torch.cat([voxels, f_cluster, f_center], -1) * pmask[..., None]
        for i, layer in enumerate(self.pfn_layers):
            x, pooled = layer(x, pmask)
            pooled = torch.where(num_points[..., None] > 0, pooled, 0.0)
            if i < len(self.pfn_layers) - 1:
                x = torch.cat([x, pooled[..., None, :].expand_as(x)],
                              -1) * pmask[..., None]
        return pooled
