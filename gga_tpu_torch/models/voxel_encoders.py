"""Voxel feature encoders (port of ``gga_tpu/models/voxel_encoders.py``):
``HardSimpleVFE`` and ``PillarFeatureNet`` on the padded
[..., V, max_points, C] voxel buffers of ``ops.voxelize``, and MVXNet's
``DynamicVFE`` on every point with its voxel's slot."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.scatter import dynamic_scatter_max, dynamic_scatter_mean
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


def _per_point(voxel_rows, ids, V):
    """Each point's row of its scene's voxel array [B, V, C] (slot clipped
    to V - 1, as gga_tpu gathers) -> [B, P, C]."""
    idx = ids.long().clamp(0, V - 1)[..., None]
    return voxel_rows.gather(1, idx.expand(-1, -1, voxel_rows.shape[-1]))


class DynamicVFE(nn.Module):
    """Dynamic voxel feature encoder (mmdet3d voxel_encoder.py:88
    DynamicVFE, as gga_tpu computes it with its defaults): each point
    decorated with its offset to its voxel's points mean
    (``dynamic_scatter_mean``, summed in point order) and to its voxel's
    centre, then Linear (no bias) + masked BN + ReLU layers, each voxel's
    max (``dynamic_scatter_max``) gathered back and concatenated between
    two layers. A ``fusion`` callable runs on the last layer's point
    features before the last scatter (mmdet3d's ``fusion_layer`` hook;
    the module it calls is the ``fusion_layer`` child, so its keys are
    mmdet3d's).

    State_dict keys: ``vfe_layers.{i}.0`` (Linear), ``vfe_layers.{i}.1``
    (norm), ``fusion_layer.*``."""

    def __init__(self, in_channels=4, feat_channels: Tuple[int, ...] = (64,
                                                                       64),
                 voxel_size: Tuple[float, float, float] = (0.05, 0.05, 0.1),
                 point_cloud_range: Sequence[float] = (0, -40, -3, 70.4, 40,
                                                       1),
                 max_voxels=16000, fusion_layer=None):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.max_voxels = max_voxels
        ch = in_channels + 6
        layers = []
        for i, out_ch in enumerate(feat_channels):
            layers.append(nn.Sequential(
                nn.Linear(ch if i == 0 else 2 * ch, out_ch, bias=False),
                MaskedBatchNorm(out_ch)))
            ch = out_ch
        self.vfe_layers = nn.ModuleList(layers)
        self.fusion_layer = fusion_layer

    def forward(self, points, ids, pok, coords, vvalid, fusion=None):
        """points [B, P, C]; ids [B, P] point -> voxel slot (V where none);
        pok [B, P] the points in range; coords [B, V, 3] (z, y, x); vvalid
        [B, V]. ``fusion(point_feats, pok) -> point_feats`` or None.

        Returns voxel features [B, V, feat_channels[-1]] (or the fusion's
        width), 0 at padding voxels."""
        V = self.max_voxels
        pts_xyz = points[..., :3]
        vmean, _ = dynamic_scatter_mean(points, ids, pok, V)
        vsz = torch.tensor(self.voxel_size, dtype=torch.float32,
                           device=points.device)
        off = torch.tensor(self.point_cloud_range[:3], dtype=torch.float32,
                           device=points.device)
        centers = (_per_point(coords, ids, V).flip(-1).float() + 0.5) * vsz \
            + off
        feats = torch.where(pok[..., None], torch.cat(
            [points, pts_xyz - _per_point(vmean, ids, V)[..., :3],
             pts_xyz - centers], -1), 0.0)
        vfeat = None
        for i, layer in enumerate(self.vfe_layers):
            feats = F.relu(layer[1](layer[0](feats), pok))
            last = i == len(self.vfe_layers) - 1
            if last and fusion is not None:
                feats = fusion(feats, pok)
            vfeat, _ = dynamic_scatter_max(feats, ids, pok, V)
            if not last:
                feats = torch.where(pok[..., None], torch.cat(
                    [feats, _per_point(vfeat, ids, V)], -1), 0.0)
        return torch.where(vvalid[..., None], vfeat, 0.0)
