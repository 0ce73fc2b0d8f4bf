"""Point-wise LiDAR-camera fusion (port of
``gga_tpu/models/fusion_layers/point_fusion.py``; mmdet3d's PointFusion):
project points into the image, sample multi-scale image features
bilinearly (grid_sample's align_corners=True, zero padding), a lateral
3x3 ConvModule a level first, then per-point Linear + BN transforms of the
image and point streams, summed and ReLU'd.

State_dict keys are mmdet3d's: ``lateral_convs.{i}.conv`` / ``.bn``,
``img_transform.{0,1}`` and ``pts_transform.{0,1}`` (Linear, then the
norm over the valid points). gga_tpu's ``activate_out`` and ``fuse_out``
are left at their defaults (the ReLU, no fuse conv), as its MVXNet
builds them.

Feature maps are NCHW; the sample gathers each tap's rows of the map laid
out [B, H*W, C], the whole batch in one gather a tap.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.geometry import project_to_image
from ..layers import ConvModule2d, MaskedBatchNorm


def bilinear_sample(feat, uv, valid):
    """Sample NCHW features at float pixel coords (align_corners=True).

    The coords are clipped to the map first; points outside [0, W-1] x
    [0, H-1], or not ``valid``, sample zeros (padding_mode='zeros').

    Args:
        feat: [B, C, H, W].
        uv: [B, P, 2] (x, y) in pixel units of this feature map.
        valid: [B, P] bool.
    Returns:
        [B, P, C].
    """
    B, C, H, W = feat.shape
    x, y = uv[..., 0], uv[..., 1]
    inb = valid & (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    x = x.clamp(0.0, W - 1)
    y = y.clamp(0.0, H - 1)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    rows = feat.flatten(2).transpose(1, 2)                  # [B, H*W, C]

    def tap(yy, xx):
        idx = (yy * W + xx)[..., None].expand(-1, -1, C)
        return rows.gather(1, idx)

    out = (tap(y0, x0) * (1 - wx) * (1 - wy) + tap(y0, x1) * wx * (1 - wy)
           + tap(y1, x0) * (1 - wx) * wy + tap(y1, x1) * wx * wy)
    return torch.where(inb[..., None], out, 0.0)


def point_sample(img_feat, pts_xyz, lidar2img, img_shape, pts_valid):
    """Per-point image features (mmdet3d point_fusion.py:14 point_sample,
    as gga_tpu samples: the pixel coords scaled by the feature map over
    the image, no augmentation undone).

    Args:
        img_feat: [B, C, Hf, Wf] one feature level.
        pts_xyz: [B, P, 3] LiDAR points.
        lidar2img: [B, 4, 4].
        img_shape: (H, W) of the image the projection maps to.
        pts_valid: [B, P] bool.
    Returns:
        [B, P, C]; zero for points behind the camera (depth <= 1e-3) or
        outside the image.
    """
    uv, depth = project_to_image(pts_xyz, lidar2img)
    ok = pts_valid & (depth > 1e-3)
    H, W = img_shape
    Hf, Wf = img_feat.shape[-2:]
    scale = torch.tensor([Wf / W, Hf / H], dtype=torch.float32,
                         device=uv.device)
    return bilinear_sample(img_feat, uv * scale, ok)


class PointFusion(nn.Module):
    """Fuse multi-scale image features into point features (mmdet3d
    point_fusion.py:95)."""

    def __init__(self, img_channels: Sequence[int] = (256,) * 5,
                 pts_channels=64, mid_channels=128, out_channels=128,
                 img_levels: Tuple[int, ...] = (0, 1, 2, 3, 4)):
        super().__init__()
        self.img_levels = tuple(img_levels)
        self.lateral_convs = nn.ModuleList(
            ConvModule2d(img_channels[lvl], mid_channels, 3)
            for lvl in self.img_levels)
        self.img_transform = nn.Sequential(
            nn.Linear(mid_channels * len(self.img_levels), out_channels),
            MaskedBatchNorm(out_channels))
        self.pts_transform = nn.Sequential(
            nn.Linear(pts_channels, out_channels),
            MaskedBatchNorm(out_channels))

    @staticmethod
    def _transform(seq, x, valid):
        return seq[1](seq[0](x), valid)

    def forward(self, img_feats, pts_xyz, pts_feats, pts_valid, lidar2img,
                img_shape):
        """img_feats: NCHW levels; pts_xyz [B, P, 3]; pts_feats [B, P, Cp];
        pts_valid [B, P]; lidar2img [B, 4, 4]; img_shape (H, W).

        Returns fused [B, P, out_channels], 0 at invalid points."""
        img_pts = torch.cat([
            point_sample(lat(img_feats[lvl]), pts_xyz, lidar2img,
                         tuple(img_shape), pts_valid)
            for lat, lvl in zip(self.lateral_convs, self.img_levels)], -1)
        fused = F.relu(
            self._transform(self.img_transform, img_pts, pts_valid)
            + self._transform(self.pts_transform, pts_feats, pts_valid))
        return torch.where(pts_valid[..., None], fused, 0.0)
