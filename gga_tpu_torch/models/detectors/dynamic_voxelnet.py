"""Dynamic-voxelization detectors (port of
``gga_tpu/models/detectors/dynamic_voxelnet.py``): each voxel's feature
is the mean of ALL its points (mmdet3d's DynamicSimpleVFE), not of the
first ``max_points`` of them.

- ``DynamicVoxelNet`` (dv_pointpillars): pillar means ->
  PointPillarsScatter -> SECOND (4 input channels) -> SECONDFPN ->
  Anchor3DHead. No hand kernel runs.
- ``DVSECONDDetector`` (dv_second): voxel means -> SECOND's conv_module
  SparseEncoder -> SECOND -> SECONDFPN -> Anchor3DHead, as
  ``SECONDDetector`` (f32; bf16 is refused as SECOND's).

The voxel list is the hard voxelizer's at one point a voxel (the same
voxels, sorted, the farthest dropped past ``max_voxels``); each point
finds its voxel's slot by a binary search and the means are summed in
point order (``ops.scatter.dynamic_scatter_mean``), so they have the same
bits on every run.
"""
from __future__ import annotations

import dataclasses

import torch

from ...ops.scatter import assign_point_voxel_ids, dynamic_scatter_mean
from ...ops.voxelize import dynamic_voxelize, hard_voxelize
from ..middle_encoders import PointPillarsScatter
from .voxelnet import (PointPillarsConfig, SECONDDetector, SECONDNetConfig,
                       _AnchorDetector)


def dynamic_voxel_means(cfg, grid_zyx, points, points_valid):
    """(means [B, V, 4] f32, coords [B, V, 3] (z, y, x), valid [B, V]) of
    the voxels of ``cfg``'s size and range, V = ``cfg.max_voxels``."""
    vs, rng = tuple(cfg.voxel_size), tuple(cfg.point_cloud_range)
    vox = hard_voxelize(points, points_valid, voxel_size=vs, pc_range=rng,
                        max_points=1, max_voxels=cfg.max_voxels)
    pc, ok = dynamic_voxelize(points, points_valid, voxel_size=vs,
                              pc_range=rng)
    ids = assign_point_voxel_ids(pc, vox['coords'], ok,
                                 vox['coords'][..., 0] >= 0, grid_zyx)
    means, _ = dynamic_scatter_mean(points, ids, ok, cfg.max_voxels)
    valid = (torch.arange(cfg.max_voxels, device=points.device)[None]
             < vox['num_voxels'][:, None])
    return means, vox['coords'], valid


@dataclasses.dataclass(frozen=True)
class DynamicVoxelNetConfig(PointPillarsConfig):
    """PointPillars' layout (copy of gga_tpu's config); the voxel features
    are dynamic pillar means. gga_tpu's DynamicVoxelNet reads neither
    ``backbone``, ``neck``, ``pfn_channels`` nor ``compute_dtype``: it
    always runs SECOND and SECONDFPN in f32, and so does the port."""

    @classmethod
    def tiny(cls):
        base = PointPillarsConfig.tiny()
        return cls(**{f.name: getattr(base, f.name)
                      for f in dataclasses.fields(base)})


class DynamicVoxelNet(_AnchorDetector):
    def __init__(self, cfg: DynamicVoxelNetConfig):
        super().__init__()
        self.cfg = cfg
        self.middle_encoder = PointPillarsScatter(cfg.scatter_shape)
        self._dense(cfg, 4)

    def extract_bev(self, points, points_valid, diag=None):
        """points [B, P, 4] f32; points_valid [B, P] -> canvas NCHW
        [B, 4, ny, nx] f32. ``diag`` is not read."""
        ny, nx = self.cfg.scatter_shape
        feats, coords, valid = dynamic_voxel_means(
            self.cfg, (1, ny, nx), points, points_valid)
        return self.middle_encoder(feats, coords, valid)

    def forward(self, points, points_valid, diag=None):
        """Returns the head's dict of NHWC f32 maps."""
        return self.head(self.extract_bev(points, points_valid, diag))


@dataclasses.dataclass(frozen=True)
class DVSECONDConfig(SECONDNetConfig):
    """SECOND with dynamic voxelization (dv_second_secfpn configs; copy of
    gga_tpu's config)."""

    @classmethod
    def tiny(cls):
        base = SECONDNetConfig(
            voxel_size=(0.32, 0.3125, 0.1),
            point_cloud_range=(0, -40, -3, 71.68, 40, 1),
            max_voxels=512, sparse_shape=(41, 256, 224),
            encoder_channels=((8,), (8, 8), (8, 8), (8, 8)),
            encoder_paddings=((1,), (1, 1), (1, 1), ((0, 1, 1), 1)),
            encoder_budgets=(512, 512, 512), encoder_out_budget=512,
            backbone_channels=(16, 32), backbone_layers=(1, 1),
            neck_channels=(16, 16))
        return cls(**{f.name: getattr(base, f.name)
                      for f in dataclasses.fields(base)})


class DVSECONDDetector(SECONDDetector):
    """SECOND on dynamic voxel means over the full 3D grid."""

    def __init__(self, cfg: DVSECONDConfig):
        super().__init__(cfg)
        del self.voxel_encoder              # the means are DynamicSimpleVFE's

    def voxel_features(self, points, points_valid):
        return dynamic_voxel_means(self.cfg, tuple(self.cfg.sparse_shape),
                                   points, points_valid)
