"""SSN, the shape-signature pillars detector of ``configs/ssn`` (port of
``gga_tpu/models/detectors/ssn.py``): PointPillars' shell (hard
voxelization -> PillarFeatureNet -> PointPillarsScatter -> SECOND or
NoStemRegNet -> SECONDFPN), f32, with the shape-aware grouping head
(``dense_heads/shape_aware_head.py``) in place of Anchor3DHead. Its
modules carry mmdet3d's names (``voxel_encoder``, ``middle_encoder``,
``backbone``, ``neck``, ``bbox_head``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from ..dense_heads.shape_aware_head import ShapeAwareConfig, ShapeAwareHead
from ..middle_encoders import PointPillarsScatter
from ..voxel_encoders import PillarFeatureNet
from .voxelnet import POINT_FEATURES, _AnchorDetector, pillar_canvas


@dataclasses.dataclass(frozen=True)
class SSNConfig:
    """hv_ssn_secfpn_sbn-all nuScenes (copy of gga_tpu's config)."""
    voxel_size: Tuple[float, float, float] = (0.25, 0.25, 8.0)
    point_cloud_range: Tuple[float, ...] = (-50, -50, -5, 50, 50, 3)
    max_points_per_voxel: int = 20
    max_voxels: int = 32000
    pfn_channels: Tuple[int, ...] = (64,)
    scatter_shape: Tuple[int, int] = (400, 400)     # (ny, nx)
    backbone: str = 'second'
    backbone_channels: Tuple[int, ...] = (64, 128, 256)
    backbone_layers: Tuple[int, ...] = (3, 5, 5)
    backbone_strides: Tuple[int, ...] = (2, 2, 2)
    neck_channels: Tuple[int, ...] = (128, 128, 128)
    neck_strides: Tuple[int, ...] = (1, 2, 4)
    head: ShapeAwareConfig = dataclasses.field(
        default_factory=ShapeAwareConfig)


class SSNDetector(_AnchorDetector):
    def __init__(self, cfg: SSNConfig):
        super().__init__()
        self.cfg = cfg
        self.voxel_encoder = PillarFeatureNet(
            feat_channels=cfg.pfn_channels, voxel_size=cfg.voxel_size,
            point_cloud_range=cfg.point_cloud_range,
            in_channels=POINT_FEATURES)
        self.middle_encoder = PointPillarsScatter(cfg.scatter_shape)
        self._dense(cfg, cfg.pfn_channels[-1], cfg.backbone,
                    head_cls=ShapeAwareHead)

    def forward(self, points, points_valid, diag=None):
        """points [B, P, >= 4] f32; points_valid [B, P] -> the head's list
        of group dicts of NHWC f32 maps. ``diag`` is not read."""
        return self.bbox_head(self.fused(pillar_canvas(self, points,
                                                       points_valid)))
