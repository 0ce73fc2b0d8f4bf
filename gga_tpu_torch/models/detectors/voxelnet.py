"""VoxelNet-family detectors (port of
``gga_tpu/models/detectors/voxelnet.py``), the fully supervised KITTI
anchor detectors:

- SECOND (``SECONDDetector``): hard voxelization -> HardSimpleVFE ->
  SparseEncoder (conv_module variant) -> SECOND -> SECONDFPN ->
  Anchor3DHead;
- PointPillars (``PointPillars``): hard voxelization -> PillarFeatureNet
  -> PointPillarsScatter -> SECOND -> SECONDFPN -> Anchor3DHead.

In train mode (``model.train()``) every batch norm uses the batch's
statistics and updates its running ones, as gga_tpu's ``train=True``.
Submodules carry mmdet3d's VoxelNet names (``voxel_encoder``,
``middle_encoder``, ``backbone``, ``neck``, ``bbox_head``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn

from ...ops.voxelize import hard_voxelize
from ..backbones.second import SECOND
from ..dense_heads.anchor3d_head import Anchor3DConfig, Anchor3DHead
from ..layers import init_params
from ..middle_encoders import PointPillarsScatter, SparseEncoder
from ..necks.second_fpn import SECONDFPN
from ..voxel_encoders import HardSimpleVFE, PillarFeatureNet


@dataclasses.dataclass(frozen=True)
class PointPillarsConfig:
    """hv_pointpillars_secfpn_kitti (copy of gga_tpu's config)."""
    voxel_size: Tuple[float, float, float] = (0.16, 0.16, 4.0)
    point_cloud_range: Tuple[float, ...] = (0, -39.68, -3, 69.12, 39.68, 1)
    max_points_per_voxel: int = 32
    max_voxels: int = 16000
    pfn_channels: Tuple[int, ...] = (64,)
    scatter_shape: Tuple[int, int] = (496, 432)     # (ny, nx)
    backbone_channels: Tuple[int, ...] = (64, 128, 256)
    backbone_layers: Tuple[int, ...] = (3, 5, 5)
    backbone_strides: Tuple[int, ...] = (2, 2, 2)
    neck_channels: Tuple[int, ...] = (128, 128, 128)
    neck_strides: Tuple[int, ...] = (1, 2, 4)
    # gga_tpu's 'regnetx_*' backbones and its 'fpn' neck wait for their
    # slice; the port refuses them (PointPillars)
    backbone: str = 'second'
    neck: str = 'secfpn'
    # gga_tpu's 'bfloat16' (its fp16 configs are nuScenes ones with an
    # FPN neck) waits: PointPillars refuses it
    compute_dtype: str = 'float32'
    head: Anchor3DConfig = dataclasses.field(default_factory=Anchor3DConfig)

    @classmethod
    def tiny(cls):
        # scatter dims divisible by 8 so SECONDFPN's x4 deconv lines up
        rng = (0, -40.96, -3, 71.68, 40.96, 1)
        head = Anchor3DConfig(
            feat_channels=48, nms_pre=32, max_num=16,
            anchor_ranges=((0, -40.96, -0.6, 71.68, 40.96, -0.6),
                           (0, -40.96, -0.6, 71.68, 40.96, -0.6),
                           (0, -40.96, -1.78, 71.68, 40.96, -1.78)))
        return cls(voxel_size=(0.64, 0.64, 4.0), max_voxels=2048,
                   point_cloud_range=rng,
                   scatter_shape=(128, 112), pfn_channels=(16,),
                   backbone_channels=(16, 32, 32),
                   backbone_layers=(1, 1, 1),
                   neck_channels=(16, 16, 16), head=head)


@dataclasses.dataclass(frozen=True)
class SECONDNetConfig:
    """hv_second_secfpn_kitti: voxel (0.05, 0.05, 0.1), SparseEncoder
    (copy of gga_tpu's config)."""
    voxel_size: Tuple[float, float, float] = (0.05, 0.05, 0.1)
    point_cloud_range: Tuple[float, ...] = (0, -40, -3, 70.4, 40, 1)
    max_points_per_voxel: int = 5
    max_voxels: int = 16000
    sparse_shape: Tuple[int, int, int] = (41, 1600, 1408)
    encoder_channels: Sequence = ((16,), (32, 32, 32), (64, 64, 64),
                                  (64, 64, 64))
    encoder_paddings: Sequence = ((1,), (1, 1, 1), (1, 1, 1),
                                  ((0, 1, 1), 1, 1))
    encoder_budgets: Tuple[int, ...] = (16000, 14000, 12000)
    encoder_out_budget: int = 12000
    backbone_channels: Tuple[int, ...] = (128, 256)
    backbone_layers: Tuple[int, ...] = (5, 5)
    backbone_strides: Tuple[int, ...] = (1, 2)
    neck_channels: Tuple[int, ...] = (256, 256)
    neck_strides: Tuple[int, ...] = (1, 2)
    # gga_tpu's 'bfloat16' (hv_second_secfpn_fp16_*) waits: SECOND
    # refuses it
    compute_dtype: str = 'float32'
    head: Anchor3DConfig = dataclasses.field(
        default_factory=lambda: Anchor3DConfig(
            anchor_ranges=((0, -40, -0.6, 70.4, 40, -0.6),
                           (0, -40, -0.6, 70.4, 40, -0.6),
                           (0, -40, -1.78, 70.4, 40, -1.78))))


def _voxelize(cfg, points, points_valid):
    vox = hard_voxelize(points, points_valid,
                        voxel_size=tuple(cfg.voxel_size),
                        pc_range=tuple(cfg.point_cloud_range),
                        max_points=cfg.max_points_per_voxel,
                        max_voxels=cfg.max_voxels)
    vvalid = (torch.arange(cfg.max_voxels, device=points.device)[None]
              < vox['num_voxels'][:, None])
    return vox, vvalid


class _AnchorDetector(nn.Module):
    """The dense half shared by both detectors: SECOND -> SECONDFPN ->
    Anchor3DHead on an NCHW BEV map."""

    def _dense(self, cfg, bev_channels):
        self.backbone = SECOND(bev_channels, cfg.backbone_channels,
                               cfg.backbone_layers, cfg.backbone_strides)
        self.neck = SECONDFPN(cfg.backbone_channels, cfg.neck_channels,
                              cfg.neck_strides)
        self.bbox_head = Anchor3DHead(cfg.head, sum(cfg.neck_channels))

    def init_weights(self, generator):
        """Seeded weights: He-uniform convs and linears (as the GGA
        detector's, ``layers.init_params``), the cls logits' prior bias."""
        init_params(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    bound = (6.0 / m.in_features) ** 0.5
                    m.weight.uniform_(-bound, bound, generator=generator)
        self.bbox_head.init_biases()

    def head(self, bev):
        return self.bbox_head(self.neck(self.backbone(bev)))


def second_encoder_args(cfg: SECONDNetConfig):
    """SparseEncoder arguments of SECOND's conv_module encoder: gga_tpu
    builds it with base 16 and 128 output channels."""
    return dict(in_channels=4, sparse_shape=cfg.sparse_shape,
                base_channels=16, output_channels=128,
                encoder_channels=cfg.encoder_channels,
                encoder_paddings=cfg.encoder_paddings,
                stage_budgets=cfg.encoder_budgets,
                out_budget=cfg.encoder_out_budget, block_type='conv_module')


class SECONDDetector(_AnchorDetector):
    def __init__(self, cfg: SECONDNetConfig):
        super().__init__()
        if cfg.compute_dtype != 'float32':
            raise NotImplementedError(
                f'compute_dtype {cfg.compute_dtype!r}: the _fp16_ SECOND '
                'configs wait for their slice (ROADMAP.md §1, "The _fp16_ '
                'SECOND configs (bf16)"): at full width their whole bf16 '
                "step with the kernels meets the plain step's one-ulp noise "
                'but not the fixed cosine floor of the bf16 gates')
        self.cfg = cfg
        self.voxel_encoder = HardSimpleVFE()
        self.middle_encoder = self.build_encoder(cfg)
        self._dense(cfg, self.middle_encoder.bev_channels)

    @staticmethod
    def build_encoder(cfg):
        return SparseEncoder(**second_encoder_args(cfg))

    def voxel_features(self, points, points_valid):
        """Voxel means of the points a voxel keeps (f32 [B, V, 4]), the
        voxels' (z, y, x) coords and valid mask."""
        vox, vvalid = _voxelize(self.cfg, points, points_valid)
        return (self.voxel_encoder(vox['voxels'], vox['num_points']),
                vox['coords'], vvalid)

    def extract_bev(self, points, points_valid, diag=None):
        """points [B, P, 4] f32; points_valid [B, P] -> BEV NCHW
        [B, 128 * nz, ny, nx]. A dict ``diag`` receives the encoder's
        ``occupancy_out``."""
        feats, coords, vvalid = self.voxel_features(points, points_valid)
        return self.middle_encoder(feats, coords, vvalid, diag)

    def forward(self, points, points_valid, diag=None):
        """Returns the head's dict of NHWC f32 maps."""
        return self.head(self.extract_bev(points, points_valid, diag))


class PointPillars(_AnchorDetector):
    def __init__(self, cfg: PointPillarsConfig):
        super().__init__()
        if cfg.backbone != 'second' or cfg.neck != 'secfpn':
            raise NotImplementedError(
                f'PointPillars backbone {cfg.backbone!r}, neck {cfg.neck!r}:'
                ' the port has the SECOND backbone and SECONDFPN neck only; '
                "gga_tpu's RegNet backbones and FPN neck wait for their "
                'slice (ROADMAP.md §1, "FreeAnchor, SSN and the RegNet '
                'backbones")')
        if cfg.compute_dtype != 'float32':
            raise NotImplementedError(
                f'compute_dtype {cfg.compute_dtype!r}: the _fp16_ '
                'PointPillars configs are nuScenes ones with an FPN neck, '
                'which wait for their slice (ROADMAP.md §1, "FreeAnchor, SSN '
                'and the RegNet backbones")')
        self.cfg = cfg
        self.voxel_encoder = PillarFeatureNet(
            feat_channels=cfg.pfn_channels, voxel_size=cfg.voxel_size,
            point_cloud_range=cfg.point_cloud_range)
        self.middle_encoder = PointPillarsScatter(cfg.scatter_shape)
        self._dense(cfg, cfg.pfn_channels[-1])

    def extract_bev(self, points, points_valid, diag=None):
        """points [B, P, 4] f32; points_valid [B, P] -> canvas NCHW
        [B, C, ny, nx] f32. ``diag`` is not read (no budget but the
        voxels')."""
        vox, vvalid = _voxelize(self.cfg, points, points_valid)
        feats = self.voxel_encoder(vox['voxels'], vox['num_points'],
                                   vox['coords'])
        return self.middle_encoder(feats, vox['coords'], vvalid)

    def forward(self, points, points_valid, diag=None):
        """Returns the head's dict of NHWC f32 maps."""
        return self.head(self.extract_bev(points, points_valid, diag))
