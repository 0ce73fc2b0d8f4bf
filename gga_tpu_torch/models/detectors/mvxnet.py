"""MVXNet: point-level LiDAR-camera fusion (port of
``gga_tpu/models/detectors/mvxnet.py``; mmdet3d's DynamicMVXFasterRCNN of
``configs/mvxnet/dv_mvx-fpn_second_secfpn_adamw_2x8_40e_kitti-3d-3class
.py``): image ResNet + FPN; the voxel list of the hard voxelizer at one
point a voxel and each point's slot in it; a DynamicVFE whose last
layer's point features take the image features of PointFusion before the
last scatter-max; SECOND's conv_module SparseEncoder (128 channels in,
on the hand-written sparse-conv kernels), SECOND, SECONDFPN and the
3-class Anchor3DHead.

The VFE output carries weights upstream, so the encoder's ``conv_input``
takes an input gradient too: a step launches 12 + 8 ``gather_gemm_conv``
(forward, SubM input gradients), 12 ``gather_gemm_dw`` and 4
``gather_rows`` (the strided convs' input gradients).

State_dict keys are mmdet3d's: ``img_backbone``, ``img_neck``,
``pts_voxel_encoder`` (with ``fusion_layer``), ``pts_middle_encoder``,
``pts_backbone``, ``pts_neck``, ``pts_bbox_head``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn

from ...ops.scatter import assign_point_voxel_ids
from ...ops.voxelize import dynamic_voxelize, hard_voxelize
from ..backbones.resnet import ResNet
from ..backbones.second import SECOND
from ..dense_heads.anchor3d_head import Anchor3DConfig, Anchor3DHead
from ..fusion_layers.point_fusion import PointFusion
from ..layers import init_params
from ..middle_encoders import SparseEncoder
from ..necks.fpn import FPN
from ..necks.second_fpn import SECONDFPN
from ..voxel_encoders import DynamicVFE


@dataclasses.dataclass(frozen=True)
class MVXNetConfig:
    """Copy of gga_tpu's config."""
    voxel_size: Tuple[float, float, float] = (0.05, 0.05, 0.1)
    point_cloud_range: Tuple[float, ...] = (0, -40, -3, 70.4, 40, 1)
    max_voxels: int = 16000
    max_points: int = 24000
    sparse_shape: Tuple[int, int, int] = (41, 1600, 1408)
    # image branch
    img_depth: int = 50
    img_base_planes: int = 64
    img_fpn_channels: int = 256
    img_levels: Tuple[int, ...] = (0, 1, 2, 3)
    # dynamic VFE (dv_mvx config: feat_channels=[64, 64])
    vfe_channels: Tuple[int, ...] = (64, 64)
    fusion_mid_channels: int = 128
    fusion_out_channels: int = 128
    # sparse encoder + 2D stack (SECOND-class)
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
    head: Anchor3DConfig = dataclasses.field(
        default_factory=lambda: Anchor3DConfig(
            anchor_ranges=((0, -40, -0.6, 70.4, 40, -0.6),
                           (0, -40, -0.6, 70.4, 40, -0.6),
                           (0, -40, -1.78, 70.4, 40, -1.78))))

    @classmethod
    def tiny(cls):
        head = Anchor3DConfig(
            feat_channels=32, nms_pre=32, max_num=16,
            anchor_ranges=((0, -40, -0.6, 71.68, 40, -0.6),
                           (0, -40, -0.6, 71.68, 40, -0.6),
                           (0, -40, -1.78, 71.68, 40, -1.78)))
        return cls(voxel_size=(0.32, 0.3125, 0.1), max_voxels=1024,
                   max_points=2048,
                   point_cloud_range=(0, -40, -3, 71.68, 40, 1),
                   sparse_shape=(41, 256, 224),
                   img_depth=18, img_base_planes=8, img_fpn_channels=16,
                   img_levels=(0, 1, 2),
                   vfe_channels=(16, 16), fusion_mid_channels=16,
                   fusion_out_channels=16,
                   encoder_channels=((8,), (8, 8), (8, 8), (8, 8)),
                   encoder_paddings=((1,), (1, 1), (1, 1), ((0, 1, 1), 1)),
                   encoder_budgets=(1024, 1024, 1024),
                   encoder_out_budget=1024,
                   backbone_channels=(16, 32), backbone_layers=(1, 1),
                   backbone_strides=(1, 2), neck_channels=(16, 16),
                   neck_strides=(1, 2), head=head)


def mvxnet_voxels(cfg: MVXNetConfig, points, points_valid):
    """(coords [B, V, 3] (z, y, x), per-point slots [B, P] (V where none),
    in-range points [B, P], valid voxels [B, V]) of ``cfg``'s grid."""
    vs, rng = tuple(cfg.voxel_size), tuple(cfg.point_cloud_range)
    vox = hard_voxelize(points, points_valid, voxel_size=vs, pc_range=rng,
                        max_points=1, max_voxels=cfg.max_voxels)
    pc, ok = dynamic_voxelize(points, points_valid, voxel_size=vs,
                              pc_range=rng)
    ids = assign_point_voxel_ids(pc, vox['coords'], ok,
                                 vox['coords'][..., 0] >= 0,
                                 tuple(cfg.sparse_shape))
    vvalid = (torch.arange(cfg.max_voxels, device=points.device)[None]
              < vox['num_voxels'][:, None])
    return vox['coords'], ids, ok, vvalid


class MVXNet(nn.Module):
    def __init__(self, cfg: MVXNetConfig):
        super().__init__()
        self.cfg = cfg
        levels = len(cfg.img_levels)
        self.img_backbone = ResNet(depth=cfg.img_depth,
                                   base_planes=cfg.img_base_planes)
        self.img_neck = FPN(self.img_backbone.out_channels,
                            cfg.img_fpn_channels, num_outs=levels)
        fusion = PointFusion(
            img_channels=(cfg.img_fpn_channels,) * levels,
            pts_channels=cfg.vfe_channels[-1],
            mid_channels=cfg.fusion_mid_channels,
            out_channels=cfg.fusion_out_channels,
            img_levels=tuple(range(levels)))
        self.pts_voxel_encoder = DynamicVFE(
            feat_channels=cfg.vfe_channels, voxel_size=cfg.voxel_size,
            point_cloud_range=cfg.point_cloud_range,
            max_voxels=cfg.max_voxels, fusion_layer=fusion)
        self.pts_middle_encoder = SparseEncoder(
            in_channels=cfg.fusion_out_channels,
            sparse_shape=cfg.sparse_shape, base_channels=16,
            output_channels=128, encoder_channels=cfg.encoder_channels,
            encoder_paddings=cfg.encoder_paddings,
            stage_budgets=cfg.encoder_budgets,
            out_budget=cfg.encoder_out_budget, block_type='conv_module')
        self.pts_backbone = SECOND(self.pts_middle_encoder.bev_channels,
                                   cfg.backbone_channels,
                                   cfg.backbone_layers, cfg.backbone_strides)
        self.pts_neck = SECONDFPN(cfg.backbone_channels, cfg.neck_channels,
                                  cfg.neck_strides)
        self.pts_bbox_head = Anchor3DHead(cfg.head, sum(cfg.neck_channels))

    def init_weights(self, generator):
        """Seeded weights: He-uniform convs and linears (as the anchor
        detectors'), linear biases zero (flax's), the cls logits' prior
        bias."""
        init_params(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    bound = (6.0 / m.in_features) ** 0.5
                    m.weight.uniform_(-bound, bound, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
        self.pts_bbox_head.init_biases()

    def extract_bev(self, points, points_valid, img, lidar2img, diag=None):
        """points [B, P, 4] f32; points_valid [B, P]; img [B, 3, H, W]
        (normalized); lidar2img [B, 4, 4] -> BEV NCHW [B, 128 * nz, ny,
        nx]. A dict ``diag`` receives the encoder's ``occupancy_out``."""
        img_feats = self.img_neck(self.img_backbone(img))
        coords, ids, pok, vvalid = mvxnet_voxels(self.cfg, points,
                                                 points_valid)
        fusion_layer = self.pts_voxel_encoder.fusion_layer

        def fusion(point_feats, ok):
            return fusion_layer(img_feats, points[..., :3], point_feats, ok,
                                lidar2img, img.shape[-2:])

        vfeat = self.pts_voxel_encoder(points, ids, pok, coords, vvalid,
                                       fusion)
        return self.pts_middle_encoder(vfeat, coords, vvalid, diag)

    def head(self, bev):
        return self.pts_bbox_head(self.pts_neck(self.pts_backbone(bev)))

    def forward(self, points, points_valid, img, lidar2img, diag=None):
        """Returns the head's dict of NHWC f32 maps."""
        return self.head(self.extract_bev(points, points_valid, img,
                                          lidar2img, diag))
