"""The fully supervised CenterPoint detector of the nuScenes family (port
of ``gga_tpu/models/detectors/centerpoint.py``):

- voxel configs: hard voxelization -> HardSimpleVFE -> SparseEncoder
  (conv_module) -> SECOND -> SECONDFPN -> CenterHead;
- pillar configs (``pillar=True``): hard voxelization ->
  PillarFeatureNet -> PointPillarsScatter -> SECOND -> SECONDFPN ->
  CenterHead;

with ``centerpoint_loss`` (targets + the supervised loss) and
``decode_centerpoint`` (per task top-k decode, then rotated-BEV or
circle NMS, merged over tasks).

As in gga_tpu, ``HardSimpleVFE`` keeps the first 4 point channels: the
sweeps' time lag (channel 5) never reaches the sparse encoder, and
``in_channels`` is not read by the voxel path. The pillar path's
PillarFeatureNet reads all 5.

In train mode (``model.train()``) every batch norm uses the batch's
statistics and updates its running ones, as gga_tpu's ``train=True``.
Submodules carry mmdet3d's CenterPoint names (``pts_voxel_encoder``,
``pts_middle_encoder``, ``pts_backbone``, ``pts_neck``,
``pts_bbox_head``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn

from ...core.nms import circle_nms
from ...ops.voxelize import hard_voxelize
from ..backbones.second import SECOND
from ..dense_heads import centerpoint_head as cp
from ..layers import init_params
from ..middle_encoders import PointPillarsScatter, SparseEncoder
from ..necks.second_fpn import SECONDFPN
from ..voxel_encoders import HardSimpleVFE, PillarFeatureNet


@dataclasses.dataclass(frozen=True)
class CenterPointConfig:
    """configs/_base_/models/centerpoint_01voxel_second_secfpn_nus.py
    (copy of gga_tpu's CenterPointConfig, but for the repaired default of
    ``encoder_paddings``)."""
    voxel_size: Tuple[float, float, float] = (0.1, 0.1, 0.2)
    point_cloud_range: Tuple[float, ...] = (-51.2, -51.2, -5.0,
                                            51.2, 51.2, 3.0)
    in_channels: int = 5              # nus: xyzi + sweep dt
    max_points_per_voxel: int = 10
    max_voxels: int = 90000
    sparse_shape: Tuple[int, int, int] = (41, 1024, 1024)
    encoder_channels: Sequence = ((16,), (32, 32, 32), (64, 64, 64),
                                  (128, 128))
    # stage 3's strided conv pads (z, y, x) = (0, 1, 1), mmdet3d's order
    # (its CenterPoint's [0, 1, 1], SECOND's (0, 1, 1)): a 128 x 128 BEV
    # of 2 x 128 channels. gga_tpu's default (1, 1, 0) pads z and not x,
    # which gives 128 x 127 and fails SECONDFPN's concat against the
    # upsampled 128 x 128 level (ROADMAP.md §3)
    encoder_paddings: Sequence = ((1,), (1, 1, 1), (1, 1, 1),
                                  ((0, 1, 1), 1))
    encoder_budgets: Tuple[int, ...] = (90000, 60000, 40000)
    encoder_out_budget: int = 40000
    encoder_out_channels: int = 128
    backbone_channels: Tuple[int, ...] = (128, 256)
    backbone_layers: Tuple[int, ...] = (5, 5)
    backbone_strides: Tuple[int, ...] = (1, 2)
    neck_channels: Tuple[int, ...] = (256, 256)
    neck_strides: Tuple[int, ...] = (1, 2)
    # nuScenes task grouping: car | truck, construction_vehicle | bus,
    # trailer | barrier | motorcycle, bicycle | pedestrian, traffic_cone
    tasks: Tuple[int, ...] = (1, 2, 2, 1, 2, 2)
    share_conv_channel: int = 64
    # DCNSeparateHead per task (the *_dcn_* configs)
    dcn_head: bool = False
    with_velocity: bool = True
    out_size_factor: int = 8
    gaussian_overlap: float = 0.1
    min_radius: int = 2
    code_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
                                       1.0, 1.0, 0.2, 0.2)
    loss_bbox_weight: float = 0.25
    # test cfg
    max_per_task: int = 100
    score_threshold: float = 0.1
    nms_thr: float = 0.2
    post_max_size: int = 500
    # 'rotated' (nms_bev) or 'circle' (the *_circlenms_* configs: centre
    # distance NMS with a per-task radius)
    nms_type: str = 'rotated'
    nms_min_radius: Tuple[float, ...] = (4, 12, 10, 1, 0.85, 0.175)
    # pillar variant (02pillar configs): PillarFeatureNet +
    # PointPillarsScatter replace VFE + SparseEncoder
    pillar: bool = False
    pfn_channels: Tuple[int, ...] = (64,)
    scatter_shape: Tuple[int, int] = (512, 512)

    @classmethod
    def tiny(cls):
        return cls(voxel_size=(0.8, 0.8, 0.2),
                   point_cloud_range=(-25.6, -25.6, -5.0,
                                      25.6, 25.6, 3.0),
                   max_voxels=2048, sparse_shape=(41, 64, 64),
                   encoder_channels=((8,), (8, 8), (8, 8), (8,)),
                   encoder_paddings=((1,), (1, 1), (1, 1), (1,)),
                   encoder_budgets=(2048, 2048, 2048),
                   encoder_out_budget=2048, encoder_out_channels=16,
                   backbone_channels=(16, 32), backbone_layers=(1, 1),
                   neck_channels=(16, 16), tasks=(1, 1),
                   share_conv_channel=16, max_per_task=16,
                   post_max_size=32)


def common_heads(cfg: CenterPointConfig):
    """The box outputs of every task: gga_tpu's four, plus ``vel``."""
    heads = dict(cp.COMMON_HEADS)
    if cfg.with_velocity:
        heads['vel'] = (2, 2)
    return heads


class CenterPointDetector(nn.Module):
    def __init__(self, cfg: CenterPointConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        if c.pillar:
            self.pts_voxel_encoder = PillarFeatureNet(
                feat_channels=c.pfn_channels, voxel_size=c.voxel_size,
                point_cloud_range=c.point_cloud_range,
                in_channels=c.in_channels)
            self.pts_middle_encoder = PointPillarsScatter(c.scatter_shape)
            bev_channels = c.pfn_channels[-1]
        else:
            self.pts_voxel_encoder = HardSimpleVFE()
            self.pts_middle_encoder = SparseEncoder(
                in_channels=self.pts_voxel_encoder.num_features,
                sparse_shape=c.sparse_shape,
                base_channels=c.encoder_channels[0][0],
                output_channels=c.encoder_out_channels,
                encoder_channels=c.encoder_channels,
                encoder_paddings=c.encoder_paddings,
                stage_budgets=c.encoder_budgets,
                out_budget=c.encoder_out_budget, block_type='conv_module')
            bev_channels = self.pts_middle_encoder.bev_channels
        self.pts_backbone = SECOND(bev_channels, c.backbone_channels,
                                   c.backbone_layers, c.backbone_strides)
        self.pts_neck = SECONDFPN(c.backbone_channels, c.neck_channels,
                                  c.neck_strides)
        self.pts_bbox_head = cp.CenterHead(
            sum(c.neck_channels), c.tasks, c.share_conv_channel,
            common_heads=common_heads(c), dcn_head=c.dcn_head)

    def init_weights(self, generator):
        """Seeded weights: He-uniform convs, linears and deformable
        kernels (``layers.init_params``), zero offset convs (a DCN starts
        as a plain conv, as mmcv's and gga_tpu's), the heatmap logits'
        prior bias."""
        init_params(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    bound = (6.0 / m.in_features) ** 0.5
                    m.weight.uniform_(-bound, bound, generator=generator)
                elif isinstance(m, cp.DeformConv2d):
                    bound = (6.0 / m.weight[0].numel()) ** 0.5
                    m.weight.uniform_(-bound, bound, generator=generator)
                    m.conv_offset.weight.zero_()
            for head in self.pts_bbox_head.task_heads:
                head.heatmap[-1].bias.fill_(head.init_bias)

    def extract_bev(self, points, points_valid, diag=None):
        """points [B, P, C] f32 (C = 5 on nuScenes); points_valid [B, P]
        -> BEV NCHW. A dict ``diag`` receives the sparse encoder's
        ``occupancy_out`` (voxel configs)."""
        c = self.cfg
        vox = hard_voxelize(points, points_valid,
                            voxel_size=tuple(c.voxel_size),
                            pc_range=tuple(c.point_cloud_range),
                            max_points=c.max_points_per_voxel,
                            max_voxels=c.max_voxels)
        vvalid = (torch.arange(c.max_voxels, device=points.device)[None]
                  < vox['num_voxels'][:, None])
        if c.pillar:
            feats = self.pts_voxel_encoder(vox['voxels'], vox['num_points'],
                                           vox['coords'])
            feats = torch.where(vvalid[..., None], feats, 0.0)
            return self.pts_middle_encoder(feats, vox['coords'], vvalid)
        feats = self.pts_voxel_encoder(vox['voxels'], vox['num_points'])
        return self.pts_middle_encoder(feats, vox['coords'], vvalid, diag)

    def head(self, bev):
        """BEV NCHW -> list over tasks of dicts of NHWC f32 maps."""
        return self.pts_bbox_head(self.pts_neck(self.pts_backbone(bev)))

    def forward(self, points, points_valid, diag=None):
        return self.head(self.extract_bev(points, points_valid, diag))


def centerpoint_loss(cfg: CenterPointConfig, preds, gt_boxes, gt_labels,
                     gt_valid):
    """Targets at the head's map size and the supervised loss of a batch:
    gt_boxes [B, M, 7 or 9] bottom-centre lidar (+ velocity), gt_labels
    [B, M], gt_valid [B, M]. Returns (total, logs)."""
    H, W = preds[0]['heatmap'].shape[1:3]
    targets = cp.centerpoint_targets(
        gt_boxes, gt_labels, gt_valid, task_classes=tuple(cfg.tasks),
        feat_hw=(H, W), voxel_size=tuple(cfg.voxel_size),
        pc_range=tuple(cfg.point_cloud_range),
        out_size_factor=cfg.out_size_factor,
        gaussian_overlap=cfg.gaussian_overlap, min_radius=cfg.min_radius,
        with_velocity=cfg.with_velocity)
    ncode = 10 if cfg.with_velocity else 8
    return cp.centerpoint_loss(preds, targets,
                               code_weights=cfg.code_weights[:ncode],
                               loss_bbox_weight=cfg.loss_bbox_weight)


def decode_centerpoint(cfg: CenterPointConfig, preds):
    """Head outputs -> merged per-scene detections (static shapes): per
    task the top ``max_per_task`` of the heatmap logits decoded, then
    rotated-BEV NMS (``nms_type='rotated'``) or circle NMS with the task's
    radius (``'circle'``), both ranking by logit; boxes bottom-centre
    [B, tasks * k, 7 (+2 velocity)]."""
    dets = []
    k = min(cfg.post_max_size, cfg.max_per_task)
    for ti, tp in enumerate(preds):
        d = cp.decode_task(
            tp, voxel_size=cfg.voxel_size[:2],
            pc_range=cfg.point_cloud_range,
            out_size_factor=cfg.out_size_factor, max_num=cfg.max_per_task,
            score_threshold=cfg.score_threshold,
            post_center_range=cfg.point_cloud_range)
        if cfg.nms_type != 'circle':
            dets.append(cp.get_task_detections(d, nms_thr=cfg.nms_thr,
                                               post_max_size=k))
            continue
        radius = cfg.nms_min_radius[min(ti, len(cfg.nms_min_radius) - 1)]
        idx, _ = circle_nms(d['boxes'][..., :2], d['logits'], radius,
                            post_max_size=k, valid=d['valid'])
        kept = idx >= 0
        safe = idx.clamp(min=0)

        def take(x):
            if x.dim() == 3:
                return x.gather(1, safe[..., None].expand(-1, -1,
                                                          x.shape[-1]))
            return x.gather(1, safe)

        dets.append(dict(
            boxes=take(d['boxes']),
            scores=torch.where(kept, take(d['scores']), 0.0),
            labels=take(d['labels']), valid=kept,
            logits=torch.where(kept, take(d['logits']), -torch.inf)))
    return cp.merge_task_detections(dets, cfg.tasks)
