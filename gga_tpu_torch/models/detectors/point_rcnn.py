"""PointRCNN, the two-stage point-based detector (port of
``gga_tpu/models/detectors/point_rcnn.py``; mmdet3d's PointRCNN with
configs/_base_/models/point_rcnn.py): ``PointNet2SAMSG`` (4 levels, no
aggregation layers) -> ``PointNetFPNeck`` back to every input point ->
``PointRPNHead`` (a box a point, class-agnostic NMS) -> the RoI stage:
PartA2's IoU-piecewise sampler in train mode, ``roipoint_pool3d`` of
[RoI-frame xyz, the RPN's score, the normalised depth, the backbone
features], and ``PointRCNNBboxHead``. Plain PyTorch: it reaches none of
the port's CUDA kernels.

As gga_tpu's, every budget is static: ``nms_pre`` top points, then
``num_proposals`` proposals, ``roi.num_rois`` sampled RoIs and
``roi.roi_pts_budget`` pooled points an RoI.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn

from ...core.nms import nms_bev
from ...ops.roipoint_pool import roipoint_pool3d
from ..backbones.pointnet2 import PointConv, PointNet2SAMSG
from ..dense_heads.point_rpn_head import (PointRPNConfig, PointRPNHead,
                                          rpn_loss, rpn_proposals)
from ..necks.pointnet_fp_neck import PointNetFPNeck
from ..roi_heads.part_aggregation import (RoIHeadConfig, assign_and_sample,
                                          build_rcnn_targets)
from ..roi_heads.parta2_bbox_head import bbox_head_loss, decode_refined
from ..roi_heads.point_rcnn_bbox_head import (PointRCNNBboxConfig,
                                              PointRCNNBboxHead)
from .ssd3d import _tuples


@dataclasses.dataclass(frozen=True)
class PointRCNNConfig:
    in_channels: int = 4
    num_points: Tuple[int, ...] = (4096, 1024, 256, 64)
    radii: Sequence[Tuple[float, ...]] = (
        (0.1, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 4.0))
    num_samples: Sequence[Tuple[int, ...]] = (
        (16, 32), (16, 32), (16, 32), (16, 32))
    sa_channels: Sequence = (
        ((16, 16, 32), (32, 32, 64)),
        ((64, 64, 128), (64, 96, 128)),
        ((128, 196, 256), (128, 196, 256)),
        ((256, 256, 512), (256, 384, 512)))
    fp_channels: Sequence[Tuple[int, ...]] = (
        (512, 512), (512, 512), (256, 256), (128, 128))
    depth_normalizer: float = 70.0
    rpn: PointRPNConfig = dataclasses.field(default_factory=PointRPNConfig)
    roi: RoIHeadConfig = dataclasses.field(
        default_factory=lambda: RoIHeadConfig(
            num_rois=128, pos_fraction=0.5, pos_iou_thr=0.55,
            hard_neg_iou_thr=0.1, hard_neg_fraction=0.8,
            roi_pts_budget=512))
    bbox: PointRCNNBboxConfig = dataclasses.field(
        default_factory=PointRCNNBboxConfig)

    @classmethod
    def tiny(cls):
        """gga_tpu's tiny config."""
        return cls(
            num_points=(128, 64, 32, 16),
            sa_channels=(((8, 8), (8, 8)), ((8, 8), (8, 8)),
                         ((8, 8), (8, 8)), ((8, 8), (8, 8))),
            fp_channels=((16, 16), (16, 16), (16, 16), (16, 16)),
            rpn=PointRPNConfig(cls_channels=(16,), reg_channels=(16,),
                               nms_pre=64, num_proposals=16),
            roi=RoIHeadConfig(num_rois=8, pos_fraction=0.5,
                              pos_iou_thr=0.55, hard_neg_iou_thr=0.1,
                              hard_neg_fraction=0.8, roi_pts_budget=32),
            bbox=PointRCNNBboxConfig(
                mlp_channels=(16, 16), num_points=(16, 8, -1),
                num_samples=(8, 8, 8),
                sa_channels=((16,), (16,), (16,)),
                cls_channels=(16,), reg_channels=(16,)))


class PointRCNNDetector(nn.Module):
    def __init__(self, cfg: PointRCNNConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.backbone = PointNet2SAMSG(
            in_channels=c.in_channels, num_points=tuple(c.num_points),
            radii=_tuples(c.radii), num_samples=_tuples(c.num_samples),
            sa_channels=_tuples(c.sa_channels),
            aggregation_channels=(0,) * len(c.num_points))
        self.neck = PointNetFPNeck(self.backbone.level_channels,
                                   _tuples(c.fp_channels))
        self.rpn_head = PointRPNHead(c.rpn, self.neck.out_channels)
        self.roi_head = nn.ModuleDict(dict(bbox_head=PointRCNNBboxHead(
            c.bbox, self.neck.out_channels)))

    @torch.no_grad()
    def init_weights(self, generator):
        """gga_tpu's initializers, drawn from ``generator``: every 1x1 conv
        and linear uniform in +-1/sqrt(fan_in) (flax's Dense default is
        LeCun normal; gga_tpu's tests draw their own), biases 0; norms at 1
        and 0."""
        for m in self.modules():
            if isinstance(m, PointConv):
                m.init_weights(generator)
            elif isinstance(m, nn.Linear):
                bound = (1.0 / m.weight.shape[1]) ** 0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()

    def forward(self, points, points_valid, gt_boxes=None, gt_labels=None,
                gt_valid=None, sample_u=None, sample_idx=None,
                proposals=None):
        """points [B, N, 4]; points_valid [B, N]. Train mode also takes
        gt_boxes [B, M, 7] (bottom-centre lidar), gt_labels [B, M],
        gt_valid [B, M] and ``sample_u`` [B, num_proposals], the uniform
        draw that orders the RoI sampler's groups. ``sample_idx``
        (dict(backbone=[...], rcnn=[...]), the sampled centre indices) and
        ``proposals`` (``rpn_proposals``' dict) replace the forward's own;
        comparisons across devices pass them.

        Returns gga_tpu's dict (``rpn``, ``fp_xyz``, ``fp_valid``,
        ``samples``, ``rcnn``, ``props``) plus ``sample_idx``, the indices
        this forward sampled."""
        c = self.cfg
        sample_idx = sample_idx or {}
        feat = self.backbone(points, points_valid, sample_idx.get('backbone'))
        neck = self.neck(feat)
        fp_feats, fp_xyz, fp_valid = (neck['fp_features'], neck['fp_xyz'],
                                      neck['fp_valid'])
        bbox_preds, cls_preds = self.rpn_head(fp_feats, fp_valid)
        props = proposals if proposals is not None else rpn_proposals(
            c.rpn, bbox_preds.detach(), cls_preds.detach(), fp_xyz, fp_valid,
            self.training)
        if self.training:
            samples = assign_and_sample(
                c.roi, sample_u, props['boxes'], props['valid'], gt_boxes,
                gt_labels, gt_valid)
        else:
            samples = dict(rois=props['boxes'], roi_valid=props['valid'],
                           roi_scores=props['scores'],
                           roi_labels=props['labels'])
        rois = samples['rois']

        # the RCNN's point features: [score, depth, backbone]
        score = torch.sigmoid(cls_preds).amax(-1, keepdim=True)
        depth = (torch.linalg.vector_norm(fp_xyz, dim=-1, keepdim=True)
                 / c.depth_normalizer - 0.5)
        pooled, empty = roipoint_pool3d(
            fp_xyz, torch.cat([score, depth, fp_feats], -1), fp_valid, rois,
            c.roi.roi_pts_budget)
        B, R = rois.shape[:2]
        rcnn_valid = samples['roi_valid'] & ~empty
        cls_score, bbox_pred, rcnn_idx = self.roi_head['bbox_head'](
            pooled.reshape(B * R, c.roi.roi_pts_budget, -1),
            rcnn_valid.reshape(B * R), sample_idx.get('rcnn'))
        return dict(rpn=dict(bbox=bbox_preds, cls=cls_preds), fp_xyz=fp_xyz,
                    fp_valid=fp_valid, samples=samples,
                    rcnn=dict(cls=cls_score.reshape(B, R, 1),
                              reg=bbox_pred.reshape(B, R, 7)),
                    props=props,
                    sample_idx=dict(backbone=feat['sa_indices'],
                                    rcnn=rcnn_idx))


def point_rcnn_draws(model: PointRCNNDetector, batch_size, generator,
                     device):
    """A train step's draw from ``generator``: ``sample_u`` [B,
    num_proposals], the uniform draw that orders each group of the RoI
    sampler (gga_tpu draws it with ``jax.random.uniform``), on
    ``device``."""
    u = torch.rand((batch_size, model.cfg.rpn.num_proposals),
                   generator=generator)
    return u.to(device)


def point_rcnn_loss(cfg: PointRCNNConfig, out, gt_boxes, gt_labels,
                    gt_valid):
    """RPN + RCNN losses of a train-mode forward (point_rcnn.py:59-108).
    Returns (total, logs): 'rpn_bbox_loss', 'rpn_semantic_loss', the
    RCNN's terms, 'loss' and 'num_pos' (the RPN's positive points)."""
    loss_bbox, loss_cls, num_pos = rpn_loss(
        cfg.rpn, out['rpn']['bbox'], out['rpn']['cls'], out['fp_xyz'],
        out['fp_valid'], gt_boxes, gt_labels, gt_valid)
    rcnn_t = build_rcnn_targets(cfg.bbox, out['samples'])
    loss_rcnn, rcnn_logs = bbox_head_loss(
        cfg.bbox, out['rcnn']['cls'], out['rcnn']['reg'],
        out['samples']['rois'], rcnn_t)
    total = loss_bbox + loss_cls + loss_rcnn
    logs = dict(rpn_bbox_loss=loss_bbox, rpn_semantic_loss=loss_cls,
                **rcnn_logs)
    logs['loss'] = total
    logs['num_pos'] = num_pos
    return total, logs


@torch.no_grad()
def decode_point_rcnn(cfg: PointRCNNConfig, out):
    """The refined boxes and a rotated BEV NMS among the valid ones
    scoring at least ``test_score_thr`` (point_rcnn_bbox_head.get_bboxes).
    Returns dict(boxes [B, R, 7] bottom-centre lidar, scores, labels,
    valid): the kept boxes first by score, the free slots the first RoI's
    box with score 0 and valid False."""
    samples = out['samples']
    rois = samples['rois']
    boxes = decode_refined(rois, out['rcnn']['reg'])
    scores = torch.sigmoid(out['rcnn']['cls'][..., 0])
    idx, _ = nms_bev(boxes[..., [0, 1, 3, 4, 6]], scores,
                     cfg.bbox.test_nms_thr, post_max_size=boxes.shape[1],
                     valid=samples['roi_valid']
                     & (scores >= cfg.bbox.test_score_thr))
    safe = idx.clamp(min=0)
    kept = idx >= 0
    return dict(boxes=boxes.gather(1, safe[..., None].expand(-1, -1, 7)),
                scores=torch.where(kept, scores.gather(1, safe), 0.0),
                labels=samples['roi_labels'].gather(1, safe), valid=kept)
