"""PointRCNN's point-wise RPN head (port of ``gga_tpu/models/dense_heads/
point_rpn_head.py``; mmdet3d's PointRPNHead), batched over scenes: class
logits and PointXYZWHLR box residuals for every point, targets by
point-in-box membership (negatives: outside every GT box enlarged by
``enlarge_width``), a sigmoid focal loss over the count of positives and
a smooth-L1 (beta 1/9) box loss, and the proposals: the top
``nms_pre`` points by their largest class score, then a class-agnostic
rotated BEV NMS down to ``num_proposals``.

The branches carry mmdet3d's names: ``cls_layers`` / ``reg_layers``, a
Sequential of (Linear without bias, BatchNorm1d, ReLU) a layer, then a
Linear with bias; the norms are the port's ``MaskedBatchNorm`` (padding
points out of the statistics, as gga_tpu's).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.coders import point_xyzwhlr_decode, point_xyzwhlr_encode
from ...core.geometry import points_in_rbbox
from ...core.nms import nms_bev
from ..layers import MaskedBatchNorm
from ..losses import focal_loss, smooth_l1_loss
from .vote_head import _take


@dataclasses.dataclass(frozen=True)
class PointRPNConfig:
    num_classes: int = 3
    cls_channels: Tuple[int, ...] = (256, 256)
    reg_channels: Tuple[int, ...] = (256, 256)
    enlarge_width: float = 0.1
    # PointXYZWHLRBBoxCoder(code_size=8, use_mean_size=True)
    mean_sizes: Tuple[Tuple[float, float, float], ...] = (
        (3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73))
    loss_bbox_weight: float = 1.0
    loss_cls_weight: float = 1.0
    # proposal cfg (train_cfg / test_cfg rpn.nms_cfg)
    nms_pre: int = 1024
    num_proposals: int = 512
    train_nms_thr: float = 0.8
    test_nms_thr: float = 0.85


class Branch(nn.Module):
    """(Linear, MaskedBatchNorm, ReLU) a width, then a Linear with bias,
    at mmdet3d's Sequential indices (``{3k}``, ``{3k + 1}``, ``{3n}``)."""

    def __init__(self, in_channels, channels, out_channels):
        super().__init__()
        for k, ch in enumerate(channels):
            self.add_module(str(3 * k), nn.Linear(in_channels, ch, bias=False))
            self.add_module(str(3 * k + 1), MaskedBatchNorm(ch))
            in_channels = ch
        self.n = len(channels)
        self.add_module(str(3 * self.n), nn.Linear(in_channels, out_channels))

    def forward(self, x, valid):
        for k in range(self.n):
            x = getattr(self, str(3 * k))(x)
            x = F.relu(getattr(self, str(3 * k + 1))(x, valid))
        return getattr(self, str(3 * self.n))(x)


class PointRPNHead(nn.Module):
    def __init__(self, cfg: PointRPNConfig, in_channels):
        super().__init__()
        self.cfg = cfg
        self.cls_layers = Branch(in_channels, cfg.cls_channels,
                                 cfg.num_classes)
        self.reg_layers = Branch(in_channels, cfg.reg_channels, 8)

    def forward(self, fp_features, fp_valid):
        """[B, N, C] -> (bbox_preds [B, N, 8], cls_preds [B, N, K])."""
        return (self.reg_layers(fp_features, fp_valid),
                self.cls_layers(fp_features, fp_valid))


@torch.no_grad()
def rpn_targets(cfg: PointRPNConfig, points_xyz, points_valid, gt_boxes,
                gt_labels, gt_valid):
    """get_targets_single (point_rpn_head.py:206) of every scene: each
    point's first box that holds it, encoded against its gravity centre.

    Args:
        points_xyz [B, N, 3]; points_valid [B, N]; gt_boxes [B, G, 7]
        lidar bottom-centre; gt_labels [B, G]; gt_valid [B, G].
    Returns dict(bbox_targets [B, N, 8], mask_targets [B, N], positive,
    negative).
    """
    inbox = points_in_rbbox(points_xyz, gt_boxes) & gt_valid[:, None, :]
    assignment = inbox.to(torch.uint8).argmax(-1)      # the first, else 0
    positive = inbox.any(-1) & points_valid
    # the enlarged box (base_box3d.enlarged_box): dims + 2 w, bottom - w
    w = cfg.enlarge_width
    enlarged = torch.cat([gt_boxes[..., :2], (gt_boxes[..., 2] - w)[..., None],
                          gt_boxes[..., 3:6] + 2 * w, gt_boxes[..., 6:]], -1)
    near = points_in_rbbox(points_xyz, enlarged) & gt_valid[:, None, :]
    negative = ~near.any(-1) & points_valid
    gt = _take(gt_boxes, assignment)
    gt_grav = torch.cat([gt[..., :2], (gt[..., 2] + gt[..., 5] / 2)[..., None],
                         gt[..., 3:]], -1)
    mask_targets = _take(gt_labels, assignment).long()
    return dict(bbox_targets=point_xyzwhlr_encode(
        gt_grav, points_xyz, mask_targets, cfg.mean_sizes),
        mask_targets=mask_targets, positive=positive, negative=negative)


def rpn_loss(cfg: PointRPNConfig, bbox_preds, cls_preds, points_xyz,
             points_valid, gt_boxes, gt_labels, gt_valid):
    """The batch's RPN loss (point_rpn_head.py:127-171). Returns
    (loss_bbox, loss_cls, num_pos)."""
    t = rpn_targets(cfg, points_xyz, points_valid, gt_boxes, gt_labels,
                    gt_valid)
    pos = t['positive'].float()
    num_pos = pos.sum()
    box_w = pos / (num_pos + 1e-6)
    loss_bbox = (smooth_l1_loss(bbox_preds, t['bbox_targets'], beta=1.0 / 9.0)
                 * box_w[..., None]).sum() * cfg.loss_bbox_weight
    labels = torch.where(t['negative'], cfg.num_classes, t['mask_targets'])
    w = pos + t['negative'].float()
    fl = focal_loss(cls_preds, labels, cfg.num_classes)
    loss_cls = ((fl * w).sum() / num_pos.clamp(min=1.0)
                * cfg.loss_cls_weight)
    return loss_bbox, loss_cls, num_pos


@torch.no_grad()
def rpn_proposals(cfg: PointRPNConfig, bbox_preds, cls_preds, points_xyz,
                  points_valid, train: bool):
    """get_bboxes + class_agnostic_nms (point_rpn_head.py:246-356): every
    point's box decoded with its best class's mean size, the top
    ``nms_pre`` points by that class's sigmoid score (equal scores by the
    lower index, as ``jax.lax.top_k``), a rotated BEV NMS at the train or
    test threshold among those with a score above 0.

    Returns dict(boxes [B, num_proposals, 7] bottom-centre, scores, labels,
    valid): the kept boxes by score, the free slots the first top box
    with score 0 and valid False."""
    sem = torch.sigmoid(cls_preds)
    obj = torch.where(points_valid, sem.amax(-1), -1.0)
    label = sem.argmax(-1)
    boxes = point_xyzwhlr_decode(bbox_preds, points_xyz, label,
                                 cfg.mean_sizes)
    boxes = torch.cat([boxes[..., :2],
                       (boxes[..., 2] - boxes[..., 5] / 2)[..., None],
                       boxes[..., 3:]], -1)
    k = min(cfg.nms_pre, obj.shape[-1])
    top_i = torch.sort(-obj, dim=-1, stable=True).indices[..., :k]
    top_s = obj.gather(-1, top_i)
    top_b, top_l = _take(boxes, top_i), label.gather(-1, top_i)
    idx, _ = nms_bev(top_b[..., [0, 1, 3, 4, 6]], top_s,
                     cfg.train_nms_thr if train else cfg.test_nms_thr,
                     post_max_size=cfg.num_proposals, valid=top_s > 0)
    safe = idx.clamp(min=0)
    kept = idx >= 0
    return dict(boxes=_take(top_b, safe),
                scores=torch.where(kept, top_s.gather(-1, safe), 0.0),
                labels=top_l.gather(-1, safe), valid=kept)
