"""Anchor3DHead: the SECOND / PointPillars anchor head (port of
``gga_tpu/models/dense_heads/anchor3d_head.py``): each class's aligned
anchors with 2 rotations, max-IoU assignment on the nearest axis-aligned
BEV overlap, one class at a time, delta box coding with the sine
difference of the yaw, focal cls + smooth-L1 box + direction CE losses,
and a decode with rotated BEV NMS a class.

The head takes NCHW features and returns NHWC f32 maps, the layout of
gga_tpu's flax convs: ``cls`` [B, H, W, A * num_classes], ``reg``
[B, H, W, A * 7] and ``dir`` [B, H, W, A * 2], where A = num_classes x
len(rotations) anchors a location and a map's channel is
(anchor class, rotation, value) in row-major order. Its convs carry
mmdet3d's names (``conv_cls``, ``conv_reg``, ``conv_dir_cls``); a
released mmdet3d checkpoint may order its anchors otherwise.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchors import multiclass_anchors
from ...core.coders import delta_decode, delta_encode
from ...core.geometry import limit_period
from ...core.nms import nms_bev
from ..layers import Conv2d

CLS_BIAS = -4.595       # the logits' prior, sigmoid(-4.595) = 0.01


@dataclasses.dataclass(frozen=True)
class Anchor3DConfig:
    num_classes: int = 3
    feat_channels: int = 384
    anchor_ranges: Tuple[Tuple[float, ...], ...] = (
        (0, -39.68, -0.6, 69.12, 39.68, -0.6),
        (0, -39.68, -0.6, 69.12, 39.68, -0.6),
        (0, -39.68, -1.78, 69.12, 39.68, -1.78))
    anchor_sizes: Tuple[Tuple[float, float, float], ...] = (
        (0.8, 0.6, 1.73), (1.76, 0.6, 1.73), (3.9, 1.6, 1.56))
    rotations: Tuple[float, ...] = (0.0, 1.5707963)
    pos_iou_thr: Tuple[float, ...] = (0.5, 0.5, 0.6)
    neg_iou_thr: Tuple[float, ...] = (0.35, 0.35, 0.45)
    min_pos_iou: Tuple[float, ...] = (0.35, 0.35, 0.45)
    dir_offset: float = 0.0
    loss_bbox_weight: float = 2.0
    loss_dir_weight: float = 0.2
    # test cfg
    nms_pre: int = 100
    nms_thr: float = 0.01
    score_thr: float = 0.1
    max_num: int = 50


class Anchor3DHead(nn.Module):
    """Three 1x1 convs with biases over the fused BEV map."""

    def __init__(self, cfg: Anchor3DConfig, in_channels):
        super().__init__()
        self.cfg = cfg
        A = cfg.num_classes * len(cfg.rotations)
        self.conv_cls = Conv2d(in_channels, A * cfg.num_classes, 1)
        self.conv_reg = Conv2d(in_channels, A * 7, 1)
        self.conv_dir_cls = Conv2d(in_channels, A * 2, 1)

    def init_biases(self):
        """The cls logits' prior bias (gga_tpu's ``constant(-4.595)``)."""
        with torch.no_grad():
            self.conv_cls.bias.fill_(CLS_BIAS)

    def forward(self, x):
        """x [B, C, H, W] -> dict of NHWC f32 maps (cls, reg, dir)."""
        return {name: conv(x).permute(0, 2, 3, 1)
                for name, conv in (('cls', self.conv_cls),
                                   ('reg', self.conv_reg),
                                   ('dir', self.conv_dir_cls))}


@functools.lru_cache(maxsize=8)
def make_anchors(cfg: Anchor3DConfig, feature_size, device='cpu'):
    """[num_classes, H*W*R, 7] per-class anchors on ``device``. Cached
    by (config, size, device), so that a train step neither rebuilds
    them on the host nor copies them to the card (a copy from pageable
    memory waits for the step's queued work); every step of a run shares
    one tensor, which no caller may write."""
    return multiclass_anchors(feature_size, cfg.anchor_ranges,
                              cfg.anchor_sizes, cfg.rotations, device)


def _nearest_bev(boxes):
    """Axis-aligned nearest BEV boxes [..., 4] (BboxOverlapsNearest3D):
    dx and dy swap where |yaw| mod pi lies beyond pi / 4."""
    rot = limit_period(boxes[..., 6], 0.5, np.pi)
    swap = rot.abs() > np.pi / 4
    dx = torch.where(swap, boxes[..., 4], boxes[..., 3])
    dy = torch.where(swap, boxes[..., 3], boxes[..., 4])
    return torch.stack([boxes[..., 0] - dx / 2, boxes[..., 1] - dy / 2,
                        boxes[..., 0] + dx / 2, boxes[..., 1] + dy / 2], -1)


def _bev_iou(a, b):
    """[..., N, 4] x [..., M, 4] axis-aligned IoU -> [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area_a = (a[..., 2:] - a[..., :2]).prod(-1)
    area_b = (b[..., 2:] - b[..., :2]).prod(-1)
    return inter / (area_a[..., :, None] + area_b[..., None, :]
                    - inter).clamp(min=1e-8)


def assign_targets(cfg: Anchor3DConfig, anchors, gt_boxes, gt_labels,
                   obj_valid):
    """Max-IoU assignment of each class's anchors, batched over scenes
    (gga_tpu's ``assign_targets`` under ``jax.vmap``).

    Args:
        anchors: [C, A, 7] per-class anchors.
        gt_boxes: [B, M, 7] bottom-centre lidar boxes; gt_labels [B, M];
            obj_valid [B, M].
    Returns dict, over classes then anchors ([B, C*A]): labels
    (num_classes = background), bbox_targets [B, C*A, 7], dir_targets
    (int64), pos_mask, neg_mask.

    An anchor takes its first best GT (``argmax``; where a class has no
    GT every IoU is -1 and the anchor is neither positive nor negative).
    Each GT's first best anchor turns positive where their IoU reaches
    ``min_pos_iou``: a scatter-max over the batch's GTs, so that a GT
    that does not qualify (a padded one at anchor 0 among them) cannot
    unset one that does, whatever the order of the writes.
    """
    C, A, _ = anchors.shape
    B = gt_boxes.shape[0]
    gt_bev = _nearest_bev(gt_boxes)
    out = dict(labels=[], bbox_targets=[], dir_targets=[], pos_mask=[],
               neg_mask=[])
    for ci in range(C):
        anc = anchors[ci]
        iou = _bev_iou(_nearest_bev(anc)[None], gt_bev)       # [B, A, M]
        cls_ok = (gt_labels == ci) & obj_valid
        iou = torch.where(cls_ok[:, None, :], iou, -1.0)
        max_iou, argmax = iou.max(-1)
        pos = max_iou >= cfg.pos_iou_thr[ci]
        neg = (max_iou < cfg.neg_iou_thr[ci]) & (max_iou >= -0.5)
        gt_best, best_anchor = iou.max(1)                      # [B, M]
        ok_force = (cls_ok & (gt_best >= cfg.min_pos_iou[ci])).int()
        force = torch.zeros(B, A, dtype=torch.int32, device=iou.device)
        force = force.scatter_reduce(1, best_anchor, ok_force, 'amax')
        pos = pos | force.bool()
        neg = neg & ~pos

        tgt = gt_boxes.gather(1, argmax[..., None].expand(B, A, 7))
        enc = delta_encode(tgt, anc[None])
        rot = limit_period(tgt[..., 6] - cfg.dir_offset, 0, 2 * np.pi)
        # truncation toward zero, as gga_tpu's astype(int32); rot >= 0
        dir_t = (rot / np.pi).long().clamp(0, 1)
        out['labels'].append(torch.where(pos, ci, cfg.num_classes))
        out['bbox_targets'].append(torch.where(pos[..., None], enc, 0.0))
        out['dir_targets'].append(dir_t)
        out['pos_mask'].append(pos)
        out['neg_mask'].append(neg)
    return {k: torch.cat(v, 1) for k, v in out.items()}


def _flat(m, C, R, ch):
    """NHWC [B, H, W, A*ch] -> [B, C, H*W*R, ch], each class's anchors in
    ``multiclass_anchors``' order (location-major, then rotation)."""
    B, H, W, _ = m.shape
    return m.reshape(B, H * W, C, R, ch).permute(0, 2, 1, 3, 4).reshape(
        B, C, H * W * R, ch)


def loss(cfg: Anchor3DConfig, preds, anchors, targets):
    """The batch's loss (anchor3d_head.loss): sigmoid focal loss
    (alpha 0.25, gamma 2) over positive and negative anchors, smooth-L1
    (beta 1/9) on the deltas with the yaw's sine difference over the
    positives, direction cross-entropy over the positives, each over the
    count of positives (at least 1).

    Args:
        preds: the head's NHWC maps.
        anchors: [C, A, 7].
        targets: ``assign_targets``' dict.
    Returns:
        (total, logs) with 0-d tensors loss_cls, loss_bbox, loss_dir,
        loss and num_pos.
    """
    C = cfg.num_classes
    R = len(cfg.rotations)
    B = preds['cls'].shape[0]
    cls = _flat(preds['cls'], C, R, C).reshape(B, -1, C)
    reg = _flat(preds['reg'], C, R, 7).reshape(B, -1, 7)
    dirp = _flat(preds['dir'], C, R, 2).reshape(B, -1, 2)

    pos = targets['pos_mask'].float()
    neg = targets['neg_mask'].float()
    num_pos = pos.sum().clamp(min=1.0)

    # labels == C (background) one-hot to zeros, as jax.nn.one_hot
    onehot = F.one_hot(targets['labels'], C + 1)[..., :C].float()
    p = torch.sigmoid(cls)
    pt = p * onehot + (1 - p) * (1 - onehot)
    alpha_w = 0.25 * onehot + 0.75 * (1 - onehot)
    ce = -(onehot * F.logsigmoid(cls) + (1 - onehot) * F.logsigmoid(-cls))
    valid_w = (pos + neg)[..., None]
    loss_cls = ((alpha_w * (1 - pt) ** 2 * ce) * valid_w).sum() / num_pos

    bt = targets['bbox_targets']
    rs = torch.sin(reg[..., 6]) * torch.cos(bt[..., 6])
    rt = torch.cos(reg[..., 6]) * torch.sin(bt[..., 6])
    diff = torch.cat([reg[..., :6] - bt[..., :6], (rs - rt)[..., None]], -1)
    beta = 1.0 / 9.0
    sl1 = torch.where(diff.abs() < beta, 0.5 * diff ** 2 / beta,
                      diff.abs() - 0.5 * beta)
    loss_bbox = ((sl1 * pos[..., None]).sum() / num_pos
                 * cfg.loss_bbox_weight)

    dir_ce = -F.log_softmax(dirp, -1).gather(
        -1, targets['dir_targets'][..., None])[..., 0]
    loss_dir = (dir_ce * pos).sum() / num_pos * cfg.loss_dir_weight

    total = loss_cls + loss_bbox + loss_dir
    return total, dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                       loss_dir=loss_dir, loss=total, num_pos=pos.sum())


def decode(cfg: Anchor3DConfig, preds, anchors):
    """Inference decode with a rotated BEV NMS a class (static shapes).

    Each class keeps its ``nms_pre`` best anchors, by a stable descending
    sort (``jax.lax.top_k``'s order of equal scores), decodes them with
    the direction correction ``limit_period(yaw - dir_offset, 1, pi) +
    dir_offset + pi * dir`` and keeps at most ``max_num`` after an NMS
    among those above ``score_thr``.

    Returns dict: boxes [B, C*max_num, 7] (bottom-centre lidar), scores,
    labels (int32), valid.
    """
    C = cfg.num_classes
    R = len(cfg.rotations)
    cls = torch.sigmoid(_flat(preds['cls'], C, R, C))
    reg = _flat(preds['reg'], C, R, 7)
    dirp = _flat(preds['dir'], C, R, 2)
    outs = []
    for ci in range(C):
        score = cls[:, ci, :, ci]                               # [B, A]
        boxes = delta_decode(reg[:, ci], anchors[ci][None])
        dir_score = dirp[:, ci].argmax(-1)
        rot = limit_period(boxes[..., 6] - cfg.dir_offset, 1.0, np.pi)
        boxes = torch.cat([boxes[..., :6], (rot + cfg.dir_offset + np.pi
                                            * dir_score.float())[..., None]],
                          -1)
        k = min(cfg.nms_pre, score.shape[-1])
        top_s, top_i = torch.sort(score, dim=-1, descending=True,
                                  stable=True)
        top_s, top_i = top_s[:, :k], top_i[:, :k]
        bx = boxes.gather(1, top_i[..., None].expand(-1, -1, 7))
        idx, _ = nms_bev(bx[..., [0, 1, 3, 4, 6]], top_s, cfg.nms_thr,
                         post_max_size=cfg.max_num,
                         valid=top_s > cfg.score_thr)
        safe = idx.clamp(min=0)
        kept = idx >= 0
        outs.append((bx.gather(1, safe[..., None].expand(-1, -1, 7)),
                     torch.where(kept, top_s.gather(1, safe), 0.0),
                     torch.full(kept.shape, ci, dtype=torch.int32,
                                device=kept.device), kept))
    return dict(boxes=torch.cat([o[0] for o in outs], 1),
                scores=torch.cat([o[1] for o in outs], 1),
                labels=torch.cat([o[2] for o in outs], 1),
                valid=torch.cat([o[3] for o in outs], 1))
