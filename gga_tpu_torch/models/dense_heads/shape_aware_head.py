"""Shape-aware grouping head of SSN (port of
``gga_tpu/models/dense_heads/shape_aware_head.py``, mmdet3d's
ShapeAwareHead + BaseShapeHead): classes are grouped by shape; each group
runs its own conv stack (deeper and strided for large objects) over the
shared BEV map, and each class's anchors lie at its group's resolution
(AlignedAnchor3DRangeGeneratorPerCls). Assignment and losses are
Anchor3DHead's, one class at a time with its own anchors and thresholds.

The head takes NCHW features and returns, per group, NHWC f32 maps
(``cls`` [B, H, W, R * n], ``reg`` [B, H, W, R * n * 7], ``dir``
[B, H, W, R * n * 2] for the group's n classes, a channel being (class,
rotation, value) in row-major order). Keys are mmdet3d's:
``heads.{i}.shared_conv.{j}.conv`` / ``.bn``, ``heads.{i}.conv_cls``,
``conv_reg``, ``conv_dir_cls``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchors import aligned_anchors_single_range
from ...core.coders import delta_decode, delta_encode
from ...core.geometry import limit_period
from ...core.nms import nms_bev
from ..layers import Conv2d, ConvModule2d
from .anchor3d_head import _bev_iou, _nearest_bev


@dataclasses.dataclass(frozen=True)
class ShapeTask:
    num_class: int
    shared_conv_channels: Tuple[int, ...]
    shared_conv_strides: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class ShapeAwareConfig:
    num_classes: int = 3
    # per-class anchor z + size (AlignedAnchor3DRangeGeneratorPerCls)
    anchor_z: Tuple[float, ...] = (-0.6, -0.6, -1.78)
    anchor_sizes: Tuple[Tuple[float, float, float], ...] = (
        (0.8, 0.6, 1.73), (1.76, 0.6, 1.73), (3.9, 1.6, 1.56))
    # which task group each class belongs to, and group conv specs
    class_to_task: Tuple[int, ...] = (0, 0, 1)
    tasks: Tuple[ShapeTask, ...] = (
        ShapeTask(2, (64, 64), (1, 1)),        # small objects
        ShapeTask(1, (64, 64, 64), (2, 1, 1)))  # large objects
    bev_range: Tuple[float, ...] = (0, -40, 70.4, 40)
    rotations: Tuple[float, ...] = (0.0, 1.5707963)
    pos_iou_thr: Tuple[float, ...] = (0.5, 0.5, 0.6)
    neg_iou_thr: Tuple[float, ...] = (0.35, 0.35, 0.45)
    min_pos_iou: Tuple[float, ...] = (0.35, 0.35, 0.45)
    dir_offset: float = 0.0
    loss_bbox_weight: float = 2.0
    loss_dir_weight: float = 0.2
    # test cfg
    nms_pre: int = 256
    nms_thr: float = 0.2
    score_thr: float = 0.1
    max_num: int = 128


class BaseShapeHead(nn.Module):
    """A group's conv stack (Conv + BN + ReLU, 3x3) and its three 1x1
    convs with biases."""

    def __init__(self, task: ShapeTask, in_channels, num_rot):
        super().__init__()
        convs = []
        ch = in_channels
        for out_ch, stride in zip(task.shared_conv_channels,
                                  task.shared_conv_strides):
            convs.append(ConvModule2d(ch, out_ch, 3, stride))
            ch = out_ch
        self.shared_conv = nn.Sequential(*convs)
        n = num_rot * task.num_class
        self.conv_cls = Conv2d(ch, n, 1)
        self.conv_reg = Conv2d(ch, n * 7, 1)
        self.conv_dir_cls = Conv2d(ch, n * 2, 1)

    def forward(self, x):
        h = self.shared_conv(x)
        return {name: conv(h).permute(0, 2, 3, 1)
                for name, conv in (('cls', self.conv_cls),
                                   ('reg', self.conv_reg),
                                   ('dir', self.conv_dir_cls))}


class ShapeAwareHead(nn.Module):
    def __init__(self, cfg: ShapeAwareConfig, in_channels):
        super().__init__()
        self.cfg = cfg
        self.heads = nn.ModuleList(
            BaseShapeHead(t, in_channels, len(cfg.rotations))
            for t in cfg.tasks)

    def forward(self, x):
        """x [B, C, H, W] -> a list, a task group each, of dicts of NHWC
        f32 maps (cls, reg, dir) at the group's resolution."""
        return [head(x) for head in self.heads]


def feat_sizes(outs):
    """Each task group's (H, W)."""
    return tuple(tuple(o['cls'].shape[1:3]) for o in outs)


@functools.lru_cache(maxsize=8)
def shape_aware_anchors(cfg: ShapeAwareConfig, sizes, device='cpu'):
    """Each class's anchors [A_c, 7] at its task group's map size
    (``sizes``, a group each) on ``device``. Cached by (config, sizes,
    device): every step shares the tensors, which no caller may write."""
    anchors = []
    for ci in range(cfg.num_classes):
        H, W = sizes[cfg.class_to_task[ci]]
        anchors.append(aligned_anchors_single_range(
            (H, W),
            (cfg.bev_range[0], cfg.bev_range[1], cfg.anchor_z[ci],
             cfg.bev_range[2], cfg.bev_range[3], cfg.anchor_z[ci]),
            cfg.anchor_sizes[ci], cfg.rotations, device).reshape(-1, 7))
    return anchors


def flatten_shape_preds(cfg: ShapeAwareConfig, outs):
    """-> per-class lists, in class order (a group's classes are
    contiguous): cls [B, A_c, 1], reg [B, A_c, 7], dir [B, A_c, 2]."""
    R = len(cfg.rotations)
    lists = ([], [], [])
    for task, out in zip(cfg.tasks, outs):
        B, H, W = out['cls'].shape[:3]
        for lst, key, ch in zip(lists, ('cls', 'reg', 'dir'), (1, 7, 2)):
            m = out[key].reshape(B, H * W, task.num_class, R, ch)
            lst.extend(m[:, :, k].reshape(B, H * W * R, ch)
                       for k in range(task.num_class))
    return lists


def shape_aware_loss(cfg: ShapeAwareConfig, outs, anchors, gt_boxes,
                     gt_labels, gt_valid):
    """Each class's max-IoU assignment over its own anchors, then the
    focal / smooth-L1 / direction losses summed over classes and scenes,
    each over the batch's count of positives (at least 1).

    Args:
        outs: the head's list of group maps.
        anchors: ``shape_aware_anchors``' list.
        gt_boxes [B, G, 7] bottom-centre lidar; gt_labels [B, G];
            gt_valid [B, G].
    Returns:
        (total, logs: 'loss_cls', 'loss_bbox', 'loss_dir', 'loss',
        'num_pos').

    An anchor takes its first best GT (``argmax``); each GT's first best
    anchor turns positive where their IoU reaches ``min_pos_iou``, by a
    scatter-max, as gga_tpu's ``.at[iou.argmax(0)].max(...)``.
    """
    cls_l, reg_l, dir_l = flatten_shape_preds(cfg, outs)
    B = gt_boxes.shape[0]
    gt_bev = _nearest_bev(gt_boxes)
    total_cls = total_bbox = total_dir = num_pos = 0.0
    for ci in range(cfg.num_classes):
        anc = anchors[ci]
        A = anc.shape[0]
        iou = _bev_iou(_nearest_bev(anc)[None], gt_bev)           # [B, A, G]
        ok = (gt_labels == ci) & gt_valid
        iou = torch.where(ok[:, None, :], iou, -1.0)
        max_iou, argm = iou.max(-1)
        pos = max_iou >= cfg.pos_iou_thr[ci]
        neg = (max_iou < cfg.neg_iou_thr[ci]) & (max_iou >= -0.5)
        gt_best, best_anchor = iou.max(1)                        # [B, G]
        ok_force = (ok & (gt_best >= cfg.min_pos_iou[ci])).int()
        force = torch.zeros(B, A, dtype=torch.int32, device=iou.device)
        force = force.scatter_reduce(1, best_anchor, ok_force, 'amax')
        pos = pos | force.bool()
        neg = neg & ~pos
        tgt_box = gt_boxes.gather(1, argm[..., None].expand(B, A, 7))
        tgt = delta_encode(tgt_box, anc[None])
        rot = limit_period(tgt_box[..., 6] - cfg.dir_offset, 0, 2 * np.pi)
        # truncation toward zero, as gga_tpu's astype(int32); rot >= 0
        dir_t = (rot / np.pi).long().clamp(0, 1)

        logit = cls_l[ci][..., 0]
        p = torch.sigmoid(logit)
        t = pos.float()
        pt = p * t + (1 - p) * (1 - t)
        al = 0.25 * t + 0.75 * (1 - t)
        ce = -(t * F.logsigmoid(logit) + (1 - t) * F.logsigmoid(-logit))
        total_cls = total_cls + (al * (1 - pt) ** 2 * ce
                                 * (pos | neg).float()).sum()

        reg = reg_l[ci]
        rs = torch.sin(reg[..., 6]) * torch.cos(tgt[..., 6])
        rt = torch.cos(reg[..., 6]) * torch.sin(tgt[..., 6])
        diff = torch.cat([reg[..., :6] - tgt[..., :6], (rs - rt)[..., None]],
                         -1)
        beta = 1.0 / 9.0
        sl1 = torch.where(diff.abs() < beta, 0.5 * diff ** 2 / beta,
                          diff.abs() - 0.5 * beta)
        total_bbox = total_bbox + (sl1 * t[..., None]).sum()
        d_ce = -F.log_softmax(dir_l[ci], -1).gather(-1, dir_t[..., None])[
            ..., 0]
        total_dir = total_dir + (d_ce * t).sum()
        num_pos = num_pos + t.sum()

    n = num_pos.clamp(min=1.0)
    loss_cls = total_cls / n
    loss_bbox = total_bbox / n * cfg.loss_bbox_weight
    loss_dir = total_dir / n * cfg.loss_dir_weight
    total = loss_cls + loss_bbox + loss_dir
    return total, dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                       loss_dir=loss_dir, loss=total, num_pos=num_pos)


def decode_shape_aware(cfg: ShapeAwareConfig, outs, anchors):
    """Each class's ``nms_pre`` best anchors (a stable descending sort:
    ``jax.lax.top_k``'s order of equal scores), decoded with the
    direction correction, then one rotated BEV NMS over all classes a
    scene, keeping at most ``max_num`` above ``score_thr``.

    Returns dict: boxes [B, max_num, 7] (bottom-centre lidar), scores,
    labels (int32, the head's class index), valid.
    """
    cls_l, reg_l, dir_l = flatten_shape_preds(cfg, outs)
    boxes_all, scores_all, labels_all = [], [], []
    for ci in range(cfg.num_classes):
        score = torch.sigmoid(cls_l[ci][..., 0])                # [B, A]
        k = min(cfg.nms_pre, score.shape[-1])
        top_s, top_i = torch.sort(score, dim=-1, descending=True,
                                  stable=True)
        top_s, top_i = top_s[:, :k], top_i[:, :k]
        boxes = delta_decode(
            reg_l[ci].gather(1, top_i[..., None].expand(-1, -1, 7)),
            anchors[ci][top_i])
        dcls = dir_l[ci].gather(1, top_i[..., None].expand(-1, -1, 2)
                                ).argmax(-1)
        rot = limit_period(boxes[..., 6] - cfg.dir_offset, 1.0, np.pi)
        boxes = torch.cat([boxes[..., :6], (rot + cfg.dir_offset + np.pi
                                            * dcls.float())[..., None]], -1)
        boxes_all.append(boxes)
        scores_all.append(top_s)
        labels_all.append(torch.full(top_s.shape, ci, dtype=torch.int32,
                                     device=top_s.device))
    boxes = torch.cat(boxes_all, 1)
    scores = torch.cat(scores_all, 1)
    labels = torch.cat(labels_all, 1)
    idx, _ = nms_bev(boxes[..., [0, 1, 3, 4, 6]], scores, cfg.nms_thr,
                     post_max_size=cfg.max_num, valid=scores > cfg.score_thr)
    safe = idx.clamp(min=0)
    kept = idx >= 0
    return dict(boxes=boxes.gather(1, safe[..., None].expand(-1, -1, 7)),
                scores=torch.where(kept, scores.gather(1, safe), 0.0),
                labels=labels.gather(1, safe), valid=kept)
