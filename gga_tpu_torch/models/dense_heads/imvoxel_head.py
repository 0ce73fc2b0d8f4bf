"""ImVoxelNet's indoor head (port of
``gga_tpu/models/dense_heads/imvoxel_head.py``; mmdet3d's ImVoxelHead):
one 3x3x3 conv each for centerness, the 6 face distances + yaw, and the
class logits, shared by the levels, with a learned scale a level on the
distances' exponent; FCAF3D's target assignment (``fcaf3d_head.
get_targets``), the rotated 3D IoU loss weighted by the centerness
targets, the focal class loss and the centerness BCE; decoding by
sigmoid(cls) * sigmoid(center) * valid, the top ``nms_pre`` of each class
and a rotated BEV NMS.

State_dict keys are mmdet3d's: ``conv_center``, ``conv_reg``,
``conv_cls``, ``scales.{i}.scale``. The head's maps are channel-last
[B, Nx, Ny, Nz, C] (the NCDHW conv output permuted), so a level
flattens in gga_tpu's (x, y, z) order.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.nms import nms_bev
from . import fcaf3d_head as fc


@dataclasses.dataclass(frozen=True)
class ImVoxelHeadConfig:
    """Copy of gga_tpu's config."""
    n_classes: int = 10
    n_levels: int = 3
    n_channels: int = 128
    n_reg_outs: int = 7            # 6 face distances + raw yaw
    pts_assign_threshold: int = 27
    pts_center_threshold: int = 18
    # metric extent the voxel grid spans (prior_generator ranges,
    # imvoxelnet_4x2_sunrgbd config): (x0, y0, z0, x1, y1, z1)
    prior_range: Tuple[float, ...] = (-3.2, -0.2, -2.28, 3.2, 6.2, 0.28)
    # test cfg (imvoxelnet sunrgbd test_cfg)
    nms_pre: int = 256
    iou_thr: float = 0.25
    score_thr: float = 0.01
    max_out: int = 64
    loss_center_weight: float = 1.0
    loss_bbox_weight: float = 1.0
    loss_cls_weight: float = 1.0
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25


class ImVoxelHead(nn.Module):
    def __init__(self, cfg: ImVoxelHeadConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.n_channels
        self.conv_center = nn.Conv3d(c, 1, 3, padding=1, bias=False)
        self.conv_reg = nn.Conv3d(c, cfg.n_reg_outs, 3, padding=1,
                                  bias=False)
        self.conv_cls = nn.Conv3d(c, cfg.n_classes, 3, padding=1)
        self.scales = nn.ModuleList(fc.Scale() for _ in range(cfg.n_levels))

    def init_weights(self, generator):
        """gga_tpu's initializers: normal(0.01) kernels, the cls logits'
        prior bias -4.595, unit scales."""
        with torch.no_grad():
            for conv in (self.conv_center, self.conv_reg, self.conv_cls):
                conv.weight.normal_(0.0, 0.01, generator=generator)
            self.conv_cls.bias.fill_(-4.595)
            for s in self.scales:
                s.scale.fill_(1.0)

    def forward(self, volumes):
        """volumes: levels of [B, C, Nx, Ny, Nz] -> levels of dicts with
        'center' [B, Nx, Ny, Nz, 1], 'bbox' [..., n_reg_outs] (the
        distances exp-scaled), 'cls' [..., n_classes]."""
        outs = []
        for scale, x in zip(self.scales, volumes):
            reg = self.conv_reg(x).permute(0, 2, 3, 4, 1)
            dist = torch.exp(reg[..., :6] * scale.scale)
            outs.append(dict(
                center=self.conv_center(x).permute(0, 2, 3, 4, 1),
                bbox=torch.cat([dist, reg[..., 6:]], -1),
                cls=self.conv_cls(x).permute(0, 2, 3, 4, 1)))
        return outs


def grid_centers(rng, n_voxels, device='cpu'):
    """[Nx * Ny * Nz, 3] voxel centres of an (Nx, Ny, Nz) grid over ``rng``
    (x0, y0, z0, x1, y1, z1), in (x, y, z) meshgrid order and in f32 as
    gga_tpu computes them."""
    axes = [rng[a] + (torch.arange(n, dtype=torch.float32, device=device)
                      + 0.5) * (rng[a + 3] - rng[a]) / n
            for a, n in enumerate(n_voxels)]
    return torch.stack(torch.meshgrid(*axes, indexing='ij'), -1).reshape(
        -1, 3)


def level_points(cfg: ImVoxelHeadConfig, level_shapes, device='cpu'):
    """Each level's voxel centres over the prior range (mmdet3d
    ``_get_points`` through AlignedAnchor3DRangeGenerator)."""
    return [grid_centers(cfg.prior_range, shape, device)
            for shape in level_shapes]


def bbox_pred_to_bbox(points, bbox_pred):
    """(d_xmin, d_xmax, d_ymin, d_ymax, d_zmin, d_zmax, alpha) ->
    gravity-centred (x, y, z, dx, dy, dz, alpha); the face-distance shift
    turns with the predicted yaw (mmdet3d imvoxel_head.py:321)."""
    sx = (bbox_pred[..., 1] - bbox_pred[..., 0]) / 2
    sy = (bbox_pred[..., 3] - bbox_pred[..., 2]) / 2
    sz = (bbox_pred[..., 5] - bbox_pred[..., 4]) / 2
    a = bbox_pred[..., 6]
    cos, sin = torch.cos(a), torch.sin(a)
    shift = torch.stack([sx * cos - sy * sin, sx * sin + sy * cos, sz], -1)
    size = torch.stack([bbox_pred[..., 0] + bbox_pred[..., 1],
                        bbox_pred[..., 2] + bbox_pred[..., 3],
                        bbox_pred[..., 4] + bbox_pred[..., 5]], -1)
    return torch.cat([points + shift, size, a[..., None]], -1)


def _flatten(preds, key, ch):
    return torch.cat([p[key].reshape(p[key].shape[0], -1, ch)
                      for p in preds], 1)


def _flatten_valid(valids):
    return torch.cat([v.reshape(v.shape[0], -1) for v in valids], 1)


def _assign_cfg(cfg):
    # fcaf3d's get_targets reads only len(level_budgets) and the two
    # thresholds
    return types.SimpleNamespace(
        level_budgets=(0,) * cfg.n_levels,
        pts_assign_threshold=cfg.pts_assign_threshold,
        pts_center_threshold=cfg.pts_center_threshold)


def _level_grid(cfg, preds):
    """(points [Np, 3] of every level, level ids [Np])."""
    shapes = [tuple(p['center'].shape[1:4]) for p in preds]
    pts = level_points(cfg, shapes, preds[0]['center'].device)
    ids = torch.cat([torch.full((p.shape[0],), i, dtype=torch.int64,
                                device=p.device) for i, p in enumerate(pts)])
    return torch.cat(pts), ids


def loss(cfg: ImVoxelHeadConfig, preds, valids, gt_boxes, gt_labels,
         obj_valid):
    """Batched loss (mmdet3d imvoxel_head._loss_single:107, as gga_tpu).

    Args:
        preds: the head's levels.
        valids: levels of [B, Nx, Ny, Nz] bool projection validity.
        gt_boxes: [B, M, 7] gravity-centred depth boxes; gt_labels [B, M];
            obj_valid [B, M].
    Returns:
        (total, logs: 'loss', 'cls_loss', 'center_loss', 'bbox_loss',
        'num_pos').
    """
    points, level_ids = _level_grid(cfg, preds)
    center_p = _flatten(preds, 'center', 1)[..., 0]        # [B, Np]
    bbox_p = _flatten(preds, 'bbox', cfg.n_reg_outs)
    cls_p = _flatten(preds, 'cls', cfg.n_classes)
    valid = _flatten_valid(valids)                         # [B, Np]
    B = valid.shape[0]
    center_t, bbox_t, cls_t, pos = fc.get_targets(
        _assign_cfg(cfg), points.expand(B, -1, -1), valid, level_ids,
        gt_boxes, gt_labels, obj_valid)

    posf = (pos & valid).float()
    n_pos = posf.sum().clamp(min=1.0)
    # focal class loss over the valid locations (-1: background)
    onehot = ((cls_t[..., None] == torch.arange(
        cfg.n_classes, device=cls_t.device)) & pos[..., None]).float()
    p = torch.sigmoid(cls_p)
    pt = torch.where(onehot > 0, p, 1 - p)
    alpha_t = torch.where(onehot > 0, cfg.focal_alpha, 1 - cfg.focal_alpha)
    fl = -alpha_t * (1 - pt) ** cfg.focal_gamma * torch.log(pt.clamp(
        min=1e-8))
    cls_loss = (fl * valid[..., None]).sum() / n_pos * cfg.loss_cls_weight
    # centerness BCE on the positives
    bce = -(center_t * F.logsigmoid(center_p)
            + (1 - center_t) * F.logsigmoid(-center_p))
    center_loss = (bce * posf).sum() / n_pos * cfg.loss_center_weight
    # rotated-IoU box loss on the positives, weighted by the centerness
    iou = fc._iou3d_aligned(bbox_pred_to_bbox(points[None], bbox_p), bbox_t,
                            with_yaw=True)
    w = torch.where(posf > 0, center_t, 0.0)
    bbox_loss = ((1 - iou) * w).sum() / w.sum().clamp(min=1e-4) \
        * cfg.loss_bbox_weight
    total = cls_loss + center_loss + bbox_loss
    return total, dict(loss=total, cls_loss=cls_loss, center_loss=center_loss,
                       bbox_loss=bbox_loss, num_pos=posf.sum())


def decode(cfg: ImVoxelHeadConfig, preds, valids):
    """Boxes of every scene (mmdet3d imvoxel_head._get_bboxes_single:209):
    sigmoid(cls) * sigmoid(center) * valid, each class's top ``nms_pre``
    by a stable descending sort (every voxel outside the image scores
    exactly 0, and equal scores keep ``jax.lax.top_k``'s lower index
    first), a rotated BEV NMS a class.

    Returns dict: boxes [B, K, 7] gravity-centred depth boxes, scores,
    labels, valid (K = n_classes * min(max_out, nms_pre))."""
    points, _ = _level_grid(cfg, preds)
    center_p = torch.sigmoid(_flatten(preds, 'center', 1)[..., 0])
    cls_p = torch.sigmoid(_flatten(preds, 'cls', cfg.n_classes))
    valid = _flatten_valid(valids)
    scores = cls_p * center_p[..., None] * valid[..., None]
    boxes = bbox_pred_to_bbox(points[None], _flatten(preds, 'bbox',
                                                     cfg.n_reg_outs))
    K = min(cfg.nms_pre, scores.shape[1])
    outs = []
    for ci in range(cfg.n_classes):
        top_s, top_i = torch.sort(scores[..., ci], dim=-1, descending=True,
                                  stable=True)
        top_s, top_i = top_s[:, :K], top_i[:, :K]
        bx = boxes.gather(1, top_i[..., None].expand(-1, -1, 7))
        idx, _ = nms_bev(bx[..., [0, 1, 3, 4, 6]], top_s, cfg.iou_thr,
                         post_max_size=min(cfg.max_out, K),
                         valid=top_s > cfg.score_thr)
        safe = idx.clamp(min=0)
        outs.append((bx.gather(1, safe[..., None].expand(-1, -1, 7)),
                     torch.where(idx >= 0, top_s.gather(1, safe), 0.0),
                     torch.full(safe.shape, ci, dtype=torch.int32,
                                device=safe.device), idx >= 0))
    return dict(boxes=torch.cat([o[0] for o in outs], 1),
                scores=torch.cat([o[1] for o in outs], 1),
                labels=torch.cat([o[2] for o in outs], 1),
                valid=torch.cat([o[3] for o in outs], 1))
