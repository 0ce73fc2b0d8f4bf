"""FCAF3D head: sparse 3D FPN + anchor-free head, targets, losses, decode
(port of ``gga_tpu/models/dense_heads/fcaf3d_head.py``; mmdet3d's
FCAF3DHead): a top-down generative-transpose pathway with score-based
pruning, shared 1x1 head convs with per-level scales, the 3-condition
target assigner and the centerness / IoU / focal losses.

As in gga_tpu, each level's active sites live in a static budget and the
prune IS the budget's top-k; the prune score of a site is its parent's
(``child // 2``) max class logit at the coarser level; NMS takes a static
top-k of candidates per class.

State-dict names follow mmdet3d's FCAF3DHead: ``up_block_{i}`` takes level
i to level i - 1 (``.0`` the transposed conv, ``.1`` its norm, ``.3`` the
conv, ``.4`` its norm: gga_tpu's ``w_up{i-1}``, ``bn_up{i-1}``,
``up_conv{i-1}``), ``out_block_{i}`` (``.0``, ``.1``), ``conv_center``,
``conv_reg``, ``conv_cls``, ``scales.{i}.scale``. Kernels keep gga_tpu's
``[K, C, D]`` layout and (z, y, x) offset order, the 1x1 head convs
``[C, D]``; as in gga_tpu only ``conv_cls`` has a bias.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.nms import nms_bev
from ...core.rotated_iou import rotated_overlap
from ...ops import sparse as sp
from ...parallel import mesh
from ..backbones.mink_resnet import MinkBatchNorm, MinkConv, subm, subm_map

INF = 1e8


@dataclasses.dataclass(frozen=True)
class FCAF3DConfig:
    n_classes: int = 10
    in_channels: Tuple[int, ...] = (64, 128, 256, 512)
    out_channels: int = 128
    n_reg_outs: int = 8          # 6 distances + 2 angle chans (SUN RGB-D)
    voxel_size: float = 0.01
    pts_assign_threshold: int = 27
    pts_center_threshold: int = 18
    # static per-level budgets (fine -> coarse), double as prune thresholds
    level_budgets: Tuple[int, ...] = (16384, 8192, 4096, 2048)
    max_objs: int = 64
    with_yaw: bool = True
    # test cfg (configs/fcaf3d: nms_pre=1000, iou_thr=.5, score_thr=.01)
    nms_pre: int = 512
    iou_thr: float = 0.5
    score_thr: float = 0.01
    max_out: int = 128


class SparseConvBNELU(nn.Sequential):
    """SubM conv k3 + masked BN + ELU on its own neighbor map (children
    ``0`` the kernel, ``1`` the norm: mmdet3d's ``_make_block``)."""

    def __init__(self, in_channels, out_channels):
        super().__init__(MinkConv(27, in_channels, out_channels),
                         MinkBatchNorm(out_channels))

    def forward(self, feats, coords, valid, grid):
        conv, bn = self[0], self[1]
        x = subm(conv.kernel, feats, valid, subm_map(coords, valid, grid))
        return F.elu(bn(x, valid))


class UpBlock(nn.Module):
    """Generative transpose k2 s2 -> BN -> ELU -> SubM k3 -> BN -> ELU
    (mmdet3d ``_make_up_block``; state-dict children ``0``, ``1``, ``3``,
    ``4`` as its Sequential numbers them)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.add_module('0', MinkConv(8, in_channels, out_channels))
        self.add_module('1', MinkBatchNorm(out_channels))
        self.add_module('3', MinkConv(27, out_channels, out_channels))
        self.add_module('4', MinkBatchNorm(out_channels))

    def forward(self, st: sp.SparseTensor, out_budget):
        up = sp.generative_transpose_conv(st, getattr(self, '0').kernel,
                                          out_budget=out_budget)
        f = F.elu(getattr(self, '1')(up.features, up.valid))
        nmap = subm_map(up.coords, up.valid, up.grid)
        f = F.elu(getattr(self, '4')(
            subm(getattr(self, '3').kernel, f, up.valid, nmap), up.valid))
        return sp.SparseTensor(f, up.coords, up.valid, up.grid)


class Conv1x1(nn.Module):
    """A shared 1x1 head conv: ``kernel`` [C, D], optional ``bias`` [D]."""

    def __init__(self, in_channels, out_channels, bias=False):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_channels, out_channels))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if bias
                     else None)

    def forward(self, x):
        y = torch.matmul(x, self.kernel)
        return y if self.bias is None else y + self.bias


class Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(()))


class FCAF3DHead(nn.Module):
    def __init__(self, cfg: FCAF3DConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        n = len(c.in_channels)
        for i in range(n):
            if i > 0:
                setattr(self, f'up_block_{i}',
                        UpBlock(c.in_channels[i], c.in_channels[i - 1]))
            setattr(self, f'out_block_{i}',
                    SparseConvBNELU(c.in_channels[i], c.out_channels))
        self.conv_center = Conv1x1(c.out_channels, 1)
        self.conv_reg = Conv1x1(c.out_channels, c.n_reg_outs)
        self.conv_cls = Conv1x1(c.out_channels, c.n_classes, bias=True)
        self.scales = nn.ModuleList([Scale() for _ in range(n)])

    def forward(self, backbone_outs, diag=None):
        """backbone_outs: list over 4 levels of (feats [B, N, C], coords,
        valid, grid), fine -> coarse. With a dict ``diag``, records each
        level's active sites per scene after its prune (``active.head{i}``).

        Returns a list over levels (fine -> coarse) of dicts: center
        [B, N, 1], bbox [B, N, n_reg_outs], cls [B, N, n_classes], points
        [B, N, 3] (grid-frame metres), valid [B, N]."""
        c = self.cfg
        n_lvl = len(backbone_outs)
        outs = [None] * n_lvl
        st = None
        for i in range(n_lvl - 1, -1, -1):
            f_i, c_i, v_i, g_i = backbone_outs[i]
            if st is None:
                st = sp.SparseTensor(f_i, c_i, v_i, g_i)
            else:
                up = getattr(self, f'up_block_{i + 1}')(
                    st, out_budget=c.level_budgets[i] * 2)
                merged = sp.sparse_add(up, sp.SparseTensor(f_i, c_i, v_i,
                                                           g_i),
                                       c.level_budgets[i] * 2)
                # prune by the coarser level's max class score at parents
                prev = sp.SparseTensor(
                    outs[i + 1]['cls'].amax(-1, keepdim=True), st.coords,
                    st.valid, st.grid)
                parent = torch.div(merged.coords, 2, rounding_mode='floor')
                score = sp.lookup_features(prev, parent, merged.valid)[..., 0]
                st = sp.topk_prune(merged, score, c.level_budgets[i])
            if diag is not None:
                diag[f'active.head{i}'] = st.valid.sum(-1)
            out_f = getattr(self, f'out_block_{i}')(st.features, st.coords,
                                                    st.valid, st.grid)
            center = self.conv_center(out_f)
            cls = self.conv_cls(out_f)
            reg = self.conv_reg(out_f)
            dist = torch.exp(reg[..., :6] * self.scales[i].scale)
            bbox = torch.cat([dist, reg[..., 6:]], -1)
            # level i sits at stride 2^(i+3) (conv1 s2 * pool s2 * per
            # stage s2): the grid coords rescale to metres by it
            lvl_stride = c.voxel_size * (2 ** (i + 3))
            pts = st.coords.flip(-1).float() * lvl_stride
            outs[i] = dict(center=center, bbox=bbox, cls=cls, points=pts,
                           valid=st.valid)
        return outs


def bbox_pred_to_bbox(points, bbox_pred, with_yaw=True):
    """6-distance (+2 angle) predictions -> gravity-centered boxes
    (x, y, z, dx, dy, dz[, yaw]) (fcaf3d ``_bbox_pred_to_bbox``)."""
    x = points[..., 0] + (bbox_pred[..., 1] - bbox_pred[..., 0]) / 2
    y = points[..., 1] + (bbox_pred[..., 3] - bbox_pred[..., 2]) / 2
    z = points[..., 2] + (bbox_pred[..., 5] - bbox_pred[..., 4]) / 2
    if not with_yaw:
        return torch.stack([x, y, z,
                            bbox_pred[..., 0] + bbox_pred[..., 1],
                            bbox_pred[..., 2] + bbox_pred[..., 3],
                            bbox_pred[..., 4] + bbox_pred[..., 5]], -1)
    scale = (bbox_pred[..., 0] + bbox_pred[..., 1]
             + bbox_pred[..., 2] + bbox_pred[..., 3])
    # guarded sqrt / atan2: inactive (zero) rows sit exactly at (0, 0),
    # where both have NaN gradients that the masked loss would keep
    s6, c7 = bbox_pred[..., 6], bbox_pred[..., 7]
    degen = (s6.abs() + c7.abs()) < 1e-8
    q = torch.exp(torch.sqrt(s6 ** 2 + c7 ** 2 + 1e-12))
    alpha = 0.5 * torch.atan2(torch.where(degen, 0.0, s6),
                              torch.where(degen, 1.0, c7))
    return torch.stack([x, y, z, scale / (1 + q), scale / (1 + q) * q,
                        bbox_pred[..., 5] + bbox_pred[..., 4], alpha], -1)


def _face_distances(points, boxes):
    """points [B, Np, 3], boxes [B, M, 7] -> [B, Np, M, 6] distances to
    the box faces (fcaf3d ``_get_face_distances``)."""
    rel = points[:, :, None, :] - boxes[:, None, :, :3]
    yaw = (boxes[..., 6] if boxes.shape[-1] > 6
           else boxes.new_zeros(boxes.shape[:-1]))
    cos, sin = torch.cos(-yaw)[:, None], torch.sin(-yaw)[:, None]
    rx = rel[..., 0] * cos - rel[..., 1] * sin
    ry = rel[..., 0] * sin + rel[..., 1] * cos
    b = boxes[:, None]
    centers = b[..., :3] + torch.stack([rx, ry, rel[..., 2]], -1)
    return torch.stack([
        centers[..., 0] - b[..., 0] + b[..., 3] / 2,
        b[..., 0] + b[..., 3] / 2 - centers[..., 0],
        centers[..., 1] - b[..., 1] + b[..., 4] / 2,
        b[..., 1] + b[..., 4] / 2 - centers[..., 1],
        centers[..., 2] - b[..., 2] + b[..., 5] / 2,
        b[..., 2] + b[..., 5] / 2 - centers[..., 2]], -1)


def _centerness(face_d):
    xd, yd, zd = face_d[..., 0:2], face_d[..., 2:4], face_d[..., 4:6]
    c = (xd.amin(-1) / xd.amax(-1).clamp(min=1e-8)
         * yd.amin(-1) / yd.amax(-1).clamp(min=1e-8)
         * zd.amin(-1) / zd.amax(-1).clamp(min=1e-8))
    return torch.sqrt(c.clamp(min=0.0))


def get_targets(cfg: FCAF3DConfig, points, pts_valid, level_ids, gt_boxes,
                gt_labels, obj_valid):
    """Target assignment (fcaf3d ``_get_targets``), batched over scenes.

    Args:
        points: [B, Np, 3] metric locations (all levels concatenated).
        pts_valid: [B, Np] bool; level_ids: [Np] int.
        gt_boxes: [B, M, 7] gravity-centered depth boxes.
        gt_labels: [B, M]; obj_valid: [B, M].
    Returns:
        (center_t [B, Np], bbox_t [B, Np, 7], cls_t [B, Np] with -1 for
        background, pos [B, Np]).
    """
    n_levels = len(cfg.level_budgets)
    face_d = _face_distances(points, gt_boxes)           # [B, Np, M, 6]
    inside = ((face_d.amin(-1) > 0) & pts_valid[..., None]
              & obj_valid[:, None, :])
    n_pos_per_level = torch.stack([
        (inside & (level_ids == i)[None, :, None]).sum(1)
        for i in range(n_levels)], 1)                      # [B, L, M]
    lower_mask = n_pos_per_level < cfg.pts_assign_threshold
    lower_index = (torch.argmax(lower_mask.int(), 1) - 1).clamp(min=0)
    all_upper = (~lower_mask).all(1)
    best_level = torch.where(all_upper, n_levels - 1, lower_index)  # [B, M]
    level_cond = level_ids[None, :, None] == best_level[:, None, :]

    center = _centerness(face_d)
    center = torch.where(inside & level_cond, center, -1.0)
    k = min(cfg.pts_center_threshold + 1, center.shape[1])
    top_c = torch.topk(center.transpose(1, 2), k, dim=-1).values[..., -1]
    topk_cond = center > top_c[:, None, :]

    volumes = gt_boxes[..., 3] * gt_boxes[..., 4] * gt_boxes[..., 5]
    vol = torch.where(inside & level_cond & topk_cond, volumes[:, None, :],
                      INF)
    min_vol, amin = vol.min(-1)
    pos = min_vol < INF
    center_t = center.gather(2, amin[..., None])[..., 0]
    bbox_t = gt_boxes.gather(1, amin[..., None].expand(*amin.shape, 7))
    cls_t = torch.where(pos, gt_labels.gather(1, amin), -1)
    return center_t, bbox_t, cls_t, pos


def _iou3d_aligned(a, b, with_yaw=True):
    """Elementwise rotated 3D IoU of gravity-centered boxes [..., 7]
    (mmcv ``diff_iou_rotated_3d``'s behaviour; gradients flow through
    the vertices)."""
    if with_yaw:
        idx = [0, 1, 3, 4, 6]
        inter_bev = rotated_overlap(a[..., None, idx],
                                    b[..., None, idx])[..., 0, 0]
    else:
        lo = torch.maximum(a[..., :2] - a[..., 3:5] / 2,
                           b[..., :2] - b[..., 3:5] / 2)
        hi = torch.minimum(a[..., :2] + a[..., 3:5] / 2,
                           b[..., :2] + b[..., 3:5] / 2)
        inter_bev = (hi - lo).clamp(min=0).prod(-1)
    z_ov = (torch.minimum(a[..., 2] + a[..., 5] / 2, b[..., 2] + b[..., 5] / 2)
            - torch.maximum(a[..., 2] - a[..., 5] / 2,
                            b[..., 2] - b[..., 5] / 2)).clamp(min=0)
    inter = inter_bev * z_ov
    va = a[..., 3] * a[..., 4] * a[..., 5]
    vb = b[..., 3] * b[..., 4] * b[..., 5]
    return inter / (va + vb - inter).clamp(min=1e-8)


def _cat(head_outs, key):
    return torch.cat([o[key] for o in head_outs], 1)


def loss(cfg: FCAF3DConfig, head_outs, gt_boxes, gt_labels, obj_valid):
    """Batch loss (fcaf3d ``_loss_single`` averaged over scenes).

    Args:
        head_outs: list over levels of ``FCAF3DHead`` output dicts.
        gt_boxes: [B, M, 7]; gt_labels: [B, M]; obj_valid: [B, M].
    Returns:
        (total, logs: center_loss, bbox_loss, cls_loss, loss, num_pos).

    The normalisers are per scene; under a process group the mean over
    scenes and ``num_pos`` span the global batch (``mesh.global_mean``:
    each rank's terms are its shares of the global ones).
    """
    points = _cat(head_outs, 'points')
    pvalid = _cat(head_outs, 'valid')
    level_ids = torch.cat([
        torch.full((o['points'].shape[1],), i, device=points.device)
        for i, o in enumerate(head_outs)])
    center_p = _cat(head_outs, 'center')[..., 0]
    bbox_p = _cat(head_outs, 'bbox')
    cls_p = _cat(head_outs, 'cls')

    center_t, bbox_t, cls_t, pos = get_targets(
        cfg, points, pvalid, level_ids, gt_boxes, gt_labels, obj_valid)
    posf = (pos & pvalid).float()
    n_pos = posf.sum(1).clamp(min=1.0)                   # per scene

    # focal class loss (alpha .25, gamma 2; -1 is background); a label
    # beyond n_classes one-hots to zeros, as jax.nn.one_hot gives it
    onehot = F.one_hot(torch.where((cls_t < 0) | (cls_t > cfg.n_classes),
                                   cfg.n_classes, cls_t).long(),
                       cfg.n_classes + 1)[..., :cfg.n_classes].float()
    p = torch.sigmoid(cls_p)
    pt = p * onehot + (1 - p) * (1 - onehot)
    alpha_w = 0.25 * onehot + 0.75 * (1 - onehot)
    ce = -(onehot * F.logsigmoid(cls_p) + (1 - onehot) * F.logsigmoid(-cls_p))
    cls_loss = ((alpha_w * (1 - pt) ** 2 * ce).sum(-1)
                * pvalid.float()).sum(1) / n_pos

    # centerness BCE
    bce = -(center_t * F.logsigmoid(center_p)
            + (1 - center_t) * F.logsigmoid(-center_p))
    center_loss = (bce * posf).sum(1) / n_pos

    # IoU box loss weighted by the centerness targets
    boxes_pred = bbox_pred_to_bbox(points, bbox_p, cfg.with_yaw)
    if not cfg.with_yaw:
        boxes_pred = torch.cat([boxes_pred, torch.zeros_like(
            boxes_pred[..., :1])], -1)
    iou = _iou3d_aligned(boxes_pred, bbox_t, cfg.with_yaw)
    denom = (center_t * posf).sum(1).clamp(min=1e-6)
    bbox_loss = ((1 - iou) * center_t * posf).sum(1) / denom

    logs = dict(center_loss=mesh.global_mean(center_loss),
                bbox_loss=mesh.global_mean(bbox_loss),
                cls_loss=mesh.global_mean(cls_loss))
    total = logs['center_loss'] + logs['bbox_loss'] + logs['cls_loss']
    logs['loss'] = total
    logs['num_pos'] = mesh.global_sum(posf.sum())
    return total, logs


def decode(cfg: FCAF3DConfig, head_outs):
    """Inference decode (fcaf3d ``_get_bboxes_single`` + per-class NMS),
    static shapes; rotated BEV NMS (``core.nms.nms_bev``) stands in for
    nms3d, as in gga_tpu.

    The top ``nms_pre`` candidates of a class come from a stable
    descending sort, so equal scores keep ``jax.lax.top_k``'s order.

    Returns dict: boxes [B, K, 7] gravity-centered, scores [B, K], labels
    [B, K], valid [B, K] (K = n_classes * max_out).
    """
    scores, boxes = [], []
    for o in head_outs:
        s = torch.sigmoid(o['cls']) * torch.sigmoid(o['center'])
        b = bbox_pred_to_bbox(o['points'], o['bbox'], cfg.with_yaw)
        if not cfg.with_yaw:
            b = torch.cat([b, torch.zeros_like(b[..., :1])], -1)
        scores.append(torch.where(o['valid'][..., None], s, 0.0))
        boxes.append(b)
    scores = torch.cat(scores, 1)                # [B, Np, C]
    boxes = torch.cat(boxes, 1)                  # [B, Np, 7]

    outs = []
    for ci in range(cfg.n_classes):
        top_s, top_i = torch.sort(scores[..., ci], dim=-1, descending=True,
                                  stable=True)
        top_s, top_i = top_s[:, :cfg.nms_pre], top_i[:, :cfg.nms_pre]
        bx = boxes.gather(1, top_i[..., None].expand(*top_i.shape, 7))
        idx, _ = nms_bev(bx[..., [0, 1, 3, 4, 6]], top_s, cfg.iou_thr,
                         post_max_size=cfg.max_out,
                         valid=top_s > cfg.score_thr)
        safe = idx.clamp(min=0)
        b = bx.gather(1, safe[..., None].expand(*safe.shape, 7))
        s = torch.where(idx >= 0, top_s.gather(1, safe), 0.0)
        outs.append((b, s, torch.full(s.shape, ci, dtype=torch.int32,
                                      device=s.device), idx >= 0))
    return dict(boxes=torch.cat([o[0] for o in outs], 1),
                scores=torch.cat([o[1] for o in outs], 1),
                labels=torch.cat([o[2] for o in outs], 1),
                valid=torch.cat([o[3] for o in outs], 1))
