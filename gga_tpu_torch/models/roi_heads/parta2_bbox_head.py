"""PartA2's RoI bbox head (port of
``gga_tpu/models/roi_heads/parta2_bbox_head.py``; mmdet3d's
parta2_bbox_head.py:26): the pooled RoI grids through masked 3-D convs,
a 2x2x2 max pool, shared FC layers, an IoU-score cls branch and a
canonical box refinement branch, with the corner loss.

As gga_tpu computes them, the reference's submanifold convs over the
pooled grids are dense 3-D convs of zero-padded grids whose output is
masked to the occupied cells (a zero input contributes nothing, as
spconv's misses), so the product is ``F.conv3d`` (cuDNN on the card):
gga_tpu leaves it to XLA, not to a Pallas kernel. Grids are
channel-last ``[R, X, Y, Z, C]`` as in gga_tpu; each conv sees an NCDHW
view of them. The flattened [R, 7, 7, 7, C] grid keeps gga_tpu's
(x, y, z, c) order, so ``shared_fc.0`` holds gga_tpu's matrix
transposed (mmdet3d flattens (c, x, y, z)).

Module names follow mmdet3d (``conv_part``, ``conv_seg``,
``conv_down.merge_conv`` / ``down_conv``, ``shared_fc``, ``conv_cls``,
``conv_reg``, a Dropout at its index where mmdet3d puts one); the dense
convs and linear layers keep torch's own weight layouts.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.coders import delta_decode, delta_encode
from ...core.geometry import corners_3d
from ..layers import BatchNorm2d, MaskedBatchNorm


@dataclasses.dataclass(frozen=True)
class PartA2BboxConfig:
    num_classes: int = 3
    seg_in_channels: int = 16
    part_in_channels: int = 4
    seg_conv_channels: Tuple[int, ...] = (64, 64)
    part_conv_channels: Tuple[int, ...] = (64, 64)
    merge_conv_channels: Tuple[int, ...] = (128, 128)
    down_conv_channels: Tuple[int, ...] = (128, 256)
    shared_fc_channels: Tuple[int, ...] = (256, 512, 512, 512)
    cls_channels: Tuple[int, ...] = (256, 256)
    reg_channels: Tuple[int, ...] = (256, 256)
    dropout_ratio: float = 0.1
    roi_feat_size: int = 14
    with_corner_loss: bool = True
    # rcnn train cfg (configs/_base_/models/parta2.py:188-189)
    cls_pos_thr: float = 0.75
    cls_neg_thr: float = 0.25
    loss_bbox_weight: float = 1.0
    loss_cls_weight: float = 1.0


class SubMConvDense(nn.Sequential):
    """A submanifold conv on occupancy-masked dense grids: a 3x3x3 conv
    (no bias) of the zero-padded grid, masked to the occupied cells, then
    the masked BN (eps 1e-3, momentum 0.01) and a ReLU (children ``0``
    conv, ``1`` norm)."""

    def __init__(self, in_channels, out_channels):
        super().__init__(nn.Conv3d(in_channels, out_channels, 3, padding=1,
                                   bias=False),
                         MaskedBatchNorm(out_channels))

    def forward(self, x, occ):
        """x [R, X, Y, Z, C]; occ [R, X, Y, Z] -> [R, X, Y, Z, D]."""
        conv, bn = self[0], self[1]
        y = conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        y = torch.where(occ[..., None], y, 0.0)
        return F.relu(bn(y, occ))


def sparse_max_pool_dense(x, occ):
    """SparseMaxPool3d(2, 2): the max over a window's occupied cells and
    the union of their occupancy. x [R, X, Y, Z, C] -> [R, X/2, Y/2, Z/2,
    C]."""
    neg = torch.finfo(x.dtype).min
    xm = torch.where(occ[..., None], x, neg).permute(0, 4, 1, 2, 3)
    pooled = F.max_pool3d(xm, 2, 2).permute(0, 2, 3, 4, 1)
    occ_out = F.max_pool3d(occ[:, None].float(), 2, 2)[:, 0] > 0
    return torch.where(occ_out[..., None], pooled, 0.0), occ_out


class BatchNorm1d(BatchNorm2d):
    """flax's ``nn.BatchNorm`` on [N, C] (``layers.BatchNorm2d`` on a
    1x1 map)."""

    def forward(self, x):
        return super().forward(x[..., None, None])[..., 0, 0]


class FCModule(nn.Module):
    """mmcv's ConvModule of a 1x1 Conv1d + BN1d + ReLU, as a linear layer
    (no bias) + BN + ReLU (children ``conv``, ``bn``)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv = nn.Linear(in_channels, out_channels, bias=False)
        self.bn = BatchNorm1d(out_channels)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Dropout(nn.Module):
    """Dropout with the keep mask given by the caller (the trainer's
    generator draws it, as gga_tpu's 'dropout' rng): ``x / (1 - p)``
    where kept, 0 elsewhere, as flax's; the identity without a mask."""

    def __init__(self, p):
        super().__init__()
        self.p = p

    def forward(self, x, keep=None):
        return x if keep is None else torch.where(keep, x / (1 - self.p),
                                                  0.0)


class PartA2BboxHead(nn.Module):
    """``roi_size``: the side of the pooled grids (the RoI head's
    ``roi_out_size``; ``cfg.roi_feat_size`` by default). The first shared
    FC takes the last down conv's width times (roi_size / 2)^3 inputs, as
    gga_tpu's flax layer infers them."""

    def __init__(self, cfg: PartA2BboxConfig, roi_size=None):
        super().__init__()
        c = cfg
        self.cfg = cfg

        def convs(in_ch, chans):
            layers = []
            for ch in chans:
                layers.append(SubMConvDense(in_ch, ch))
                in_ch = ch
            return nn.ModuleList(layers), in_ch

        self.conv_part, part_ch = convs(c.part_in_channels,
                                        c.part_conv_channels)
        self.conv_seg, seg_ch = convs(c.seg_in_channels, c.seg_conv_channels)
        merge, ch = convs(part_ch + seg_ch, c.merge_conv_channels)
        down, ch = convs(ch, c.down_conv_channels)
        self.conv_down = nn.ModuleDict(dict(merge_conv=merge, down_conv=down))
        fc = []
        side = (c.roi_feat_size if roi_size is None else roi_size) // 2
        pre = ch * side ** 3
        n_fc = len(c.shared_fc_channels)
        for k in range(1, n_fc):
            fc.append(FCModule(pre, c.shared_fc_channels[k]))
            pre = c.shared_fc_channels[k]
            if k != n_fc - 1 and c.dropout_ratio > 0:
                fc.append(Dropout(c.dropout_ratio))
        self.shared_fc = nn.ModuleList(fc)

        def branch(chans, out_ch):
            layers, ch = [], pre
            for width in chans:
                layers.append(FCModule(ch, width))
                ch = width
            layers.append(nn.Linear(ch, out_ch))
            layers.insert(1, Dropout(c.dropout_ratio))
            return nn.ModuleList(layers)

        self.conv_cls = branch(c.cls_channels, 1)
        self.conv_reg = branch(c.reg_channels, 7)

    def dropout_widths(self):
        """The widths of the layers a dropout follows, in forward order
        (the shared FCs', then the cls and reg branches' first); empty at
        ratio 0."""
        c = self.cfg
        if c.dropout_ratio <= 0:
            return []
        return (list(c.shared_fc_channels[1:-1])
                + [c.cls_channels[0], c.reg_channels[0]])

    def forward(self, seg_grids, part_grids, occ, keep=None):
        """seg_grids [R, S, S, S, Cs]; part_grids [R, S, S, S, Cp]; occ
        [R, S, S, S]; keep: the dropout keep masks [R, width] in the
        order of ``dropout_widths`` (train mode), or None.

        Returns (cls_score [R, 1], bbox_pred [R, 7])."""
        x_part = part_grids
        for m in self.conv_part:
            x_part = m(x_part, occ)
        x_seg = seg_grids
        for m in self.conv_seg:
            x_seg = m(x_seg, occ)
        x = torch.cat([x_seg, x_part], -1)
        for m in self.conv_down['merge_conv']:
            x = m(x, occ)
        x, occ2 = sparse_max_pool_dense(x, occ)
        for m in self.conv_down['down_conv']:
            x = m(x, occ2)
        x = x.reshape(x.shape[0], -1)
        masks = iter(keep or [])
        for m in self.shared_fc:
            x = m(x, next(masks, None)) if isinstance(m, Dropout) else m(x)

        def branch(layers, mask):
            h = layers[0](x)
            if self.cfg.dropout_ratio > 0:
                h = layers[1](h, mask)
            for m in layers[2:]:
                h = m(h)
            return h

        cls_mask, reg_mask = next(masks, None), next(masks, None)
        return branch(self.conv_cls, cls_mask), branch(self.conv_reg,
                                                       reg_mask)


def _canonical_anchor(rois):
    """The RoI as the anchor of its own frame: centre 0, yaw 0."""
    return torch.cat([torch.zeros_like(rois[..., :3]), rois[..., 3:6],
                      torch.zeros_like(rois[..., 6:7])], -1)


@torch.no_grad()
def canonical_targets(cfg: PartA2BboxConfig, rois, gt_of_roi, ious,
                      pos_mask, roi_valid):
    """The IoU-derived cls target and the canonical-frame box targets of
    the positives (_get_target_single, parta2_bbox_head.py:405-467).

    Args ([..., R] leading dims): rois [.., 7]; gt_of_roi [.., 7] the GT
        box of each RoI; ious; pos_mask / roi_valid bool.
    Returns dict(label, label_weights, bbox_targets [.., 7], reg_mask).
    """
    label = (ious > cfg.cls_pos_thr).float()
    interval = (ious >= cfg.cls_neg_thr) & (ious <= cfg.cls_pos_thr)
    label = torch.where(interval, (ious - cfg.cls_neg_thr)
                        / (cfg.cls_pos_thr - cfg.cls_neg_thr), label)
    roi_ry = rois[..., 6] % (2 * np.pi)
    rel = gt_of_roi[..., :3] - rois[..., :3]
    c, s = torch.cos(-roi_ry), torch.sin(-roi_ry)
    lx = rel[..., 0] * c - rel[..., 1] * s
    ly = rel[..., 0] * s + rel[..., 1] * c
    ry = (gt_of_roi[..., 6] - roi_ry) % (2 * np.pi)
    opposite = (ry > np.pi * 0.5) & (ry < np.pi * 1.5)
    ry = torch.where(opposite, (ry + np.pi) % (2 * np.pi), ry)
    ry = torch.where(ry > np.pi, ry - 2 * np.pi, ry)
    ry = ry.clamp(-np.pi / 2, np.pi / 2)
    gt_ct = torch.cat([torch.stack([lx, ly, rel[..., 2]], -1),
                       gt_of_roi[..., 3:6], ry[..., None]], -1)
    targets = delta_encode(gt_ct, _canonical_anchor(rois))
    reg_mask = pos_mask & roi_valid
    return dict(label=label, label_weights=roi_valid.float(),
                bbox_targets=torch.where(reg_mask[..., None], targets, 0.0),
                reg_mask=reg_mask)


def decode_refined(rois, bbox_pred):
    """Canonical-frame predictions back to lidar boxes
    (parta2_bbox_head.loss:341-356, get_bboxes)."""
    ct = delta_decode(bbox_pred, _canonical_anchor(rois))
    ry = rois[..., 6]
    c, s = torch.cos(ry), torch.sin(ry)
    x = ct[..., 0] * c - ct[..., 1] * s + rois[..., 0]
    y = ct[..., 0] * s + ct[..., 1] * c + rois[..., 1]
    z = ct[..., 2] + rois[..., 2]
    return torch.cat([torch.stack([x, y, z], -1), ct[..., 3:6],
                      (ct[..., 6] + ry)[..., None]], -1)


def _corners(boxes):
    return corners_3d(boxes[..., :3], boxes[..., 3:6], boxes[..., 6])


def corner_loss_lidar(pred_boxes, gt_boxes, delta=1.0):
    """Huber distance of the corners, the GT's heading flip taken where it
    is nearer (get_corner_loss_lidar:471-506). Returns [...]."""
    pc = _corners(pred_boxes)
    gc = _corners(gt_boxes)
    flipped = torch.cat([gt_boxes[..., :6], gt_boxes[..., 6:] + np.pi], -1)
    gcf = _corners(flipped)
    d = torch.minimum(torch.linalg.norm(pc - gc, dim=-1),
                      torch.linalg.norm(pc - gcf, dim=-1))     # [..., 8]
    quad = d.clamp(max=delta)
    return (0.5 * quad ** 2 + delta * (d - quad)).mean(-1)


def bbox_head_loss(cfg: PartA2BboxConfig, cls_score, bbox_pred, rois,
                   targets):
    """The batch's RCNN loss (parta2_bbox_head.loss:291-363): BCE of the
    IoU-score over the valid RoIs, smooth-L1 (beta 1/9) of the canonical
    deltas and the corner loss over the positives. Inputs [B, R, ...].
    Returns (total, logs)."""
    label = targets['label']
    lw = targets['label_weights']
    lw = lw / lw.sum().clamp(min=1.0)
    logits = cls_score[..., 0]
    bce = (logits.clamp(min=0) - logits * label
           + torch.log1p(torch.exp(-logits.abs())))
    loss_cls = (bce * lw).sum() * cfg.loss_cls_weight

    reg_mask = targets['reg_mask']
    bw = reg_mask.float()
    bw = bw / bw.sum().clamp(min=1.0)
    diff = bbox_pred - targets['bbox_targets']
    beta = 1.0 / 9.0
    sl1 = torch.where(diff.abs() < beta, 0.5 * diff ** 2 / beta,
                      diff.abs() - 0.5 * beta)
    loss_bbox = (sl1 * bw[..., None]).sum() * cfg.loss_bbox_weight

    logs = dict(loss_rcnn_cls=loss_cls, loss_rcnn_bbox=loss_bbox)
    total = loss_cls + loss_bbox
    if cfg.with_corner_loss:
        cl = corner_loss_lidar(decode_refined(rois, bbox_pred),
                               targets['gt_of_roi'])
        logs['loss_rcnn_corner'] = ((cl * reg_mask).sum()
                                    / reg_mask.sum().clamp(min=1).float())
        total = total + logs['loss_rcnn_corner']
    logs['loss_rcnn'] = total
    return total, logs
