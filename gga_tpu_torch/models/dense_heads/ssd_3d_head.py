"""3DSSD's anchor-free head (port of ``gga_tpu/models/dense_heads/
ssd_3d_head.py``; mmdet3d's SSD3DHead with AnchorFreeBBoxCoder), batched
over scenes: the candidates are the F-FPS half of the last set
abstraction's seeds; a vote module (offsets only, clamped to
``vote_xyz_range``) moves them; a 'spec' multi-scale grouping pools ALL
seeds around the votes; shared convs then predict per-class centerness
logits and the (centre offset, half sizes, direction bins and residuals)
regression. Losses: BCE of the centerness on its soft min / max face
ratio targets, smooth-L1 of centre, size, direction residual, corners and
votes, cross-entropy of the direction class.

The module carries mmdet3d's state_dict names (``vote_module.vote_conv``
/ ``conv_out``, ``vote_aggregation.mlps``, ``conv_pred.shared_convs`` /
``cls_convs`` / ``conv_cls`` / ``reg_convs`` / ``conv_reg``).

gga_tpu's documented test-time delta stays: each box takes the label of
its largest class score, not one copy a class (``per_class_proposal``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.geometry import points_in_rbbox
from ...core.nms import aligned_3d_nms
from ..backbones.pointnet2 import PointConv, PointSAModuleMSG, SharedMLP
from ..losses import smooth_l1_loss
from ..roi_heads.parta2_bbox_head import _corners
from .vote_head import _mod, _take


@dataclasses.dataclass(frozen=True)
class SSD3DConfig:
    num_classes: int = 1
    num_dir_bins: int = 12
    in_channels: int = 256
    num_candidates: int = 256       # vote_module_cfg.num_points
    vote_conv_channels: Tuple[int, ...] = (128,)
    vote_xyz_range: Tuple[float, float, float] = (3.0, 3.0, 2.0)
    agg_radii: Tuple[float, ...] = (4.8, 6.4)
    agg_samples: Tuple[int, ...] = (16, 32)
    agg_mlps: Sequence[Tuple[int, ...]] = (
        (256, 256, 256, 512), (256, 256, 512, 1024))
    shared_conv_channels: Tuple[int, ...] = (512, 128)
    cls_conv_channels: Tuple[int, ...] = (128,)
    reg_conv_channels: Tuple[int, ...] = (128,)
    # train cfg (configs/_base_/models/3dssd.py:71-72)
    pos_distance_thr: float = 10.0
    expand_dims_length: float = 0.05
    # test cfg
    nms_thr: float = 0.1
    score_thr: float = 0.0
    max_out: int = 100


class VoteModule(nn.Module):
    def __init__(self, cfg: SSD3DConfig, in_channels):
        super().__init__()
        self.vote_conv = SharedMLP(in_channels, cfg.vote_conv_channels,
                                   prefix='')
        self.conv_out = PointConv(cfg.vote_conv_channels[-1], 3, bias=True)


class ConvPred(nn.Module):
    def __init__(self, cfg: SSD3DConfig, in_channels):
        super().__init__()
        self.shared_convs = SharedMLP(in_channels, cfg.shared_conv_channels)
        ch = cfg.shared_conv_channels[-1]
        self.cls_convs = SharedMLP(ch, cfg.cls_conv_channels)
        self.conv_cls = PointConv(cfg.cls_conv_channels[-1], cfg.num_classes,
                                  bias=True)
        self.reg_convs = SharedMLP(ch, cfg.reg_conv_channels)
        self.conv_reg = PointConv(cfg.reg_conv_channels[-1],
                                  6 + 2 * cfg.num_dir_bins, bias=True)


class SSD3DHead(nn.Module):
    """``in_channels``: the seeds' width, the encoder's last (gga_tpu's
    flax modules infer it; ``SSD3DConfig.in_channels`` is the shipped
    config's 256)."""

    def __init__(self, cfg: SSD3DConfig, in_channels):
        super().__init__()
        self.cfg = cfg
        self.vote_module = VoteModule(cfg, in_channels)
        self.vote_aggregation = PointSAModuleMSG(
            cfg.num_candidates, cfg.agg_radii, cfg.agg_samples,
            in_channels, cfg.agg_mlps)
        self.conv_pred = ConvPred(cfg, self.vote_aggregation.out_channels)

    def forward(self, feat_dict):
        """feat_dict: ``PointNet2SAMSG``'s. The candidates are the first
        ``num_candidates`` seeds of the last level (its F-FPS half).
        Returns gga_tpu's prediction dict (all [B, S, ...])."""
        c = self.cfg
        seed_xyz = feat_dict['sa_xyz'][-1]
        seed_feat = feat_dict['sa_features'][-1]
        seed_valid = feat_dict['sa_valid'][-1]
        n = c.num_candidates
        cand_xyz, cand_feat = seed_xyz[:, :n], seed_feat[:, :n]
        cand_valid = seed_valid[:, :n]

        vm = self.vote_module
        offset = vm.conv_out(vm.vote_conv(cand_feat, cand_valid))
        rng3 = torch.tensor(c.vote_xyz_range, dtype=offset.dtype,
                            device=offset.device)
        offset = torch.clamp(offset, -rng3, rng3)
        vote_xyz = cand_xyz + offset

        agg_xyz, agg_feat, agg_valid = self.vote_aggregation(
            seed_xyz, seed_feat, seed_valid, target_xyz=vote_xyz,
            target_valid=cand_valid)

        cp = self.conv_pred
        y = cp.shared_convs(agg_feat, agg_valid)
        obj = cp.conv_cls(cp.cls_convs(y, agg_valid))
        reg = cp.conv_reg(cp.reg_convs(y, agg_valid))
        b = c.num_dir_bins
        return dict(seed_xyz=cand_xyz, seed_valid=cand_valid,
                    vote_offset=offset, vote_xyz=vote_xyz,
                    agg_xyz=agg_xyz, agg_valid=agg_valid, obj=obj,
                    center_offset=reg[..., :3],
                    center=agg_xyz.detach() + reg[..., :3],
                    size=reg[..., 3:6], dir_cls=reg[..., 6:6 + b],
                    dir_res_norm=reg[..., 6 + b:])


def _angle2class(yaw, num_bins):
    """PartialBinBasedBBoxCoder.angle2class (bin centres at k 2 pi / N):
    (class int64, residual to the bin's centre)."""
    bin_w = 2 * np.pi / num_bins
    shifted = _mod(_mod(yaw, 2 * np.pi) + bin_w / 2, 2 * np.pi)
    cls = torch.div(shifted, bin_w, rounding_mode='floor').to(
        torch.int32).clamp(0, num_bins - 1).long()
    res = shifted - (cls.float() * bin_w + bin_w / 2)
    return cls, res


@torch.no_grad()
def ssd3d_targets(cfg: SSD3DConfig, gt_boxes, gt_labels, gt_valid, agg_xyz,
                  seed_xyz):
    """get_targets_single (ssd_3d_head.py:309) of every scene: each
    proposal's box (the first that holds it), its centerness, and the
    votes' targets from seeds inside the boxes enlarged by
    ``expand_dims_length``.

    Args:
        gt_boxes: [B, G, 7] lidar bottom-centre; gt_labels [B, G];
            gt_valid [B, G]; agg_xyz [B, S, 3]; seed_xyz [B, S, 3].
    Returns gga_tpu's target dict ([B, S, ...]).
    """
    grav = torch.cat([gt_boxes[..., :2],
                      (gt_boxes[..., 2] + gt_boxes[..., 5] / 2)[..., None]],
                     -1)
    size_res = gt_boxes[..., 3:6] / 2
    dir_cls_t, dir_res_t = _angle2class(gt_boxes[..., 6], cfg.num_dir_bins)
    dir_res_t = dir_res_t / (2 * np.pi / cfg.num_dir_bins)

    inbox = points_in_rbbox(agg_xyz, gt_boxes) & gt_valid[:, None, :]
    assign = inbox.to(torch.uint8).argmax(-1)          # the first, else 0

    center_t = _take(grav, assign)
    size_t = _take(size_res, assign)
    mask_t = _take(gt_labels, assign).long().clamp(0, cfg.num_classes - 1)
    corners = _take(_corners(gt_boxes), assign)            # [B, S, 8, 3]

    top_center = torch.cat([center_t[..., :2],
                            (center_t[..., 2] + size_t[..., 2])[..., None]],
                           -1)
    dist = torch.linalg.vector_norm(agg_xyz - top_center, dim=-1)
    hit = inbox.any(-1)
    positive = hit & (dist < cfg.pos_distance_thr)

    # centerness: the min / max face distance ratios in the box's frame
    rel = agg_xyz - center_t
    yaw = _take(gt_boxes[..., 6], assign)
    cs, sn = torch.cos(-yaw), torch.sin(-yaw)
    canon = torch.stack([rel[..., 0] * cs - rel[..., 1] * sn,
                         rel[..., 0] * sn + rel[..., 1] * cs, rel[..., 2]],
                        -1)
    near = (size_t - canon).clamp(min=0.0)
    far = (size_t + canon).clamp(min=0.0)
    ratio = torch.minimum(near, far) / torch.maximum(near, far).clamp(
        min=1e-8)
    ctr = (ratio.prod(-1).clamp(min=0.0) ** (1.0 / 3)).clamp(0.0, 1.0)
    onehot = F.one_hot(mask_t, cfg.num_classes).float()

    e = cfg.expand_dims_length
    enlarged = torch.cat([gt_boxes[..., :2], (gt_boxes[..., 2] - e)[..., None],
                          gt_boxes[..., 3:6] + 2 * e, gt_boxes[..., 6:]], -1)
    vin = points_in_rbbox(seed_xyz, enlarged) & gt_valid[:, None, :]
    vote_t = _take(grav, vin.to(torch.uint8).argmax(-1)) - seed_xyz
    return dict(center_targets=center_t, size_res_targets=size_t,
                dir_class_targets=_take(dir_cls_t, assign),
                dir_res_targets=_take(dir_res_t, assign),
                mask_targets=mask_t,
                centerness_targets=ctr[..., None] * onehot,
                corner_targets=corners, vote_targets=vote_t,
                vote_mask=vin.any(-1), positive=positive, negative=~hit)


def ssd3d_loss(cfg: SSD3DConfig, preds, gt_boxes, gt_labels, gt_valid):
    """The batch's loss (ssd_3d_head.py:115-220). Returns (total, logs):
    the seven terms, 'loss' and 'num_pos'."""
    t = ssd3d_targets(cfg, gt_boxes, gt_labels, gt_valid,
                      preds['agg_xyz'].detach(), preds['seed_xyz'].detach())
    pos = t['positive'].float()
    neg = t['negative'].float()
    ctr_w = (pos + neg)[..., None].expand_as(t['centerness_targets'])
    ctr_w = ctr_w / (ctr_w.sum() + 1e-6)
    logits = preds['obj']
    bce = (logits.clamp(min=0) - logits * t['centerness_targets']
           + torch.log1p(torch.exp(-logits.abs())))
    centerness_loss = (bce * ctr_w).sum()

    blw = pos / (pos.sum() + 1e-6)
    center_off_t = t['center_targets'] - preds['agg_xyz'].detach()
    center_loss = (smooth_l1_loss(preds['center_offset'], center_off_t)
                   * blw[..., None]).sum()

    logp = torch.log_softmax(preds['dir_cls'], -1)
    dir_class_loss = (-logp.gather(-1, t['dir_class_targets'][..., None])[
        ..., 0] * blw).sum()

    onehot = F.one_hot(t['dir_class_targets'], cfg.num_dir_bins).float()
    dir_res_loss = (smooth_l1_loss(
        preds['dir_res_norm'],
        t['dir_res_targets'][..., None].expand_as(preds['dir_res_norm']))
        * onehot * blw[..., None]).sum()

    size_loss = (smooth_l1_loss(preds['size'], t['size_res_targets'])
                 * blw[..., None]).sum()

    # corners of the boxes decoded with the TARGET direction class
    boxes = decode_ssd3d_boxes(cfg, preds, dir_onehot=onehot)
    corner_loss = (smooth_l1_loss(_corners(boxes), t['corner_targets'])
                   * blw[..., None, None]).sum()

    vmask = t['vote_mask'].float()
    vmask = vmask / (vmask.sum() + 1e-6)
    vote_loss = (smooth_l1_loss(preds['vote_offset'], t['vote_targets'])
                 * vmask[..., None]).sum()

    total = (centerness_loss + center_loss + dir_class_loss + dir_res_loss
             + size_loss + corner_loss + vote_loss)
    logs = dict(centerness_loss=centerness_loss, center_loss=center_loss,
                dir_class_loss=dir_class_loss, dir_res_loss=dir_res_loss,
                size_res_loss=size_loss, corner_loss=corner_loss,
                vote_loss=vote_loss, loss=total)
    logs['num_pos'] = pos.sum()
    return total, logs


def decode_ssd3d_boxes(cfg: SSD3DConfig, preds, dir_onehot=None):
    """AnchorFreeBBoxCoder.decode: the centre, the sizes twice the
    predicted halves (at least 0.1), the yaw of the direction bin (the
    predicted class where ``dir_onehot`` is None) plus its residual.
    Returns lidar bottom-centre boxes [B, S, 7]."""
    bin_w = 2 * np.pi / cfg.num_dir_bins
    if dir_onehot is None:
        dir_onehot = F.one_hot(preds['dir_cls'].argmax(-1),
                               cfg.num_dir_bins).float()
    dir_res = (preds['dir_res_norm'] * bin_w * dir_onehot).sum(-1)
    yaw = dir_onehot.argmax(-1).float() * bin_w + dir_res
    yaw = torch.where(yaw > np.pi, yaw - 2 * np.pi, yaw)
    dims = (preds['size'] * 2).clamp(min=0.1)
    center = preds['center']
    return torch.cat([center[..., :2],
                      (center[..., 2] - dims[..., 2] / 2)[..., None], dims,
                      yaw[..., None]], -1)


@torch.no_grad()
def decode_ssd3d(cfg: SSD3DConfig, preds):
    """get_bboxes + multiclass_nms_single (ssd_3d_head.py:442-540): the
    boxes and a class-aware NMS of their axis-aligned BEV extents (the
    corners' min / max; z neutralised, as the reference's NMS is 2-D).

    Returns dict(boxes [B, max_out, 7] bottom-centre lidar, scores,
    labels, valid): the kept boxes first by score, then the rest in the
    order of their indices, with score 0 and valid False."""
    sem = torch.sigmoid(preds['obj'])
    obj, labels = sem.amax(-1), sem.argmax(-1)
    boxes = decode_ssd3d_boxes(cfg, preds)
    corners = _corners(boxes)
    lo, hi = corners.amin(-2), corners.amax(-2)
    aligned = torch.cat([lo[..., :2], torch.zeros_like(lo[..., :1]),
                         hi[..., :2], torch.ones_like(hi[..., :1])], -1)
    keep = aligned_3d_nms(aligned, obj, labels, cfg.nms_thr,
                          valid=preds['agg_valid'] & (obj >= cfg.score_thr))
    order = torch.sort(torch.where(keep, -obj, math.inf), dim=-1,
                       stable=True).indices[..., :cfg.max_out]
    kept = keep.gather(-1, order)
    return dict(boxes=_take(boxes, order),
                scores=torch.where(kept, obj.gather(-1, order), 0.0),
                labels=labels.gather(-1, order), valid=kept)
