"""VoteNet head: voting module, vote aggregation, proposal head, targets,
loss and decode (port of ``gga_tpu/models/dense_heads/vote_head.py``;
mmdet3d's VoteHead + VoteModule + PartialBinBasedBBoxCoder as configured
by configs/_base_/models/votenet.py), batched over scenes.

The module carries mmdet3d's state_dict names (``vote_module.vote_conv``
/ ``conv_out``, ``vote_aggregation``, ``conv_pred.shared_convs`` /
``conv_cls`` / ``conv_reg``); the forward assembles gga_tpu's fused
prediction vector from ``conv_cls`` and ``conv_reg``: [objectness 2 |
center 3 | dir class b | dir residual b | size class s | size residual 3s
| semantic c], with ``conv_cls`` giving objectness and semantic and
``conv_reg`` the rest (gga_tpu's ``_votenet_pred_slices``).

gga_tpu's documented delta from mmdet3d stays: the vote loss is the
minimum over ALL the boxes that contain a seed, not over mmdet3d's first
``gt_per_seed=3`` of them (the same where a seed lies in at most 3
boxes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ...core.geometry import points_in_rbbox
from ...core.nms import aligned_3d_nms
from ..backbones.pointnet2 import PointConv, PointSAModule, SharedMLP
from ..losses import axis_aligned_iou_loss, smooth_l1_loss

# SUN RGB-D 10-class mean sizes (sunrgbd partial-bin coder config)
SUNRGBD_MEAN_SIZES = (
    (2.114256, 1.620300, 0.927272), (0.791118, 1.279516, 0.718529),
    (0.923508, 1.867419, 0.845495), (0.591958, 0.552978, 0.827272),
    (0.699104, 0.454178, 0.75625), (0.69519, 1.346299, 0.736364),
    (0.528526, 1.002642, 1.172878), (0.500618, 0.632163, 0.683424),
    (0.404671, 1.071108, 1.688889), (0.76584, 1.398258, 0.472728))


@dataclasses.dataclass(frozen=True)
class VoteHeadConfig:
    num_classes: int = 10
    num_dir_bins: int = 12
    mean_sizes: Tuple[Tuple[float, float, float], ...] = SUNRGBD_MEAN_SIZES
    with_rot: bool = True
    in_channels: int = 256
    vote_conv_channels: Tuple[int, ...] = (256, 256)
    agg_num_point: int = 256
    agg_radius: float = 0.3
    agg_num_sample: int = 16
    agg_mlp: Tuple[int, ...] = (128, 128, 128)
    pred_conv_channels: Tuple[int, ...] = (128, 128)
    max_objs: int = 64
    pos_distance_thr: float = 0.3
    neg_distance_thr: float = 0.6
    # loss weights (votenet.py base config)
    vote_loss_weight: float = 10.0
    objectness_weight: float = 5.0
    center_loss_weight: float = 10.0
    dir_class_weight: float = 1.0
    dir_res_weight: float = 10.0
    size_class_weight: float = 1.0
    size_res_weight: float = 10.0 / 3.0
    semantic_weight: float = 1.0
    # optional axis-aligned IoU loss on positive proposals against their
    # assigned box (votenet_iouloss_8x8_scannet: weight 10/3)
    iou_loss_weight: float = 0.0
    # test cfg
    nms_thr: float = 0.25
    score_thr: float = 0.05
    max_out: int = 64

    @property
    def num_sizes(self):
        return len(self.mean_sizes)

    @property
    def n_reg(self):
        """conv_reg's channels: center, dir class and residual, size
        class and residual."""
        return 3 + 2 * self.num_dir_bins + 4 * self.num_sizes


class VoteModule(nn.Module):
    def __init__(self, cfg: VoteHeadConfig):
        super().__init__()
        self.vote_conv = SharedMLP(cfg.in_channels, cfg.vote_conv_channels,
                                   prefix='')
        self.conv_out = PointConv(cfg.vote_conv_channels[-1],
                                  3 + cfg.in_channels, bias=True)


class ConvPred(nn.Module):
    def __init__(self, cfg: VoteHeadConfig):
        super().__init__()
        self.shared_convs = SharedMLP(cfg.agg_mlp[-1], cfg.pred_conv_channels)
        ch = cfg.pred_conv_channels[-1]
        self.conv_cls = PointConv(ch, 2 + cfg.num_classes, bias=True)
        self.conv_reg = PointConv(ch, cfg.n_reg, bias=True)


class VoteHead(nn.Module):
    def __init__(self, cfg: VoteHeadConfig):
        super().__init__()
        self.cfg = cfg
        self.vote_module = VoteModule(cfg)
        self.vote_aggregation = PointSAModule(
            cfg.agg_num_point, cfg.agg_radius, cfg.agg_num_sample,
            cfg.in_channels, cfg.agg_mlp, conv2d=False)
        self.conv_pred = ConvPred(cfg)

    def forward(self, feat_dict, sample_idx=None):
        """feat_dict: ``PointNet2SASSG``'s (fp_xyz / fp_features /
        fp_valid); ``sample_idx`` [B, agg_num_point] the aggregation's
        centres among the votes, sampled when None (the indices are kept
        in ``vote_aggregation.last_idx``). Returns the proposal dict of
        gga_tpu's VoteHead (all [B, S, ...])."""
        c = self.cfg
        seed_xyz = feat_dict['fp_xyz']
        seed_feat = feat_dict['fp_features']
        seed_valid = feat_dict['fp_valid']

        # voting: MLP -> (offset, feature residual); the vote feature
        # rescaled to the seed feature's norm
        vm = self.vote_module
        out = vm.conv_out(vm.vote_conv(seed_feat, seed_valid))
        offset = out[..., :3]
        vote_xyz = seed_xyz + offset
        vote_feat = seed_feat + out[..., 3:]
        vote_feat = vote_feat * (
            torch.linalg.vector_norm(seed_feat, dim=-1, keepdim=True)
            / torch.linalg.vector_norm(vote_feat, dim=-1,
                                       keepdim=True).clamp(min=1e-6))

        agg_xyz, agg_feat, agg_valid = self.vote_aggregation(
            vote_xyz, vote_feat, seed_valid, sample_idx)

        cp = self.conv_pred
        y = cp.shared_convs(agg_feat, agg_valid)
        cls, reg = cp.conv_cls(y), cp.conv_reg(y)
        b, s = c.num_dir_bins, c.num_sizes
        i = 3
        dir_cls = reg[..., i:i + b]
        i += b
        dir_res_norm = reg[..., i:i + b]
        i += b
        size_cls = reg[..., i:i + s]
        i += s
        size_res_norm = reg[..., i:i + 3 * s].reshape(*reg.shape[:-1], s, 3)
        return dict(seed_xyz=seed_xyz, seed_valid=seed_valid,
                    vote_offset=offset, vote_xyz=vote_xyz,
                    agg_xyz=agg_xyz, agg_valid=agg_valid,
                    agg_feats=agg_feat,
                    obj=cls[..., :2], center=agg_xyz + reg[..., :3],
                    dir_cls=dir_cls, dir_res_norm=dir_res_norm,
                    size_cls=size_cls, size_res_norm=size_res_norm,
                    sem=cls[..., 2:])


def _mod(x, y):
    """``jnp.mod`` (the divisor's sign) for y > 0: fmod, then + y where
    the remainder is negative."""
    r = torch.fmod(x, y)
    return torch.where(r < 0, r + y, r)


def _take(x, idx):
    """x [B, M, ...] gathered at idx [B, S] -> [B, S, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _encode_gt(cfg: VoteHeadConfig, gt_boxes, gt_labels):
    """PartialBinBasedBBoxCoder.encode (gga_tpu ``_encode_gt``): gravity
    centres, size class = label, size residual against the mean size,
    direction bin + residual."""
    centers = torch.cat([gt_boxes[..., :2],
                         (gt_boxes[..., 2] + gt_boxes[..., 5] / 2)[..., None]],
                        -1)
    size_cls = gt_labels.long().clamp(0, cfg.num_sizes - 1)
    mean = torch.tensor(cfg.mean_sizes, dtype=torch.float32,
                        device=gt_boxes.device)[size_cls]
    size_res = gt_boxes[..., 3:6] - mean
    if cfg.with_rot:
        yaw = _mod(gt_boxes[..., 6], 2 * np.pi)
        bin_w = 2 * np.pi / cfg.num_dir_bins
        dir_cls = (yaw / bin_w).to(torch.int32).clamp(
            0, cfg.num_dir_bins - 1).long()
        dir_res = yaw - (dir_cls.float() * bin_w + bin_w / 2)
    else:
        dir_cls = torch.zeros_like(size_cls)
        dir_res = torch.zeros_like(gt_boxes[..., 6])
    return centers, size_cls, size_res, dir_cls, dir_res


@torch.no_grad()
def build_targets(cfg: VoteHeadConfig, points, p_valid, agg_xyz, agg_valid,
                  gt_boxes, gt_labels, obj_valid):
    """Targets of a batch (gga_tpu ``build_targets`` vmapped over scenes).

    Args:
        points: [B, P, 3] seed points; p_valid [B, P]; agg_xyz: [B, S, 3]
            proposal centres; agg_valid [B, S]; gt_boxes: [B, M, 7]
            bottom-centre depth boxes; gt_labels [B, M]; obj_valid [B, M].
    Returns the dict of target tensors.
    """
    centers, size_cls_t, size_res_t, dir_cls_t, dir_res_t = _encode_gt(
        cfg, gt_boxes, gt_labels)
    centers = torch.where(obj_valid[..., None], centers, 1e6)

    # vote targets: offsets to every box that holds the seed (the loss
    # takes the minimum)
    inside = points_in_rbbox(points, gt_boxes) & obj_valid[:, None, :]
    vote_offsets = centers[:, None, :, :] - points[:, :, None, :3]
    vote_mask = inside.any(-1) & p_valid

    # proposal assignment: the nearest box centre
    d2 = ((agg_xyz[:, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)
    d2 = torch.where(obj_valid[:, None, :], d2, 1e12)
    assign = d2.argmin(-1)
    dist = torch.sqrt(d2.amin(-1) + 1e-6)
    objectness_t = (dist < cfg.pos_distance_thr).long()
    objectness_mask = ((dist < cfg.pos_distance_thr)
                       | (dist > cfg.neg_distance_thr)).float()
    objectness_mask = objectness_mask * agg_valid.float()

    mean = torch.tensor(cfg.mean_sizes, dtype=torch.float32,
                        device=gt_boxes.device)
    size_cls_a = _take(size_cls_t, assign)
    return dict(
        vote_offsets=vote_offsets, vote_inside=inside,
        vote_mask=vote_mask,
        center_targets=centers,
        assigned_center=_take(centers, assign),
        size_cls_t=size_cls_a,
        size_res_t=_take(size_res_t, assign) / mean[size_cls_a],
        dir_cls_t=_take(dir_cls_t, assign),
        dir_res_t=_take(dir_res_t, assign) / (np.pi / cfg.num_dir_bins),
        sem_t=_take(gt_labels.long().clamp(0, cfg.num_classes - 1), assign),
        objectness_t=objectness_t,
        objectness_mask=objectness_mask,
        gt_valid=obj_valid,
    )


def _ce(logits, labels):
    """Cross-entropy of each entry: -log_softmax(logits)[label]."""
    lp = torch.log_softmax(logits, -1)
    return -lp.gather(-1, labels[..., None])[..., 0]


def loss(cfg: VoteHeadConfig, preds, targets):
    """The batch's loss (gga_tpu ``loss``, mmdet3d vote_head.loss).

    Returns (total, logs): the eight terms, 'iou_loss' where
    ``iou_loss_weight``, 'loss' and 'num_pos'."""
    t = targets

    # vote loss: over the boxes that hold the seed, the least L1 distance
    # of the predicted offset to the offset of the box
    diff = (preds['vote_offset'][:, :, None, :]
            - t['vote_offsets']).abs().sum(-1)
    diff = torch.where(t['vote_inside'], diff, 1e9)
    vote_l = diff.amin(-1)
    vm = t['vote_mask'].float()
    vote_loss = ((vote_l * vm).sum() / vm.sum().clamp(min=1.0)
                 * cfg.vote_loss_weight)

    pos = t['objectness_t'].float()
    om = t['objectness_mask']
    n_mask = om.sum().clamp(min=1.0)
    n_pos = (pos * om).sum().clamp(min=1.0)

    # objectness CE with class weights (0.2, 0.8), 'sum' / mask count
    w = torch.where(t['objectness_t'] == 1, 0.8, 0.2)
    obj_ce = _ce(preds['obj'], t['objectness_t'])
    objectness_loss = ((obj_ce * w * om).sum() / n_mask
                       * cfg.objectness_weight)

    # centre chamfer, both directions
    d_pc = ((preds['center'][:, :, None, :]
             - t['center_targets'][:, None, :, :]) ** 2).sum(-1)
    gv = t['gt_valid'].float()
    d_pc = torch.where(t['gt_valid'][:, None, :], d_pc, 1e12)
    src = d_pc.amin(-1)         # proposal -> nearest box
    dst = torch.where((pos > 0)[:, :, None], d_pc, 1e12).amin(1)
    center_src = (src * pos * om).sum() / n_pos
    dst = torch.where(dst > 1e11, 0.0, dst)
    center_dst = (dst * gv).sum() / gv.sum().clamp(min=1.0)
    center_loss = (center_src + center_dst) * cfg.center_loss_weight

    def masked_ce(logits, labels):
        return (_ce(logits, labels) * pos * om).sum() / n_pos

    dir_class_loss = masked_ce(preds['dir_cls'],
                               t['dir_cls_t']) * cfg.dir_class_weight
    sem_loss = masked_ce(preds['sem'], t['sem_t']) * cfg.semantic_weight
    size_class_loss = masked_ce(preds['size_cls'],
                                t['size_cls_t']) * cfg.size_class_weight

    one_hot_dir = torch.nn.functional.one_hot(
        t['dir_cls_t'], cfg.num_dir_bins).float()
    dir_res_pred = (preds['dir_res_norm'] * one_hot_dir).sum(-1)
    dir_res_loss = ((smooth_l1_loss(dir_res_pred, t['dir_res_t']) * pos * om
                     ).sum() / n_pos * cfg.dir_res_weight)

    one_hot_size = torch.nn.functional.one_hot(
        t['size_cls_t'], cfg.num_sizes).float()
    size_res_pred = (preds['size_res_norm']
                     * one_hot_size[..., None]).sum(-2)      # [B, S, 3]
    size_res_loss = ((smooth_l1_loss(size_res_pred, t['size_res_t']).sum(-1)
                      * pos * om).sum() / n_pos * cfg.size_res_weight)

    logs = dict(vote_loss=vote_loss, objectness_loss=objectness_loss,
                center_loss=center_loss, dir_class_loss=dir_class_loss,
                dir_res_loss=dir_res_loss,
                size_class_loss=size_class_loss,
                size_res_loss=size_res_loss, semantic_loss=sem_loss)
    if cfg.iou_loss_weight:
        # axis-aligned IoU against the nearest box, both sizes decoded
        # with the TARGET size class (gga_tpu's documented delta from the
        # reference's decode-then-IoU)
        mean = torch.tensor(cfg.mean_sizes, dtype=torch.float32,
                            device=d_pc.device)
        mean_t = torch.einsum('bps,sc->bpc', one_hot_size, mean)
        pred_size = mean_t * (1.0 + size_res_pred)
        tgt_size = mean_t * (1.0 + t['size_res_t'])
        tgt_center = _take(t['center_targets'], d_pc.argmin(-1))

        def aabb(cc, ss):
            return torch.cat([cc - ss / 2, cc + ss / 2], -1)

        il = axis_aligned_iou_loss(
            aabb(preds['center'], pred_size.clamp(min=1e-4)),
            aabb(tgt_center, tgt_size.clamp(min=1e-4)))
        logs['iou_loss'] = ((il * pos * om).sum() / n_pos
                            * cfg.iou_loss_weight)
    total = sum(logs.values())
    logs['loss'] = total
    logs['num_pos'] = (pos * om).sum()
    return total, logs


@torch.no_grad()
def decode(cfg: VoteHeadConfig, preds):
    """Proposals -> boxes + class-aware aligned 3D NMS (gga_tpu
    ``decode``, mmdet3d vote_head.get_bboxes).

    Returns dict: boxes [B, max_out, 7] (bottom-centre depth), scores,
    labels, valid; the kept boxes by score first, the rest of the slots
    box 0 with score 0 and valid False."""
    obj_score = torch.softmax(preds['obj'], -1)[..., 1]
    sem_score = torch.softmax(preds['sem'], -1)
    center = preds['center']

    dir_bin = preds['dir_cls'].argmax(-1)
    bin_w = 2 * np.pi / cfg.num_dir_bins
    dir_res = (preds['dir_res_norm'].gather(-1, dir_bin[..., None])[..., 0]
               * (np.pi / cfg.num_dir_bins))
    yaw = ((dir_bin.float() * bin_w + bin_w / 2 + dir_res) if cfg.with_rot
           else torch.zeros_like(obj_score))

    size_bin = preds['size_cls'].argmax(-1)
    mean = torch.tensor(cfg.mean_sizes, dtype=torch.float32,
                        device=center.device)[size_bin]
    size_res = preds['size_res_norm'].gather(
        -2, size_bin[..., None, None].expand(*size_bin.shape, 1, 3))[
            ..., 0, :] * mean
    dims = (mean + size_res).clamp(min=0.01)
    boxes = torch.cat([center[..., :2],
                       (center[..., 2] - dims[..., 2] / 2)[..., None],
                       dims, yaw[..., None]], -1)

    labels = sem_score.argmax(-1)
    score = obj_score * sem_score.amax(-1)

    # axis-aligned corners for the NMS
    half = boxes[..., 3:6] / 2
    gz = boxes[..., 2] + half[..., 2]
    lo = torch.stack([boxes[..., 0] - half[..., 0],
                      boxes[..., 1] - half[..., 1], gz - half[..., 2]], -1)
    hi = torch.stack([boxes[..., 0] + half[..., 0],
                      boxes[..., 1] + half[..., 1], gz + half[..., 2]], -1)
    keep = aligned_3d_nms(torch.cat([lo, hi], -1), score, labels,
                          cfg.nms_thr,
                          valid=preds['agg_valid'] & (score > cfg.score_thr))
    order = torch.sort(torch.where(keep, -score, math.inf), dim=-1,
                       stable=True).indices[..., :cfg.max_out]
    idx = torch.arange(cfg.max_out, device=score.device)
    kept = idx < keep.sum(-1, keepdim=True)
    sel = torch.where(kept, order, 0)
    return dict(boxes=_take(boxes, sel),
                scores=torch.where(kept, score.gather(-1, sel), 0.0),
                labels=labels.gather(-1, sel), valid=kept)
