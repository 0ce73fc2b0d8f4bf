"""CenterPoint head, its static-shape box decoder and its fully supervised
targets and loss (port of ``gga_tpu/models/dense_heads/centerpoint_head.py``:
SeparateHead, DeformConv2d, DCNSeparateHead, CenterHead, decode_task,
get_task_detections, merge_task_detections, centerpoint_targets_single
batched over scenes, centerpoint_loss).

The head takes NCHW features and returns, per task, a dict of NHWC f32
maps, the layout gga_tpu's decoder reads. The targets render every class
map of every scene of a step in one heatmap launch
(``core.gaussian.render_class_heatmaps``).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...core.gaussian import (clip_sigmoid, gaussian_focal_loss,
                              gaussian_radius, render_class_heatmaps)
from ...core.nms import nms_bev
from ...ops.deform import deform_conv2d
from ..layers import Conv2d, ConvModule2d

COMMON_HEADS = dict(reg=(2, 2), height=(1, 2), dim=(3, 2), rot=(2, 2))


class SeparateHead(nn.Module):
    """Per-task branches: for each output, (num_conv - 1) ConvModules with
    conv bias, then a final conv with bias (heatmap bias starts at
    ``init_bias``). Children are named after the outputs, as mmdet3d's."""

    def __init__(self, in_channels, heads: Dict[str, Tuple[int, int]],
                 head_conv=64, final_kernel=3, init_bias=-2.19):
        super().__init__()
        self.heads = dict(heads)
        self.init_bias = init_bias
        for name, (out_ch, num_conv) in self.heads.items():
            layers = []
            ch = in_channels
            for _ in range(num_conv - 1):
                layers.append(ConvModule2d(ch, head_conv, final_kernel,
                                           bias=True))
                ch = head_conv
            layers.append(Conv2d(ch, out_ch, final_kernel,
                                 padding=final_kernel // 2, bias=True))
            self.add_module(name, nn.Sequential(*layers))

    def forward(self, x):
        """x [B, C, H, W] -> {name: [B, H, W, out] f32}."""
        return {name: getattr(self, name)(x).float().permute(0, 2, 3, 1)
                for name in self.heads}


class DeformConv2d(nn.Module):
    """mmcv's DeformConv2dPack (DCN v1): a conv ``conv_offset`` (zero at
    init, so the module starts as a plain conv) predicts each tap's
    (dy, dx), and the main kernel ``weight`` [Cout, Cin / groups, k, k]
    (no bias) reads the shifted bilinear samples."""

    def __init__(self, in_channels, out_channels, kernel_size=3, groups=1):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.zeros(
            out_channels, in_channels // groups, kernel_size, kernel_size))
        self.conv_offset = Conv2d(in_channels, 2 * kernel_size * kernel_size,
                                  kernel_size, padding=kernel_size // 2,
                                  bias=True)

    def forward(self, x):
        return deform_conv2d(x, self.conv_offset(x), self.weight,
                             self.groups)


class DCNSeparateHead(nn.Module):
    """mmdet3d's DCNSeparateHead: two deformable feature adapters split
    classification from regression; ``cls_head`` (ConvModule + final conv,
    bias ``init_bias``) reads the first for the heatmap, ``task_head`` (a
    SeparateHead of the box outputs) the second."""

    def __init__(self, in_channels, heads: Dict[str, Tuple[int, int]],
                 num_cls, head_conv=64, final_kernel=3, init_bias=-2.19,
                 dcn_groups=4):
        super().__init__()
        self.init_bias = init_bias
        self.feature_adapt_cls = DeformConv2d(in_channels, in_channels,
                                              groups=dcn_groups)
        self.feature_adapt_reg = DeformConv2d(in_channels, in_channels,
                                              groups=dcn_groups)
        self.cls_head = nn.Sequential(
            ConvModule2d(in_channels, head_conv, 3, bias=True),
            Conv2d(head_conv, num_cls, 3, padding=1, bias=True))
        self.task_head = SeparateHead(
            in_channels, {k: v for k, v in heads.items() if k != 'heatmap'},
            head_conv, final_kernel)

    def forward(self, x):
        """x [B, C, H, W] -> {name: [B, H, W, out] f32}."""
        out = self.task_head(self.feature_adapt_reg(x))
        hm = self.cls_head(self.feature_adapt_cls(x))
        out['heatmap'] = hm.float().permute(0, 2, 3, 1)
        return out

    @property
    def heatmap(self):
        """The heatmap branch (its last conv carries ``init_bias``)."""
        return self.cls_head


class CenterHead(nn.Module):
    """Shared 3x3 ConvModule then one SeparateHead (or, with
    ``dcn_head``, one DCNSeparateHead) per task.

    tasks: per-task class counts, e.g. (1, 1, 1) for the GGA
    Pedestrian/Cyclist/Car config. common_heads: {name: (channels,
    convs)} of the box outputs, by default ``COMMON_HEADS`` (CenterPoint's
    nuScenes configs add ``vel``)."""

    def __init__(self, in_channels=512, tasks: Sequence[int] = (1, 1, 1),
                 share_conv_channel=64, num_heatmap_convs=2, final_kernel=3,
                 common_heads=None, dcn_head=False):
        super().__init__()
        common = dict(common_heads or COMMON_HEADS)
        self.shared_conv = ConvModule2d(in_channels, share_conv_channel, 3,
                                        bias=True)
        if dcn_head:
            heads = [DCNSeparateHead(share_conv_channel, common, num_cls,
                                     final_kernel=final_kernel)
                     for num_cls in tasks]
        else:
            heads = [SeparateHead(share_conv_channel,
                                  dict(common,
                                       heatmap=(num_cls, num_heatmap_convs)),
                                  final_kernel=final_kernel)
                     for num_cls in tasks]
        self.task_heads = nn.ModuleList(heads)

    def forward(self, x):
        """x [B, C, H, W] -> list over tasks of dicts of NHWC maps."""
        x = self.shared_conv(x)
        return [head(x) for head in self.task_heads]


def decode_task(preds, *, voxel_size, pc_range, out_size_factor, max_num=100,
                score_threshold=0.1, post_center_range=None):
    """Static-shape CenterPoint box decode of one task.

    Top-k runs over the heatmap LOGITS: sigmoid is monotone, but saturates
    to exactly 1.0 in f32 and would then tie.

    Args:
        preds: dict of NHWC maps (heatmap pre-sigmoid, dim pre-exp).
    Returns dict: boxes [B, K, 7] (x, y, z_gravity, dx, dy, dz, yaw; and
        vx, vy where the task predicts ``vel``), scores, labels, valid,
        logits, each [B, K].
    """
    B, H, W, C = preds['heatmap'].shape
    logits, inds = torch.topk(preds['heatmap'].reshape(B, H * W * C),
                              max_num, dim=-1)
    scores = torch.sigmoid(logits)
    labels = inds % C
    loc = inds // C
    ys = (loc // W).float()
    xs = (loc % W).float()

    def gather(m):
        m = m.reshape(B, H * W, -1)
        return m.gather(1, loc[..., None].expand(-1, -1, m.shape[-1]))

    reg = gather(preds['reg'])
    xs = (xs + reg[..., 0]) * out_size_factor * voxel_size[0] + pc_range[0]
    ys = (ys + reg[..., 1]) * out_size_factor * voxel_size[1] + pc_range[1]
    hei = gather(preds['height'])[..., 0]
    dim = torch.exp(gather(preds['dim']))
    rot = gather(preds['rot'])
    yaw = torch.atan2(rot[..., 0], rot[..., 1])
    boxes = torch.stack([xs, ys, hei, dim[..., 0], dim[..., 1], dim[..., 2],
                         yaw], dim=-1)
    if 'vel' in preds:
        boxes = torch.cat([boxes, gather(preds['vel'])], -1)
    valid = scores > score_threshold
    if post_center_range is not None:
        pcr = torch.tensor(post_center_range, dtype=boxes.dtype,
                           device=boxes.device)
        valid &= (boxes[..., :3] >= pcr[:3]).all(-1)
        valid &= (boxes[..., :3] <= pcr[3:]).all(-1)
    return dict(boxes=boxes, scores=scores, labels=labels, valid=valid,
                logits=logits)


def get_task_detections(decoded, *, nms_thr=0.2, post_max_size=512):
    """Rotated-BEV NMS per scene, ranked by logit; returns the decoded dict
    with ``valid`` refined by NMS and entries reordered by score among the
    kept ones (padding at the end)."""
    boxes, logits = decoded['boxes'], decoded['logits']
    k = min(post_max_size, boxes.shape[1])
    idx, _ = nms_bev(boxes[..., [0, 1, 3, 4, 6]], logits, nms_thr,
                     post_max_size=k, valid=decoded['valid'])
    kept = idx >= 0
    safe = idx.clamp(min=0)

    def take(x):
        if x.dim() == 3:
            return x.gather(1, safe[..., None].expand(-1, -1, x.shape[-1]))
        return x.gather(1, safe)

    return dict(boxes=take(boxes),
                scores=torch.where(kept, take(decoded['scores']), 0.0),
                labels=take(decoded['labels']), valid=kept,
                logits=torch.where(kept, take(logits), -torch.inf))


def merge_task_detections(task_dets, task_num_classes):
    """Concatenate per-task detections, offsetting labels by the classes of
    earlier tasks and moving z from the gravity center to the bottom."""
    out = {key: [] for key in ('boxes', 'scores', 'labels', 'valid',
                               'logits')}
    flag = 0
    for det, ncls in zip(task_dets, task_num_classes):
        b = det['boxes'].clone()
        b[..., 2] -= b[..., 5] * 0.5
        out['boxes'].append(b)
        out['scores'].append(det['scores'])
        out['labels'].append(det['labels'] + flag)
        out['valid'].append(det['valid'])
        out['logits'].append(det.get('logits', det['scores']))
        flag += ncls
    return {key: torch.cat(v, dim=1) for key, v in out.items()}


# --------------------------------------------------------------- training
# Fully supervised CenterPoint targets and loss (mmdet3d CenterHead
# get_targets_single and loss): gaussian heatmaps at the GT centres, and a
# per-task regression target (sub-cell offset, gravity z, log dims,
# sin / cos yaw [, velocity]) at each object's cell.

def centerpoint_targets(gt_boxes, gt_labels, gt_valid, *, task_classes,
                        feat_hw, voxel_size, pc_range, out_size_factor,
                        gaussian_overlap=0.1, min_radius=2,
                        with_velocity=False):
    """gga_tpu's ``centerpoint_targets_single``, batched over scenes.

    Args:
        gt_boxes: [B, M, 7 (+2)] lidar BOTTOM-centre boxes (+ velocity);
            gt_labels [B, M] int global class ids; gt_valid [B, M] bool.
    Returns:
        list over tasks of dicts: heatmap [B, H, W, C_t] f32, ind [B, M]
        int64 (``cy * W + cx``, 0 where masked), anno_box [B, M, 8 or 10],
        mask [B, M] bool. All class maps of all scenes render in one
        heatmap launch.
    """
    H, W = feat_hw
    # times the f32 reciprocal of the cell size: XLA compiles gga_tpu's
    # division by that constant so, and the sub-cell offsets of the
    # regression target keep its rounding
    inv_fx = float(np.float32(1) / np.float32(voxel_size[0]
                                              * out_size_factor))
    inv_fy = float(np.float32(1) / np.float32(voxel_size[1]
                                              * out_size_factor))
    cx = (gt_boxes[..., 0] - pc_range[0]) * inv_fx
    cy = (gt_boxes[..., 1] - pc_range[1]) * inv_fy
    # truncation toward zero, as gga_tpu's astype(int32)
    cxi = cx.to(torch.int32).clamp(0, W - 1)
    cyi = cy.to(torch.int32).clamp(0, H - 1)
    inb = gt_valid & (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
    radius = gaussian_radius((gt_boxes[..., 4] * inv_fy,
                              gt_boxes[..., 3] * inv_fx), gaussian_overlap)
    radius = radius.to(torch.int32).clamp(min=min_radius)
    z_grav = gt_boxes[..., 2] + gt_boxes[..., 5] / 2
    anno = [torch.stack([cx - cxi, cy - cyi], -1), z_grav[..., None],
            torch.log(gt_boxes[..., 3:6].clamp(min=1e-6)),
            torch.stack([torch.sin(gt_boxes[..., 6]),
                         torch.cos(gt_boxes[..., 6])], -1)]
    if with_velocity:
        anno.append(gt_boxes[..., 7:9])
    anno_box = torch.cat(anno, -1)
    ind = (cyi * W + cxi).long()
    labels = gt_labels.long()
    hms = render_class_heatmaps(torch.stack([cxi, cyi], -1), radius,
                                labels, inb, sum(task_classes), (H, W))
    tasks, flag = [], 0
    for ncls in task_classes:
        tmask = inb & (labels >= flag) & (labels < flag + ncls)
        tasks.append(dict(
            heatmap=hms[flag:flag + ncls].permute(1, 2, 3, 0),
            ind=torch.where(tmask, ind, 0),
            anno_box=torch.where(tmask[..., None], anno_box, 0.0),
            mask=tmask))
        flag += ncls
    return tasks


def centerpoint_loss(preds, targets, *, code_weights,
                     loss_heatmap_weight=1.0, loss_bbox_weight=0.25):
    """Batched supervised loss: per task the gaussian focal loss of the
    clipped heatmap sigmoid over the positive count (pixels exactly 1.0),
    and the code-weighted L1 of the box outputs at the object cells over
    the object count. Returns (total, logs)."""
    total = 0.0
    logs = {}
    for t, (tp, tt) in enumerate(zip(preds, targets)):
        hm = clip_sigmoid(tp['heatmap'])
        num_pos = (tt['heatmap'] == 1.0).sum().float().clamp(min=1.0)
        l_hm = gaussian_focal_loss(hm, tt['heatmap']).sum() / num_pos
        keys = ['reg', 'height', 'dim', 'rot'] + (
            ['vel'] if 'vel' in tp else [])
        pred_map = torch.cat([tp[k] for k in keys], -1)
        B, H, W, C = pred_map.shape
        picked = pred_map.reshape(B, H * W, C).gather(
            1, tt['ind'][..., None].expand(-1, -1, C))
        m = tt['mask'].float()[..., None]
        cw = torch.tensor(code_weights[:C], dtype=torch.float32,
                          device=pred_map.device)
        l1 = (picked - tt['anno_box']).abs() * m * cw
        l_bbox = l1.sum() / m.sum().clamp(min=1.0)
        logs[f'task{t}.loss_heatmap'] = l_hm * loss_heatmap_weight
        logs[f'task{t}.loss_bbox'] = l_bbox * loss_bbox_weight
        total = (total + logs[f'task{t}.loss_heatmap']
                 + logs[f'task{t}.loss_bbox'])
    logs['loss'] = total
    return total, logs
