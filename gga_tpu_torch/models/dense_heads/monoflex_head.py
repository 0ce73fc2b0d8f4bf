"""MonoFlex monocular 3D head, its coder, targets, loss and decode (the
port of ``gga_tpu/models/dense_heads/monoflex_head.py``; the reference's
MonoFlexHead, MonoFlexCoder and EdgeFusionModule): a CenterNet-style
stride-4 head whose 50 regression channels hold the 2D box distances (4),
the centre offsets (2), 10 keypoints (20), the keypoint depths'
uncertainties (3), the dimensions (3), 4 orientation bins (8 logits + 8
offsets), a direct depth (1) and its uncertainty (1). Depth is solved
three ways (direct, and from the keypoints' pixel heights in two corner
groups and the top / bottom centres) and fused by inverse uncertainty.
A truncated object (its centre off the image) has its heatmap peak moved
to where the line to its 2D box centre crosses the image border, with an
ellipse gaussian; the edge fusion convolves the border's features into the
class and offset maps.

As gga_tpu (its parity note), the keypoint and 2D-box targets are at
FEATURE scale (divided by the stride), which makes the keypoint-depth
geometry exact. The heatmaps' float-radius ellipse and circle gaussians
are not what the TPU heatmap kernel computes (integer radii), and
gga_tpu renders them in XLA: here they are plain PyTorch, no kernel.
``jnp.round`` and ``torch.round`` both round half to even.

Maps are NHWC in the outputs. State_dict keys follow mmdet3d's head:
``conv_cls_prev.0``, ``conv_cls``, ``conv_reg_prevs.{g}.0``,
``conv_regs.{g}`` (g over ``GROUPS``), ``edge_fuse_cls`` and
``edge_fuse_reg`` (``edge_convs.0.conv`` / ``.bn``, ``edge_convs.1``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ...core.gaussian import (clip_sigmoid, gaussian_focal_loss,
                              gaussian_radius)
from ...core.geometry import corners_3d, project_to_image
from ..layers import BatchNorm2d
from ..losses import multibin_loss
from ..necks.dla_neck import ConvGN
from .smoke_head import CAM_ORIGIN, local_maxima, top_cells

KITTI_BASE_DIMS = ((3.8840, 1.5261, 1.6286, 0.4259, 0.1367, 0.1022),
                   (0.8423, 1.7607, 0.6602, 0.2349, 0.1133, 0.1427),
                   (1.7635, 1.7372, 0.5968, 0.1766, 0.0948, 0.1242))


@dataclasses.dataclass(frozen=True)
class MonoFlexConfig:
    num_classes: int = 3
    feat_channels: int = 256
    max_objs: int = 32
    # coder (test-pinned constants)
    depth_mode: str = 'exp'
    base_depth: Tuple[float, float] = (26.494627, 16.05988)
    depth_range: Tuple[float, float] = (0.1, 100.0)
    uncertainty_range: Tuple[float, float] = (-10.0, 10.0)
    base_dims: Tuple = KITTI_BASE_DIMS
    num_dir_bins: int = 4
    bin_centers: Tuple[float, ...] = (0.0, np.pi / 2, np.pi, -np.pi / 2)
    bin_margin: float = np.pi / 6
    # head
    use_edge_fusion: bool = True
    edge_heatmap_ratio: float = 0.125
    filter_outside_objs: bool = True
    down_ratio: int = 4
    # loss weights (head __init__ defaults, monoflex_head.py:90-101)
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 0.1
    loss_dir_weight: float = 0.1
    loss_keypoints_weight: float = 0.1
    loss_dims_weight: float = 0.1
    loss_offsets2d_weight: float = 0.1
    loss_direct_depth_weight: float = 0.1
    loss_keypoints_depth_weight: float = 0.1
    loss_combined_depth_weight: float = 0.1
    # test cfg (get_bboxes: topk 100, local-max kernel 3, score 0.25)
    topk: int = 100
    score_thr: float = 0.25


def edge_indices(feat_h, feat_w):
    """The border pixels (x, y) in mmdet3d's order: the left column top to
    bottom, the bottom row, the right column bottom to top, the top row
    right to left."""
    x_max, y_max = feat_w - 1, feat_h - 1
    left = np.stack([np.zeros(y_max), np.arange(y_max)], 1)
    bottom = np.stack([np.arange(x_max), np.full(x_max, y_max)], 1)
    right = np.stack([np.full(y_max, x_max), np.arange(y_max, 0, -1)], 1)
    top = np.stack([np.arange(x_max, 0, -1), np.zeros(x_max)], 1)
    return np.concatenate([left, bottom, right, top]).astype(np.int64)


class ConvBN1d(nn.Module):
    """1-D conv (3, no bias) + batch norm (flax's ``nn.BatchNorm``
    defaults but momentum 0.9: eps 1e-5, torch momentum 0.1) + ReLU
    (mmcv ConvModule: children ``conv`` and ``bn``)."""

    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv1d(channels, channels, 3, padding=1, bias=False)
        self.bn = BatchNorm2d(channels, eps=1e-5, momentum=0.1)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class EdgeFusionModule(nn.Module):
    """Gather the branch features along the border, ``ConvBN1d`` and a 1-D
    conv (1, bias), added into the output map at the border pixels (each
    once: ``edge_indices`` are distinct)."""

    def __init__(self, out_channels, feat_channels):
        super().__init__()
        self.edge_convs = nn.Sequential(
            ConvBN1d(feat_channels), nn.Conv1d(feat_channels, out_channels, 1))

    def forward(self, feat, fused):
        """feat [B, C, H, W] the branch's features; fused [B, out, H, W]."""
        H, W = feat.shape[2:]
        idx = torch.from_numpy(edge_indices(H, W)).to(feat.device)
        flat = idx[:, 1] * W + idx[:, 0]
        out = self.edge_convs(feat.flatten(2)[:, :, flat])     # [B, out, L]
        return fused.flatten(2).index_add(2, flat, out).view(fused.shape)


# the 50 regression channels (monoflex_bbox_coder.decode's order)
REG_SLICES = dict(bbox2d=(0, 4), offsets2d=(4, 6), keypoints=(6, 26),
                  kpt_depth_unc=(26, 29), dims=(29, 32),
                  ori_cls=(32, 40), ori_offset=(40, 48),
                  depth=(48, 49), depth_unc=(49, 50))
GROUPS = (('bbox2d', 4), ('offsets2d', 2), ('keypoints', 20),
          ('kpt_depth_unc', 3), ('dims', 3), ('ori', 16),
          ('depth', 1), ('depth_unc', 1))


class MonoFlexHead(nn.Module):
    """[B, C, H, W] stride-4 map -> dict(heatmap [B, H, W, classes], reg
    [B, H, W, 50]): a 3x3 conv + GroupNorm + ReLU branch a group and one
    for the classes (bias -2.19 when seeded), each with its 1x1 conv."""

    def __init__(self, cfg: MonoFlexConfig, in_channels):
        super().__init__()
        self.cfg = cfg
        fc, g = cfg.feat_channels, min(32, cfg.feat_channels)
        self.conv_cls_prev = nn.ModuleList([ConvGN(in_channels, fc, g)])
        self.conv_cls = nn.Conv2d(fc, cfg.num_classes, 1)
        self.conv_reg_prevs = nn.ModuleList(
            nn.ModuleList([ConvGN(in_channels, fc, g)]) for _ in GROUPS)
        self.conv_regs = nn.ModuleList(nn.Conv2d(fc, dim, 1)
                                       for _, dim in GROUPS)
        if cfg.use_edge_fusion:
            self.edge_fuse_cls = EdgeFusionModule(cfg.num_classes, fc)
            self.edge_fuse_reg = EdgeFusionModule(2, fc)

    def init_biases(self):
        with torch.no_grad():
            self.conv_cls.bias.fill_(-2.19)

    def forward(self, x):
        cls_feat = self.conv_cls_prev[0](x)
        hm = self.conv_cls(cls_feat)
        regs = []
        for (name, _), prev, out in zip(GROUPS, self.conv_reg_prevs,
                                        self.conv_regs):
            f = prev[0](x)
            r = out(f)
            if self.cfg.use_edge_fusion and name == 'offsets2d':
                r = self.edge_fuse_reg(f, r)
            regs.append(r)
        if self.cfg.use_edge_fusion:
            hm = self.edge_fuse_cls(cls_feat, hm)
        return dict(heatmap=hm.permute(0, 2, 3, 1),
                    reg=torch.cat(regs, 1).permute(0, 2, 3, 1))


# --- the coder ------------------------------------------------------------

def encode_orientation(cfg: MonoFlexConfig, local_yaw):
    """[...] local yaws -> [..., 2 bins]: each bin's flag (within its
    range) and the residual to its centre where flagged."""
    centers = torch.tensor(cfg.bin_centers, dtype=torch.float32,
                           device=local_yaw.device)
    bin_size = 2 * np.pi / cfg.num_dir_bins
    range_size = bin_size / 2 + bin_size * cfg.bin_margin
    off = local_yaw[..., None] - centers
    off = torch.where(off > np.pi, off - 2 * np.pi, off)
    off = torch.where(off < -np.pi, off + 2 * np.pi, off)
    inside = off.abs() < range_size
    return torch.cat([inside.float(), torch.where(inside, off, 0.0)], -1)


def decode_dims(cfg, labels, dims_offset):
    """dims_mode 'linear': offset * class mean + class std (a label of -1
    takes the last class's row, as gga_tpu's indexing wraps)."""
    base = torch.tensor(cfg.base_dims, dtype=torch.float32,
                        device=dims_offset.device)[labels.long()]
    return dims_offset * base[..., :3] + base[..., 3:6]


def decode_direct_depth(cfg, depth_offset):
    return torch.clamp(torch.exp(depth_offset), *cfg.depth_range)


def keypoints2depth(cfg, keypoints2d, dims, cam2img):
    """Three depths [..., 3] from the keypoints' [..., 10, 2] (feature
    scale) pixel heights: f * h3d / height for the bottom / top centre
    pair and the two corner groups' (7, 3) / (2, 6) bottoms over (0, 4) /
    (1, 5) tops (gga_tpu's geometry, bottom minus top for the centres);
    dims [..., M, 3], ``cam2img`` [..., 4, 4]."""
    num = (cam2img[..., 0, 0][..., None] * dims[..., 1])[..., None]
    r = cfg.down_ratio

    def depth_of(hpix):
        return num / (torch.relu(hpix) * r + 1e-3)

    kv = keypoints2d[..., 1]
    center_h = kv[..., 9] - kv[..., 8]
    g0 = kv[..., (7, 3)] - kv[..., (0, 4)]
    g1 = kv[..., (2, 6)] - kv[..., (1, 5)]
    d = torch.stack([depth_of(center_h[..., None])[..., 0],
                     depth_of(g0).mean(-1), depth_of(g1).mean(-1)], -1)
    return torch.clamp(d, *cfg.depth_range)


def combine_depths(depth, depth_unc):
    """The depths [..., n] weighted by their normalized inverse
    uncertainties."""
    w = 1.0 / depth_unc
    w = w / w.sum(-1, keepdim=True)
    return (depth * w).sum(-1)


def decode_orientation(cfg, ori_vector, locations):
    """[..., 16] multibin vector + locations -> (global yaw, local yaw):
    the most probable bin, its atan2 offset (guarded at (0, 0)) plus its
    centre, plus the location's ray."""
    nb = cfg.num_dir_bins
    cls_logits = ori_vector[..., :2 * nb].unflatten(-1, (nb, 2))
    best = torch.softmax(cls_logits, -1)[..., 1].argmax(-1)
    offs = ori_vector[..., 2 * nb:].unflatten(-1, (nb, 2))
    off = offs.gather(-2, best[..., None, None].expand(
        *best.shape, 1, 2))[..., 0, :]
    safe = (off[..., 0].abs() + off[..., 1].abs()) > 1e-8
    centers = torch.tensor(cfg.bin_centers, dtype=torch.float32,
                           device=ori_vector.device)
    local = torch.atan2(torch.where(safe, off[..., 0], 0.0),
                        torch.where(safe, off[..., 1], 1.0)) + centers[best]
    rays = torch.atan2(locations[..., 0],
                       torch.clamp(locations[..., 2], min=1e-6))
    yaw = local + rays
    yaw = torch.where(yaw > np.pi, yaw - 2 * np.pi, yaw)
    yaw = torch.where(yaw < -np.pi, yaw + 2 * np.pi, yaw)
    local = torch.where(local > np.pi, local - 2 * np.pi, local)
    local = torch.where(local < -np.pi, local + 2 * np.pi, local)
    return yaw, local


def decode_location(cfg, base_centers2d, offsets2d, depths, cam2img_inv):
    """Back-project (feature cell + offsets) * stride at ``depths``
    through the inverse camera [..., 4, 4] -> [..., N, 3]."""
    uv = (base_centers2d + offsets2d) * cfg.down_ratio
    d = depths[..., None]
    img_pt = torch.cat([uv * d, d, torch.ones_like(d)], -1)
    return (img_pt @ cam2img_inv.transpose(-1, -2))[..., :3]


# --- targets --------------------------------------------------------------

def _gaussians(hw, center, rx, ry):
    """[..., H, W] axis-wise gaussians, sigmas (2 r + 1) / 6, zero outside
    their |dx| <= rx, |dy| <= ry window (gga_tpu ``_ellip_gaussian``; its
    circle is rx = ry)."""
    H, W = hw
    dev = center.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    c = center[..., None, None, :]
    rx, ry = rx[..., None, None], ry[..., None, None]
    sx = (2 * rx + 1) / 6.0
    sy = (2 * ry + 1) / 6.0
    dx = xs - c[..., 0]
    dy = ys - c[..., 1]
    g = torch.exp(-(dx ** 2 / torch.clamp(2 * sx ** 2, min=1e-6)
                    + dy ** 2 / torch.clamp(2 * sy ** 2, min=1e-6)))
    return torch.where((dx.abs() <= rx) & (dy.abs() <= ry), g, 0.0)


def build_targets(cfg: MonoFlexConfig, gt_boxes_cam, labels, bboxes2d,
                  centers2d, depths, obj_valid, cam2img, img_shape,
                  feat_shape):
    """A batch's targets (gga_tpu ``monoflex_targets``): camera-frame
    bottom-centre boxes [B, M, 7]; ``centers2d`` / ``bboxes2d`` in input
    pixels; the dense targets at feature scale. Returns a dict of
    heatmap [B, H, W, classes], base_int [B, M, 2] (x, y), offsets2d,
    bboxes2d (FCOS distances), keypoints [B, M, 10, 2], keypoints_vis,
    kdep_valid [B, M, 3], ori [B, M, 8], dims, depth, valid, trunc."""
    H, W = feat_shape
    img_h, img_w = img_shape
    r = cfg.down_ratio
    B, M = labels.shape
    c2d, bb2d, boxes = centers2d, bboxes2d, gt_boxes_cam
    inside = ((c2d[..., 0] > 0) & (c2d[..., 0] < img_w)
              & (c2d[..., 1] > 0) & (c2d[..., 1] < img_h))
    ok = obj_valid & inside if cfg.filter_outside_objs else obj_valid
    trunc = ok & ~inside

    # a truncated centre's target: where the line from it to its 2D box's
    # centre meets the image border nearest to it
    bc = (bb2d[..., :2] + bb2d[..., 2:]) / 2
    dxc = bc[..., 0] - c2d[..., 0]
    a = (bc[..., 1] - c2d[..., 1]) / torch.where(dxc.abs() < 1e-6, 1e-6,
                                                 dxc)
    b = bc[..., 1] - a * bc[..., 0]
    a_safe = torch.where(a.abs() < 1e-6, 1e-6, a)
    zeros = torch.zeros_like(a)
    cands = torch.stack([
        torch.stack([zeros, b], -1),
        torch.stack([zeros + (img_w - 1.0), (img_w - 1) * a + b], -1),
        torch.stack([-b / a_safe, zeros], -1),
        torch.stack([(img_h - 1 - b) / a_safe, zeros + (img_h - 1.0)], -1)],
        -2)                                                  # [B, M, 4, 2]
    in_img = ((cands[..., 0] >= 0) & (cands[..., 0] <= img_w - 1)
              & (cands[..., 1] >= 0) & (cands[..., 1] <= img_h - 1))
    d2 = ((cands - c2d[..., None, :]) ** 2).sum(-1)
    d2 = torch.where(in_img, d2, torch.inf)
    border = cands.gather(-2, d2.argmin(-1)[..., None, None].expand(
        B, M, 1, 2))[..., 0, :]
    target_c2d = torch.where(trunc[..., None], border, c2d)

    base_int = torch.round(target_c2d / r).int()
    base_int = torch.stack([base_int[..., 0].clamp(0, W - 1),
                            base_int[..., 1].clamp(0, H - 1)], -1)
    center_f = base_int.float()
    offsets2d = c2d / r - center_f

    # keypoints: the 8 corners and the top and bottom centres, projected
    corners = corners_3d(boxes[..., :3], boxes[..., 3:6], boxes[..., 6],
                         origin=CAM_ORIGIN, axis=1)         # [B, M, 8, 3]
    kpts3d = torch.cat([corners, corners[..., (0, 1, 4, 5), :].mean(
        -2, keepdim=True), corners[..., (2, 3, 6, 7), :].mean(
        -2, keepdim=True)], -2)                              # [B, M, 10, 3]
    kpts2d = project_to_image(kpts3d.reshape(B, M * 10, 3),
                              cam2img)[0].reshape(B, M, 10, 2)
    kvis = ((kpts2d[..., 0] >= 0) & (kpts2d[..., 0] <= img_w - 1)
            & (kpts2d[..., 1] >= 0) & (kpts2d[..., 1] <= img_h - 1)
            & (kpts3d[..., 2] > 0))
    kdep_valid = torch.stack([kvis[..., (8, 9)].all(-1),
                              kvis[..., (0, 3, 5, 6)].all(-1),
                              kvis[..., (1, 2, 4, 7)].all(-1)], -1)
    kpts_local = (kpts2d - c2d[..., None, :]) / r

    # heatmaps: a circle of the 2D box's radius, an ellipse for truncated
    # objects, their max a class
    fb = bb2d / r
    radius = torch.clamp(gaussian_radius(
        (fb[..., 3] - fb[..., 1], fb[..., 2] - fb[..., 0]), 0.7).int(),
        min=0).float()
    rx_t = torch.minimum(base_int[..., 0] - fb[..., 0],
                         fb[..., 2] - base_int[..., 0]) \
        * cfg.edge_heatmap_ratio
    ry_t = torch.minimum(base_int[..., 1] - fb[..., 1],
                         fb[..., 3] - base_int[..., 1]) \
        * cfg.edge_heatmap_ratio
    g = _gaussians((H, W), center_f,
                   torch.where(trunc, torch.clamp(rx_t, min=0.0), radius),
                   torch.where(trunc, torch.clamp(ry_t, min=0.0), radius))
    heatmap = torch.stack([
        torch.where((ok & (labels == k))[..., None, None], g, 0.0).amax(1)
        for k in range(cfg.num_classes)], -1)

    bb_t = torch.stack([center_f[..., 0] - fb[..., 0],
                        center_f[..., 1] - fb[..., 1],
                        fb[..., 2] - center_f[..., 0],
                        fb[..., 3] - center_f[..., 1]], -1)
    ori_t = encode_orientation(cfg, boxes[..., 6] - torch.atan2(
        boxes[..., 0], torch.clamp(boxes[..., 2], min=1e-6)))
    return dict(heatmap=heatmap, base_int=base_int, offsets2d=offsets2d,
                bboxes2d=bb_t, keypoints=kpts_local, keypoints_vis=kvis,
                kdep_valid=kdep_valid, ori=ori_t, dims=boxes[..., 3:6],
                depth=depths, valid=ok, trunc=trunc)


# --- loss and decode -------------------------------------------------------

def _masked_l1(pred, target, mask):
    m = mask.float()
    return ((pred - target).abs() * m).sum() / torch.clamp(m.sum(), min=1.0)


def _slice(reg, name):
    a, b = REG_SLICES[name]
    return reg[..., a:b]


def loss(cfg: MonoFlexConfig, preds, gt_boxes_cam, labels, bboxes2d,
         centers2d, depths, obj_valid, cam2img, img_shape):
    """gga_tpu ``monoflex_loss``: the 9 weighted terms and their sum.
    Returns (total, dict of the terms, 'loss' and 'num_pos': the objects
    that count)."""
    hm_pred = clip_sigmoid(preds['heatmap'])
    B, H, W, _ = hm_pred.shape
    t = build_targets(cfg, gt_boxes_cam, labels, bboxes2d, centers2d,
                      depths, obj_valid, cam2img, img_shape, (H, W))
    avg = torch.clamp((t['heatmap'] == 1.0).sum().float(), min=1.0)
    loss_cls = gaussian_focal_loss(hm_pred, t['heatmap']).sum() / avg \
        * cfg.loss_cls_weight

    base = t['base_int'].long()
    bi = torch.arange(B, device=base.device)[:, None]
    reg = preds['reg'][bi, base[..., 1], base[..., 0]]       # [B, M, 50]
    ok = t['valid']
    n = torch.clamp(ok.sum().float(), min=1.0)
    mw = ok.float()

    # 2D IoU loss (-log iou) of the FCOS boxes at feature scale
    bp, bt = _slice(reg, 'bbox2d'), t['bboxes2d']
    cf = t['base_int'].float()
    px1, py1 = cf[..., 0] - bp[..., 0], cf[..., 1] - bp[..., 1]
    px2, py2 = cf[..., 0] + bp[..., 2], cf[..., 1] + bp[..., 3]
    tx1, ty1 = cf[..., 0] - bt[..., 0], cf[..., 1] - bt[..., 1]
    tx2, ty2 = cf[..., 0] + bt[..., 2], cf[..., 1] + bt[..., 3]
    iw = torch.clamp(torch.minimum(px2, tx2) - torch.maximum(px1, tx1),
                     min=0.0)
    ih = torch.clamp(torch.minimum(py2, ty2) - torch.maximum(py1, ty1),
                     min=0.0)
    inter = iw * ih
    area_p = torch.clamp(px2 - px1, min=0.0) * torch.clamp(py2 - py1,
                                                           min=0.0)
    area_t = torch.clamp(tx2 - tx1, min=0.0) * torch.clamp(ty2 - ty1,
                                                           min=0.0)
    iou = inter / torch.clamp(area_p + area_t - inter, min=1e-6)
    loss_bbox = (-torch.log(torch.clamp(iou, 1e-6, 1.0)) * mw).sum() / n \
        * cfg.loss_bbox_weight

    kp = _slice(reg, 'keypoints').unflatten(-1, (10, 2))
    loss_kpt = _masked_l1(kp, t['keypoints'], t['keypoints_vis'][..., None]
                          & ok[..., None, None]) * cfg.loss_keypoints_weight

    ori = reg[..., REG_SLICES['ori_cls'][0]:REG_SLICES['ori_offset'][1]]
    mb = multibin_loss(ori.reshape(-1, ori.shape[-1]),
                       t['ori'].reshape(-1, t['ori'].shape[-1]),
                       cfg.num_dir_bins)
    loss_dir = (mb.reshape(ok.shape) * mw).sum() / n * cfg.loss_dir_weight

    dims = decode_dims(cfg, labels, _slice(reg, 'dims'))
    loss_dims = _masked_l1(dims, t['dims'], ok[..., None]) \
        * cfg.loss_dims_weight
    loss_off = _masked_l1(_slice(reg, 'offsets2d'), t['offsets2d'],
                          ok[..., None]) * cfg.loss_offsets2d_weight

    # the direct depth with its uncertainty
    d_unc = torch.clamp(_slice(reg, 'depth_unc')[..., 0],
                        *cfg.uncertainty_range)
    d_pred = decode_direct_depth(cfg, _slice(reg, 'depth')[..., 0])
    loss_dd = (((d_pred - t['depth']).abs() * torch.exp(-d_unc) * mw).sum()
               / n + (d_unc * mw).sum() / n) \
        * cfg.loss_direct_depth_weight

    # the keypoint depths with theirs
    k_unc = torch.clamp(_slice(reg, 'kpt_depth_unc'), *cfg.uncertainty_range)
    kd = keypoints2depth(cfg, kp, dims, cam2img)
    km = (t['kdep_valid'] & ok[..., None]).float()
    nk = torch.clamp(km.sum(), min=1.0)
    loss_kd = (((kd - t['depth'][..., None]).abs() * torch.exp(-k_unc)
                * km).sum() + (k_unc * km).sum()) / nk \
        * cfg.loss_keypoints_depth_weight

    comb = combine_depths(torch.cat([d_pred[..., None], kd], -1),
                          torch.exp(torch.cat([d_unc[..., None], k_unc], -1)))
    loss_cd = _masked_l1(comb, t['depth'], ok) \
        * cfg.loss_combined_depth_weight

    total = (loss_cls + loss_bbox + loss_kpt + loss_dir + loss_dims
             + loss_off + loss_dd + loss_kd + loss_cd)
    return total, dict(
        loss_cls=loss_cls, loss_bbox=loss_bbox, loss_keypoints=loss_kpt,
        loss_dir=loss_dir, loss_dims=loss_dims, loss_offsets2d=loss_off,
        loss_direct_depth=loss_dd, loss_keypoints_depth=loss_kd,
        loss_combined_depth=loss_cd, loss=total, num_pos=ok.sum().float())


def decode(cfg: MonoFlexConfig, preds, cam2img):
    """Top-k local maxima -> camera bottom-centre boxes (gga_tpu
    ``monoflex_decode``): dict(boxes [B, topk, 7], scores, labels int32,
    valid = scores > score_thr)."""
    hm = local_maxima(clip_sigmoid(preds['heatmap']))
    scores, cls, y, x = top_cells(hm, cfg.topk)
    bi = torch.arange(hm.shape[0], device=hm.device)[:, None]
    reg = preds['reg'][bi, y, x]                             # [B, K, 50]
    base = torch.stack([x, y], -1).float()
    dims = decode_dims(cfg, cls, _slice(reg, 'dims'))
    d_unc = torch.clamp(_slice(reg, 'depth_unc')[..., 0],
                        *cfg.uncertainty_range)
    k_unc = torch.clamp(_slice(reg, 'kpt_depth_unc'), *cfg.uncertainty_range)
    d_direct = decode_direct_depth(cfg, _slice(reg, 'depth')[..., 0])
    kd = keypoints2depth(cfg, _slice(reg, 'keypoints').unflatten(-1, (10, 2)),
                         dims, cam2img)
    depth = combine_depths(
        torch.cat([d_direct[..., None], kd], -1),
        torch.exp(torch.cat([d_unc[..., None], k_unc], -1)))
    loc = decode_location(cfg, base, _slice(reg, 'offsets2d'), depth,
                          torch.linalg.inv(cam2img))
    ori = reg[..., REG_SLICES['ori_cls'][0]:REG_SLICES['ori_offset'][1]]
    yaw, _ = decode_orientation(cfg, ori, loc)
    # gravity centre -> bottom centre
    loc = torch.cat([loc[..., :1], loc[..., 1:2] + dims[..., 1:2] / 2,
                     loc[..., 2:]], -1)
    return dict(boxes=torch.cat([loc, dims, yaw[..., None]], -1),
                scores=scores, labels=cls, valid=scores > cfg.score_thr)
