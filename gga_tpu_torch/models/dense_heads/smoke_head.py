"""SMOKE monocular 3D head, its coder, targets, loss and decode (the port
of ``gga_tpu/models/dense_heads/smoke_head.py``; the reference's
SMOKEMono3DHead and SMOKECoder): a CenterNet-style class heatmap and an
8-channel regression (depth offset, keypoint offset xy, dimension
offsets lhw, orientation sin / cos) on the stride-4 map. The box loss is
the disentangled corner L1: three camera boxes, each with ONE predicted
component (orientation, dimensions, location) swapped into the ground
truth, against the ground truth's corners.

Targets: the class heatmaps are gga_tpu's ``render_heatmap`` with an
integer radius a box, which the TPU kernel ``render_heatmap_pallas``
computes; so ``build_targets`` renders all B x classes maps of a step
through ``core.gaussian.render_class_heatmaps``: one launch of the CUDA
kernel ``kernels.heatmap.render_heatmap`` on the card, the plain renderer
on the CPU.

Maps are NHWC in the outputs, as gga_tpu's: the decode's top-k runs over
the channel-last flattening (class ``idx % K``, pixel ``idx // K``), ties
in ``jax.lax.top_k``'s order. State_dict keys follow mmdet3d's head:
``conv_cls_prev.0`` (``conv``, ``gn``), ``conv_cls``,
``conv_reg_prevs.0.0``, ``conv_regs.0``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.gaussian import (clip_sigmoid, gaussian_focal_loss,
                              gaussian_radius, render_class_heatmaps)
from ...core.geometry import corners_3d
from ..necks.dla_neck import ConvGN
from .free_anchor3d_head import top_k_first

CAM_ORIGIN = (0.5, 1.0, 0.5)


@dataclasses.dataclass(frozen=True)
class SMOKEConfig:
    num_classes: int = 3
    feat_channels: int = 64
    max_objs: int = 32
    down_ratio: int = 4
    base_depth: Tuple[float, float] = (28.01, 16.32)
    base_dims: Tuple[Tuple[float, float, float], ...] = (
        (0.88, 1.73, 0.67), (1.78, 1.70, 0.58), (3.88, 1.63, 1.53))
    loss_hm_weight: float = 1.0
    loss_bbox_weight: float = 0.1
    # test cfg
    topk: int = 100
    score_thr: float = 0.25


def stride_trans_mat(down_ratio, batch, device=None):
    """[B, 3, 3] ``diag(1 / r, 1 / r, 1)``: the unaugmented image ->
    feature-map affine of a stride-r map."""
    m = torch.diag(torch.tensor([1.0 / down_ratio, 1.0 / down_ratio, 1.0]))
    return m.to(device).expand(batch, 3, 3).contiguous()


# --- the coder ------------------------------------------------------------

def decode_depth(depth_offset, base_depth):
    """depth = offset * sigma + mu."""
    return depth_offset * base_depth[1] + base_depth[0]


def decode_location(points, offsets, depths, cam2img_inv, trans_mat_inv):
    """Feature-map keypoints [..., N, 2] + offsets, depths [..., N] ->
    camera locations [..., N, 3] through the inverse affine [..., 3, 3]
    (feature map -> image) and the inverse camera [..., 4, 4]."""
    centers = points + offsets
    ones = torch.ones_like(centers[..., :1])
    img_pts = torch.cat([centers, ones], -1) @ trans_mat_inv.transpose(-1, -2)
    img_pts = img_pts * depths[..., None]
    locs = torch.cat([img_pts, ones], -1) @ cam2img_inv.transpose(-1, -2)
    return locs[..., :3]


def decode_dimension(labels, dims_offset, base_dims):
    """dims = exp(offset) * the class's prior (labels clipped)."""
    base = torch.tensor(base_dims, dtype=torch.float32,
                        device=dims_offset.device)
    return torch.exp(dims_offset) * base[labels.clamp(0, base.shape[0] - 1)]


def decode_orientation(ori_vector, locations):
    """[..., 2] (sin, cos) + the location's ray -> global yaw in
    [-pi, pi]."""
    s, c = ori_vector[..., 0], ori_vector[..., 1]
    rays = torch.atan(locations[..., 0] / (locations[..., 2] + 1e-7))
    alphas = torch.atan(s / (c + 1e-7))
    alphas = torch.where(c >= 0, alphas - np.pi / 2, alphas + np.pi / 2)
    yaws = alphas + rays
    yaws = torch.where(yaws > np.pi, yaws - 2 * np.pi, yaws)
    return torch.where(yaws < -np.pi, yaws + 2 * np.pi, yaws)


# --- the head -------------------------------------------------------------

class SMOKEHead(nn.Module):
    """[B, C, H, W] stride-4 map -> dict(heatmap [B, H, W, classes], reg
    [B, H, W, 8]): two branches of a 3x3 conv + GroupNorm (min(32,
    feat_channels) groups) + ReLU and a 1x1 conv, each with a bias."""

    def __init__(self, cfg: SMOKEConfig, in_channels):
        super().__init__()
        self.cfg = cfg
        g = min(32, cfg.feat_channels)
        self.conv_cls_prev = nn.ModuleList(
            [ConvGN(in_channels, cfg.feat_channels, g)])
        self.conv_cls = nn.Conv2d(cfg.feat_channels, cfg.num_classes, 1)
        self.conv_reg_prevs = nn.ModuleList([nn.ModuleList(
            [ConvGN(in_channels, cfg.feat_channels, g)])])
        self.conv_regs = nn.ModuleList([nn.Conv2d(cfg.feat_channels, 8, 1)])

    def forward(self, x):
        hm = self.conv_cls(self.conv_cls_prev[0](x))
        reg = self.conv_regs[0](self.conv_reg_prevs[0][0](x))
        return dict(heatmap=hm.permute(0, 2, 3, 1),
                    reg=reg.permute(0, 2, 3, 1))


# --- targets, loss, decode -------------------------------------------------

def build_targets(cfg: SMOKEConfig, gt_boxes_cam, labels, centers2d,
                  obj_valid, feat_shape, trans_mat):
    """The class heatmaps and the objects' centre cells.

    Args:
        gt_boxes_cam: [B, M, 7] camera boxes (x, y bottom, z, l, h, w,
            yaw); labels [B, M]; centers2d [B, M, 2] the projected 3D
            centres on the image; obj_valid [B, M]; trans_mat [B, 3, 3]
            image -> feature map.
    Returns:
        (heatmap [B, H, W, classes], cells [B, M, 2] int (x, y) floored,
        inb [B, M]: valid and inside the map).
    """
    H, W = feat_shape
    tm = trans_mat
    cx = tm[:, None, 0, 0] * centers2d[..., 0] \
        + tm[:, None, 0, 1] * centers2d[..., 1] + tm[:, None, 0, 2]
    cy = tm[:, None, 1, 0] * centers2d[..., 0] \
        + tm[:, None, 1, 1] * centers2d[..., 1] + tm[:, None, 1, 2]
    cti = torch.stack([torch.floor(cx), torch.floor(cy)], -1).int()
    inb = (obj_valid & (cti[..., 0] >= 0) & (cti[..., 0] < W)
           & (cti[..., 1] >= 0) & (cti[..., 1] < H))
    # gga_tpu's radius: the box's length and height scaled by the map's
    # focal-free 1 / trans_mat[0, 0] over the depth (at least 1 m)
    z = torch.clamp(gt_boxes_cam[..., 2], min=1.0)
    fx = 1.0 / torch.clamp(tm[:, 0, 0], min=1e-6)[:, None]
    wpix = gt_boxes_cam[..., 3] * fx / z
    hpix = gt_boxes_cam[..., 4] * fx / z
    radius = torch.clamp(gaussian_radius((hpix, wpix), 0.7).int(), min=1)
    cells = torch.stack([cti[..., 0].clamp(0, W - 1),
                         cti[..., 1].clamp(0, H - 1)], -1)
    hm = render_class_heatmaps(cells, radius, labels, inb, cfg.num_classes,
                               (H, W))
    return hm.permute(1, 2, 3, 0), cti, inb


def _corners(loc, dim, yaw):
    return corners_3d(loc, dim, yaw, origin=CAM_ORIGIN, axis=1)


def _boxes_at(cfg, reg, pts, labels, cam2img, trans_mat):
    """Regression rows [B, N, 8] at feature cells ``pts`` [B, N, 2] ->
    (bottom-centre locations, dimensions, yaws)."""
    depths = decode_depth(reg[..., 0], cfg.base_depth)
    locs = decode_location(pts, reg[..., 1:3], depths,
                           torch.linalg.inv(cam2img),
                           torch.linalg.inv(trans_mat))
    dims = decode_dimension(labels, reg[..., 3:6], cfg.base_dims)
    oris = decode_orientation(reg[..., 6:8], locs)
    # to the bottom centre: y + h / 2
    locs = torch.cat([locs[..., :1], locs[..., 1:2] + dims[..., 1:2] / 2,
                      locs[..., 2:]], -1)
    return locs, dims, oris


def loss(cfg: SMOKEConfig, preds, gt_boxes_cam, labels, centers2d,
         obj_valid, cam2img, trans_mat):
    """Gaussian focal heatmap loss + the disentangled corner L1 (gga_tpu
    ``smoke_loss``). Returns dict(loss_heatmap, loss_bbox, loss, num_pos:
    the objects on the map)."""
    hm_pred = clip_sigmoid(preds['heatmap'])
    B, H, W, _ = hm_pred.shape
    heatmap, cti, inb = build_targets(cfg, gt_boxes_cam, labels, centers2d,
                                      obj_valid, (H, W), trans_mat)
    num_pos = torch.clamp(inb.sum().float(), min=1.0)
    loss_hm = gaussian_focal_loss(hm_pred, heatmap).sum() / num_pos

    x = cti[..., 0].clamp(0, W - 1).long()
    y = cti[..., 1].clamp(0, H - 1).long()
    b = torch.arange(B, device=x.device)[:, None]
    reg = preds['reg'][b, y, x]                              # [B, M, 8]
    pts = torch.stack([x, y], -1).float()
    locs, dims, oris = _boxes_at(cfg, reg, pts, labels, cam2img, trans_mat)
    g_loc, g_dim, g_yaw = (gt_boxes_cam[..., :3], gt_boxes_cam[..., 3:6],
                           gt_boxes_cam[..., 6])
    gt_cor = _corners(g_loc, g_dim, g_yaw)
    m = inb[..., None, None].float()
    l_ori = (_corners(g_loc, g_dim, oris) - gt_cor).abs() * m
    l_dim = (_corners(g_loc, dims, g_yaw) - gt_cor).abs() * m
    l_loc = (_corners(locs, g_dim, g_yaw) - gt_cor).abs() * m
    loss_bbox = (l_ori + l_dim + l_loc).sum() / (num_pos * 24.0)
    hm_term = cfg.loss_hm_weight * loss_hm
    bbox_term = cfg.loss_bbox_weight * loss_bbox
    return dict(loss_heatmap=hm_term, loss_bbox=bbox_term,
                loss=hm_term + bbox_term, num_pos=inb.sum().float())


def local_maxima(hm):
    """[B, H, W, K] scores kept where they equal their 3x3 neighbourhood's
    max ('SAME' padding), else 0."""
    pooled = F.max_pool2d(hm.permute(0, 3, 1, 2), 3, 1, padding=1)
    return torch.where(hm == pooled.permute(0, 2, 3, 1), hm, 0.0)


def top_cells(hm, k):
    """The top ``k`` of NHWC [B, H, W, K] scores over the channel-last
    flattening, ``jax.lax.top_k``'s ties -> (scores, classes, y, x)."""
    B, H, W, K = hm.shape
    flat = hm.reshape(B, -1)
    idx = top_k_first(flat, k)
    pix = idx // K
    return flat.gather(1, idx), (idx % K).int(), pix // W, pix % W


def decode(cfg: SMOKEConfig, preds, cam2img, trans_mat):
    """Top-k heatmap peaks -> camera boxes (gga_tpu ``smoke_decode``).

    Returns dict(boxes [B, topk, 7] bottom-centre camera boxes, scores
    [B, topk], labels [B, topk] int32)."""
    hm = local_maxima(clip_sigmoid(preds['heatmap']))
    scores, cls, y, x = top_cells(hm, cfg.topk)
    b = torch.arange(hm.shape[0], device=hm.device)[:, None]
    reg = preds['reg'][b, y, x]
    pts = torch.stack([x, y], -1).float()
    locs, dims, oris = _boxes_at(cfg, reg, pts, cls.long(), cam2img,
                                 trans_mat)
    return dict(boxes=torch.cat([locs, dims, oris[..., None]], -1),
                scores=scores, labels=cls)
