"""PGD monocular 3D head (FCOS3D family): module, targets, loss and decode
(the port of ``gga_tpu/models/dense_heads/pgd_head.py``; reference
``pgd_head.py:17`` with its FCOS3D base and coders, configured as in the
GGA retrain, ``configs/gga/gga_pdg.py``): 4 FPN levels, 27 regression
channels (offset 2, depth 1, size 3, rot 1, keypoints 16, 2D box 4), a
direction classifier, probabilistic depth (8 uniform bins fused with the
direct depth by a learnt lambda), a depth uncertainty, and the keypoint
and 2D / 3D consistency (GIoU) losses.

The convs run NCHW; each level's outputs come out NHWC, as gga_tpu's, so
targets, loss and decode read them as [B, points, channels].

As gga_tpu (its notes at ``pgd_head.py:13-20``), and unlike the reference:
the tower convs have no GroupNorm and the last one is not deformable; each
level has one learnt (5,) scale vector (``scales.{l}``), not five
``Scale`` modules; objects are padded to a static count, and the FCOS
assignment is one masked argmin over [points, objects], here batched over
the images instead of vmapped.

State_dict keys are mmdet3d's: ``cls_convs.{i}.conv``, ``reg_convs``,
``conv_cls_prev.{j}.conv``, ``conv_cls``, ``conv_reg_prevs.{g}.{j}.conv``,
``conv_regs.{g}``, ``conv_dir_cls_prev`` / ``conv_dir_cls``,
``conv_depth_cls_prev`` / ``conv_depth_cls``, ``conv_weight_prevs.0`` /
``conv_weights.0``, ``conv_centerness_prev`` / ``conv_centerness``,
``scales.{l}`` and ``fuse_lambda``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.geometry import corners_3d, limit_period
from ...core.nms import nms_bev
from ...parallel import mesh
from ..layers import PlainConvModule
from ..losses import smooth_l1_loss as _smooth_l1

INF = 1e8


@dataclasses.dataclass(frozen=True)
class PGDConfig:
    num_classes: int = 3
    code_size: int = 7
    strides: Tuple[int, ...] = (4, 8, 16, 32)
    regress_ranges: Tuple[Tuple[float, float], ...] = (
        (-1, 64), (64, 128), (128, 256), (256, 1e8))
    feat_channels: int = 256
    stacked_convs: int = 2
    cls_branch: Tuple[int, ...] = (256,)
    reg_branch: Tuple[Tuple[int, ...], ...] = (
        (256,), (256,), (256,), (256,), (256,), (256,))
    group_reg_dims: Tuple[int, ...] = (2, 1, 3, 1, 16, 4)
    dir_branch: Tuple[int, ...] = (256,)
    centerness_branch: Tuple[int, ...] = (256,)
    depth_branch: Tuple[int, ...] = (256,)
    weight_dim: int = 1
    weight_branch: Tuple[Tuple[int, ...], ...] = ((256,),)
    depth_range: Tuple[float, float] = (0, 70)
    depth_unit: float = 10
    depth_bins: int = 8
    base_depths: Tuple[Tuple[float, float], ...] = ((28.01, 16.32),)
    base_dims: Tuple[Tuple[float, float, float], ...] = (
        (0.8, 1.73, 0.6), (1.76, 1.73, 0.6), (3.9, 1.56, 1.6))
    dir_offset: float = 0.7854
    centerness_alpha: float = 2.5
    center_sample_radius: float = 1.5
    # offset 2 + depth 1 + size 3 + rot 1 + keypoints 16 + 2D box 4
    code_weight: Tuple[float, ...] = (
        1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0) + (0.2,) * 16 + (1.0,) * 4
    smooth_l1_beta: float = 1.0 / 9.0
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    depth_loss_alpha: float = 1.0   # UncertainSmoothL1 alpha
    depth_loss_beta: float = 3.0    # UncertainSmoothL1 beta
    # optional groups after (offset, depth, size, rot), in group_reg_dims
    # order: velocity 2, keypoints 16, 2D box 4
    pred_velo: bool = False
    pred_keypoints: bool = True
    pred_bbox2d: bool = True
    pos_budget: int = 1024
    # test cfg (gga_pdg.py:63)
    nms_pre: int = 100
    nms_thr: float = 0.05
    score_thr: float = 0.001
    max_per_img: int = 20

    @property
    def kpts_start(self):
        return 7 + (2 if self.pred_velo else 0)

    @property
    def bbox2d_start(self):
        return self.kpts_start + (16 if self.pred_keypoints else 0)

    @property
    def reg_dims_total(self):
        total = sum(self.group_reg_dims)
        want = (7 + (2 if self.pred_velo else 0)
                + (16 if self.pred_keypoints else 0)
                + (4 if self.pred_bbox2d else 0))
        if total != want:
            raise ValueError(f'group_reg_dims sums to {total} but the '
                             f'pred_velo / keypoints / bbox2d flags imply '
                             f'{want}')
        return total


def _branch(in_channels, channels):
    """3x3 conv + ReLU stack (``conv_*_prev``)."""
    layers, c = [], in_channels
    for ch in channels:
        layers.append(PlainConvModule(c, ch, 3, padding=1, relu=True))
        c = ch
    return nn.ModuleList(layers)


def _run(convs, x):
    for conv in convs:
        x = conv(x)
    return x


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class PGDHead(nn.Module):
    """FPN features (NCHW) -> (per-level dicts of NHWC outputs,
    fuse_lambda). The coder's decode (scales, base depth, exp x class
    prior, tanh keypoints, ReLU 2D box) happens in the forward, as in
    gga_tpu and the reference."""

    def __init__(self, cfg: PGDConfig, in_channels=256):
        super().__init__()
        c = cfg
        self.cfg = c
        self.cls_convs = _branch(in_channels,
                                 (c.feat_channels,) * c.stacked_convs)
        self.reg_convs = _branch(in_channels,
                                 (c.feat_channels,) * c.stacked_convs)
        feat = c.feat_channels if c.stacked_convs else in_channels

        def out_conv(channels, dim):
            return nn.Conv2d(channels[-1] if channels else feat, dim, 1)

        self.conv_cls_prev = _branch(feat, c.cls_branch)
        self.conv_cls = out_conv(c.cls_branch, c.num_classes)
        self.conv_reg_prevs = nn.ModuleList(
            _branch(feat, br) for br in c.reg_branch)
        self.conv_regs = nn.ModuleList(
            out_conv(br, dim) for br, dim in zip(c.reg_branch,
                                                 c.group_reg_dims))
        self.conv_dir_cls_prev = _branch(feat, c.dir_branch)
        self.conv_dir_cls = out_conv(c.dir_branch, 2)
        self.conv_depth_cls_prev = _branch(feat, c.depth_branch)
        self.conv_depth_cls = out_conv(c.depth_branch, c.depth_bins)
        self.conv_weight_prevs = nn.ModuleList([_branch(feat,
                                                        c.weight_branch[0])])
        self.conv_weights = nn.ModuleList([out_conv(c.weight_branch[0],
                                                    c.weight_dim)])
        self.conv_centerness_prev = _branch(feat, c.centerness_branch)
        self.conv_centerness = out_conv(c.centerness_branch, 1)
        self.scales = nn.ParameterList(
            nn.Parameter(torch.ones(5)) for _ in c.strides)
        self.fuse_lambda = nn.Parameter(torch.tensor(1e-4))
        self.register_buffer('base_dims',
                             torch.tensor(c.base_dims, dtype=torch.float32),
                             persistent=False)

    def forward(self, feats):
        c = self.cfg
        outs = []
        for lvl, x in enumerate(feats):
            cls_feat = _run(self.cls_convs, x)
            reg_feat = _run(self.reg_convs, x)
            cls_score = _nhwc(self.conv_cls(_run(self.conv_cls_prev,
                                                 cls_feat)))
            bbox_pred = _nhwc(torch.cat([
                out(_run(prev, reg_feat))
                for prev, out in zip(self.conv_reg_prevs, self.conv_regs)],
                1))
            dir_pred = self.conv_dir_cls(_run(self.conv_dir_cls_prev,
                                              reg_feat))
            depth_cls = self.conv_depth_cls(_run(self.conv_depth_cls_prev,
                                                 reg_feat))
            weight = self.conv_weights[0](_run(self.conv_weight_prevs[0],
                                               reg_feat))
            centerness = self.conv_centerness(_run(self.conv_centerness_prev,
                                                   reg_feat))

            # fcos3d_bbox_coder.decode + pgd decode_2d
            scales = self.scales[lvl]
            mean, std = c.base_depths[0]
            size = torch.exp(bbox_pred[..., 3:6] * scales[2])
            priors = self.base_dims[cls_score.argmax(-1)]
            parts = [bbox_pred[..., 0:2] * scales[0],
                     mean + bbox_pred[..., 2:3] * scales[1] * std,
                     size * priors, bbox_pred[..., 6:7]]
            i = 7
            if c.pred_velo:
                parts.append(bbox_pred[..., i:i + 2])   # no scale (ref)
                i += 2
            if c.pred_keypoints:
                parts.append(torch.tanh(bbox_pred[..., i:i + 16]
                                        * scales[3]))
                i += 16
            if c.pred_bbox2d:
                parts.append(F.relu(bbox_pred[..., i:i + 4] * scales[4]))
            outs.append(dict(cls_score=cls_score,
                             bbox_pred=torch.cat(parts, -1),
                             dir_pred=_nhwc(dir_pred),
                             depth_cls=_nhwc(depth_cls),
                             weight=_nhwc(weight),
                             centerness=_nhwc(centerness)))
        return outs, self.fuse_lambda

    def init_biases(self):
        """The reference's non-zero initial biases: the class logits at
        prior probability 0.01 (mmdet ``bias_init_with_prob``)."""
        with torch.no_grad():
            self.conv_cls.bias.fill_(-4.595)


def level_points(cfg: PGDConfig, featmap_sizes, device=None):
    """Per-level pixel centres [(Hi * Wi, 2)] (anchor-free get_points)."""
    pts = []
    for (h, w), s in zip(featmap_sizes, cfg.strides):
        yy, xx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device),
            torch.arange(w, dtype=torch.float32, device=device),
            indexing='ij')
        pts.append(torch.stack([xx.reshape(-1) * s, yy.reshape(-1) * s], -1)
                   + s // 2)
    return pts


def flat_points(cfg: PGDConfig, featmap_sizes, device=None):
    """All levels' points [Np, 2], each point's stride [Np] and regress
    range [Np, 2]."""
    pts = level_points(cfg, featmap_sizes, device)
    strides = torch.cat([torch.full((len(p),), float(s), device=device)
                         for p, s in zip(pts, cfg.strides)])
    ranges = torch.cat([
        torch.tensor(r, dtype=torch.float32, device=device).expand(len(p), 2)
        for p, r in zip(pts, cfg.regress_ranges)])
    return torch.cat(pts), strides, ranges


def build_targets(cfg: PGDConfig, points, strides_flat, regress_flat,
                  gt_bboxes, gt_labels, gt_cam3d, centers2d, depths,
                  obj_valid):
    """FCOS-mono target assignment of a batch
    (``fcos_mono3d_head._get_target_single`` + pgd ``get_targets``).

    Args:
        points: [Np, 2] all levels' pixel centres; strides_flat: [Np];
            regress_flat: [Np, 2].
        gt_bboxes: [B, M, 4]; gt_labels: [B, M]; gt_cam3d: [B, M, 7]
            camera boxes (gravity centre); centers2d: [B, M, 2];
            depths: [B, M]; obj_valid: [B, M] bool.
    Returns:
        dict: labels_3d [B, Np] (num_classes = background),
        bbox_targets_3d [B, Np, 11] (dx, dy, depth, dims 3, local yaw,
        ltrb 4; offsets and ltrb over the stride), centerness [B, Np],
        pos_mask [B, Np], amin [B, Np] (the assigned object).
    """
    B, M = gt_labels.shape
    Np = points.shape[0]
    local_yaw = -torch.atan2(gt_cam3d[..., 0], gt_cam3d[..., 2]) \
        + gt_cam3d[..., 6]                                  # [B, M]
    xs = points[None, :, 0:1]                               # [1, Np, 1]
    ys = points[None, :, 1:2]
    cx, cy = centers2d[:, None, :, 0], centers2d[:, None, :, 1]
    delta_x, delta_y = xs - cx, ys - cy                     # [B, Np, M]
    ltrb = torch.stack([xs - gt_bboxes[:, None, :, 0],
                        ys - gt_bboxes[:, None, :, 1],
                        gt_bboxes[:, None, :, 2] - xs,
                        gt_bboxes[:, None, :, 3] - ys], -1)  # [B, Np, M, 4]

    cs = strides_flat[None, :, None] * cfg.center_sample_radius
    inside_center = ((delta_x.abs() < cs) & (delta_y.abs() < cs)
                     & (xs > cx - cs) & (xs < cx + cs)
                     & (ys > cy - cs) & (ys < cy + cs))
    max_reg = ltrb.max(-1).values
    inside_range = ((max_reg >= regress_flat[None, :, 0:1])
                    & (max_reg <= regress_flat[None, :, 1:2]))
    dists = torch.sqrt(delta_x ** 2 + delta_y ** 2)
    dists = torch.where(inside_center & inside_range & obj_valid[:, None, :],
                        dists, INF)
    amin = dists.argmin(-1)                                 # [B, Np]
    pos_mask = dists.gather(-1, amin[..., None])[..., 0] < INF

    labels_3d = torch.where(pos_mask, gt_labels.gather(1, amin),
                            cfg.num_classes)
    tx = delta_x.gather(-1, amin[..., None])[..., 0]
    ty = delta_y.gather(-1, amin[..., None])[..., 0]
    tdims = gt_cam3d[..., 3:6].gather(1, amin[..., None].expand(B, Np, 3))
    tltrb = ltrb.gather(2, amin[..., None, None].expand(B, Np, 1, 4))[:, :,
                                                                      0]
    s = strides_flat[None]
    bbox_targets_3d = torch.cat([
        (tx / s)[..., None], (ty / s)[..., None],
        depths.gather(1, amin)[..., None], tdims,
        local_yaw.gather(1, amin)[..., None], tltrb / s[..., None]], -1)
    rel = torch.sqrt(tx ** 2 + ty ** 2) / (1.414 * s)
    return dict(labels_3d=labels_3d, bbox_targets_3d=bbox_targets_3d,
                centerness=torch.exp(-cfg.centerness_alpha * rel),
                pos_mask=pos_mask, amin=amin)


def decode_prob_depth(cfg: PGDConfig, depth_cls):
    """Uniform-division probabilistic depth (pgd_bbox_coder:74)."""
    mult = cfg.depth_unit * torch.arange(cfg.depth_bins, dtype=torch.float32,
                                         device=depth_cls.device)
    return (torch.softmax(depth_cls, -1) * mult).sum(-1)


def _focal_loss(logits, labels, num_classes, gamma, alpha):
    """Sigmoid focal loss summed over classes; labels == num_classes is
    background."""
    onehot = F.one_hot(labels.long(), num_classes + 1)[..., :num_classes]
    onehot = onehot.to(logits.dtype)
    p = torch.sigmoid(logits)
    pt = p * onehot + (1 - p) * (1 - onehot)
    w = alpha * onehot + (1 - alpha) * (1 - onehot)
    ce = -(onehot * F.logsigmoid(logits)
           + (1 - onehot) * F.logsigmoid(-logits))
    return (w * ((1 - pt) ** gamma) * ce).sum(-1)


def _corners_cam(boxes7):
    """Camera boxes (gravity centre, yaw about y) -> [..., 8, 3] corners."""
    return corners_3d(boxes7[..., :3], boxes7[..., 3:6], boxes7[..., 6],
                      origin=(0.5, 0.5, 0.5), axis=1)


def _project(pts3, cam2img):
    """[B, ..., 3] camera points through [B, 4, 4] -> [B, ..., 2] pixels."""
    hom = torch.cat([pts3, torch.ones_like(pts3[..., :1])], -1)
    img = torch.einsum('bij,b...j->b...i', cam2img, hom)
    return img[..., :2] / img[..., 2:3].clamp(min=1e-5)


def _img2cam(uvd, inv_t):
    """[B, N, 3] (u, v, depth) -> camera xyz through [B, 4, 4] inv(P)^T."""
    xys = uvd[..., :2] * uvd[..., 2:3]
    hom = torch.cat([xys, uvd[..., 2:3], torch.ones_like(uvd[..., :1])], -1)
    return torch.einsum('bnj,bjk->bnk', hom, inv_t)[..., :3]


def _giou(a, b, eps=1e-7):
    """GIoU of [..., 4] xyxy boxes."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    inter = ((torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(min=0)
             * (torch.minimum(ay2, by2)
                - torch.maximum(ay1, by1)).clamp(min=0))
    area_a = (ax2 - ax1).clamp(min=0) * (ay2 - ay1).clamp(min=0)
    area_b = (bx2 - bx1).clamp(min=0) * (by2 - by1).clamp(min=0)
    union = area_a + area_b - inter
    iou = inter / union.clamp(min=eps)
    hull = ((torch.maximum(ax2, bx2) - torch.minimum(ax1, bx1))
            * (torch.maximum(ay2, by2) - torch.minimum(ay1, by1)))
    return iou - (hull - union) / hull.clamp(min=eps)


def _flat(preds, key, ch):
    B = preds[0][key].shape[0]
    return torch.cat([p[key].reshape(B, -1, ch) for p in preds], 1)


def _stride_scale(cfg: PGDConfig, strides_flat, n_channels, keypoints):
    """[Np, n_channels] multipliers: the offsets and the 2D box by the
    point's stride, the keypoints (where ``keypoints``) by its regress
    scale; 1 elsewhere."""
    mult = torch.ones(len(strides_flat), n_channels,
                      device=strides_flat.device)
    mult[:, :2] = strides_flat[:, None]
    if cfg.pred_bbox2d:
        b0 = cfg.bbox2d_start
        mult[:, b0:b0 + 4] = strides_flat[:, None]
    if keypoints and cfg.pred_keypoints:
        k0 = cfg.kpts_start
        mult[:, k0:k0 + 16] = (strides_flat * cfg.regress_ranges[0][1]
                               / cfg.strides[0])[:, None]
    return mult


def _yaw(cfg: PGDConfig, rot, dir_preds, centers2d, cam2img):
    """Global yaw from the local rot, the direction class and the ray."""
    dir_score = dir_preds.argmax(-1).to(rot.dtype)
    yaw = (limit_period(rot - cfg.dir_offset, 0.0, math.pi)
           + cfg.dir_offset + math.pi * dir_score)
    return yaw + _ray(centers2d, cam2img)


def _ray(centers2d, cam2img):
    return torch.atan2(centers2d[..., 0] - cam2img[:, None, 0, 2],
                       cam2img[:, None, 0, 0])


def loss(cfg: PGDConfig, preds, fuse_lambda, targets, cam2img,
         featmap_sizes):
    """The PGD loss of a batch (pgd_head.loss:526).

    Args:
        preds: per-level head output dicts (NHWC).
        targets: ``build_targets``'s dict.
        cam2img: [B, 4, 4] intrinsics.
    Returns:
        (total, logs): the 0-d total and the terms ``loss_cls`` ...
        ``loss_centerness`` (as gga_tpu), ``loss`` and ``num_pos``.

    Under a process group ``num_pos`` and the focal term's ``B`` count the
    global batch: each rank's terms are its shares of the global ones.
    """
    B = preds[0]['cls_score'].shape[0]
    dev = cam2img.device
    points_flat, strides_flat, _ = flat_points(cfg, featmap_sizes, dev)
    cls_scores = _flat(preds, 'cls_score', cfg.num_classes)  # [B, Np, C]
    bbox_preds = _flat(preds, 'bbox_pred', cfg.reg_dims_total)
    dir_preds = _flat(preds, 'dir_pred', 2)
    depth_cls = _flat(preds, 'depth_cls', cfg.depth_bins)
    weights = _flat(preds, 'weight', cfg.weight_dim)
    centerness = _flat(preds, 'centerness', 1)[..., 0]

    labels = targets['labels_3d']
    bt = targets['bbox_targets_3d']                         # [B, Np, 11]
    ct = targets['centerness']
    pos = targets['pos_mask'].float()
    num_pos = mesh.global_sum(pos.sum())
    avg = num_pos.clamp(min=1.0)

    logs = {}
    logs['loss_cls'] = _focal_loss(cls_scores, labels, cfg.num_classes,
                                   cfg.focal_gamma,
                                   cfg.focal_alpha).sum() / (
                                       num_pos + B * mesh.world_size())
    cw = torch.tensor(cfg.code_weight, dtype=torch.float32, device=dev)
    w = pos[..., None] * cw

    # diff_rad_by_sin on the rot channel
    rot_p = torch.sin(bbox_preds[..., 6]) * torch.cos(bt[..., 6])
    rot_t = torch.cos(bbox_preds[..., 6]) * torch.sin(bt[..., 6])

    def sl1(p, t, wslice):
        return (_smooth_l1(p, t, cfg.smooth_l1_beta) * wslice).sum() / avg

    logs['loss_offset'] = sl1(bbox_preds[..., :2], bt[..., :2], w[..., :2])
    logs['loss_size'] = sl1(bbox_preds[..., 3:6], bt[..., 3:6], w[..., 3:6])
    logs['loss_rotsin'] = sl1(rot_p, rot_t, w[..., 6])

    # direction classification
    offset_rot = limit_period(bt[..., 6] - cfg.dir_offset, 0.0, 2 * math.pi)
    dir_t = torch.floor(offset_rot / math.pi).long().clamp(0, 1)
    dir_ce = -torch.log_softmax(dir_preds, -1).gather(
        -1, dir_t[..., None])[..., 0]
    logs['loss_dir'] = (dir_ce * pos).sum() / avg

    # fused depth with its uncertainty
    sig_a = torch.sigmoid(fuse_lambda)
    fused = (sig_a * bbox_preds[..., 2]
             + (1 - sig_a) * decode_prob_depth(cfg, depth_cls))
    sigma = weights[..., 0]
    udl = (torch.exp(-sigma)
           * _smooth_l1(fused, bt[..., 2], cfg.depth_loss_beta)
           + cfg.depth_loss_alpha * sigma)
    logs['loss_depth'] = (udl * w[..., 2]).sum() / avg

    # keypoints, 2D box and consistency need the projected corners; the
    # targets are [dx, dy, depth, dims 3, yaw, ltrb 4]
    b0, k0 = cfg.bbox2d_start, cfg.kpts_start
    sp = bbox_preds * _stride_scale(cfg, strides_flat, bbox_preds.shape[-1],
                                    keypoints=False)
    tmult = torch.ones(bt.shape[-1], device=dev).repeat(len(strides_flat), 1)
    tmult[:, :2] = strides_flat[:, None]
    tmult[:, 7:11] = strides_flat[:, None]
    st = bt * tmult

    centers2d_pred = points_flat[None] - sp[..., :2]        # [B, Np, 2]
    centers2d_tgt = points_flat[None] - st[..., :2]
    inv_t = torch.linalg.inv(cam2img).transpose(1, 2)
    # depth fixed to the target depth for the re-projection (pgd_head:398)
    c3d_pred = _img2cam(torch.cat([centers2d_pred, st[..., 2:3]], -1), inv_t)
    c3d_tgt = _img2cam(torch.cat([centers2d_tgt, st[..., 2:3]], -1), inv_t)
    yaw_p = _yaw(cfg, sp[..., 6], dir_preds, centers2d_pred, cam2img)
    yaw_t = _ray(centers2d_tgt, cam2img) + st[..., 6]
    boxes_p = torch.cat([c3d_pred, sp[..., 3:6], yaw_p[..., None]], -1)
    boxes_t = torch.cat([c3d_tgt, st[..., 3:6], yaw_t[..., None]], -1)
    pix_p = _project(_corners_cam(boxes_p), cam2img)        # [B, Np, 8, 2]
    pix_t = _project(_corners_cam(boxes_t), cam2img)

    if cfg.pred_velo:
        # datasets without velocity labels supply zero targets
        velo_t = targets.get('velo_targets',
                             torch.zeros_like(bbox_preds[..., 7:9]))
        logs['loss_velo'] = sl1(bbox_preds[..., 7:9], velo_t, w[..., 7:9])

    if cfg.pred_keypoints:
        # projected GT corners over the regress range
        norm_strides = (strides_flat * cfg.regress_ranges[0][1]
                        / cfg.strides[0])
        kpts_t = ((pix_t - points_flat[None, :, None, :])
                  .reshape(B, -1, 16) / norm_strides[None, :, None])
        logs['loss_kpts'] = sl1(bbox_preds[..., k0:k0 + 16], kpts_t,
                                w[..., k0:k0 + 16])

    if cfg.pred_bbox2d:
        logs['loss_bbox2d'] = sl1(bbox_preds[..., b0:b0 + 4], bt[..., 7:11],
                                  w[..., b0:b0 + 4])
        # GIoU of the projected 3D box and the predicted 2D box
        proj2d = torch.cat([pix_p.min(2).values, pix_p.max(2).values], -1)
        px, py = points_flat[None, :, 0], points_flat[None, :, 1]
        pred2d = torch.stack([px - sp[..., b0], py - sp[..., b0 + 1],
                              px + sp[..., b0 + 2], py + sp[..., b0 + 3]],
                             -1)
        logs['loss_consistency'] = ((1 - _giou(proj2d, pred2d))
                                    * w[..., b0:b0 + 4].mean(-1)).sum() / avg

    # centerness BCE over the positives
    bce = -(ct * F.logsigmoid(centerness)
            + (1 - ct) * F.logsigmoid(-centerness))
    logs['loss_centerness'] = (bce * pos).sum() / avg

    total = sum(logs.values())
    logs['loss'] = total
    logs['num_pos'] = num_pos
    return total, logs


def decode(cfg: PGDConfig, preds, fuse_lambda, cam2img, featmap_sizes):
    """Inference decode (pgd ``_get_bboxes_single``): the top ``nms_pre``
    points by merged score, then per-class rotated NMS in the camera x-z
    plane (``core.nms.nms_bev``, all images and classes as one batch).

    Returns dict: boxes [B, K, 7] camera boxes (gravity centre), scores
    [B, K], labels [B, K], valid [B, K], bboxes2d [B, K, 4]; K =
    num_classes x max_per_img, class by class, each by score.
    """
    B = preds[0]['cls_score'].shape[0]
    dev = cam2img.device
    points_flat, strides_flat, _ = flat_points(cfg, featmap_sizes, dev)
    scores = torch.sigmoid(_flat(preds, 'cls_score', cfg.num_classes))
    bbox = _flat(preds, 'bbox_pred', cfg.reg_dims_total)
    dirp = _flat(preds, 'dir_pred', 2)
    depth_cls = _flat(preds, 'depth_cls', cfg.depth_bins)
    weight = _flat(preds, 'weight', cfg.weight_dim)
    centerness = torch.sigmoid(_flat(preds, 'centerness', 1)[..., 0])

    # offsets and the 2D box were left over the stride, keypoints over
    # the regress scale
    bbox = bbox * _stride_scale(cfg, strides_flat, bbox.shape[-1],
                                keypoints=True)
    depth_conf = torch.softmax(depth_cls, -1).max(-1).values
    merged = (scores * centerness[..., None] * depth_conf[..., None]
              * torch.exp(-weight[..., -1])[..., None])
    sig_a = torch.sigmoid(fuse_lambda)
    fused_depth = (sig_a * bbox[..., 2]
                   + (1 - sig_a) * decode_prob_depth(cfg, depth_cls))
    centers2d = points_flat[None] - bbox[..., :2]
    inv_t = torch.linalg.inv(cam2img).transpose(1, 2)
    c3d = _img2cam(torch.cat([centers2d, fused_depth[..., None]], -1), inv_t)
    yaw = _yaw(cfg, bbox[..., 6], dirp, centers2d, cam2img)
    boxes_cam = torch.cat([c3d, bbox[..., 3:6], yaw[..., None]], -1)

    K, C = cfg.nms_pre, cfg.num_classes
    top_idx = merged.max(-1).values.topk(K, -1).indices     # [B, K]

    def gather(x):
        return x.gather(1, top_idx.reshape(B, K, *([1] * (x.dim() - 2)))
                        .expand(B, K, *x.shape[2:]))

    boxes_k = gather(boxes_cam)
    merged_k = gather(merged)
    if cfg.pred_bbox2d:
        b0 = cfg.bbox2d_start
        px, py = points_flat[None, :, 0], points_flat[None, :, 1]
        bboxes2d = gather(torch.stack([px - bbox[..., b0],
                                       py - bbox[..., b0 + 1],
                                       px + bbox[..., b0 + 2],
                                       py + bbox[..., b0 + 3]], -1))
    else:
        bboxes2d = boxes_k.new_zeros(B, K, 4)

    # per-class NMS in pseudo-BEV, images x classes as one batch
    bev = torch.stack([boxes_k[..., 0], boxes_k[..., 2], boxes_k[..., 3],
                       boxes_k[..., 5], -boxes_k[..., 6]], -1)
    sc = merged_k.transpose(1, 2)                           # [B, C, K]
    idx, _ = nms_bev(bev[:, None].expand(B, C, K, 5), sc, cfg.nms_thr,
                     post_max_size=cfg.max_per_img,
                     valid=sc > cfg.score_thr)              # [B, C, n]
    valid = idx >= 0
    safe = idx.clamp(min=0)
    n = safe.shape[-1]

    def pick(x):                                            # [B, K, d]
        d = x.shape[-1]
        return x[:, None].expand(B, C, K, d).gather(
            2, safe[..., None].expand(B, C, n, d)).reshape(B, C * n, d)

    labels = torch.arange(C, device=dev)[None, :, None].expand(B, C, n)
    return dict(boxes=pick(boxes_k),
                scores=torch.where(valid, sc.gather(2, safe),
                                   0.0).reshape(B, C * n),
                labels=labels.reshape(B, C * n).to(torch.int32),
                valid=valid.reshape(B, C * n),
                bboxes2d=pick(bboxes2d))
