"""GGA weak-supervision targets and losses of the CenterPoint head (port of
``gga_tpu/models/dense_heads/centerpoint_head_gga.py``).

- heatmap targets centred on the initial pseudo labels, all maps of a
  batch rendered in one launch of ``kernels.heatmap.render_heatmap``
  (``core.gaussian.render_class_heatmaps``);
- Boundary-Projection Loss (BPL): the predicted box's 8 corners projected
  through each object's lidar2img, L1 of their 2D extent against the 2D
  box, masked per edge where the 2D box touches the image boundary;
- Semantic-Ratio Loss (SRL): max/min of the predicted BEV dims against a
  per-task prior ratio drawn each step from N(mean, std);
- Point-to-Box Alignment (PAL): BEV distances of each object's cluster
  points to the predicted box edges. As in the reference, PAL is logged
  but kept out of the total unless ``pal_in_total_loss`` is set (mmdet's
  ``_parse_losses`` sums only keys that contain 'loss').

Objects stay at their padded slot ``[max_objs]`` with per-task masks, as
in gga_tpu: every loss is a masked sum.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ...core import geometry as geo
from ...parallel import mesh
from ...core.gaussian import (clip_sigmoid, gaussian_focal_loss,
                              gaussian_radius, render_class_heatmaps)


@dataclasses.dataclass(frozen=True)
class GGAHeadConfig:
    """Static train-time config (gga_kitti_config.py:64-76; a copy of
    gga_tpu's GGAHeadConfig)."""
    voxel_size: Tuple[float, float, float] = (0.05, 0.05, 0.1)
    point_cloud_range: Tuple[float, ...] = (0, -40, -3, 70.4, 40, 1)
    grid_size: Tuple[int, int, int] = (1408, 1600, 40)   # (nx, ny, nz)
    out_size_factor: int = 8
    max_objs: int = 500
    dense_reg: int = 1
    gaussian_overlap: float = 0.1
    min_radius: int = 2
    code_weights: Tuple[float, ...] = (0.5, 0.5, 0.5, 0.5, 0.5)
    # task t covers the global labels [task_offsets[t], task_offsets[t+1])
    task_num_classes: Tuple[int, ...] = (1, 1, 1)
    # per-task (mean, std) of the dim-ratio prior: Ped, Cyc, Car
    srl_priors: Tuple[Tuple[float, float], ...] = (
        (1.35, 0.48), (3.60, 0.68), (2.40, 0.28))
    loss_heatmap_weight: float = 5.0
    loss_bpl_weight: float = 0.3
    loss_srl_weight: float = 0.1
    loss_pal_weight: float = 0.1
    l1_loss_weight: float = 0.25
    focal_alpha: float = 0.0
    focal_gamma: float = 4.0
    pal_in_total_loss: bool = False
    # gga_tpu's optional anchors (off by default, as there): L1 of the
    # predicted log-dims to log class-mean dims, of (sin, cos) to the
    # initial pseudo label's yaw, and a one-way penalty on cluster points
    # outside the predicted BEV box
    task_dim_priors: Tuple[Tuple[float, float, float], ...] = None
    loss_dim_prior_weight: float = 0.0
    loss_yaw_prior_weight: float = 0.0
    loss_containment_weight: float = 0.0

    @property
    def feature_map_size(self):
        return (self.grid_size[0] // self.out_size_factor,
                self.grid_size[1] // self.out_size_factor)  # (W, H)

    @property
    def task_offsets(self):
        offs = [0]
        for n in self.task_num_classes:
            offs.append(offs[-1] + n)
        return tuple(offs)


def build_targets(cfg: GGAHeadConfig, srl_normal, labels, valid, init_pseudo,
                  boxes_img, bdry_masks, lidar2img):
    """Per-task training targets of a batch.

    Args:
        srl_normal: [T, B] standard-normal draws for the SRL prior, one
            per (task, scene); gga_tpu draws them from its step key.
        labels: [B, M] int global class ids (-1 for padding).
        valid: [B, M] bool, object usable for supervision.
        init_pseudo: [B, M, 7] initial pseudo boxes (lidar frame).
        boxes_img: [B, M, 4] 2D boxes (x1, y1, x2, y2).
        bdry_masks: [B, M, 4] bool, True where that 2D edge is on the
            image boundary.
        lidar2img: [B, M, 4, 4] per-object projection.
    Returns:
        list over tasks of dicts: heatmap [B, H, W, C_t], anno_box
        [B, M, 5], ind [B, M], mask [B, M] bool, boundary_mask [B, M, 4]
        f32, lidar2img, yaw [B, M].
    """
    B, M = labels.shape
    W, H = cfg.feature_map_size
    vx, vy = cfg.voxel_size[0], cfg.voxel_size[1]
    x0, y0 = cfg.point_cloud_range[0], cfg.point_cloud_range[1]
    f = cfg.out_size_factor

    gw = init_pseudo[..., 3] / vx / f
    gl = init_pseudo[..., 4] / vy / f
    # int() truncation toward zero, as astype(int32) in gga_tpu
    radius = torch.clamp(
        gaussian_radius((gl, gw), cfg.gaussian_overlap).to(torch.int32),
        min=cfg.min_radius)
    size_ok = (gw > 0) & (gl > 0)

    # truncation toward zero too: floor would move a negative centre
    cxi = ((init_pseudo[..., 0] - x0) / vx / f).to(torch.int32)
    cyi = ((init_pseudo[..., 1] - y0) / vy / f).to(torch.int32)
    in_map = (cxi >= 0) & (cxi < W) & (cyi >= 0) & (cyi < H)
    ind = cyi.clamp(0, H - 1) * W + cxi.clamp(0, W - 1)
    centers = torch.stack([cxi.clamp(0, W - 1), cyi.clamp(0, H - 1)], -1)

    offs = cfg.task_offsets
    live = valid & size_ok & in_map
    masks = [live & (labels >= offs[t]) & (labels < offs[t + 1])
             for t in range(len(cfg.task_num_classes))]
    # every (class map, scene) of the step in one launch; the classes of
    # task t are the maps offs[t]:offs[t + 1]
    hms = render_class_heatmaps(centers, radius, labels, live, offs[-1],
                                (H, W))

    targets = []
    boundary = (~bdry_masks).float()
    for t, ncls in enumerate(cfg.task_num_classes):
        first = offs[t]
        hm = hms[first:first + ncls].permute(1, 2, 3, 0)   # [B, H, W, C_t]
        mean, std = cfg.srl_priors[t]
        srl = torch.clamp(mean + std * srl_normal[t], min=1e-3)
        anno_box = torch.cat([boxes_img, srl[:, None, None].expand(B, M, 1)],
                             -1)
        targets.append(dict(heatmap=hm, anno_box=anno_box, ind=ind,
                            mask=masks[t], boundary_mask=boundary,
                            lidar2img=lidar2img, yaw=init_pseudo[..., 6]))
    return targets


def _gather_preds(task_preds, ind):
    """[B, M, 8] regression channels at the target cells: (reg_x, reg_y,
    height, dim_x, dim_y, dim_z, rot_sin, rot_cos)."""
    maps = torch.cat([task_preds['reg'], task_preds['height'],
                      task_preds['dim'], task_preds['rot']], -1)
    B, H, W, C = maps.shape
    return maps.reshape(B, H * W, C).gather(
        1, ind.long()[..., None].expand(-1, -1, C))


def _predict_geometry(cfg: GGAHeadConfig, pred, ind, lidar2img):
    """pred [B, M, 8] -> (pred_ratio [B, M, 2], pred_iou [B, M, 4],
    pred_box_bev [B, M, 5]), as the reference's get_prediction_single."""
    W, _ = cfg.feature_map_size
    vx, vy = cfg.voxel_size[0], cfg.voxel_size[1]
    x0, y0 = cfg.point_cloud_range[0], cfg.point_cloud_range[1]
    f = cfg.out_size_factor

    # atan2 has a NaN gradient at (0, 0) that would poison the step through
    # the masked loss (0 * NaN); use (0, 1) there
    s_, c_ = pred[..., 6], pred[..., 7]
    degen = (s_.abs() + c_.abs()) < 1e-8
    rot = torch.atan2(torch.where(degen, 0.0, s_), torch.where(degen, 1.0, c_))
    x = ((ind % W).float() + pred[..., 0]) * vx * f + x0
    y = (torch.div(ind, W, rounding_mode='floor').float()
         + pred[..., 1]) * vy * f + y0
    z = pred[..., 2]
    dims = torch.exp(pred[..., 3:6])

    bottom = torch.stack([x, y, z - dims[..., 2] * 0.5], -1)
    corners = geo.corners_3d(bottom.reshape(-1, 3), dims.reshape(-1, 3),
                             rot.reshape(-1))
    hom = torch.cat([corners, torch.ones_like(corners[..., :1])], -1)
    # f32 projection (TF32 is off on the card; gga_tpu uses HIGHEST here)
    cam = torch.einsum('nij,nkj->nki', lidar2img.reshape(-1, 4, 4), hom)
    # depth clamped at 0.1, ALL corners kept (also those behind the camera)
    pix = cam[..., :2] / torch.clamp(cam[..., 2:3], min=0.1)
    B, M = pred.shape[:2]
    pix = pix.reshape(B, M, 8, 2)
    pred_iou = torch.cat([pix.amin(2), pix.amax(2)], -1)   # x/y min, max

    pred_ratio = dims[..., :2]
    pred_box_bev = torch.cat([torch.stack([x, y], -1), dims[..., :2],
                              rot[..., None]], -1)
    return pred_ratio, pred_iou, pred_box_bev


def _pal_distances(pred_box_bev, ibp_xy, ibp_valid):
    """Point-to-box BEV distances of the cluster points.

    Args:
        pred_box_bev: [B, M, 5] (x, y, w, h, rot).
        ibp_xy: [B, M, P, 2] cluster points (lidar xy); ibp_valid [B, M, P].
    Returns:
        (min-edge distance, x overflow, y overflow, containment), each
        summed over the valid points: [B, M].
    """
    rot = pred_box_bev[..., 4]
    c, s = torch.cos(rot), torch.sin(rot)
    # clockwise rotation of points and centre, as the reference
    px = ibp_xy[..., 0] * c[..., None] + ibp_xy[..., 1] * s[..., None]
    py = -ibp_xy[..., 0] * s[..., None] + ibp_xy[..., 1] * c[..., None]
    cx = pred_box_bev[..., 0] * c + pred_box_bev[..., 1] * s
    cy = -pred_box_bev[..., 0] * s + pred_box_bev[..., 1] * c
    half_l = pred_box_bev[..., 2] / 2.0
    half_h = pred_box_bev[..., 3] / 2.0

    dx1 = (px - (cx - half_l)[..., None]).abs()
    dx2 = (px - (cx + half_l)[..., None]).abs()
    dy1 = (py - (cy - half_h)[..., None]).abs()
    dy2 = (py - (cy + half_h)[..., None]).abs()
    all_dis = torch.minimum(torch.minimum(dx1, dx2), torch.minimum(dy1, dy2))

    p2c_x = (px - cx[..., None]).abs()
    p2c_y = (py - cy[..., None]).abs()
    dx = torch.relu(p2c_x - 2 * half_l[..., None])
    dy = torch.relu(p2c_y - 2 * half_h[..., None])
    out_x = torch.relu(p2c_x - half_l[..., None])
    out_y = torch.relu(p2c_y - half_h[..., None])

    m = ibp_valid.to(all_dis.dtype)
    return ((all_dis * m).sum(-1), (dx * m).sum(-1), (dy * m).sum(-1),
            ((out_x + out_y) * m).sum(-1))


def _l1(pred, target, weight, avg_factor, loss_weight):
    return (torch.abs(pred - target) * weight).sum() / avg_factor \
        * loss_weight


def loss(cfg: GGAHeadConfig, preds, targets, ibp_xy, ibp_valid):
    """The GGA loss (reference centerpoint_head_gga.py:629-723).

    Args:
        preds: list over tasks of NHWC f32 map dicts (head output).
        targets: ``build_targets``' output.
        ibp_xy / ibp_valid: [B, M, P, 2] clusters and [B, M, P] masks.
    Returns:
        (total loss, dict of logged scalars).

    Under a process group the normalisers (``num_pos``, ``avg``) are sums
    over the global batch: each rank's total is its share of the global
    loss, and the ranks' totals sum to it.
    """
    cw = torch.tensor(cfg.code_weights, dtype=torch.float32,
                      device=ibp_xy.device)
    logs = {}
    total = 0.0
    for t, (tp, tt) in enumerate(zip(preds, targets)):
        hm_pred = clip_sigmoid(tp['heatmap'])
        num_pos = mesh.global_sum((tt['heatmap'] == 1.0).sum())
        loss_hm = gaussian_focal_loss(
            hm_pred, tt['heatmap'], cfg.focal_alpha, cfg.focal_gamma
        ).sum() / torch.clamp(num_pos, min=1)

        pred = _gather_preds(tp, tt['ind'])
        pred_ratio, pred_iou, pred_box_bev = _predict_geometry(
            cfg, pred, tt['ind'], tt['lidar2img'])

        maskf = tt['mask'].float()
        avg = mesh.global_sum(maskf.sum()) + 1e-4
        bbox_w = maskf[..., None] * torch.isfinite(
            tt['anno_box']).float() * cw

        p2c_min, p2c_x, p2c_y, p2c_out = _pal_distances(
            pred_box_bev, ibp_xy, ibp_valid)
        w_pal = bbox_w[..., 0]
        loss_pal = _l1(p2c_min, 0.0, w_pal, avg, cfg.l1_loss_weight)
        loss_palx = _l1(p2c_x, 0.0, w_pal, avg, cfg.l1_loss_weight)
        loss_paly = _l1(p2c_y, 0.0, w_pal, avg, cfg.l1_loss_weight)
        extra = []
        if cfg.loss_containment_weight > 0.0:
            extra.append((f'task{t}.loss_containment', _l1(
                p2c_out, 0.0, w_pal, avg, cfg.l1_loss_weight)
                * cfg.loss_containment_weight))

        ratio_w = pred_ratio.amin(-1)
        ratio_l = pred_ratio.amax(-1)
        srl = ratio_l - ratio_w * tt['anno_box'][..., 4]
        loss_srl = _l1(srl, 0.0, bbox_w[..., 4], avg, cfg.l1_loss_weight)

        w_bpl = bbox_w[..., :4] * tt['boundary_mask']
        loss_bpl = _l1(pred_iou, tt['anno_box'][..., :4], w_bpl, avg,
                       cfg.l1_loss_weight)

        if cfg.loss_dim_prior_weight > 0.0 and cfg.task_dim_priors:
            log_prior = torch.log(torch.tensor(
                cfg.task_dim_priors[t], dtype=torch.float32,
                device=pred.device))
            extra.append((f'task{t}.loss_dim_prior', _l1(
                pred[..., 3:6], log_prior[None, None], maskf[..., None], avg,
                cfg.l1_loss_weight) * cfg.loss_dim_prior_weight))
        if cfg.loss_yaw_prior_weight > 0.0:
            tgt_rot = torch.stack([torch.sin(tt['yaw']),
                                   torch.cos(tt['yaw'])], -1)
            extra.append((f'task{t}.loss_yaw_prior', _l1(
                pred[..., 6:8], tgt_rot, maskf[..., None], avg,
                cfg.l1_loss_weight) * cfg.loss_yaw_prior_weight))

        logs[f'task{t}.loss_heatmap'] = loss_hm * cfg.loss_heatmap_weight
        logs[f'task{t}.loss_bbox'] = loss_bpl * cfg.loss_bpl_weight
        logs[f'task{t}.loss_ratio'] = loss_srl * cfg.loss_srl_weight
        logs[f'task{t}.distancemin'] = loss_pal * cfg.loss_pal_weight
        logs[f'task{t}.distancex'] = loss_palx * cfg.loss_pal_weight
        logs[f'task{t}.distancey'] = loss_paly * cfg.loss_pal_weight
        logs.update(extra)

        total = (total + logs[f'task{t}.loss_heatmap']
                 + logs[f'task{t}.loss_bbox'] + logs[f'task{t}.loss_ratio'])
        # gga_tpu's order: dim prior, yaw prior, containment
        for key in ('loss_dim_prior', 'loss_yaw_prior', 'loss_containment'):
            if f'task{t}.{key}' in logs:
                total = total + logs[f'task{t}.{key}']
        if cfg.pal_in_total_loss:
            total = (total + logs[f'task{t}.distancemin']
                     + logs[f'task{t}.distancex']
                     + logs[f'task{t}.distancey'])
    logs['loss'] = total
    return total, logs
