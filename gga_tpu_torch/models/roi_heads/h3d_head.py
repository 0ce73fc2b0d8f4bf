"""H3DNet's primitive heads and proposal refinement (port of
``gga_tpu/models/roi_heads/h3d_head.py``; mmdet3d's PrimitiveHead and
H3DBboxHead as gga_tpu rebuilt them for the axis-aligned ScanNet
H3DNet), batched over scenes.

- Three ``PrimitiveHead``s predict geometric primitives from the fused
  seed features: 'z' (the top and bottom faces, 2 size dims), 'xy' (the
  four sides, 1 size dim) and 'line' (the 12 edges). Each is an
  existence flag, a vote module (without VoteHead's feature rescale),
  farthest-point aggregation of the votes, and centre / size / class
  predictions. Their targets label every point within ``dist_thresh`` of
  a box's primitive with the offset to that primitive's centre, and the
  loss matches each predicted centre to its nearest target centre
  (chamfer-min). Rejected centres are parked at ``BIG``.
- ``H3DBboxHead`` builds each proposal's 6 face and 12 edge centres,
  groups the predicted primitives around them (ball query of
  ``match_radius``, ``match_samples`` each), scores the match and
  refines the proposal features from the pooled primitive features.

State_dict names follow ``torch2flax.h3dnet_rules``: ``flag_conv`` (a
bare ConvModule), ``flag_pred``, ``vote_module.vote_conv.{k}`` /
``conv_out``, ``vote_aggregation.mlps.0.layer{k}``, ``conv_pred.{k}`` /
``conv_pred.conv_out``; the refinement's are the port's own
(``convert.h3dnet_rules``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..backbones.pointnet2 import ConvBN, PointConv, PointSAModule, SharedMLP
from ..dense_heads.vote_head import VoteModule, _take

BIG = 1e4


@dataclasses.dataclass(frozen=True)
class PrimitiveConfig:
    mode: str = 'z'                  # 'z' | 'xy' | 'line'
    num_classes: int = 18
    in_channels: int = 256
    vote_conv_channels: Tuple[int, ...] = (256, 256)
    num_proposal: int = 256
    agg_radius: float = 0.3
    agg_num_sample: int = 16
    agg_mlp: Tuple[int, ...] = (128, 128, 128)
    feat_channels: Tuple[int, ...] = (128, 128)
    dist_thresh: float = 0.2
    surface_thresh: float = 0.5
    # loss weights (configs/_base_/models/h3dnet.py primitive losses)
    flag_weight: float = 1.0
    vote_weight: float = 1.0
    center_weight: float = 1.0
    size_weight: float = 1.0
    sem_weight: float = 1.0

    @property
    def num_dims(self):
        return {'z': 2, 'xy': 1, 'line': 0}[self.mode]


class PrimitiveHead(nn.Module):
    def __init__(self, cfg: PrimitiveConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.flag_conv = ConvBN(c.in_channels, c.in_channels // 2)
        self.flag_pred = PointConv(c.in_channels // 2, 2, bias=True)
        self.vote_module = VoteModule(c)
        self.vote_aggregation = PointSAModule(
            c.num_proposal, c.agg_radius, c.agg_num_sample, c.in_channels,
            c.agg_mlp, conv2d=False)
        self.conv_pred = SharedMLP(c.agg_mlp[-1], c.feat_channels, prefix='')
        self.conv_pred.add_module('conv_out', PointConv(
            c.feat_channels[-1], 3 + c.num_dims + c.num_classes, bias=True))

    def forward(self, seeds, feats, valid, sample_idx=None):
        """seeds [B, N, 3]; feats [B, N, C] the fused features; valid
        [B, N]; ``sample_idx`` [B, num_proposal] the aggregation's centres
        among the votes, sampled when None (kept in
        ``vote_aggregation.last_idx``). Returns gga_tpu's dict."""
        c = self.cfg
        flag = self.flag_pred(self.flag_conv(feats, valid))
        vm = self.vote_module
        out = vm.conv_out(vm.vote_conv(feats, valid))
        votes = seeds + out[..., :3]
        vote_feats = feats + out[..., 3:]
        agg_xyz, agg_feats, agg_valid = self.vote_aggregation(
            votes, vote_feats, valid, sample_idx)
        pred = self.conv_pred.conv_out(self.conv_pred(agg_feats, agg_valid))
        center = agg_xyz + pred[..., :3]
        return dict(flag=flag, votes=votes, agg_xyz=agg_xyz,
                    agg_valid=agg_valid, agg_feats=agg_feats, center=center,
                    size_res=pred[..., 3:3 + c.num_dims],
                    sem=pred[..., 3 + c.num_dims:],
                    matched_center=torch.where(agg_valid[..., None], center,
                                               BIG),
                    seed_conf=torch.softmax(flag, -1)[..., 1])


@torch.no_grad()
def _primitive_targets(cfg: PrimitiveConfig, points, p_valid, gt_boxes,
                       gt_labels, gt_valid):
    """Each point's primitive membership and vote offset (gga_tpu
    ``_primitive_targets_single`` batched; axis-aligned, the yaw
    ignored). gt_boxes [B, G, 7] bottom-centre depth boxes.

    Returns mask [B, N], offset [B, N, 3], sem [B, N] class, size
    [B, N, num_dims]."""
    t = cfg.dist_thresh
    grav = torch.cat([gt_boxes[..., :2], (gt_boxes[..., 2]
                                          + gt_boxes[..., 5] / 2)[..., None]],
                     -1)
    half = (gt_boxes[..., 3:6] / 2)[:, None]               # [B, 1, G, 3]
    g = grav[:, None]                                      # [B, 1, G, 3]
    rel = points[:, :, None, :] - g                        # [B, N, G, 3]
    inside_xy = ((rel[..., 0].abs() <= half[..., 0] + t)
                 & (rel[..., 1].abs() <= half[..., 1] + t))
    inside_z = rel[..., 2].abs() <= half[..., 2] + t
    gv = gt_valid[:, None, :]
    shape2 = rel.shape[:3]
    if cfg.mode == 'z':
        d_top = (rel[..., 2] - half[..., 2]).abs()
        d_bot = (rel[..., 2] + half[..., 2]).abs()
        member = (torch.minimum(d_top, d_bot) < t) & inside_xy & gv
        sign = torch.where(d_top < d_bot, 1.0, -1.0)
        center = torch.cat([g[..., :2].expand(*shape2, 2),
                            (g[..., 2] + sign * half[..., 2])[..., None]], -1)
        size = gt_boxes[:, None, :, 3:5].expand(*shape2, 2)
    elif cfg.mode == 'xy':
        d_xp = (rel[..., 0] - half[..., 0]).abs()
        d_xm = (rel[..., 0] + half[..., 0]).abs()
        d_yp = (rel[..., 1] - half[..., 1]).abs()
        d_ym = (rel[..., 1] + half[..., 1]).abs()
        dmin = torch.minimum(torch.minimum(d_xp, d_xm),
                             torch.minimum(d_yp, d_ym))
        member = (dmin < t) & inside_z & inside_xy & gv
        is_x = torch.minimum(d_xp, d_xm) <= torch.minimum(d_yp, d_ym)
        sx = torch.where(d_xp < d_xm, 1.0, -1.0)
        sy = torch.where(d_yp < d_ym, 1.0, -1.0)
        cx = torch.where(is_x, g[..., 0] + sx * half[..., 0], g[..., 0])
        cy = torch.where(is_x, g[..., 1], g[..., 1] + sy * half[..., 1])
        center = torch.stack([cx, cy, g[..., 2].expand(*shape2)], -1)
        size = gt_boxes[:, None, :, 5:6].expand(*shape2, 1)
    else:   # 'line': the nearest of the 4 vertical and 8 horizontal edges
        dx = (rel[..., 0].abs() - half[..., 0]).abs()
        dy = (rel[..., 1].abs() - half[..., 1]).abs()
        dz = (rel[..., 2].abs() - half[..., 2]).abs()
        near_vert = (dx < t) & (dy < t) & inside_z
        near_horiz = (dz < t) & (((dx < t) & inside_xy)
                                 | ((dy < t) & inside_xy))
        member = (near_vert | near_horiz) & gv
        sx = torch.sign(rel[..., 0]) * half[..., 0]
        sy = torch.sign(rel[..., 1]) * half[..., 1]
        sz = torch.sign(rel[..., 2]) * half[..., 2]
        vert_c = torch.stack([g[..., 0] + sx, g[..., 1] + sy,
                              g[..., 2].expand(*shape2)], -1)
        horiz_x = torch.stack([g[..., 0].expand(*shape2), g[..., 1] + sy,
                               g[..., 2] + sz], -1)
        horiz_y = torch.stack([g[..., 0] + sx, g[..., 1].expand(*shape2),
                               g[..., 2] + sz], -1)
        center = torch.where(near_vert[..., None], vert_c,
                             torch.where((dx < dy)[..., None], horiz_y,
                                         horiz_x))
        size = rel.new_zeros(*shape2, 0)

    member = member & p_valid[:, :, None]
    d2 = torch.where(member, (rel ** 2).sum(-1), torch.inf)
    best = d2.argmin(-1)                                   # [B, N]
    mask = member.any(-1)

    def pick(x):                                           # [B, N, G, k]
        return x.gather(2, best[..., None, None].expand(
            *best.shape, 1, x.shape[-1]))[:, :, 0]

    offset = torch.where(mask[..., None], pick(center) - points, 0.0)
    sem = torch.where(mask, gt_labels.long().clamp(0, cfg.num_classes - 1)
                      .gather(1, best), 0)
    size_t = torch.where(mask[..., None], pick(size), 0.0)
    return mask, offset, sem, size_t


def primitive_loss(cfg: PrimitiveConfig, preds, seeds, seed_valid, gt_boxes,
                   gt_labels, gt_valid):
    """Flag CE + vote L1 + the chamfer-matched centre / size / class
    losses (gga_tpu ``primitive_loss``). Returns (total, logs)."""
    mask, offset, sem_t, size_t = _primitive_targets(
        cfg, seeds, seed_valid, gt_boxes, gt_labels, gt_valid)
    m = mask.float()
    n_pos = m.sum().clamp(min=1.0)

    # flag CE with class weights as VoteNet's objectness (0.2 / 0.8)
    w = torch.where(mask, 0.8, 0.2) * seed_valid
    flag_ce = -torch.log_softmax(preds['flag'], -1).gather(
        -1, mask.long()[..., None])[..., 0]
    loss_flag = ((flag_ce * w).sum() / seed_valid.float().sum().clamp(min=1.0)
                 * cfg.flag_weight)

    vote_err = (preds['votes'] - (seeds + offset)).abs().sum(-1)
    loss_vote = (vote_err * m).sum() / n_pos * cfg.vote_weight

    # each predicted centre against its nearest target centre
    gt_center = torch.where(mask[..., None], seeds + offset, BIG)
    d2 = ((preds['center'][:, :, None, :] - gt_center[:, None, :, :])
          ** 2).sum(-1)                                    # [B, P, N]
    j = d2.argmin(-1)
    dmin = torch.sqrt(d2.amin(-1).clamp(min=1e-12))
    ok = preds['agg_valid'] & mask.any(-1, keepdim=True) & (dmin < BIG / 2)
    okf = ok.float()
    n = okf.sum(-1).clamp(min=1.0)
    c_loss = (dmin * okf).sum(-1) / n
    s_loss = ((_take(size_t, j) - preds['size_res']).abs()
              * okf[..., None]).sum((-2, -1)) / n
    s_ce = -torch.log_softmax(preds['sem'], -1).gather(
        -1, sem_t.gather(1, j)[..., None])[..., 0]
    se_loss = (s_ce * okf).sum(-1) / n
    loss_center = c_loss.mean() * cfg.center_weight
    loss_size = s_loss.mean() * cfg.size_weight
    loss_sem = se_loss.mean() * cfg.sem_weight

    total = loss_flag + loss_vote + loss_center + loss_size + loss_sem
    return total, {
        f'flag_loss_{cfg.mode}': loss_flag,
        f'vote_loss_{cfg.mode}': loss_vote,
        f'center_loss_{cfg.mode}': loss_center,
        f'size_loss_{cfg.mode}': loss_size,
        f'sem_loss_{cfg.mode}': loss_sem,
    }


def box_surface_line_centers(boxes):
    """[B, P, 7] bottom-centre depth boxes -> (face centres [B, P * 6, 3],
    edge centres [B, P * 12, 3]) (base_box3d.get_surface_line_center)."""
    grav = torch.cat([boxes[..., :2], (boxes[..., 2]
                                       + boxes[..., 5] / 2)[..., None]], -1)
    hx, hy, hz = boxes[..., 3] / 2, boxes[..., 4] / 2, boxes[..., 5] / 2
    zeros = torch.zeros_like(hx)

    def offs(ox, oy, oz):
        return torch.stack([ox, oy, oz], -1)

    surf = torch.stack([
        offs(zeros, zeros, hz), offs(zeros, zeros, -hz),
        offs(hx, zeros, zeros), offs(-hx, zeros, zeros),
        offs(zeros, hy, zeros), offs(zeros, -hy, zeros)], -2)
    line = torch.stack([
        offs(hx, hy, zeros), offs(hx, -hy, zeros),
        offs(-hx, hy, zeros), offs(-hx, -hy, zeros),
        offs(hx, zeros, hz), offs(hx, zeros, -hz),
        offs(-hx, zeros, hz), offs(-hx, zeros, -hz),
        offs(zeros, hy, hz), offs(zeros, hy, -hz),
        offs(zeros, -hy, hz), offs(zeros, -hy, -hz)], -2)
    B, P = boxes.shape[:2]
    return ((grav[..., None, :] + surf).reshape(B, P * 6, 3),
            (grav[..., None, :] + line).reshape(B, P * 12, 3))


@dataclasses.dataclass(frozen=True)
class H3DBboxConfig:
    num_classes: int = 18
    in_channels: int = 128           # aggregated proposal features
    primitive_channels: int = 128
    match_radius: float = 0.5
    match_samples: int = 1
    match_mlp: Tuple[int, ...] = (128, 128)
    agg_channels: Tuple[int, ...] = (128,)


class H3DBboxHead(nn.Module):
    """Refine the RPN's proposals with the matched primitives' features.
    ``prop_channels`` is the proposals' feature width and
    ``surface_channels`` / ``line_channels`` the primitives' (gga_tpu
    reads them off its inputs)."""

    def __init__(self, cfg: H3DBboxConfig, prop_channels, surface_channels,
                 line_channels):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.surface_matcher = PointSAModule(
            0, c.match_radius, c.match_samples, surface_channels,
            c.match_mlp, conv2d=False)
        self.line_matcher = PointSAModule(
            0, c.match_radius, c.match_samples, line_channels, c.match_mlp,
            conv2d=False)
        width = 18 * c.match_mlp[-1]
        self.matching_conv = SharedMLP(width, (128,))
        self.matching_pred = PointConv(128, 18, bias=True)
        self.sem_matching_conv = SharedMLP(width, (128,))
        self.sem_matching_pred = PointConv(128, 18, bias=True)
        self.feat_agg = SharedMLP(width, c.agg_channels)
        self.refine_proj = PointConv(c.agg_channels[-1], prop_channels,
                                     bias=True)

    def forward(self, proposals, prop_feats, prop_valid, prim_surface,
                prim_line):
        """proposals [B, P, 7]; prop_feats [B, P, C]; prop_valid [B, P];
        prim_surface / prim_line: dicts of center [B, S, 3] (BIG where
        rejected), feats [B, S, C'] and valid [B, S]."""
        B, P = proposals.shape[:2]
        surf_c, line_c = box_surface_line_centers(proposals)

        def match(sa, prim, centers):
            return sa(prim['center'], prim['feats'], prim['valid'],
                      target_xyz=centers,
                      target_valid=centers.new_ones(centers.shape[:2],
                                                    dtype=torch.bool))[1]

        sf = match(self.surface_matcher, prim_surface, surf_c)
        lf = match(self.line_matcher, prim_line, line_c)
        comb = torch.cat([sf.reshape(B, P, -1), lf.reshape(B, P, -1)], -1)
        h = self.feat_agg(comb, prop_valid)
        return dict(
            refined_feats=self.refine_proj(h) + prop_feats,
            matching_score=self.matching_pred(
                self.matching_conv(comb, prop_valid)),
            semantic_matching_score=self.sem_matching_pred(
                self.sem_matching_conv(comb, prop_valid)))
