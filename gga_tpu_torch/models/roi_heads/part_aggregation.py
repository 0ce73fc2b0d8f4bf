"""PartA2's part-aggregation RoI head without its bbox head (port of
``gga_tpu/models/roi_heads/part_aggregation.py``; mmdet3d's
part_aggregation_roi_head.py:14), batched over scenes: assignment and
sampling of the proposals, RoI-aware pooling of the seg and part
features, and the RCNN targets.

gga_tpu's sampler keeps ``num_rois`` static slots with validity masks in
place of the reference's IoUNegPiecewiseSampler: positives first (at most
``round(num_rois * pos_fraction)``), then hard and easy negatives
interleaved 4:1, each group in the order of a uniform draw.
"""
from __future__ import annotations

import dataclasses

import torch

from ...core.rotated_iou import rotated_iou_3d
from ...ops.roiaware_pool import roiaware_pool3d
from .parta2_bbox_head import canonical_targets


@dataclasses.dataclass(frozen=True)
class RoIHeadConfig:
    num_rois: int = 128
    pos_fraction: float = 0.55
    pos_iou_thr: float = 0.55          # rcnn assigner (all classes 0.55)
    hard_neg_iou_thr: float = 0.1      # neg_iou_piece_thrs[1]
    hard_neg_fraction: float = 0.8     # neg_piece_fractions[0]
    roi_out_size: int = 14
    roi_pts_budget: int = 512
    # test cfg
    test_nms_thr: float = 0.01
    test_score_thr: float = 0.1


def _gather(x, idx):
    """x [B, P, ...] at idx [B, R] -> [B, R, ...]."""
    return x.gather(1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2)))
                    .expand(*idx.shape, *x.shape[2:]))


@torch.no_grad()
def assign_and_sample(cfg: RoIHeadConfig, r, proposals, prop_valid,
                      gt_boxes, gt_labels, gt_valid):
    """Assignment and static sampling of each scene's proposals.

    Every argsort is a stable sort, the order ``jnp.argsort`` gives keys
    that tie (the capped positives, the infinite keys of the slots left
    empty).

    Args:
        r: [B, P] the uniform draw that orders each group.
        proposals: [B, P, 7]; prop_valid: [B, P];
        gt_boxes: [B, G, 7]; gt_labels: [B, G]; gt_valid: [B, G].
    Returns dict with [B, num_rois] slots: rois [.., 7], roi_valid, ious,
    pos_mask, gt_of_roi [.., 7], gt_label_of_roi.
    """
    P = proposals.shape[1]
    iou = rotated_iou_3d(proposals, gt_boxes)                 # [B, P, G]
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    max_iou = torch.where(prop_valid, iou.amax(-1), -1.0)
    argmax = iou.argmax(-1)

    pos = (max_iou >= cfg.pos_iou_thr) & prop_valid
    hard_neg = (~pos & prop_valid & (max_iou >= cfg.hard_neg_iou_thr)
                & (max_iou < cfg.pos_iou_thr))
    easy_neg = ~pos & ~hard_neg & prop_valid
    num_pos_max = int(round(cfg.num_rois * cfg.pos_fraction))
    ranks = torch.arange(P, dtype=torch.float32, device=r.device).expand(
        r.shape)

    def group_rank(mask):
        order = torch.sort(torch.where(mask, r, 2.0), dim=-1,
                           stable=True).indices
        rank = torch.empty_like(r).scatter_(1, order, ranks)
        return torch.where(mask, rank, torch.inf)

    pos_rank = group_rank(pos)
    hard_rank = group_rank(hard_neg)
    easy_rank = group_rank(easy_neg)
    big = 1e6
    capped = pos & (pos_rank < num_pos_max)
    key = torch.where(
        capped, pos_rank,
        torch.where(hard_neg, big + hard_rank / cfg.hard_neg_fraction,
                    torch.where(easy_neg, big + easy_rank
                                / (1 - cfg.hard_neg_fraction), torch.inf)))
    # overflow positives come last (the reference drops them)
    key = torch.where(pos & ~capped, 2 * big + pos_rank, key)
    order = torch.sort(key, dim=-1, stable=True).indices[:, :cfg.num_rois]
    sel_valid = torch.isfinite(key.gather(1, order))
    gt_idx = argmax.gather(1, order)
    return dict(
        rois=_gather(proposals, order), roi_valid=sel_valid,
        ious=torch.where(sel_valid, max_iou.gather(1, order), 0.0),
        pos_mask=capped.gather(1, order) & sel_valid,
        gt_of_roi=_gather(gt_boxes, gt_idx),
        gt_label_of_roi=gt_labels.gather(1, gt_idx))


def pool_roi_features(cfg: RoIHeadConfig, seg_feats, part_feats,
                      voxel_centers, voxel_valid, rois):
    """RoI-aware pooling (seg: max, part: avg; configs/_base_/models/
    parta2.py:76-89). Returns (seg_grids, part_grids [B, R, S, S, S, C],
    occ [B, R, S, S, S])."""
    seg_grids, occ = roiaware_pool3d(
        seg_feats, voxel_centers, voxel_valid, rois, cfg.roi_out_size,
        'max', cfg.roi_pts_budget)
    part_grids, _ = roiaware_pool3d(
        part_feats, voxel_centers, voxel_valid, rois, cfg.roi_out_size,
        'avg', cfg.roi_pts_budget)
    return seg_grids, part_grids, occ


def build_rcnn_targets(bbox_cfg, samples):
    """The canonical targets of the sampled RoIs, and their GT boxes for
    the corner loss."""
    t = canonical_targets(bbox_cfg, samples['rois'], samples['gt_of_roi'],
                          samples['ious'], samples['pos_mask'],
                          samples['roi_valid'])
    t['gt_of_roi'] = samples['gt_of_roi']
    return t
