"""NMS with static shapes (port of ``gga_tpu/core/nms.py``
``_greedy_suppress``, ``nms_bev``, ``circle_nms`` and ``aligned_3d_nms``),
batched over leading dims."""
from __future__ import annotations

import torch

from .rotated_iou import rotated_iou_bev


def _greedy_suppress(iou, scores, thresh):
    """Greedy NMS keep mask from a full IoU matrix.

    The greedy keep mask is the unique fixpoint of k = valid & ~(S^T k),
    with S[j, i] = "higher-ranked j suppresses i"; iterating from
    k = valid reaches it within the longest suppression chain. Every row
    of a batch iterates until all rows are fixed: a fixed row stays fixed.

    Args:
        iou: [..., N, N]; scores: [..., N], -inf marks padding.
    Returns:
        [..., N] bool keep mask in the given order.
    """
    n = scores.shape[-1]
    order = torch.sort(-scores, dim=-1, stable=True).indices
    iou_o = iou.gather(-2, order[..., :, None].expand_as(iou))
    iou_o = iou_o.gather(-1, order[..., None, :].expand_as(iou))
    valid = torch.isfinite(scores.gather(-1, order))
    idx = torch.arange(n, device=scores.device)
    sup = ((iou_o > thresh) & (idx[:, None] < idx[None, :])
           & valid[..., :, None] & valid[..., None, :])   # [j, i]
    keep, prev = valid, ~valid
    for _ in range(n):
        if torch.equal(keep, prev):
            break
        keep, prev = valid & ~(sup & keep[..., :, None]).any(-2), keep
    return torch.zeros_like(keep).scatter(-1, order, keep)


def nms_bev(boxes_xywhr, scores, thresh, post_max_size=None, valid=None):
    """Rotated BEV NMS.

    Args:
        boxes_xywhr: [..., N, 5]; scores: [..., N]; valid: [..., N] bool,
            False entries are never kept.
    Returns:
        (indices [..., post_max_size] int64 of kept boxes by score, -1
         padded; keep mask [..., N] in the given order).
    """
    n = boxes_xywhr.shape[-2]
    if post_max_size is None:
        post_max_size = n
    s = scores if valid is None else torch.where(valid, scores, -torch.inf)
    keep = _greedy_suppress(rotated_iou_bev(boxes_xywhr, boxes_xywhr), s,
                            thresh)
    ranked = torch.sort(torch.where(keep, -s, torch.inf), dim=-1,
                        stable=True).indices
    idx = torch.arange(n, device=scores.device)
    out = torch.where(idx < keep.sum(-1, keepdim=True), ranked, -1)
    return out[..., :post_max_size], keep


def circle_nms(centers, scores, min_radius, post_max_size=None, valid=None):
    """Centre-distance NMS (gga_tpu ``circle_nms``, mmdet3d
    ``box3d_nms.circle_nms``): a detection is suppressed where its squared
    BEV centre distance to a kept higher-scoring one is below
    ``min_radius``. The squared distance is held against the UNSQUARED
    radius, as in the reference.

    Args:
        centers: [..., N, 2]; scores: [..., N]; valid: [..., N] bool,
            False entries are never kept.
    Returns:
        (indices [..., post_max_size] int64 of kept boxes by score, -1
         padded; keep mask [..., N] in the given order).
    """
    n = centers.shape[-2]
    if post_max_size is None:
        post_max_size = n
    s = scores if valid is None else torch.where(valid, scores, -torch.inf)
    d2 = ((centers[..., :, None, :] - centers[..., None, :, :]) ** 2).sum(-1)
    keep = _greedy_suppress((d2 < min_radius).float(), s, 0.5)
    ranked = torch.sort(torch.where(keep, -s, torch.inf), dim=-1,
                        stable=True).indices
    idx = torch.arange(n, device=scores.device)
    out = torch.where(idx < keep.sum(-1, keepdim=True), ranked, -1)
    return out[..., :post_max_size], keep


def aligned_3d_nms(boxes, scores, classes, thresh, valid=None):
    """Class-aware axis-aligned 3D NMS (gga_tpu ``aligned_3d_nms``,
    mmdet3d ``box3d_nms.aligned_3d_nms``): the IoU of boxes of different
    classes is 0.

    Args:
        boxes: [..., N, 6] (x1, y1, z1, x2, y2, z2); scores: [..., N];
            classes: [..., N]; valid: [..., N] bool, False entries are
            never kept.
    Returns:
        keep mask [..., N] bool in the given order.
    """
    xyz1, xyz2 = boxes[..., :3], boxes[..., 3:6]
    vol = (xyz2 - xyz1).clamp(min=0.0).prod(-1)
    lo = torch.maximum(xyz1[..., :, None, :], xyz1[..., None, :, :])
    hi = torch.minimum(xyz2[..., :, None, :], xyz2[..., None, :, :])
    inter = (hi - lo).clamp(min=0.0).prod(-1)
    union = vol[..., :, None] + vol[..., None, :] - inter
    iou = inter / union.clamp(min=1e-8)
    iou = torch.where(classes[..., :, None] == classes[..., None, :], iou,
                      0.0)
    s = scores if valid is None else torch.where(valid, scores, -torch.inf)
    return _greedy_suppress(iou, s, thresh)
