"""Rotated (BEV) box overlap in numpy for the host-side KITTI eval (the
port's copy of the ``xp=np`` branch of ``gga_tpu/core/rotated_iou.py``
and its ``rotated_iou_camera_eval``; that module imports JAX).

The convex intersection of two rotated rectangles, vectorized over the
[N, M] pair grid: the 16 edge-edge intersection points and the corners of
each box inside the other give at most 24 candidate vertices; sorted by
angle around their centroid (``argsort``), the shoelace formula gives the
area, with invalid vertices collapsed onto the first valid one.
"""
from __future__ import annotations

import numpy as np


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _box_corners(boxes):
    """[..., 5] (x, y, dx, dy, yaw) -> [..., 4, 2] CCW corners."""
    half = boxes[..., 2:4] / 2.0
    hx, hy = half[..., 0], half[..., 1]
    local = np.stack([
        np.stack([hx, hy], -1),
        np.stack([-hx, hy], -1),
        np.stack([-hx, -hy], -1),
        np.stack([hx, -hy], -1),
    ], axis=-2)
    c = np.cos(boxes[..., 4])[..., None]
    s = np.sin(boxes[..., 4])[..., None]
    rx = local[..., 0] * c - local[..., 1] * s
    ry = local[..., 0] * s + local[..., 1] * c
    rot = np.stack([rx, ry], axis=-1)
    return rot + boxes[..., None, :2]


def _corners_in_box(corners, boxes, eps=1e-5):
    """corners [..., 4, 2] tested against boxes [..., 5] -> [..., 4] bool."""
    rel = corners - boxes[..., None, :2]
    c = np.cos(boxes[..., 4])[..., None]
    s = np.sin(boxes[..., 4])[..., None]
    lx = rel[..., 0] * c + rel[..., 1] * s
    ly = -rel[..., 0] * s + rel[..., 1] * c
    half = boxes[..., 2:4] / 2.0
    return ((np.abs(lx) <= half[..., 0:1] + eps)
            & (np.abs(ly) <= half[..., 1:2] + eps))


def rotated_overlap(boxes1, boxes2):
    """Pairwise intersection areas of rotated BEV rectangles.

    Args:
        boxes1: [N, 5] (x, y, dx, dy, yaw).
        boxes2: [M, 5].

    Returns:
        [N, M] intersection areas.
    """
    N, M = boxes1.shape[0], boxes2.shape[0]
    b1 = np.broadcast_to(boxes1[:, None, :], (N, M, 5))
    b2 = np.broadcast_to(boxes2[None, :, :], (N, M, 5))
    c1 = _box_corners(b1)                        # [N, M, 4, 2]
    c2 = _box_corners(b2)

    # --- edge-edge intersections (16 pairs) ---
    p = c1[..., :, None, :]                      # [N, M, 4, 1, 2]
    r = (np.roll(c1, -1, axis=-2) - c1)[..., :, None, :]
    q = c2[..., None, :, :]                      # [N, M, 1, 4, 2]
    s = (np.roll(c2, -1, axis=-2) - c2)[..., None, :, :]
    denom = _cross2(r, s)                        # [N, M, 4, 4]
    qp = q - p
    t = _cross2(qp, s) / np.where(denom == 0, 1.0, denom)
    u = _cross2(qp, r) / np.where(denom == 0, 1.0, denom)
    hit = ((np.abs(denom) > 1e-10) & (t >= 0) & (t <= 1)
           & (u >= 0) & (u <= 1))
    ipts = p + t[..., None] * r                  # [N, M, 4, 4, 2]
    ipts = ipts.reshape(N, M, 16, 2)
    hit = hit.reshape(N, M, 16)

    # --- contained corners ---
    in12 = _corners_in_box(c1, b2)               # [N, M, 4]
    in21 = _corners_in_box(c2, b1)

    pts = np.concatenate([ipts, c1, c2], axis=-2)          # [N, M, 24, 2]
    mask = np.concatenate([hit, in12, in21], axis=-1)      # [N, M, 24]

    count = mask.sum(axis=-1, keepdims=True)               # [N, M, 1]
    safe = np.maximum(count, 1)
    centroid = (pts * mask[..., None]).sum(axis=-2,
                                           keepdims=True) / safe[..., None]
    ang = np.arctan2(pts[..., 1] - centroid[..., 1],
                     pts[..., 0] - centroid[..., 0])
    ang = np.where(mask, ang, 1e9)               # invalid sorted to end
    order = np.argsort(ang, axis=-1)
    pts_s = np.take_along_axis(pts, order[..., None], axis=-2)
    mask_s = np.take_along_axis(mask, order, axis=-1)
    first = pts_s[..., 0:1, :]
    pts_s = np.where(mask_s[..., None], pts_s, first)
    nxt = np.roll(pts_s, -1, axis=-2)
    area = 0.5 * np.abs(_cross2(pts_s, nxt).sum(axis=-1))
    return np.where(count[..., 0] >= 3, area, 0.0)


def rotated_iou_camera_eval(boxes1, boxes2, criterion=-1):
    """KITTI-eval flavored rotated overlap for camera-frame boxes [N, 5]
    (x, z, l, w, ry_eval) following rotate_iou_gpu_eval semantics
    (rotate_iou.py:337): criterion -1 -> IoU denominator union, 0 -> area1,
    1 -> area2, 2 -> the raw intersection area."""
    boxes1 = np.asarray(boxes1, np.float64)
    boxes2 = np.asarray(boxes2, np.float64)
    # rotate_iou uses boxes (x, y, w, h, angle) with its own corner order;
    # the polygon-intersection area is orientation-agnostic, reuse ours.
    inter = rotated_overlap(
        np.concatenate([boxes1[:, :2], boxes1[:, 2:4], -boxes1[:, 4:5]], 1),
        np.concatenate([boxes2[:, :2], boxes2[:, 2:4], -boxes2[:, 4:5]], 1))
    a1 = boxes1[:, 2] * boxes1[:, 3]
    a2 = boxes2[:, 2] * boxes2[:, 3]
    if criterion == -1:
        denom = a1[:, None] + a2[None, :] - inter
    elif criterion == 0:
        denom = np.broadcast_to(a1[:, None], inter.shape)
    elif criterion == 1:
        denom = np.broadcast_to(a2[None, :], inter.shape)
    else:
        # criterion 2: raw intersection area (rotate_iou.py devide_method
        # fall-through; consumed by d3_box_overlap, eval.py:158)
        return inter
    return inter / np.maximum(denom, 1e-8)


def rotated_iou_3d(boxes1, boxes2, eps=1e-8):
    """Pairwise 3D IoU of [N, 7] x [M, 7] bottom-centre boxes (x, y, z,
    dx, dy, dz, yaw): the rotated BEV overlap times the z overlap."""
    inter_bev = rotated_overlap(boxes1[:, [0, 1, 3, 4, 6]],
                                boxes2[:, [0, 1, 3, 4, 6]])
    z1lo, z1hi = boxes1[:, 2], boxes1[:, 2] + boxes1[:, 5]
    z2lo, z2hi = boxes2[:, 2], boxes2[:, 2] + boxes2[:, 5]
    zoverlap = np.maximum(
        np.minimum(z1hi[:, None], z2hi[None, :])
        - np.maximum(z1lo[:, None], z2lo[None, :]), 0.0)
    inter = inter_bev * zoverlap
    v1 = boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5]
    v2 = boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5]
    return inter / np.maximum(v1[:, None] + v2[None, :] - inter, eps)
