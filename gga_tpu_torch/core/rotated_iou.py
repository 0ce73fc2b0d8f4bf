"""Rotated BEV box overlap, vectorized over all box pairs (port of
``gga_tpu/core/rotated_iou.py``).

The convex intersection of two rotated rectangles: the 16 edge-edge
intersection points and the corners of each box inside the other give at
most 24 candidate vertices; sorted by angle around their centroid, the
shoelace formula gives the area. Invalid vertices collapse onto the first
valid one. gga_tpu sorts with a bitonic network (a TPU workaround) that
reproduces the stable (angle, index) order; a stable ``torch.sort`` gives
that order directly. Boxes may carry leading batch dims.
"""
from __future__ import annotations

import torch


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _box_corners(boxes):
    """[..., 5] (x, y, dx, dy, yaw) -> [..., 4, 2] CCW corners."""
    hx, hy = boxes[..., 2] / 2.0, boxes[..., 3] / 2.0
    local = torch.stack([
        torch.stack([hx, hy], -1), torch.stack([-hx, hy], -1),
        torch.stack([-hx, -hy], -1), torch.stack([hx, -hy], -1)], dim=-2)
    c = torch.cos(boxes[..., 4])[..., None]
    s = torch.sin(boxes[..., 4])[..., None]
    rx = local[..., 0] * c - local[..., 1] * s
    ry = local[..., 0] * s + local[..., 1] * c
    return torch.stack([rx, ry], dim=-1) + boxes[..., None, :2]


def _corners_in_box(corners, boxes, eps=1e-5):
    """corners [..., 4, 2] tested against boxes [..., 5] -> [..., 4]."""
    rel = corners - boxes[..., None, :2]
    c = torch.cos(boxes[..., 4])[..., None]
    s = torch.sin(boxes[..., 4])[..., None]
    lx = rel[..., 0] * c + rel[..., 1] * s
    ly = -rel[..., 0] * s + rel[..., 1] * c
    return ((lx.abs() <= boxes[..., 2:3] / 2.0 + eps)
            & (ly.abs() <= boxes[..., 3:4] / 2.0 + eps))


def rotated_overlap(boxes1, boxes2):
    """Pairwise intersection areas: [..., N, 5] x [..., M, 5] -> [..., N, M]."""
    N, M = boxes1.shape[-2], boxes2.shape[-2]
    lead = torch.broadcast_shapes(boxes1.shape[:-2], boxes2.shape[:-2])
    b1 = boxes1[..., :, None, :].expand(*lead, N, M, 5)
    b2 = boxes2[..., None, :, :].expand(*lead, N, M, 5)
    c1 = _box_corners(b1)                                  # [..., N, M, 4, 2]
    c2 = _box_corners(b2)

    # edge-edge intersections (16 pairs)
    p = c1[..., :, None, :]
    r = (torch.roll(c1, -1, dims=-2) - c1)[..., :, None, :]
    q = c2[..., None, :, :]
    s = (torch.roll(c2, -1, dims=-2) - c2)[..., None, :, :]
    denom = _cross2(r, s)                                  # [..., 4, 4]
    qp = q - p
    safe = torch.where(denom == 0, 1.0, denom)
    t = _cross2(qp, s) / safe
    u = _cross2(qp, r) / safe
    hit = ((denom.abs() > 1e-10) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1))
    ipts = (p + t[..., None] * r).reshape(*lead, N, M, 16, 2)
    hit = hit.reshape(*lead, N, M, 16)

    pts = torch.cat([ipts, c1, c2], dim=-2)                # [..., 24, 2]
    mask = torch.cat([hit, _corners_in_box(c1, b2), _corners_in_box(c2, b1)],
                     dim=-1)
    count = mask.sum(-1, keepdim=True)
    centroid = ((pts * mask[..., None]).sum(-2, keepdim=True)
                / count.clamp(min=1)[..., None])
    ang = torch.atan2(pts[..., 1] - centroid[..., 1],
                      pts[..., 0] - centroid[..., 0])
    ang = torch.where(mask, ang, 1e9)                      # invalid sort last
    order = torch.sort(ang, dim=-1, stable=True).indices
    pts_s = pts.gather(-2, order[..., None].expand_as(pts))
    mask_s = mask.gather(-1, order)
    pts_s = torch.where(mask_s[..., None], pts_s, pts_s[..., :1, :])
    nxt = torch.roll(pts_s, -1, dims=-2)
    area = 0.5 * _cross2(pts_s, nxt).sum(-1).abs()
    return torch.where(count[..., 0] >= 3, area, 0.0)


def rotated_iou_bev(boxes1, boxes2, eps=1e-8):
    """Pairwise BEV IoU of [..., N, 5] x [..., M, 5] (x, y, dx, dy, yaw)."""
    inter = rotated_overlap(boxes1, boxes2)
    a1 = boxes1[..., 2] * boxes1[..., 3]
    a2 = boxes2[..., 2] * boxes2[..., 3]
    union = a1[..., :, None] + a2[..., None, :] - inter
    return inter / union.clamp(min=eps)


def rotated_iou_3d(boxes1, boxes2, eps=1e-8):
    """Pairwise 3D IoU of [..., N, 7] x [..., M, 7] bottom-centre boxes
    (x, y, z, dx, dy, dz, yaw): the rotated BEV overlap times the z
    overlap (gga_tpu ``rotated_iou_3d``, its 'iou' mode)."""
    bev = [0, 1, 3, 4, 6]
    inter_bev = rotated_overlap(boxes1[..., bev], boxes2[..., bev])
    z1lo, z1hi = boxes1[..., 2], boxes1[..., 2] + boxes1[..., 5]
    z2lo, z2hi = boxes2[..., 2], boxes2[..., 2] + boxes2[..., 5]
    zoverlap = (torch.minimum(z1hi[..., :, None], z2hi[..., None, :])
                - torch.maximum(z1lo[..., :, None], z2lo[..., None, :])
                ).clamp(min=0.0)
    inter = inter_bev * zoverlap
    v1 = boxes1[..., 3] * boxes1[..., 4] * boxes1[..., 5]
    v2 = boxes2[..., 3] * boxes2[..., 4] * boxes2[..., 5]
    union = v1[..., :, None] + v2[..., None, :] - inter
    return inter / union.clamp(min=eps)
