"""Box coders (port of ``gga_tpu/core/coders.py``): ``delta_encode`` /
``delta_decode``, the anchor heads' (mmdet3d's DeltaXYZWLHRBBoxCoder,
SECOND's residuals against anchors with the BEV diagonal as the x / y
scale; boxes and anchors bottom-centre (x, y, z, dx, dy, dz, yaw), the z
residual taken between the gravity centres), and ``point_xyzwhlr_encode``
/ ``point_xyzwhlr_decode``, PointRCNN's RPN's (mmdet3d's
PointXYZWHLRBBoxCoder with per-class mean sizes: gravity-centre boxes
against points, the yaw as its cosine and sine)."""
from __future__ import annotations

import torch


def delta_encode(boxes, anchors):
    """[..., 7] GT boxes against [..., 7] anchors -> [..., 7] deltas."""
    xa, ya, za, wa, la, ha, ra = anchors.unbind(-1)
    xg, yg, zg, wg, lg, hg, rg = boxes.unbind(-1)
    za = za + ha / 2
    zg = zg + hg / 2
    diag = torch.sqrt(la ** 2 + wa ** 2)
    return torch.stack([
        (xg - xa) / diag, (yg - ya) / diag, (zg - za) / ha,
        torch.log(wg.clamp(min=1e-6) / wa), torch.log(lg.clamp(min=1e-6) / la),
        torch.log(hg.clamp(min=1e-6) / ha), rg - ra], -1)


def delta_decode(deltas, anchors):
    """Inverse of ``delta_encode``: [..., 7] boxes (bottom-centre z)."""
    xa, ya, za, wa, la, ha, ra = anchors.unbind(-1)
    xt, yt, zt, wt, lt, ht, rt = deltas.unbind(-1)
    za = za + ha / 2
    diag = torch.sqrt(la ** 2 + wa ** 2)
    hg = torch.exp(ht) * ha
    return torch.stack([
        xt * diag + xa, yt * diag + ya, zt * ha + za - hg / 2,
        torch.exp(wt) * wa, torch.exp(lt) * la, hg, rt + ra], -1)


def _mean_sizes(mean_sizes, labels):
    return torch.as_tensor(mean_sizes, dtype=torch.float32,
                           device=labels.device)[labels]


def point_xyzwhlr_encode(gt_boxes, points, labels, mean_sizes):
    """[..., 7] gravity-centre boxes against [..., 3] points with the
    [K, 3] mean size of their [...] class -> [..., 8]: (x, y) offsets over
    the mean size's BEV diagonal, z over its height, the log of the dims
    over the mean, cos and sin of the yaw."""
    mean = _mean_sizes(mean_sizes, labels)
    dims = gt_boxes[..., 3:6].clamp(min=1e-5)
    diag = torch.sqrt(mean[..., 0] ** 2 + mean[..., 1] ** 2)
    r = gt_boxes[..., 6]
    return torch.cat([
        torch.stack([(gt_boxes[..., 0] - points[..., 0]) / diag,
                     (gt_boxes[..., 1] - points[..., 1]) / diag,
                     (gt_boxes[..., 2] - points[..., 2]) / mean[..., 2]], -1),
        torch.log(dims / mean),
        torch.stack([torch.cos(r), torch.sin(r)], -1)], -1)


def point_xyzwhlr_decode(encodings, points, labels, mean_sizes):
    """Inverse of ``point_xyzwhlr_encode`` -> [..., 7] gravity-centre
    boxes. The yaw's atan2 takes (0, 1) where cos and sin are both near 0
    (gga_tpu's guard: atan2's gradient at (0, 0) is NaN)."""
    mean = _mean_sizes(mean_sizes, labels)
    diag = torch.sqrt(mean[..., 0] ** 2 + mean[..., 1] ** 2)
    cos, sin = encodings[..., 6], encodings[..., 7]
    safe = (cos.abs() + sin.abs()) > 1e-8
    r = torch.atan2(torch.where(safe, sin, 0.0), torch.where(safe, cos, 1.0))
    return torch.cat([
        torch.stack([encodings[..., 0] * diag + points[..., 0],
                     encodings[..., 1] * diag + points[..., 1],
                     encodings[..., 2] * mean[..., 2] + points[..., 2]], -1),
        torch.exp(encodings[..., 3:6]) * mean, r[..., None]], -1)
