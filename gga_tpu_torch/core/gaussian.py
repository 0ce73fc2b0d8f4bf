"""Gaussian heatmap targets and the focal loss of center-based heads (port
of ``gga_tpu/core/gaussian.py``).

``render_heatmaps`` is the plain PyTorch renderer with the semantics of
gga_tpu's ``render_heatmap_dyn`` (the default renderer): the live objects
of each map are compacted to the front, then rendered in chunks of 32 as
a max over dense gaussian windows. It renders a batch of maps at once and
is the reference of the CUDA kernel ``kernels.heatmap.render_heatmap``.
"""
from __future__ import annotations

import torch


def gaussian_radius(det_size, min_overlap=0.5):
    """Radius such that a shifted box keeps >= ``min_overlap`` IoU
    (CenterNet's formula, elementwise over tensors).

    ``det_size`` is (height, width) in feature-map cells. As in gga_tpu
    and the reference, r2 and r3 divide by 2 where the quadratic formula
    would divide by 2a: the historical quirk is kept for parity."""
    height, width = det_size
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0.0))
    r1 = (b1 + sq1) / 2

    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = torch.sqrt(torch.clamp(b2 ** 2 - 4 * 4 * c2, min=0.0))
    r2 = (b2 + sq2) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))
    r3 = (b3 + sq3) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def render_heatmaps(centers, radii, valid, hw, chunk=32):
    """Max-combined gaussian heatmaps, one per row of objects.

    Each valid object contributes ``exp(-(dx^2 + dy^2) / (2 sigma^2 +
    1e-12))``, sigma = (2r + 1) / 6, inside its square window
    ``|dx|, |dy| <= r``; the map is the max over objects and 0 elsewhere.
    At a centre the value is exactly 1.0.

    Args:
        centers: [G, M, 2] int (x, y) feature-map centers.
        radii: [G, M] int radii.
        valid: [G, M] bool.
        hw: (H, W).
    Returns:
        [G, H, W] float32.
    """
    H, W = hw
    G = centers.shape[0]
    dev = centers.device
    out = torch.zeros((G, H, W), dtype=torch.float32, device=dev)
    # live objects first (max is order-free, so the result is unchanged)
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices
    n_live = int(valid.sum(1).max()) if G else 0
    order = order[:, :n_live]
    cx = centers[..., 0].gather(1, order)
    cy = centers[..., 1].gather(1, order)
    rr = radii.gather(1, order)
    vv = valid.gather(1, order)
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    for i in range(0, n_live, chunk):
        ccx = cx[:, i:i + chunk, None, None]
        ccy = cy[:, i:i + chunk, None, None]
        crr = rr[:, i:i + chunk, None, None]
        dx = xs - ccx                                   # [G, c, H, W]
        dy = ys - ccy
        sigma = (2.0 * crr.float() + 1.0) / 6.0
        g = torch.exp(-(dx.float() ** 2 + dy.float() ** 2)
                      / (2.0 * sigma ** 2 + 1e-12))
        inside = ((dx.abs() <= crr) & (dy.abs() <= crr)
                  & vv[:, i:i + chunk, None, None])
        g = torch.where(inside, g, 0.0)
        out = torch.maximum(out, g.amax(1))
    return out


def render_class_heatmaps(centers, radii, cls_ids, valid, num_classes, hw):
    """Per-class heatmaps of a batch of scenes (gga_tpu
    ``render_class_heatmaps``, batched over scenes): object k of scene b
    renders onto map ``cls_ids[b, k]`` of that scene.

    Every (class, scene) map is rendered in one call of
    ``kernels.heatmap.render_heatmap``: one kernel launch on a CUDA
    tensor, ``render_heatmaps`` on a CPU one.

    Args:
        centers: [B, M, 2] int (x, y) feature-map centres; radii [B, M]
            int; cls_ids [B, M] int; valid [B, M] bool.
    Returns:
        [num_classes, B, H, W] float32.
    """
    from ..kernels import heatmap
    B, M = radii.shape
    maps_valid = torch.stack([valid & (cls_ids == c)
                              for c in range(num_classes)]).reshape(-1, M)
    hms = heatmap.render_heatmap(
        centers.int().repeat(num_classes, 1, 1),
        radii.int().repeat(num_classes, 1), maps_valid, hw)
    return hms.reshape(num_classes, B, *hms.shape[1:])


def gaussian_focal_loss(pred, gaussian_target, alpha=2.0, gamma=4.0):
    """Per-element GaussianFocalLoss (mmdet ``gaussian_focal_loss``):
    positives ``-log(p) (1-p)^alpha`` where the target is 1, negatives
    ``-log(1-p) p^alpha (1-t)^gamma`` elsewhere. The GGA config uses
    alpha = 0, a plain log-loss on the positives."""
    eps = 1e-12
    pos_weights = (gaussian_target == 1.0).to(pred.dtype)
    neg_weights = torch.pow(1 - gaussian_target, gamma)
    pos_loss = -torch.log(pred + eps) * torch.pow(1 - pred, alpha) \
        * pos_weights
    neg_loss = -torch.log(1 - pred + eps) * torch.pow(pred, alpha) \
        * (1 - pos_weights) * neg_weights
    return pos_loss + neg_loss


def clip_sigmoid(x, eps=1e-4):
    """Sigmoid clamped to [eps, 1 - eps] (mmdet3d ``clip_sigmoid``)."""
    return torch.clamp(torch.sigmoid(x), eps, 1 - eps)
