"""3D anchor generation (port of ``gga_tpu/core/anchors.py``): anchor
centres at the voxel centres of the (H, W) feature grid over each class's
range, one (range, size) pair a class, ``rotations`` copies a location
(mmdet3d's AlignedAnchor3DRangeGenerator with align_corner=False)."""
from __future__ import annotations

import numpy as np
import torch


def aligned_anchors_single_range(feature_size, anchor_range, size,
                                 rotations=(0.0, 1.5707963), device='cpu'):
    """Anchors of one class on one feature map.

    Args:
        feature_size: (H, W) BEV feature map size.
        anchor_range: (x0, y0, z0, x1, y1, z1).
        size: (dx, dy, dz).
        rotations: yaw values a location.
    Returns:
        [H, W, len(rotations), 7] f32 anchors (x, y, z, dx, dy, dz, yaw)
        with z at the range's centre, computed in f32 numpy as gga_tpu.
    """
    H, W = feature_size
    r = np.asarray(anchor_range, np.float32)
    xs = r[0] + (np.arange(W, dtype=np.float32) + 0.5) * (r[3] - r[0]) / W
    ys = r[1] + (np.arange(H, dtype=np.float32) + 0.5) * (r[4] - r[1]) / H
    z = (r[2] + r[5]) / 2.0
    xx, yy = np.meshgrid(xs, ys)                      # [H, W]
    rot = np.asarray(rotations, np.float32)
    out = np.zeros((H, W, len(rot), 7), np.float32)
    out[..., 0] = xx[..., None]
    out[..., 1] = yy[..., None]
    out[..., 2] = z
    out[..., 3:6] = np.asarray(size, np.float32)
    out[..., 6] = rot
    return torch.from_numpy(out).to(device)


def multiclass_anchors(feature_size, ranges, sizes,
                       rotations=(0.0, 1.5707963), device='cpu'):
    """Each class's anchors, stacked: [num_classes, H*W*R, 7]."""
    return torch.stack([
        aligned_anchors_single_range(feature_size, r, s, rotations,
                                     device).reshape(-1, 7)
        for r, s in zip(ranges, sizes)])
