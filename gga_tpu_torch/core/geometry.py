"""3D box geometry the GGA losses need (port of the parts of
``gga_tpu/core/geometry.py`` that ``_predict_geometry`` calls).

Boxes follow the LiDAR convention of the reference: yaw about +z, 0 at
+x, counter-clockwise; box origins are bottom centres (0.5, 0.5, 0).

Everything stays in f32. gga_tpu contracts these with
``Precision.HIGHEST`` because the TPU's default matmul precision is bf16;
on the card the port's entry points turn TF32 off (``device.py``), so a
float32 product here is a full float32 product.
"""
from __future__ import annotations

import numpy as np
import torch

# the 8 binary corners of the unit cube, reordered so the BEV faces walk
# clockwise (reference lidar_box3d.py:52-80)
_CORNER_ORDER = np.stack(np.unravel_index(np.arange(8), [2] * 3), axis=1)[
    [0, 1, 3, 2, 4, 5, 7, 6]].astype(np.float32)                # [8, 3]

LIDAR_ORIGIN = (0.5, 0.5, 0.0)


def rotation_matrix_z(angles):
    """[..., 3, 3] right-multiplication matrices, ``p_rot = p @ M``:
    x' = x cos - y sin, y' = x sin + y cos (counter-clockwise about +z)."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    rows = [[c, s, zero], [-s, c, zero], [zero, zero, one]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rotate_points(points, angles):
    """Rotate [..., M, 3] points about z by per-box [...] angles."""
    return torch.einsum('...md,...de->...me', points,
                        rotation_matrix_z(angles))


def corners_3d(centers, dims, angles, origin=LIDAR_ORIGIN):
    """[N, 3] box origins, [N, 3] sizes, [N] yaws -> [N, 8, 3] corners in
    the reference's corner order (``box_np_ops.center_to_corner_box3d``)."""
    norm = torch.as_tensor(_CORNER_ORDER, device=dims.device) - torch.tensor(
        origin, dtype=torch.float32, device=dims.device)
    corners = dims[..., None, :] * norm
    return rotate_points(corners, angles) + centers[..., None, :]
