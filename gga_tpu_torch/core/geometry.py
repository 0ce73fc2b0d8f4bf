"""3D box geometry the GGA, PGD and SASSD losses need (port of the parts
of ``gga_tpu/core/geometry.py`` that ``_predict_geometry``, the PGD head
and SASSD's auxiliary targets call), and the projection of points into
an image that PointFusion and ImVoxelNet's lift sample through
(``project_to_image``).

LiDAR boxes follow the reference's convention: yaw about +z, 0 at +x,
counter-clockwise; box origins are bottom centres (0.5, 0.5, 0). Camera
boxes (the PGD head) turn about +y (``axis=1``).

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


def rotation_matrix(angles, axis=2):
    """[..., 3, 3] right-multiplication matrices, ``p_rot = p @ M``
    (reference ``rotation_3d_in_axis``). About +z (axis 2): x' = x cos -
    y sin, y' = x sin + y cos; about +y (axis 1): x' = x cos + z sin,
    z' = -x sin + z cos."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == 2:
        rows = [[c, s, zero], [-s, c, zero], [zero, zero, one]]
    elif axis == 1:
        rows = [[c, zero, -s], [zero, one, zero], [s, zero, c]]
    else:
        raise ValueError(f'axis must be 1 or 2, got {axis}')
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rotate_points(points, angles, axis=2):
    """Rotate [..., M, 3] points about ``axis`` by per-box [...] angles."""
    return torch.einsum('...md,...de->...me', points,
                        rotation_matrix(angles, axis))


def corners_3d(centers, dims, angles, origin=LIDAR_ORIGIN, axis=2):
    """[N, 3] box origins, [N, 3] sizes, [N] yaws -> [N, 8, 3] corners in
    the reference's corner order (``box_np_ops.center_to_corner_box3d``)."""
    norm = torch.as_tensor(_CORNER_ORDER, device=dims.device) - torch.tensor(
        origin, dtype=torch.float32, device=dims.device)
    corners = dims[..., None, :] * norm
    return rotate_points(corners, angles, axis) + centers[..., None, :]


def limit_period(val, offset=0.5, period=np.pi):
    """``val`` limited to [-offset * period, (1 - offset) * period)
    (reference ``structures/utils.py limit_period``)."""
    return val - torch.floor(val / period + offset) * period


def points_in_rbbox(points, boxes, origin=LIDAR_ORIGIN):
    """Mask of points inside rotated 3D boxes (gga_tpu ``points_in_rbbox``):
    each point moved into each box's frame about its gravity centre, then
    compared with the half sizes (faces included).

    Args:
        points: [..., P, 3+]; boxes: [..., N, 7] (x, y, z, dx, dy, dz,
            yaw) with ``origin`` semantics.
    Returns:
        [..., P, N] bool.
    """
    o = torch.tensor(origin, dtype=torch.float32, device=boxes.device)
    centers = boxes[..., :3] + boxes[..., 3:6] * (0.5 - o)
    rel = points[..., :, None, :3] - centers[..., None, :, :]
    c = torch.cos(boxes[..., 6])[..., None, :]
    s = torch.sin(boxes[..., 6])[..., None, :]
    local_x = rel[..., 0] * c + rel[..., 1] * s
    local_y = -rel[..., 0] * s + rel[..., 1] * c
    half = (boxes[..., 3:6] / 2.0)[..., None, :, :]
    return ((local_x.abs() <= half[..., 0]) & (local_y.abs() <= half[..., 1])
            & (rel[..., 2].abs() <= half[..., 2]))


def project_to_image(pts_3d, proj_mat):
    """Project 3D points with a 4x4 projection (e.g. lidar2img).

    Args:
        pts_3d: [..., N, 3].
        proj_mat: [..., 4, 4] (broadcastable).
    Returns:
        (pixels [..., N, 2], depth [..., N]); the depth the pixels divide
        by is floored at 1e-5, as in gga_tpu.

    The product is summed in pairs, ``(m0 x + m1 y) + (m2 z + m3)``, as
    XLA sums gga_tpu's f32 einsum on the CPU: a pixel a bilinear sample
    keys on then has gga_tpu's bits.
    """
    m = proj_mat[..., None, :, :]                        # [..., 1, 4, 4]
    p = pts_3d[..., :, None, :]                          # [..., N, 1, 3]
    cam = ((m[..., 0] * p[..., 0] + m[..., 1] * p[..., 1])
           + (m[..., 2] * p[..., 2] + m[..., 3]))        # [..., N, 4]
    depth = cam[..., 2]
    return cam[..., :2] / depth.clamp(min=1e-5)[..., None], depth
