"""Host-side (numpy) geometry for the offline data path (the port's copy
of ``gga_tpu/core/np_geometry.py``).

Vectorized numpy re-implementation of the reference's ``box_np_ops``
(mmdet3d/core/bbox/box_np_ops.py) — the numba JITs are
replaced by plain vectorized numpy (this code runs on the host, in the
data converters and the input pipeline).

KITTI-specific conventions:
- camera boxes: (x, y, z, l, h, w, ry) at bottom center, yaw about -y.
- lidar boxes:  (x, y, z, dx, dy, dz, yaw) bottom center, yaw about +z CCW.
"""
from __future__ import annotations

import numpy as np

_CORNER_ORDER = np.stack(np.unravel_index(np.arange(8), [2] * 3), axis=1)[
    [0, 1, 3, 2, 4, 5, 7, 6]
].astype(np.float64)


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


def rotation_matrix_3d(angles, axis=2, clockwise=False):
    """Right-multiplication rotation matrices (p_rot = p @ M), reference
    semantics (structures/utils.py:29). angles: [...]."""
    angles = np.asarray(angles)
    c, s = np.cos(angles), np.sin(angles)
    one, zero = np.ones_like(c), np.zeros_like(c)
    if axis in (1, -2):
        rows = [[c, zero, -s], [zero, one, zero], [s, zero, c]]
    elif axis in (2, -1):
        rows = [[c, s, zero], [-s, c, zero], [zero, zero, one]]
    elif axis in (0, -3):
        rows = [[one, zero, zero], [zero, c, s], [zero, -s, c]]
    else:
        raise ValueError(f'bad axis {axis}')
    mat = np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)
    if clockwise:
        mat = np.swapaxes(mat, -1, -2)
    return mat


def rotate_points(points, angles, axis=2, clockwise=False):
    """Rotate [..., M, D] points by [...] angles (D in (2, 3))."""
    points = np.asarray(points)
    if points.shape[-1] == 2:
        angles = np.asarray(angles)
        c, s = np.cos(angles), np.sin(angles)
        mat = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], -2)
        if clockwise:
            mat = np.swapaxes(mat, -1, -2)
    else:
        mat = rotation_matrix_3d(angles, axis, clockwise)
    return np.einsum('...md,...de->...me', points, mat)


def corners_nd(dims, origin=0.5):
    """[N, 3] dims -> [N, 8, 3] axis-aligned corners around ``origin``."""
    origin = np.asarray(origin, dtype=dims.dtype)
    corners_norm = _CORNER_ORDER.astype(dims.dtype) - origin
    return dims[..., None, :] * corners_norm


def center_to_corner_box3d(centers, dims, angles, origin=(0.5, 0.5, 0),
                           axis=2):
    """Matches box_np_ops.center_to_corner_box3d (box_np_ops.py:171)."""
    corners = corners_nd(dims, origin=origin)
    corners = rotate_points(corners, angles, axis=axis)
    return corners + centers[..., None, :]


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    """BEV boxes -> [N, 4, 2] corners (box_np_ops.center_to_corner_box2d)."""
    corners_norm = np.array(
        [[0., 0.], [0., 1.], [1., 1.], [1., 0.]], dtype=dims.dtype) - origin
    corners = dims[..., None, :] * corners_norm
    if angles is not None:
        corners = rotate_points(corners, angles)
    return corners + centers[..., None, :]


def camera_to_lidar(points, r_rect, velo2cam):
    """Camera -> lidar coordinates (box_np_ops.py:13)."""
    points_shape = list(points.shape[:-1])
    if points.shape[-1] == 3:
        points = np.concatenate([points, np.ones(points_shape + [1])], -1)
    lidar_points = points @ np.linalg.inv((r_rect @ velo2cam).T)
    return lidar_points[..., :3]


def lidar_to_camera(points, r_rect, velo2cam):
    """Lidar -> camera coordinates."""
    points_shape = list(points.shape[:-1])
    if points.shape[-1] == 3:
        points = np.concatenate([points, np.ones(points_shape + [1])], -1)
    camera_points = points @ (r_rect @ velo2cam).T
    return camera_points[..., :3]


def box_camera_to_lidar(data, r_rect, velo2cam):
    """Camera boxes (x,y,z,l,h,w,ry) -> lidar boxes (box_np_ops.py:36)."""
    xyz = data[:, 0:3]
    x_size, y_size, z_size = data[:, 3:4], data[:, 4:5], data[:, 5:6]
    r = data[:, 6:7]
    xyz_lidar = camera_to_lidar(xyz, r_rect, velo2cam)
    r_new = limit_period(-r - np.pi / 2, period=np.pi * 2)
    return np.concatenate([xyz_lidar, x_size, z_size, y_size, r_new], axis=1)


def box_lidar_to_camera(data, r_rect, velo2cam):
    """Lidar boxes -> camera boxes (inverse of box_camera_to_lidar)."""
    xyz_lidar = data[:, 0:3]
    x_size, y_size, z_size = data[:, 3:4], data[:, 4:5], data[:, 5:6]
    r = data[:, 6:7]
    xyz = lidar_to_camera(xyz_lidar, r_rect, velo2cam)
    r_new = limit_period(-r - np.pi / 2, period=np.pi * 2)
    return np.concatenate([xyz, x_size, z_size, y_size, r_new], axis=1)


def projection_matrix_to_CRT_kitti(proj):
    """Split P = C @ [R|T] via QR (box_np_ops.py:526)."""
    CR = proj[0:3, 0:3]
    CT = proj[0:3, 3]
    RinvCinv = np.linalg.inv(CR)
    Rinv, Cinv = np.linalg.qr(RinvCinv)
    C = np.linalg.inv(Cinv)
    R = np.linalg.inv(Rinv)
    T = Cinv @ CT
    return C, R, T


def get_frustum(bbox_image, C, near_clip=0.001, far_clip=100):
    """Frustum corners in camera coords for an image bbox
    (box_np_ops.py:584)."""
    fku = C[0, 0]
    fkv = -C[1, 1]
    u0v0 = C[0:2, 2]
    z_points = np.array([near_clip] * 4 + [far_clip] * 4,
                        dtype=C.dtype)[:, np.newaxis]
    b = bbox_image
    box_corners = np.array(
        [[b[0], b[1]], [b[0], b[3]], [b[2], b[3]], [b[2], b[1]]],
        dtype=C.dtype)
    near_box_corners = (box_corners - u0v0) / np.array(
        [fku / near_clip, -fkv / near_clip], dtype=C.dtype)
    far_box_corners = (box_corners - u0v0) / np.array(
        [fku / far_clip, -fkv / far_clip], dtype=C.dtype)
    ret_xy = np.concatenate([near_box_corners, far_box_corners], axis=0)
    return np.concatenate([ret_xy, z_points], axis=1)


def corner_to_surfaces_3d(corners):
    """[N, 8, 3] corners -> [N, 6, 4, 3] surfaces, normals inward
    (box_np_ops.py:331)."""
    surfaces = np.array([
        [corners[:, 0], corners[:, 1], corners[:, 2], corners[:, 3]],
        [corners[:, 7], corners[:, 6], corners[:, 5], corners[:, 4]],
        [corners[:, 0], corners[:, 3], corners[:, 7], corners[:, 4]],
        [corners[:, 1], corners[:, 5], corners[:, 6], corners[:, 2]],
        [corners[:, 0], corners[:, 4], corners[:, 5], corners[:, 1]],
        [corners[:, 3], corners[:, 2], corners[:, 6], corners[:, 7]],
    ]).transpose([2, 0, 1, 3])
    return surfaces


def surface_equ_3d(polygon_surfaces):
    """Plane (normal, -d) per surface (box_np_ops.py:617)."""
    surface_vec = polygon_surfaces[:, :, :2, :] - polygon_surfaces[:, :, 1:3, :]
    normal_vec = np.cross(surface_vec[:, :, 0, :], surface_vec[:, :, 1, :])
    d = np.einsum('aij, aij->ai', normal_vec, polygon_surfaces[:, :, 0, :])
    return normal_vec, -d


def points_in_convex_polygon_3d(points, polygon_surfaces):
    """[P, 3] x [M, 6, 4, 3] -> [P, M] inside mask. Vectorized replacement
    for the numba points_in_convex_polygon_3d_jit (box_np_ops.py:679):
    inside iff p . n + d < 0 for all surfaces."""
    normal_vec, d = surface_equ_3d(polygon_surfaces)  # [M, 6, 3], [M, 6]
    sign = (np.einsum('pd,msd->pms', points[:, :3], normal_vec)
            + d[None, :, :])
    return np.all(sign < 0, axis=-1)


def points_in_rbbox(points, rbbox, origin=(0.5, 0.5, 0)):
    """[P, 3+] x [N, 7] -> [P, N] inside mask for rotated lidar boxes
    (box_np_ops.points_in_rbbox, box_np_ops.py:353). Canonical-frame test
    instead of surface tests; strict inequality matches the reference's
    ``sign < 0`` boundary handling."""
    rbbox = np.asarray(rbbox).reshape(-1, 7)
    centers = rbbox[:, :3] + rbbox[:, 3:6] * (
        0.5 - np.asarray(origin, dtype=np.float64))
    rel = points[:, None, :3] - centers[None]
    c, s = np.cos(rbbox[:, 6]), np.sin(rbbox[:, 6])
    lx = rel[..., 0] * c + rel[..., 1] * s
    ly = -rel[..., 0] * s + rel[..., 1] * c
    lz = rel[..., 2]
    half = rbbox[:, 3:6] / 2.0
    return ((np.abs(lx) < half[:, 0]) & (np.abs(ly) < half[:, 1])
            & (np.abs(lz) < half[:, 2]))


def remove_outside_points(points, rect, Trv2c, P2, image_shape):
    """Keep only points inside the image frustum (box_np_ops.py:553)."""
    C, R, T = projection_matrix_to_CRT_kitti(P2)
    image_bbox = [0, 0, image_shape[1], image_shape[0]]
    frustum = get_frustum(image_bbox, C)
    frustum -= T
    frustum = np.linalg.inv(R) @ frustum.T
    frustum = camera_to_lidar(frustum.T, rect, Trv2c)
    frustum_surfaces = corner_to_surfaces_3d(frustum[np.newaxis, ...])
    indices = points_in_convex_polygon_3d(points[:, :3], frustum_surfaces)
    return points[indices.reshape([-1])]


def points_in_frustum(points, rect, Trv2c, P2, bbox_image):
    """[P] mask of lidar points inside the frustum of an image 2D box.
    Matches utils_gga.points_in_frustm_indices
    (tools/data_converter/utils_gga.py:88)."""
    C, R, T = projection_matrix_to_CRT_kitti(P2)
    frustum = get_frustum(list(np.asarray(bbox_image)), C)
    frustum -= T
    frustum = np.linalg.inv(R) @ frustum.T
    frustum = camera_to_lidar(frustum.T, rect, Trv2c)
    frustum_surfaces = corner_to_surfaces_3d(frustum[np.newaxis, ...])
    return points_in_convex_polygon_3d(points[:, :3],
                                       frustum_surfaces).reshape(-1)


def project_to_image(points_3d, proj_mat):
    """[N, 3] points + [4, 4] projection -> [N, 2] pixels."""
    num = points_3d.shape[0]
    hom = np.concatenate([points_3d[:, :3], np.ones((num, 1))], axis=-1)
    img = hom @ proj_mat.T
    return img[:, :2] / np.maximum(img[:, 2:3], 1e-5)


def boxes3d_to_image_bbox(boxes_cam, P, image_shape=None):
    """Camera boxes -> axis-aligned 2D image boxes [N, 4] (xmin, ymin,
    xmax, ymax). Mirrors the projection in
    kitti_dataset_GGA_train.convert_valid_bboxes."""
    corners = center_to_corner_box3d(
        boxes_cam[:, :3], boxes_cam[:, 3:6], boxes_cam[:, 6],
        origin=(0.5, 1.0, 0.5), axis=1)  # [N, 8, 3]
    n = corners.shape[0]
    pix = project_to_image(corners.reshape(-1, 3), P).reshape(n, 8, 2)
    minxy = pix.min(axis=1)
    maxxy = pix.max(axis=1)
    bbox = np.concatenate([minxy, maxxy], axis=1)
    if image_shape is not None:
        bbox[:, 0::2] = np.clip(bbox[:, 0::2], 0, image_shape[1] - 1)
        bbox[:, 1::2] = np.clip(bbox[:, 1::2], 0, image_shape[0] - 1)
    return bbox


def iou_2d(boxes, query_boxes, eps=1.0):
    """Axis-aligned 2D IoU [N, K] matching the reference's iou_jit
    (box_np_ops.py:483) including its ``eps`` extent convention."""
    N, K = boxes.shape[0], query_boxes.shape[0]
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0] + eps)
              * (query_boxes[:, 3] - query_boxes[:, 1] + eps))  # [K]
    area_b = ((boxes[:, 2] - boxes[:, 0] + eps)
              * (boxes[:, 3] - boxes[:, 1] + eps))  # [N]
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]) + eps)
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]) + eps)
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    union = area_b[:, None] + area_q[None, :] - inter
    return np.where((iw > 0) & (ih > 0), inter / union, 0.0)
