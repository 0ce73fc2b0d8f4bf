"""Synthetic KITTI-format scenes for the accuracy benches (the port's copy
of ``tests/test_data/fixtures.py``): a KITTI-like calibration, scenes of a
ground plane, clutter and point clusters on the surface of each 3D box,
their depth-coded point-splat camera images, and the KITTI files of a
scene (velodyne, calib, label, image, ImageSets entry).

Images are written by the port's own PNG writer (``png.write_png``): the
same pixels as gga_tpu's Pillow files, other bytes.
"""
from __future__ import annotations

import os

import numpy as np

from ...core import np_geometry as ng
from .png import write_png

# KITTI-like calibration (velodyne x-forward -> cam z-forward)
VELO2CAM = np.array([
    [0., -1., 0., 0.],
    [0., 0., -1., -0.08],
    [1., 0., 0., -0.27],
    [0., 0., 0., 1.]])
P2 = np.array([
    [721.54, 0., 609.56, 44.86],
    [0., 721.54, 172.85, 0.216],
    [0., 0., 1., 0.0027],
    [0., 0., 0., 1.]])
RECT = np.eye(4)
IMG_SHAPE = (375, 1242)


def make_scene(rng, boxes_lidar, names, n_ground=4000, n_clutter=500,
               pts_per_box=400):
    """Points (lidar) for a ground plane + per-box clusters + clutter.

    boxes_lidar: [N, 7] bottom-center lidar boxes.
    """
    gx = rng.uniform(0, 69, n_ground)
    gy = rng.uniform(-39, 39, n_ground)
    gz = np.full(n_ground, -1.73) + rng.randn(n_ground) * 0.02
    ground = np.stack([gx, gy, gz], 1)

    clutter = np.stack([
        rng.uniform(0, 69, n_clutter),
        rng.uniform(-39, 39, n_clutter),
        rng.uniform(-1.0, 1.0, n_clutter)], 1)

    obj_pts = []
    for b in boxes_lidar:
        local = rng.uniform(-0.5, 0.5, (pts_per_box, 3)) * b[3:6]
        local[:, 2] += b[5] / 2
        c, s = np.cos(b[6]), np.sin(b[6])
        x = local[:, 0] * c - local[:, 1] * s + b[0]
        y = local[:, 0] * s + local[:, 1] * c + b[1]
        z = local[:, 2] + b[2]
        obj_pts.append(np.stack([x, y, z], 1))
    pts = np.concatenate([ground, clutter] + obj_pts)
    refl = rng.rand(pts.shape[0], 1)
    return np.concatenate([pts, refl], 1).astype(np.float32)


def lidar_to_cam_box(boxes_lidar):
    return ng.box_lidar_to_camera(boxes_lidar, RECT, VELO2CAM)


def project_box_to_2d(box_cam):
    return ng.boxes3d_to_image_bbox(box_cam[None], P2, IMG_SHAPE)[0]


def render_scene_image(points, img_shape=IMG_SHAPE):
    """Depth-coded point-splat rendering of the lidar scene, RGB uint8.

    Each point in the camera's view paints a 2 x 2 splat: red 8 m over
    its depth, green its height, blue 255, near points over far ones. So
    a monocular detector (PGD, stage 4) sees pixel extents that scale
    with 1 / depth, as in a photograph."""
    pts = np.asarray(points, np.float64)[:, :3]
    hom = np.concatenate([pts, np.ones((len(pts), 1))], 1)
    cam = (RECT @ VELO2CAM @ hom.T).T[:, :3]
    z = cam[:, 2]
    uvw = (P2[:3, :3] @ cam.T).T + P2[:3, 3]
    u = uvw[:, 0] / np.maximum(uvw[:, 2], 1e-6)
    v = uvw[:, 1] / np.maximum(uvw[:, 2], 1e-6)
    H, W = img_shape
    ok = (z > 0.5) & (u >= 0) & (u < W - 1) & (v >= 0) & (v < H - 1)
    ui = u[ok].astype(np.intp)
    vi = v[ok].astype(np.intp)
    zz = z[ok]
    depth_c = np.clip(255.0 * 8.0 / zz, 0, 255).astype(np.uint8)
    height_c = np.clip((pts[ok, 2] + 3.0) / 6.0 * 255.0, 0,
                       255).astype(np.uint8)
    img = np.zeros((H, W, 3), np.uint8)
    # sort far-to-near so near points overwrite (painter's order)
    order = np.argsort(-zz)
    ui, vi = ui[order], vi[order]
    depth_c, height_c = depth_c[order], height_c[order]
    for dv in (0, 1):
        for du in (0, 1):
            img[vi + dv, ui + du, 0] = depth_c
            img[vi + dv, ui + du, 1] = height_c
            img[vi + dv, ui + du, 2] = 255
    return img


def write_kitti_scene(root, idx, points, boxes_lidar, names,
                      split='train'):
    """Write velodyne/calib/label/image files + ImageSets entry."""
    sub = 'training'
    for d in ('velodyne', 'calib', 'label_2', 'image_2'):
        os.makedirs(os.path.join(root, sub, d), exist_ok=True)
    os.makedirs(os.path.join(root, 'ImageSets'), exist_ok=True)

    points.astype(np.float32).tofile(
        os.path.join(root, sub, 'velodyne', f'{idx:06d}.bin'))

    with open(os.path.join(root, sub, 'calib', f'{idx:06d}.txt'), 'w') as f:
        for k in range(4):
            P = P2 if k == 2 else np.eye(4)[:3]
            P = P[:3, :4] if P.shape[0] > 3 else P
            f.write(f'P{k}: ' + ' '.join(f'{v:.12e}'
                                         for v in np.asarray(P)[:3, :4]
                                         .reshape(-1)) + '\n')
        f.write('R0_rect: ' + ' '.join(
            f'{v:.12e}' for v in RECT[:3, :3].reshape(-1)) + '\n')
        f.write('Tr_velo_to_cam: ' + ' '.join(
            f'{v:.12e}' for v in VELO2CAM[:3, :4].reshape(-1)) + '\n')
        f.write('Tr_imu_to_velo: ' + ' '.join(
            f'{v:.12e}' for v in np.eye(4)[:3, :4].reshape(-1)) + '\n')

    cam = lidar_to_cam_box(boxes_lidar)
    with open(os.path.join(root, sub, 'label_2', f'{idx:06d}.txt'),
              'w') as f:
        for name, cb in zip(names, cam):
            bbox2d = project_box_to_2d(cb)
            l, h, w = cb[3], cb[4], cb[5]
            f.write(f'{name} 0.00 0 {cb[6]:.2f} '
                    f'{bbox2d[0]:.2f} {bbox2d[1]:.2f} {bbox2d[2]:.2f} '
                    f'{bbox2d[3]:.2f} {h:.2f} {w:.2f} {l:.2f} '
                    f'{cb[0]:.2f} {cb[1]:.2f} {cb[2]:.2f} {cb[6]:.2f}\n')

    write_png(os.path.join(root, sub, 'image_2', f'{idx:06d}.png'),
              render_scene_image(points))

    with open(os.path.join(root, 'ImageSets', f'{split}.txt'), 'a') as f:
        f.write(f'{idx:06d}\n')
