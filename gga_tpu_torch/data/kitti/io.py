"""KITTI raw-file readers and info-dict generation (the port's copy of
``gga_tpu/data/kitti/io.py``).

Numpy rebuild of the reference's kitti_data_utils
(tools/data_converter/kitti_data_utils.py): calib/label
parsing (get_label_anno:117, dims reordered hwl -> lhw), difficulty
assignment (add_difficulty_to_annos:534) and the info-dict layout consumed
by the datasets.
"""
from __future__ import annotations

import os

import numpy as np


def _extend(mat):
    out = np.eye(4, dtype=mat.dtype)
    out[:mat.shape[0], :mat.shape[1]] = mat
    return out


def parse_calib(path, extend_matrix=True):
    """KITTI calib txt -> dict of 4x4 matrices (P0..P3, R0_rect,
    Tr_velo_to_cam, Tr_imu_to_velo)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f.readlines()]
    vals = {}
    for ln in lines:
        if not ln:
            continue
        key, data = ln.split(':', 1)
        vals[key.strip()] = np.array(
            [float(x) for x in data.split()], dtype=np.float64)
    out = {}
    for i in range(4):
        P = vals[f'P{i}'].reshape(3, 4)
        out[f'P{i}'] = _extend(P) if extend_matrix else P
    rect = np.eye(4)
    rect[:3, :3] = vals['R0_rect'].reshape(3, 3)
    out['R0_rect'] = rect
    out['Tr_velo_to_cam'] = _extend(vals['Tr_velo_to_cam'].reshape(3, 4))
    if 'Tr_imu_to_velo' in vals:
        out['Tr_imu_to_velo'] = _extend(vals['Tr_imu_to_velo'].reshape(3, 4))
    return out


def parse_label(path):
    """KITTI label txt -> annotation dict (get_label_anno:117 layout;
    dimensions hwl -> lhw)."""
    with open(path) as f:
        content = [ln.strip().split(' ') for ln in f.readlines()
                   if ln.strip()]
    num_objects = len([x[0] for x in content if x[0] != 'DontCare'])
    annos = dict(
        name=np.array([x[0] for x in content]),
        truncated=np.array([float(x[1]) for x in content]),
        occluded=np.array([int(float(x[2])) for x in content]),
        alpha=np.array([float(x[3]) for x in content]),
        bbox=np.array([[float(v) for v in x[4:8]]
                       for x in content]).reshape(-1, 4),
        dimensions=np.array([[float(v) for v in x[8:11]]
                             for x in content]).reshape(-1, 3)[:, [2, 0, 1]],
        location=np.array([[float(v) for v in x[11:14]]
                           for x in content]).reshape(-1, 3),
        rotation_y=np.array([float(x[14]) for x in content]).reshape(-1),
    )
    if content and len(content[0]) == 16:
        annos['score'] = np.array([float(x[15]) for x in content])
    else:
        annos['score'] = np.zeros((annos['bbox'].shape[0],))
    num_gt = len(annos['name'])
    annos['index'] = np.array(
        list(range(num_objects)) + [-1] * (num_gt - num_objects),
        dtype=np.int32)
    annos['group_ids'] = np.arange(num_gt, dtype=np.int32)
    return annos


def add_difficulty(annos):
    """KITTI easy/moderate/hard difficulty (add_difficulty_to_annos:534):
    -1 when failing all tiers."""
    min_height = [40, 25, 25]
    max_occlusion = [0, 1, 2]
    max_trunc = [0.15, 0.3, 0.5]
    h = annos['bbox'][:, 3] - annos['bbox'][:, 1]
    occ = annos['occluded']
    trunc = annos['truncated']
    diff = np.full(len(h), -1, np.int32)
    for level in (2, 1, 0):
        ok = ((occ <= max_occlusion[level]) & (h > min_height[level])
              & (trunc <= max_trunc[level]))
        diff[ok] = level
    annos['difficulty'] = diff
    return annos


def load_velodyne(path, num_features=4):
    return np.fromfile(path, dtype=np.float32).reshape(-1, num_features)


def read_image_shape(path):
    """(H, W) from a PNG header without decoding pixels."""
    import struct
    with open(path, 'rb') as f:
        head = f.read(26)
    if head[:8] != b'\x89PNG\r\n\x1a\n':
        # fall back to cv2/PIL-free full parse only for PNG; other formats
        # unexpected for KITTI
        raise ValueError(f'not a PNG: {path}')
    w, h = struct.unpack('>II', head[16:24])
    return np.array([h, w], dtype=np.int32)


def create_scene_info(root, split, idx, *, with_label=True, with_plane=False,
                      relative_path=True):
    """Build one scene's info dict (get_kitti_image_info:166 layout)."""
    sub = 'training' if split != 'test' else 'testing'
    rel = dict(
        velodyne=os.path.join(sub, 'velodyne', f'{idx:06d}.bin'),
        image=os.path.join(sub, 'image_2', f'{idx:06d}.png'),
        calib=os.path.join(sub, 'calib', f'{idx:06d}.txt'),
        label=os.path.join(sub, 'label_2', f'{idx:06d}.txt'),
        plane=os.path.join(sub, 'planes', f'{idx:06d}.txt'),
    )
    info = {
        'image': {
            'image_idx': idx,
            'image_path': rel['image'] if relative_path else
            os.path.join(root, rel['image']),
            'image_shape': read_image_shape(os.path.join(root,
                                                         rel['image'])),
        },
        'point_cloud': {
            'num_features': 4,
            'velodyne_path': rel['velodyne'] if relative_path else
            os.path.join(root, rel['velodyne']),
        },
        'calib': parse_calib(os.path.join(root, rel['calib'])),
    }
    if with_label and split != 'test':
        annos = parse_label(os.path.join(root, rel['label']))
        add_difficulty(annos)
        info['annos'] = annos
    if with_plane:
        plane = np.loadtxt(os.path.join(root, rel['plane']), skiprows=3)
        info['plane'] = plane
    return info


def compute_num_points_in_gt(root, info, remove_outside=True):
    """annos['num_points_in_gt'] (kitti_converter_gga.py:153):
    lidar points inside each 3D GT box (DontCare -> -1)."""
    from ...core import np_geometry as ng
    pts = load_velodyne(os.path.join(root,
                                     info['point_cloud']['velodyne_path']))
    calib = info['calib']
    rect, Trv2c, P2 = calib['R0_rect'], calib['Tr_velo_to_cam'], calib['P2']
    if remove_outside:
        pts = ng.remove_outside_points(pts, rect, Trv2c, P2,
                                       info['image']['image_shape'])
    annos = info['annos']
    num_obj = int((annos['name'] != 'DontCare').sum())
    loc = annos['location'][:num_obj]
    dims = annos['dimensions'][:num_obj]
    rots = annos['rotation_y'][:num_obj]
    gt_cam = np.concatenate([loc, dims, rots[..., None]], axis=1)
    gt_lidar = ng.box_camera_to_lidar(gt_cam, rect, Trv2c)
    inside = ng.points_in_rbbox(pts[:, :3], gt_lidar)
    counts = inside.sum(0)
    annos['num_points_in_gt'] = np.concatenate(
        [counts, -np.ones(len(annos['name']) - num_obj)]).astype(np.int32)
    return info


def read_split_ids(root, split):
    """ImageSets/{split}.txt -> list of ints."""
    path = os.path.join(root, 'ImageSets', f'{split}.txt')
    with open(path) as f:
        return [int(ln.strip()) for ln in f if ln.strip()]
