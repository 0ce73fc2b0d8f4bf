"""Pseudo GT database creation for copy-paste augmentation (the port's
copy of ``gga_tpu/data/kitti/gt_database.py``).

Rebuild of create_groundtruth_database's 'KittiDataset_GGA' branch
(tools/data_converter/create_gt_database_gga.py:110-394):
per-object point crops are taken from the *2D-box frustum* (not the 3D box)
in absolute lidar coordinates, and each db_info carries the full set of
GGA weak-label fields.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ...core import np_geometry as ng
from . import io as kio


def create_gga_gt_database(root, infos, used_classes=('Car', 'Pedestrian',
                                                      'Cyclist'),
                           db_name='kitti_gt_database_GGA',
                           info_name='kitti_dbinfos_train_GGA.pkl',
                           pts_prefix='velodyne_reduced'):
    """Write per-object .bin crops + the dbinfos pkl.

    Args:
        infos: list of GGA-augmented scene infos (train split).

    Returns:
        dict class -> list of db_info dicts (also dumped to pkl).
    """
    db_path = os.path.join(root, db_name)
    os.makedirs(db_path, exist_ok=True)
    all_db_infos = {}

    for info in infos:
        image_idx = info['image']['image_idx']
        calib = info['calib']
        rect = calib['R0_rect']
        Trv2c = calib['Tr_velo_to_cam']
        P2 = calib['P2']
        lidar2img = P2 @ rect @ Trv2c
        vpath = info['point_cloud']['velodyne_path'].replace(
            'velodyne', pts_prefix)
        if not os.path.exists(os.path.join(root, vpath)):
            vpath = info['point_cloud']['velodyne_path']
        points = kio.load_velodyne(os.path.join(root, vpath))

        annos = info['annos']
        num_obj = int((annos['name'] != 'DontCare').sum())
        names = annos['name'][:num_obj]
        loc = annos['location'][:num_obj]
        dims = annos['dimensions'][:num_obj]
        rots = annos['rotation_y'][:num_obj]
        gt_cam = np.concatenate([loc, dims, rots[..., None]], 1)
        gt_boxes_3d = ng.box_camera_to_lidar(gt_cam, rect, Trv2c)
        gt_bboxes = annos['bbox'][:num_obj]
        difficulty = annos['difficulty'][:num_obj]

        m = (annos['GGA_mask2d'][:num_obj]
             & annos['GGA_mask_valid'][:num_obj])
        sel = np.where(m)[0]

        gt_point_indices = ng.points_in_rbbox(points[:, :3], gt_boxes_3d)

        for i in sel:
            fr = ng.points_in_frustum(points, rect, Trv2c, P2,
                                      annos['GGA_boxes_img'][i])
            obj_points = points[fr]
            filename = f'{image_idx}_{names[i]}_{i}.bin'
            obj_points.astype(np.float32).tofile(
                os.path.join(db_path, filename))
            if used_classes is not None and names[i] not in used_classes:
                continue
            db_info = {
                'name': names[i],
                'path': os.path.join(db_name, filename),
                'image_idx': image_idx,
                'gt_idx': int(i),
                'box3d_lidar': gt_boxes_3d[i],
                'num_points_in_gt': int(gt_point_indices[:, i].sum()),
                'difficulty': difficulty[i],
                'GGA_gt_box': gt_bboxes[i],
                'GGA_box_img': annos['GGA_boxes_img'][i],
                'GGA_mask_depth': annos['GGA_mask_depth'][i],
                'GGA_mask2d': annos['GGA_mask2d'][i],
                'GGA_mask_valid': annos['GGA_mask_valid'][i],
                'GGA_mask_boundary': annos['GGA_mask_boundary'][i],
                'GGA_bdry_mask': annos['GGA_bdry_masks'][i],
                'GGA_in_box_points': annos['GGA_in_box_points'][i],
                'GGA_init_pseudo_label': annos['GGA_init_pseudo_label'][i],
                'GGA_num_points_in_box2d':
                    annos['GGA_num_points_in_box2d'][i],
                'GGA_lidar2img': lidar2img,
                'group_id': int(i),
            }
            all_db_infos.setdefault(names[i], []).append(db_info)

    with open(os.path.join(root, info_name), 'wb') as f:
        pickle.dump(all_db_infos, f)
    return all_db_infos


def create_reduced_point_clouds(root, infos, save_dir='velodyne_reduced'):
    """Frustum-cropped clouds (kitti_converter_gga.create_reduced_point_cloud
    behavior: keep points inside the image frustum)."""
    for info in infos:
        calib = info['calib']
        vpath = info['point_cloud']['velodyne_path']
        pts = kio.load_velodyne(os.path.join(root, vpath))
        reduced = ng.remove_outside_points(
            pts, calib['R0_rect'], calib['Tr_velo_to_cam'], calib['P2'],
            info['image']['image_shape'])
        out = os.path.join(root, os.path.dirname(vpath).replace(
            'velodyne', save_dir), os.path.basename(vpath))
        os.makedirs(os.path.dirname(out), exist_ok=True)
        reduced.astype(np.float32).tofile(out)
