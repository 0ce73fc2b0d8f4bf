"""KITTI-format result conversion and submission writing (the port's
copy of ``gga_tpu/eval/submission.py``).

Numpy rebuild of KittiDataset_GGA_train.bbox2result_kitti /
convert_valid_bboxes
(mmdet3d/datasets/kitti_dataset_GGA_train.py:453,680).
"""
from __future__ import annotations

import os

import numpy as np

from ..core import np_geometry as ng

PCD_LIMIT_RANGE = (0, -40, -3, 70.4, 40, 0.0)

EMPTY_ANNO = dict(
    name=np.array([]), truncated=np.array([]), occluded=np.array([]),
    alpha=np.array([]), bbox=np.zeros([0, 4]), dimensions=np.zeros([0, 3]),
    location=np.zeros([0, 3]), rotation_y=np.array([]),
    score=np.array([]))


def convert_valid_bboxes(boxes_lidar, scores, labels, info,
                         pcd_limit_range=PCD_LIMIT_RANGE):
    """Project lidar boxes to camera/image, keep those visible in the image
    and inside the pcd range (convert_valid_bboxes:680).

    Args:
        boxes_lidar: [N, 7] bottom-center lidar boxes.
        scores / labels: [N].

    Returns dict with bbox, box3d_camera, box3d_lidar, scores, label_preds.
    """
    sample_idx = info['image']['image_idx']
    if boxes_lidar.shape[0] == 0:
        return dict(bbox=np.zeros([0, 4]), box3d_camera=np.zeros([0, 7]),
                    box3d_lidar=np.zeros([0, 7]), scores=np.zeros([0]),
                    label_preds=np.zeros([0]), sample_idx=sample_idx)
    boxes_lidar = boxes_lidar.copy()
    boxes_lidar[:, 6] = ng.limit_period(boxes_lidar[:, 6], 0.5, 2 * np.pi)

    rect = info['calib']['R0_rect']
    Trv2c = info['calib']['Tr_velo_to_cam']
    P2 = info['calib']['P2']
    img_shape = info['image']['image_shape']

    box_cam = ng.box_lidar_to_camera(boxes_lidar, rect, Trv2c)
    corners = ng.center_to_corner_box3d(
        box_cam[:, :3], box_cam[:, 3:6], box_cam[:, 6],
        origin=(0.5, 1.0, 0.5), axis=1)
    n = corners.shape[0]
    pix = ng.project_to_image(corners.reshape(-1, 3), P2).reshape(n, 8, 2)
    box_2d = np.concatenate([pix.min(1), pix.max(1)], axis=1)

    valid_cam = ((box_2d[:, 0] < img_shape[1]) & (box_2d[:, 1] < img_shape[0])
                 & (box_2d[:, 2] > 0) & (box_2d[:, 3] > 0))
    lim = np.asarray(pcd_limit_range)
    center = boxes_lidar[:, :3]
    valid_pcd = ((center > lim[:3]) & (center < lim[3:])).all(-1)
    v = valid_cam & valid_pcd
    return dict(bbox=box_2d[v], box3d_camera=box_cam[v],
                box3d_lidar=boxes_lidar[v], scores=np.asarray(scores)[v],
                label_preds=np.asarray(labels)[v], sample_idx=sample_idx)


def detections_to_kitti_annos(detections, infos, class_names,
                              pcd_limit_range=PCD_LIMIT_RANGE):
    """Per-sample (boxes_lidar, scores, labels) -> KITTI anno dicts
    (bbox2result_kitti:453).

    Args:
        detections: list of dicts with 'boxes_3d' [N, 7] (lidar,
            bottom-center), 'scores_3d' [N], 'labels_3d' [N].
    """
    det_annos = []
    for det, info in zip(detections, infos):
        image_shape = np.asarray(info['image']['image_shape'])[:2]
        bd = convert_valid_bboxes(np.asarray(det['boxes_3d'], np.float64),
                                  det['scores_3d'], det['labels_3d'], info,
                                  pcd_limit_range)
        if len(bd['bbox']) > 0:
            bbox = bd['bbox'].copy()
            bbox[:, 2:] = np.minimum(bbox[:, 2:], image_shape[::-1])
            bbox[:, :2] = np.maximum(bbox[:, :2], 0)
            cam = bd['box3d_camera']
            lidar = bd['box3d_lidar']
            anno = dict(
                name=np.array([class_names[int(l)]
                               for l in bd['label_preds']]),
                truncated=np.zeros(len(bbox)),
                occluded=np.zeros(len(bbox), np.int64),
                alpha=(-np.arctan2(-lidar[:, 1], lidar[:, 0])
                       + cam[:, 6]),
                bbox=bbox,
                dimensions=cam[:, 3:6],
                location=cam[:, :3],
                rotation_y=cam[:, 6],
                score=np.asarray(bd['scores']),
            )
        else:
            anno = {k: v.copy() for k, v in EMPTY_ANNO.items()}
        anno['sample_idx'] = np.array(
            [bd['sample_idx']] * len(anno['score']), np.int64)
        det_annos.append(anno)
    return det_annos


def mono_detections_to_kitti_annos(detections, infos, class_names):
    """Per-sample camera-frame detections -> KITTI anno dicts (the mono
    path of bbox2result_kitti: the boxes are already in the camera frame;
    kitti_mono format_results).

    Args:
        detections: list of dicts with 'boxes_cam' [N, 7] (x, y, z gravity
            centre, l, h, w, ry, camera frame), 'scores' [N], 'labels'
            [N] and optionally 'bboxes2d' [N, 4].
    """
    det_annos = []
    for det, info in zip(detections, infos):
        image_shape = np.asarray(info['image']['image_shape'])[:2]
        P2 = np.asarray(info['calib']['P2'], np.float64)
        cam = np.asarray(det['boxes_cam'], np.float64)
        n = len(cam)
        if n == 0:
            anno = {k: v.copy() for k, v in EMPTY_ANNO.items()}
            anno['sample_idx'] = np.zeros(0, np.int64)
            det_annos.append(anno)
            continue
        loc = cam[:, :3].copy()
        loc[:, 1] += cam[:, 4] / 2.0  # gravity -> bottom centre
        box_kitti = np.concatenate([loc, cam[:, 3:6], cam[:, 6:7]], axis=1)
        if 'bboxes2d' in det and len(det['bboxes2d']):
            bbox = np.asarray(det['bboxes2d'], np.float64)
        else:
            bbox = ng.boxes3d_to_image_bbox(box_kitti, P2, image_shape)
        bbox[:, 2:] = np.minimum(bbox[:, 2:], image_shape[::-1])
        bbox[:, :2] = np.maximum(bbox[:, :2], 0)
        anno = dict(
            name=np.array([class_names[int(lab)] for lab in det['labels']]),
            truncated=np.zeros(n),
            occluded=np.zeros(n, np.int64),
            alpha=cam[:, 6] - np.arctan2(cam[:, 0], cam[:, 2]),
            bbox=bbox,
            dimensions=cam[:, 3:6],
            location=loc,
            rotation_y=cam[:, 6],
            score=np.asarray(det['scores'], np.float64),
        )
        anno['sample_idx'] = np.array(
            [info['image']['image_idx']] * n, np.int64)
        det_annos.append(anno)
    return det_annos


def write_kitti_submission(det_annos, infos, out_dir):
    """KITTI submission txt files (bbox2result_kitti:537-556)."""
    os.makedirs(out_dir, exist_ok=True)
    for anno, info in zip(det_annos, infos):
        sample_idx = info['image']['image_idx']
        path = os.path.join(out_dir, f'{sample_idx:06d}.txt')
        with open(path, 'w') as f:
            for i in range(len(anno['score'])):
                bbox = anno['bbox'][i]
                dims = anno['dimensions'][i]  # lhw
                loc = anno['location'][i]
                print('{} -1 -1 {:.4f} {:.4f} {:.4f} {:.4f} '
                      '{:.4f} {:.4f} {:.4f} '
                      '{:.4f} {:.4f} {:.4f} {:.4f} {:.4f} {:.4f}'.format(
                          anno['name'][i], anno['alpha'][i], bbox[0],
                          bbox[1], bbox[2], bbox[3], dims[1], dims[2],
                          dims[0], loc[0], loc[1], loc[2],
                          anno['rotation_y'][i], anno['score'][i]),
                      file=f)
