"""Pseudo-3D-label matching: stage 3 of the GGA workflow (the port's copy
of ``gga_tpu/data/kitti/pseudo_labels.py``).

Numpy rebuild of pseudo_label_matching_kitti
(tools/utils_pseudo_labels_gga.py:17): match predicted
boxes to 2D GT boxes by image-plane IoU argmax, keep the GGA fields of the
matched GT while replacing geometry with predictions, canonicalize dims/rot
(swap l/w + pi/2 when w > l), and dump the pseudo info pkl.
"""
from __future__ import annotations

import copy
import os
import pickle

import numpy as np

from ...eval.kitti_eval import calculate_iou_partly

KEEP_CLASSES = ('Pedestrian', 'Car', 'Cyclist')


def _drop_by_name(names, used=KEEP_CLASSES):
    return np.array([i for i, n in enumerate(names) if n in used],
                    np.int64)


def pseudo_label_matching(gt_infos, dt_annos, metric=0, out_path=None):
    """Match detections to GT 2D boxes and build pseudo-labelled infos.

    Args:
        gt_infos: GGA-augmented scene infos (trainval).
        dt_annos: per-scene KITTI-format prediction annos (aligned).
        metric: 0 = image-plane IoU (the reference's choice).
        out_path: optional pkl dump path
            (reference: data/kitti_pesudo/kitti_infos_trainval_GGA_pseudo.pkl).

    Returns:
        (pseudo_infos, cleaned gt_annos list).
    """
    assert len(gt_infos) == len(dt_annos)
    gt_infos_out = copy.deepcopy(gt_infos)
    gt_annos = [copy.deepcopy(info['annos']) for info in gt_infos]

    # strip the ragged cluster lists + DontCare + non-target classes
    # (utils_pseudo_labels_gga.py:25-38)
    for anno in gt_annos:
        anno.pop('GGA_in_box_points', None)
        num_obj = int((anno['name'] != 'DontCare').sum())
        for k in list(anno):
            anno[k] = anno[k][:num_obj]
        sel = _drop_by_name(anno['name'])
        for k in list(anno):
            anno[k] = anno[k][sel]

    overlaps, _, _, _ = calculate_iou_partly(dt_annos, gt_annos, metric)

    new_gt_annos = []
    for i, ov in enumerate(overlaps):
        g, d = gt_annos[i], dt_annos[i]
        new = {}
        if len(d['name']) == 0 or len(g['name']) == 0:
            for k, v in g.items():
                new[k] = v[:0]
            new_gt_annos.append(new)
            continue
        dt_match_gt = np.argmax(ov, axis=-1)
        for k, v in g.items():
            if k in d:
                new[k] = d[k]          # geometry/score from predictions
            else:
                new[k] = v[dt_match_gt]  # GGA fields from matched GT
        new_gt_annos.append(new)

    for i, info in enumerate(gt_infos_out):
        anno = new_gt_annos[i]
        # canonicalize: if w > l swap and rotate (reference :74-78)
        for j in range(anno['rotation_y'].shape[0]):
            dim = anno['dimensions'][j]
            if dim[2] > dim[0]:
                anno['dimensions'][j] = dim[[2, 1, 0]]
                anno['rotation_y'][j] = anno['rotation_y'][j] + np.pi / 2.0
        info['annos'] = anno

    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, 'wb') as f:
            pickle.dump(gt_infos_out, f)
    return gt_infos_out, gt_annos
