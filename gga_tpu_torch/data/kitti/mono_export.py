"""Mono3D COCO json export of (pseudo-)info pkls, the input of the stage-4
monocular retrain (the port's copy of
``gga_tpu/data/kitti/mono_export.py``, numpy only).

Writes ``*_mono3d.coco.json``: one image per info with its camera
intrinsic, and per object of a kept category its 2D box, its camera-frame
3D box (gravity centre, the info's dimensions, rotation_y), its projected
centre with depth, and its score where the annos carry one.
"""
from __future__ import annotations

import json
import os

import numpy as np

CATEGORIES = ('Pedestrian', 'Cyclist', 'Car')


def export_mono3d_coco(infos, out_path, categories=CATEGORIES):
    """infos -> COCO-style json at ``out_path``; returns the json's dict."""
    images, annotations = [], []
    ann_id = 0
    for info in infos:
        idx = int(info['image']['image_idx'])
        P2 = np.asarray(info['calib']['P2'])
        images.append(dict(
            id=idx,
            file_name=info['image']['image_path'],
            width=int(info['image']['image_shape'][1]),
            height=int(info['image']['image_shape'][0]),
            cam_intrinsic=P2.tolist(),
        ))
        if 'annos' not in info:
            continue
        annos = info['annos']
        for i, name in enumerate(annos['name']):
            if name not in categories:
                continue
            loc = annos['location'][i]
            dims = annos['dimensions'][i]  # (l, h, w)
            rot = float(annos['rotation_y'][i])
            gravity = loc.copy()
            gravity[1] -= dims[1] / 2.0
            uvw = P2 @ np.concatenate([gravity, [1.0]])
            depth = float(uvw[2])
            c2d = (uvw[:2] / max(depth, 1e-5)).tolist()
            x1, y1, x2, y2 = [float(v) for v in annos['bbox'][i]]
            ann = dict(
                id=ann_id,
                image_id=idx,
                category_id=categories.index(name),
                bbox=[x1, y1, x2 - x1, y2 - y1],
                area=float((x2 - x1) * (y2 - y1)),
                iscrowd=0,
                bbox_cam3d=[float(v) for v in
                            np.concatenate([gravity, dims, [rot]])],
                center2d=c2d + [depth],
            )
            if 'score' in annos and len(annos['score']) > i:
                ann['score'] = float(annos['score'][i])
            annotations.append(ann)
            ann_id += 1
    coco = dict(
        images=images,
        annotations=annotations,
        categories=[dict(id=i, name=n) for i, n in enumerate(categories)],
    )
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, 'w') as f:
        json.dump(coco, f)
    return coco
