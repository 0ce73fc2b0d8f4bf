"""SUN RGB-D dataset of the FCAF3D retrain (port of
``gga_tpu/data/sunrgbd.py``; mmdet3d's SUNRGBDDataset) over
mmdet3d-format info pkls: per scene a points .bin (xyzrgb f32) and annos
with ``gt_boxes_upright_depth`` [M, 7] (gravity-centered) and ``class``
labels, as the port's ``data/indoor_converter.py`` writes them
(``python -m gga_tpu_torch.tools.create_data sunrgbd``). Items are numpy
dicts of fixed shapes; train-time augmentation draws, from one
``RandomState(seed)`` in gga_tpu's order: the point sample, a horizontal
flip, a global rotation, scale and translation.

The draws are stateful, item after item, so the stream depends on the
order items are read: the epoch loader reads them in the calling
process at <= 1 worker (``data.dataset.EpochLoader``), as gga_tpu's
``epoch_batches`` does.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch.utils.data as tud

CLASSES = ('bed', 'table', 'sofa', 'chair', 'toilet', 'desk', 'dresser',
           'night_stand', 'bookshelf', 'bathtub')


class SunRgbdDataset(tud.Dataset):
    CLASSES = CLASSES

    def __init__(self, root, info_path, *, num_points=20000, max_objs=64,
                 test_mode=False, rot_range=(-0.523599, 0.523599),
                 scale_range=(0.85, 1.15), translation_std=0.1, seed=0):
        with open(info_path, 'rb') as f:
            self.infos = pickle.load(f)
        self.root = root
        self.num_points = num_points
        self.max_objs = max_objs
        self.test_mode = test_mode
        self.rot_range = rot_range
        self.scale_range = scale_range
        self.translation_std = translation_std
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, idx):
        info = self.infos[idx]
        pts = np.fromfile(os.path.join(self.root, info['pts_path']),
                          np.float32).reshape(-1, 6)

        annos = info.get('annos', {})
        n = int(annos.get('gt_num', 0))
        boxes = np.asarray(
            annos.get('gt_boxes_upright_depth',
                      np.zeros((0, 7)))).reshape(-1, 7).astype(np.float32)
        labels = np.asarray(annos.get('class', np.zeros(0)),
                            np.int64).reshape(-1)

        # sample to a static point budget
        P = self.num_points
        if pts.shape[0] >= P:
            sel = self._rng.choice(pts.shape[0], P, replace=False)
        elif pts.shape[0]:
            sel = np.concatenate([
                np.arange(pts.shape[0]),
                self._rng.choice(pts.shape[0], P - pts.shape[0],
                                 replace=True)])
        else:
            sel = np.zeros(P, np.int64)
        pts = pts[sel]

        boxes = boxes.copy()
        if not self.test_mode:
            # RandomFlip3D (horizontal: x -> -x for depth boxes)
            if self._rng.rand() < 0.5:
                pts[:, 0] = -pts[:, 0]
                boxes[:, 0] = -boxes[:, 0]
                boxes[:, 6] = np.pi - boxes[:, 6]
            # GlobalRotScaleTrans
            ang = self._rng.uniform(*self.rot_range)
            c, s = np.cos(ang), np.sin(ang)
            rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
            pts[:, :3] = pts[:, :3] @ rot
            boxes[:, :3] = boxes[:, :3] @ rot
            boxes[:, 6] += ang
            scale = self._rng.uniform(*self.scale_range)
            pts[:, :3] *= scale
            boxes[:, :6] *= scale
            trans = self._rng.randn(3).astype(np.float32) * \
                self.translation_std
            pts[:, :3] += trans
            boxes[:, :3] += trans

        M = self.max_objs
        gt_boxes = np.zeros((M, 7), np.float32)
        gt_labels = np.full((M,), -1, np.int32)
        valid = np.zeros((M,), bool)
        k = min(n, len(boxes), M)
        gt_boxes[:k] = boxes[:k]
        gt_labels[:k] = labels[:k]
        valid[:k] = True
        return dict(points=pts[:, :3], colors=pts[:, 3:6],
                    points_valid=np.ones((P,), bool),
                    gt_boxes=gt_boxes, gt_labels=gt_labels,
                    obj_valid=valid)

    def epoch_batches(self, batch_size, shuffle=True, seed=None,
                      drop_last=True):
        """gga_tpu's batches: the scene order of ``RandomState(seed or
        0)``, full batches of stacked items."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed or 0).shuffle(order)
        nmax = (len(order) // batch_size * batch_size if drop_last
                else len(order))
        for i in range(0, nmax, batch_size):
            items = [self[j] for j in order[i:i + batch_size]]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
