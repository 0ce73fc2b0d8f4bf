"""ScanNet dataset of FCAF3D and VoteNet (port of ``gga_tpu/data/
scannet.py``; mmdet3d's ScanNetDataset) over mmdet3d-format info pkls:
per scene a points .bin (xyzrgb f32) and annos with axis-aligned
``gt_boxes_upright_depth`` [M, 6] (no yaw) and ``class`` labels. Items
are numpy dicts of fixed shapes, the boxes given a zero yaw column;
train-time augmentation draws, from one ``RandomState(seed)`` in
gga_tpu's order: the point sample (without replacement where the scene
has enough points, else with it), then a flip along x and a flip along y.

The draws are stateful, item after item, so the stream depends on the
order items are read, as with ``data/sunrgbd.py``.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch.utils.data as tud

CLASSES = ('cabinet', 'bed', 'chair', 'sofa', 'table', 'door', 'window',
           'bookshelf', 'picture', 'counter', 'desk', 'curtain',
           'refrigerator', 'showercurtrain', 'toilet', 'sink', 'bathtub',
           'garbagebin')


class ScanNetDataset(tud.Dataset):
    CLASSES = CLASSES

    def __init__(self, root, info_path, *, num_points=100000, max_objs=64,
                 test_mode=False, seed=0):
        with open(info_path, 'rb') as f:
            self.infos = pickle.load(f)
        self.root = root
        self.num_points = num_points
        self.max_objs = max_objs
        self.test_mode = test_mode
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, idx):
        info = self.infos[idx]
        pts = np.fromfile(os.path.join(self.root, info['pts_path']),
                          np.float32).reshape(-1, 6)
        annos = info.get('annos', {})
        boxes6 = np.asarray(
            annos.get('gt_boxes_upright_depth', np.zeros((0, 6)))
        ).reshape(-1, 6).astype(np.float32)
        labels = np.asarray(annos.get('class', np.zeros(0)),
                            np.int64).reshape(-1)

        P = self.num_points
        if pts.shape[0] >= P:
            sel = self._rng.choice(pts.shape[0], P, replace=False)
        else:
            sel = self._rng.choice(max(pts.shape[0], 1), P, replace=True)
        pts = pts[sel]

        boxes = np.concatenate(
            [boxes6, np.zeros((len(boxes6), 1), np.float32)], -1)
        if not self.test_mode:
            if self._rng.rand() < 0.5:
                pts[:, 0] = -pts[:, 0]
                boxes[:, 0] = -boxes[:, 0]
            if self._rng.rand() < 0.5:
                pts[:, 1] = -pts[:, 1]
                boxes[:, 1] = -boxes[:, 1]

        M = self.max_objs
        gt_boxes = np.zeros((M, 7), np.float32)
        gt_labels = np.full((M,), -1, np.int32)
        valid = np.zeros((M,), bool)
        k = min(len(boxes), M)
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
