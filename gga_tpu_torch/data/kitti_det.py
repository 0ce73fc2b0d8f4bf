"""The fully supervised KITTI detection dataset (port of
``gga_tpu/data/kitti_det.py`` ``KittiDetDataset``; mmdet3d's
KittiDataset on the 3D-GT path of SECOND and PointPillars): each info's
lidar cloud and its 3D ground truth in the lidar frame, the training
augmentation (a flip of y, a global rotation and scale) and the range
filters, as static padded numpy arrays. Host code only, numpy as
gga_tpu's: a sample's draws come from ``RandomState`` seeded by (seed,
epoch, index) in gga_tpu's order (flip, rotation, scale, then the point
subsample), so the samples are gga_tpu's bit for bit.

As in gga_tpu, a config's ``db_sampler`` is not used on this path.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..core import np_geometry as ng


class KittiDetDataset:
    CLASSES = ('Pedestrian', 'Cyclist', 'Car')
    POINT_DIM = 4

    def __init__(self, root, info_path, *,
                 pc_range=(0, -40, -3, 70.4, 40, 1),
                 pts_prefix='velodyne_reduced', max_points=24000,
                 max_objs=64, test_mode=False, seed=0,
                 flip_ratio=0.5, rot_range=(-0.78539816, 0.78539816),
                 scale_range=(0.95, 1.05)):
        with open(info_path, 'rb') as f:
            self.infos = pickle.load(f)
        self.root = root
        self.pc_range = np.asarray(pc_range, np.float32)
        self.pts_prefix = pts_prefix
        self.max_points = max_points
        self.max_objs = max_objs
        self.test_mode = test_mode
        self.seed = seed
        self.epoch = 0
        self.flip_ratio = flip_ratio
        self.rot_range = rot_range
        self.scale_range = scale_range

    def __len__(self):
        return len(self.infos)

    def _item_rng(self, idx):
        return np.random.RandomState(
            (self.seed * 1000003 + self.epoch * 7919 + idx * 9176)
            % (2 ** 31 - 1))

    def _load_points(self, info):
        rel = info['point_cloud']['velodyne_path']
        if self.pts_prefix != 'velodyne':
            rel = rel.replace('velodyne', self.pts_prefix)
        pts = np.fromfile(os.path.join(self.root, rel), np.float32)
        return pts.reshape(-1, self.POINT_DIM)

    def _gt_lidar(self, info):
        """Camera-frame annos -> lidar bottom-centre boxes + labels of
        ``CLASSES`` (DontCare and other names dropped)."""
        a = info['annos']
        n = int((np.asarray(a['name']) != 'DontCare').sum())
        names = np.asarray(a['name'])[:n]
        keep = np.array([nm in self.CLASSES for nm in names], bool)
        rect = info['calib']['R0_rect']
        trv2c = info['calib']['Tr_velo_to_cam']
        loc = np.asarray(a['location'])[:n][keep]
        dims = np.asarray(a['dimensions'])[:n][keep]   # l, h, w
        rots = np.asarray(a['rotation_y'])[:n][keep]
        if len(loc) == 0:
            return np.zeros((0, 7)), np.zeros(0, np.int64)
        boxes_cam = np.concatenate([loc, dims, rots[:, None]], -1)
        boxes = ng.box_camera_to_lidar(boxes_cam, rect, trv2c)
        labels = np.array([self.CLASSES.index(nm) for nm in names[keep]],
                          np.int64)
        return boxes, labels

    def get_sample(self, idx):
        """dict(points [max_points, 4] f32, points_valid, gt_boxes
        [max_objs, 7] f32, gt_labels (-1 padded), gt_valid, sample_idx)."""
        info = self.infos[idx]
        rng = self._item_rng(idx)
        pts = self._load_points(info)
        boxes, labels = self._gt_lidar(info)

        if not self.test_mode:
            if rng.rand() < self.flip_ratio:       # RandomFlip3D (y)
                pts[:, 1] = -pts[:, 1]
                if len(boxes):
                    boxes[:, 1] = -boxes[:, 1]
                    boxes[:, 6] = -boxes[:, 6]
            ang = rng.uniform(*self.rot_range)     # GlobalRotScaleTrans
            c, s = np.cos(ang), np.sin(ang)
            rot = np.array([[c, s], [-s, c]], np.float32)
            pts[:, :2] = pts[:, :2] @ rot
            if len(boxes):
                boxes[:, :2] = boxes[:, :2] @ rot
                boxes[:, 6] += ang
            sc = rng.uniform(*self.scale_range)
            pts[:, :3] *= sc
            if len(boxes):
                boxes[:, :6] *= sc

        inr = ((pts[:, :3] >= self.pc_range[:3])
               & (pts[:, :3] <= self.pc_range[3:])).all(1)
        pts = pts[inr]
        if len(boxes):
            binr = ((boxes[:, :2] >= self.pc_range[:2])
                    & (boxes[:, :2] <= self.pc_range[3:5])).all(1)
            boxes, labels = boxes[binr], labels[binr]

        P = self.max_points
        out = np.zeros((P, self.POINT_DIM), np.float32)
        if len(pts) > P:
            pts = pts[rng.choice(len(pts), P, replace=False)]
        out[:len(pts)] = pts
        valid = np.zeros(P, bool)
        valid[:len(pts)] = True

        G = self.max_objs
        gb = np.zeros((G, 7), np.float32)
        gl = np.full(G, -1, np.int64)
        gv = np.zeros(G, bool)
        k = min(len(boxes), G)
        gb[:k] = boxes[:k]
        gl[:k] = labels[:k]
        gv[:k] = True
        return dict(points=out, points_valid=valid, gt_boxes=gb,
                    gt_labels=gl, gt_valid=gv, sample_idx=idx)

    def epoch_batches(self, batch_size, shuffle=True, seed=0):
        """Stacked batches of ``batch_size`` samples in ``RandomState(seed)``
        order, the last partial batch dropped."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            samples = [self.get_sample(j) for j in order[i:i + batch_size]]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}
