"""KITTI monocular 3D dataset for the stage-4 PGD retrain (the port's copy
of ``gga_tpu/data/kitti/mono_dataset.py``; reference
``kitti_mono_dataset.py:17``), fed directly from (pseudo) info pkls.

Items are numpy dicts of fixed shapes: the image, caffe-normalized (RGB
-> BGR, minus the BGR mean, std 1) and zero-padded to 384 x 1248 (KITTI's
375 x 1242 to a multiple of 32), HWC as gga_tpu keeps it; and the
objects padded to ``max_objs``. Images are read by the port's own PNG
reader (``png.read_png``), which gives Pillow's bytes. As gga_tpu, there
is no flip augmentation and no resize (the reference's img_scale is
KITTI's own size).

``epoch_batches`` is gga_tpu's in-process batch order; the train CLI
loads the same batches through ``data.dataset.EpochLoader``, whose
sampler draws the same order (``RandomState(epoch)``) and drops the same
last partial batch.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch.utils.data as tud

from .png import read_png

IMG_H, IMG_W = 384, 1248
# caffe-style normalization (gga_pdg.py img_norm_cfg: BGR mean, std 1)
IMG_MEAN = np.array([103.530, 116.280, 123.675], np.float32)


class KittiMonoDataset(tud.Dataset):
    CLASSES = ('Pedestrian', 'Cyclist', 'Car')

    def __init__(self, root, info_path, *, max_objs=64, min_score=None,
                 test_mode=False):
        with open(info_path, 'rb') as f:
            self.infos = pickle.load(f)
        self.root = root
        self.max_objs = max_objs
        self.min_score = min_score
        self.test_mode = test_mode

    def __len__(self):
        return len(self.infos)

    def _load_image(self, info):
        img = read_png(os.path.join(self.root, info['image']['image_path']))
        img = img[..., ::-1].astype(np.float32) - IMG_MEAN   # RGB -> BGR
        out = np.zeros((IMG_H, IMG_W, 3), np.float32)
        h, w = min(img.shape[0], IMG_H), min(img.shape[1], IMG_W)
        out[:h, :w] = img[:h, :w]
        return out

    def __getitem__(self, idx):
        info = self.infos[idx]
        P2 = info['calib']['P2'].astype(np.float32)
        M = self.max_objs
        item = dict(
            image=self._load_image(info),
            cam2img=P2,
            gt_bboxes=np.zeros((M, 4), np.float32),
            gt_labels=np.full((M,), -1, np.int32),
            gt_cam3d=np.zeros((M, 7), np.float32),
            centers2d=np.zeros((M, 2), np.float32),
            depths=np.zeros((M,), np.float32),
            obj_valid=np.zeros((M,), bool),
        )
        if self.test_mode or 'annos' not in info:
            return item

        annos = info['annos']
        keep = np.array([n in self.CLASSES for n in annos['name']], bool)
        if (self.min_score is not None and 'score' in annos
                and len(annos['score'])):
            keep &= annos['score'] >= self.min_score
        names = annos['name'][keep]
        loc = annos['location'][keep].astype(np.float32)
        dims = annos['dimensions'][keep].astype(np.float32)  # (l, h, w)
        rots = annos['rotation_y'][keep].astype(np.float32)
        bboxes = annos['bbox'][keep].astype(np.float32)

        # gravity centre in the camera frame: y points down, loc is the
        # bottom centre
        gravity = loc.copy()
        gravity[:, 1] -= dims[:, 1] / 2.0
        hom = np.concatenate([gravity, np.ones((len(gravity), 1))], -1)
        uvw = hom @ P2.T
        centers2d = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-5)
        depths = uvw[:, 2]

        n = min(len(names), M)
        item['gt_bboxes'][:n] = bboxes[:n]
        item['gt_labels'][:n] = [self.CLASSES.index(x) for x in names[:n]]
        item['gt_cam3d'][:n] = np.concatenate(
            [gravity, dims, rots[:, None]], -1)[:n]
        item['centers2d'][:n] = centers2d[:n]
        item['depths'][:n] = depths[:n]
        # objects behind the camera or projecting far off the image are
        # ignored
        item['obj_valid'][:n] = ((depths[:n] > 0.1)
                                 & (centers2d[:n, 0] > -200)
                                 & (centers2d[:n, 0] < IMG_W + 200))
        return item

    def epoch_batches(self, batch_size, shuffle=True, seed=None,
                      drop_last=True):
        """Batches of one epoch in gga_tpu's order: ``RandomState(seed or
        0)`` shuffles the scenes; the last partial batch is dropped unless
        ``drop_last`` is False."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed or 0).shuffle(order)
        n = (len(order) // batch_size * batch_size if drop_last
             else len(order))
        for i in range(0, n, batch_size):
            items = [self[j] for j in order[i:i + batch_size]]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
