"""Point-cloud segmentation datasets: S3DIS, ScanNet and SemanticKITTI (the
port's copy of ``gga_tpu/data/seg_datasets.py``; mmdet3d's
S3DISSegDataset, ScanNetSegDataset and SemanticKITTIDataset) on
mmdet3d-format info pkls: a scene is a points .bin and a semantic-mask
.bin; S3DIS also carries instance masks and per-Area splits, ScanNet maps
the nyu40 ids to its 20 benchmark classes (the rest to 20, its ignore
index), SemanticKITTI maps the raw 0..259 ids to 19 learning classes (and
255, ignored). Scenes become fixed-size samples of ``num_points`` points
(random sub- or over-sampling, or the first points in test mode, the
labels carried along), each dataset drawing from its own
``np.random.RandomState(seed)`` in gga_tpu's order, sample for sample.

S3DIS loads ``load_dim=6`` channels (xyz, rgb), as gga_tpu's: the S3DIS
configs of DGCNN, PAConv and PointNet2-MSG declare 9 (mmdet3d adds the
xyz normalised by the room's extent), and the port's segmentors refuse
the 6-channel batch rather than build for it.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

S3DIS_CLASSES = ('ceiling', 'floor', 'wall', 'beam', 'column', 'window',
                 'door', 'table', 'chair', 'sofa', 'bookcase', 'board',
                 'clutter')

SEMKITTI_CLASSES = ('car', 'bicycle', 'motorcycle', 'truck', 'bus',
                    'person', 'bicyclist', 'motorcyclist', 'road',
                    'parking', 'sidewalk', 'other-ground', 'building',
                    'fence', 'vegetation', 'trunck', 'terrian', 'pole',
                    'traffic-sign')

# semantic-kitti.yaml learning_map (raw id -> train id, 0 = unlabeled)
SEMKITTI_LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1,
    253: 7, 254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}


def _semkitti_lut():
    lut = np.zeros(260, np.int64)
    for k, v in SEMKITTI_LEARNING_MAP.items():
        lut[k] = v
    return lut


class _BaseSegDataset:
    IGNORE_INDEX = 255

    def __init__(self, root, info_path, *, num_points=40000,
                 load_dim=6, use_color=True, patch_sample=False,
                 test_mode=False, seed=0):
        with open(info_path, 'rb') as f:
            self.infos = pickle.load(f)
        self.root = root
        self.num_points = num_points
        self.load_dim = load_dim
        self.use_color = use_color
        self.patch_sample = patch_sample
        self.test_mode = test_mode
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.infos)

    def _load_mask(self, info):
        raise NotImplementedError

    def _load_points(self, info):
        pts = np.fromfile(
            os.path.join(self.root, info['pts_path']),
            np.float32).reshape(-1, self.load_dim)
        return pts

    def patch_indices(self, pts, rng, block_size=1.5, num_try=10):
        """mmdet3d's IndoorPatchPointSample: a vertical
        column block around a random point; retried until the block
        holds at least 2%% of the scene's points."""
        n = pts.shape[0]
        for _ in range(num_try):
            center = pts[rng.randint(n), :2]
            half = block_size / 2
            inb = ((np.abs(pts[:, 0] - center[0]) <= half)
                   & (np.abs(pts[:, 1] - center[1]) <= half))
            if inb.sum() >= max(int(0.02 * n), 1):
                return np.where(inb)[0]
        return np.arange(n)

    def __getitem__(self, idx):
        info = self.infos[idx]
        pts = self._load_points(info)
        sem = self._load_mask(info)
        rng = self._rng
        if self.patch_sample and not self.test_mode:
            keep = self.patch_indices(pts, rng)
            pts, sem = pts[keep], sem[keep]
        P = self.num_points
        n = pts.shape[0]
        if n >= P:
            sel = (np.arange(P) if self.test_mode
                   else rng.choice(n, P, replace=False))
        else:
            sel = rng.choice(max(n, 1), P, replace=True)
        pts = pts[sel]
        sem = sem[sel]
        feats = pts[:, :self.load_dim] if self.use_color else pts[:, :3]
        return dict(points=feats.astype(np.float32),
                    points_valid=np.ones(P, bool),
                    seg_labels=sem.astype(np.int64))

    def epoch_batches(self, batch_size, shuffle=True, seed=0):
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            samples = [self[j] for j in order[i:i + batch_size]]
            yield {k: np.stack([s[k] for s in samples])
                   for k in samples[0]}


class S3DISSegDataset(_BaseSegDataset):
    """xyzrgb points + per-point semantic/instance masks (13 classes)."""
    CLASSES = S3DIS_CLASSES

    def _load_mask(self, info):
        sem = np.fromfile(
            os.path.join(self.root, info['pts_semantic_mask_path']),
            np.int64)
        return sem

    def load_instance_mask(self, idx):
        info = self.infos[idx]
        return np.fromfile(
            os.path.join(self.root, info['pts_instance_mask_path']),
            np.int64)


SCANNET_SEG_CLASSES = (
    'wall', 'floor', 'cabinet', 'bed', 'chair', 'sofa', 'table', 'door',
    'window', 'bookshelf', 'picture', 'counter', 'desk', 'curtain',
    'refrigerator', 'showercurtrain', 'toilet', 'sink', 'bathtub',
    'otherfurniture')

# nyu40 ids kept by the ScanNet benchmark (scannet_dataset.py
# VALID_CLASS_IDS); all other raw ids map to ignore = 20
SCANNET_VALID_CLASS_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14,
                           16, 24, 28, 33, 34, 36, 39)


class ScanNetSegDataset(_BaseSegDataset):
    """ScanNet 20-class semantic segmentation (mmdet3d's
    ScanNetSegDataset): xyzrgb points, nyu40-id masks remapped to 0..19 train ids with the
    benchmark's VALID_CLASS_IDS; unmapped ids -> ignore_index 20."""
    CLASSES = SCANNET_SEG_CLASSES

    def __init__(self, root, info_path, *, num_points=8192,
                 test_mode=False, seed=0, use_color=True):
        super().__init__(root, info_path, num_points=num_points,
                         load_dim=6, use_color=use_color,
                         test_mode=test_mode, seed=seed)
        lut = np.full(41, len(self.CLASSES), np.int64)
        for ti, nyu in enumerate(SCANNET_VALID_CLASS_IDS):
            lut[nyu] = ti
        self._lut = lut

    def _load_mask(self, info):
        raw = np.fromfile(
            os.path.join(self.root, info['pts_semantic_mask_path']),
            np.int64)
        return self._lut[np.clip(raw, 0, 40)]


class SemanticKITTIDataset(_BaseSegDataset):
    """KITTI odometry velodyne scans + .label semantic masks; raw ids
    remapped by the semantic-kitti learning map (0 -> ignore)."""
    CLASSES = SEMKITTI_CLASSES

    def __init__(self, root, info_path, *, num_points=60000,
                 test_mode=False, seed=0):
        super().__init__(root, info_path, num_points=num_points,
                         load_dim=4, use_color=True,
                         test_mode=test_mode, seed=seed)
        self._lut = _semkitti_lut()

    def _load_mask(self, info):
        raw = np.fromfile(
            os.path.join(self.root, info['pts_semantic_mask_path']),
            np.uint32)
        sem_ids = raw & 0xFFFF                 # low 16 bits = semantics
        mapped = self._lut[np.clip(sem_ids, 0, 259)]
        # learning id 0 = unlabeled -> ignore; shift others to 0-based
        out = np.where(mapped == 0, self.IGNORE_INDEX, mapped - 1)
        return out
