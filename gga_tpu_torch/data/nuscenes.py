"""nuScenes dataset on info pkls, with static padded batches (port of
``gga_tpu/data/nuscenes.py`` ``NuScenesDataset``, host code in numpy;
mmdet3d's NuScenesDataset and LoadPointsFromMultiSweeps): infos sorted by
timestamp, optional ``load_interval`` subsampling, GT filtered by
``valid_flag`` or lidar-point count, boxes moved from the devkit's gravity
centre to the bottom centre, velocity channels (NaN to 0) for 9-dim
boxes, and each key frame's cloud concatenated with up to ``sweeps_num``
past sweeps moved into the key lidar frame, with a time-lag channel.

Ragged scenes become static shapes: points padded or subsampled to
``max_points`` from a per-(seed, epoch, index) generator, objects padded
to ``max_objs`` with validity masks.

``LyftDataset`` (mmdet3d's lyft_dataset.py, gga_tpu's ``LyftDataset``)
reads nuScenes-format info pkls with Lyft's 9 classes and no velocity
channels; ``eval/lyft_eval.py`` scores it.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

NUS_CLASSES = ('car', 'truck', 'trailer', 'bus', 'construction_vehicle',
               'bicycle', 'motorcycle', 'pedestrian', 'traffic_cone',
               'barrier')

DEFAULT_ATTRIBUTE = {
    'car': 'vehicle.parked', 'pedestrian': 'pedestrian.moving',
    'trailer': 'vehicle.parked', 'truck': 'vehicle.parked',
    'bus': 'vehicle.moving', 'motorcycle': 'cycle.without_rider',
    'construction_vehicle': 'vehicle.parked',
    'bicycle': 'cycle.without_rider', 'barrier': '',
    'traffic_cone': '',
}


def load_sweep_points(path, num_features=5):
    pts = np.fromfile(path, dtype=np.float32)
    return pts.reshape(-1, num_features)[:, :num_features]


class NuScenesDataset:
    CLASSES = NUS_CLASSES

    def __init__(self, data_root, info_path, max_points=60000,
                 max_objs=128, sweeps_num=10, load_interval=1,
                 with_velocity=True, use_valid_flag=False,
                 point_cloud_range=(-50, -50, -5, 50, 50, 3),
                 test_mode=False, seed=0):
        self.data_root = data_root
        with open(info_path, 'rb') as f:
            data = pickle.load(f)
        infos = sorted(data['infos'], key=lambda e: e['timestamp'])
        self.data_infos = infos[::load_interval]
        self.metadata = data.get('metadata', {})
        self.max_points = max_points
        self.max_objs = max_objs
        self.sweeps_num = sweeps_num
        self.with_velocity = with_velocity
        self.use_valid_flag = use_valid_flag
        self.pc_range = np.asarray(point_cloud_range, np.float32)
        self.test_mode = test_mode
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return len(self.data_infos)

    def _path(self, p):
        return p if os.path.isabs(p) else os.path.join(self.data_root, p)

    def load_points(self, index, rng):
        """Key frame + sweeps -> [N, 5] (x, y, z, intensity, dt)."""
        info = self.data_infos[index]
        key = load_sweep_points(self._path(info['lidar_path']))
        ts = info['timestamp'] / 1e6
        # key frame time lag = 0; intensity kept, ring dropped
        clouds = [np.concatenate(
            [key[:, :4], np.zeros((len(key), 1), np.float32)], -1)]
        sweeps = list(info.get('sweeps', []))
        if len(sweeps) > self.sweeps_num:
            if self.test_mode:
                sweeps = sweeps[:self.sweeps_num]
            else:
                sel = rng.choice(len(sweeps), self.sweeps_num,
                                 replace=False)
                sweeps = [sweeps[i] for i in sel]
        for sw in sweeps:
            pts = load_sweep_points(self._path(sw['data_path']))
            xyz = pts[:, :3] @ np.asarray(
                sw['sensor2lidar_rotation'], np.float32).T \
                + np.asarray(sw['sensor2lidar_translation'], np.float32)
            dt = ts - sw['timestamp'] / 1e6
            clouds.append(np.concatenate(
                [xyz, pts[:, 3:4],
                 np.full((len(pts), 1), dt, np.float32)], -1))
        return np.concatenate(clouds).astype(np.float32)

    def get_ann(self, index):
        """(boxes [G, 7 or 9] bottom-center lidar, labels, valid)."""
        info = self.data_infos[index]
        if self.use_valid_flag and 'valid_flag' in info:
            mask = np.asarray(info['valid_flag'], bool)
        else:
            mask = np.asarray(info['num_lidar_pts']) > 0
        boxes = np.asarray(info['gt_boxes'], np.float64)[mask]
        names = np.asarray(info['gt_names'])[mask]
        labels = np.array([self.CLASSES.index(n) if n in self.CLASSES
                           else -1 for n in names], np.int64)
        if self.with_velocity:
            vel = np.asarray(info['gt_velocity'], np.float64)[mask]
            vel = np.nan_to_num(vel)
            boxes = np.concatenate([boxes, vel], -1)
        # devkit gravity center -> bottom center
        if len(boxes):
            boxes[:, 2] -= boxes[:, 5] / 2
        keep = labels >= 0
        return boxes[keep], labels[keep], names[keep]

    def get_sample(self, index):
        rng = np.random.RandomState(
            (self.seed * 9973 + self.epoch * 131 + index) % (2 ** 31))
        pts = self.load_points(index, rng)
        rng_mask = ((pts[:, :3] >= self.pc_range[:3]).all(1)
                    & (pts[:, :3] <= self.pc_range[3:]).all(1))
        pts = pts[rng_mask]
        P = self.max_points
        out_pts = np.zeros((P, pts.shape[1]), np.float32)
        if len(pts) > P:
            sel = rng.choice(len(pts), P, replace=False) \
                if not self.test_mode else np.arange(P)
            pts = pts[sel]
        out_pts[:len(pts)] = pts
        valid = np.zeros(P, bool)
        valid[:len(pts)] = True

        sample = dict(points=out_pts, points_valid=valid,
                      sample_idx=index,
                      token=self.data_infos[index]['token'])
        if not self.test_mode:
            boxes, labels, _ = self.get_ann(index)
            G = self.max_objs
            dim = 9 if self.with_velocity else 7
            gb = np.zeros((G, dim), np.float32)
            gl = np.zeros(G, np.int64)
            gv = np.zeros(G, bool)
            n = min(len(boxes), G)
            gb[:n] = boxes[:n]
            gl[:n] = labels[:n]
            gv[:n] = True
            sample.update(gt_boxes=gb, gt_labels=gl, gt_valid=gv)
        return sample

    def epoch_batches(self, batch_size, shuffle=True, seed=0):
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            samples = [self.get_sample(j) for j in order[i:i + batch_size]]
            yield {k: np.stack([s[k] for s in samples])
                   for k in samples[0] if k != 'token'}

    def eval_ground_truth(self):
        """Per-sample GT dicts for ``eval.nuscenes_eval``."""
        gts = []
        for i in range(len(self)):
            boxes, labels, names = self.get_ann(i)
            gts.append(dict(boxes=boxes, names=names))
        return gts

    def format_results(self, detections, out_path=None):
        """Detections -> nuScenes submission dict
        (nuscenes_dataset.format_results / _format_bbox): boxes move
        from the key lidar frame to the GLOBAL frame via the info's
        lidar2ego and ego2global transforms; attributes default by
        class (DefaultAttribute)."""
        results = {}
        for det, info in zip(detections, self.data_infos):
            l2e_r = np.asarray(info['lidar2ego_rotation_matrix'])  \
                if 'lidar2ego_rotation_matrix' in info else None
            annos = []
            boxes = np.asarray(det['boxes_3d'], np.float64)
            for k in range(len(boxes)):
                b = boxes[k]
                center = b[:3].copy()
                center[2] += b[5] / 2          # bottom -> gravity
                if l2e_r is not None:
                    center = center @ l2e_r.T + np.asarray(
                        info['lidar2ego_translation'])
                    e2g_r = np.asarray(info['ego2global_rotation_matrix'])
                    center = center @ e2g_r.T + np.asarray(
                        info['ego2global_translation'])
                name = self.CLASSES[int(det['labels_3d'][k])]
                annos.append(dict(
                    sample_token=info['token'],
                    translation=center.tolist(),
                    size=[float(b[4]), float(b[3]), float(b[5])],
                    rotation_yaw=float(b[6]),
                    velocity=([float(b[7]), float(b[8])]
                              if len(b) >= 9 else [0.0, 0.0]),
                    detection_name=name,
                    detection_score=float(det['scores_3d'][k]),
                    attribute_name=DEFAULT_ATTRIBUTE[name]))
            results[info['token']] = annos
        submission = dict(
            meta=dict(use_lidar=True, use_camera=False,
                      use_radar=False, use_map=False,
                      use_external=False),
            results=results)
        if out_path:
            import json
            os.makedirs(os.path.dirname(out_path) or '.', exist_ok=True)
            with open(out_path, 'w') as f:
                json.dump(submission, f)
        return submission


LYFT_CLASSES = ('car', 'truck', 'bus', 'emergency_vehicle',
                'other_vehicle', 'motorcycle', 'bicycle', 'pedestrian',
                'animal')


class LyftDataset(NuScenesDataset):
    """Lyft L5 on nuScenes-format infos: Lyft's 9 classes, no velocity
    channels (7-dim boxes) and the range (-80, -80, -10, 80, 80, 10)
    unless given."""
    CLASSES = LYFT_CLASSES

    def __init__(self, data_root, info_path, **kwargs):
        kwargs.setdefault('with_velocity', False)
        kwargs.setdefault('point_cloud_range',
                          (-80, -80, -10, 80, 80, 10))
        super().__init__(data_root, info_path, **kwargs)
