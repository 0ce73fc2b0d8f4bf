"""Copy-paste database sampler for GGA weak training (the port's copy of
``gga_tpu/data/sampler.py``).

Each class's ``BatchSampler`` keeps a stateful ``RandomState``: a loader
worker advances its own copy, so what is pasted depends on the number of
workers, as in gga_tpu (see ``data.dataset.EpochLoader``).

Rebuild of DataBaseSampler_GGA + its per-class BatchSampler
(mmdet3d/datasets/pipelines/gga_processing.py:588-1020):
since no 3D GT exists, collision testing uses BEV center distances of the
initial pseudo labels (sample_class_GGA:961) instead of box IoU.
"""
from __future__ import annotations

import copy
import os
import pickle

import numpy as np


class BatchSampler:
    """Epoch-shuffled without-replacement sampler over one class's infos
    (mmdet3d dbsampler.BatchSampler semantics)."""

    def __init__(self, sampled_list, shuffle=True, seed=0):
        self._sampled_list = sampled_list
        self._indices = np.arange(len(sampled_list))
        self._rng = np.random.RandomState(seed)
        self._shuffle = shuffle
        if shuffle:
            self._rng.shuffle(self._indices)
        self._idx = 0

    def _sample(self, num):
        if self._idx + num >= len(self._sampled_list):
            ret = self._indices[self._idx:].copy()
            self._reset()
        else:
            ret = self._indices[self._idx:self._idx + num]
            self._idx += num
        return ret

    def _reset(self):
        if self._shuffle:
            self._rng.shuffle(self._indices)
        self._idx = 0

    def sample(self, num):
        return [self._sampled_list[i] for i in self._sample(num)]


class GGADataBaseSampler:
    """Samples pseudo-GT objects and pastes their frustum point crops.

    Args:
        info_path: kitti_dbinfos_train_GGA.pkl.
        data_root: dataset root (object .bin paths are relative to it).
        rate: sampling rate multiplier.
        prepare: dict of filters, e.g.
            {'filter_by_difficulty': [-1],
             'filter_by_min_points': {'Car': 5, ...}}.
        sample_groups: dict class -> max objects per scene.
    """

    def __init__(self, info_path, data_root, classes,
                 sample_groups, rate=1.0, prepare=None, seed=0):
        self.data_root = data_root
        self.rate = rate
        self.classes = list(classes)
        self.cat2label = {c: i for i, c in enumerate(self.classes)}
        with open(info_path, 'rb') as f:
            db_infos = pickle.load(f)

        prepare = prepare or {}
        if 'filter_by_difficulty' in prepare:
            removed = prepare['filter_by_difficulty']
            db_infos = {
                k: [x for x in v if x['difficulty'] not in removed]
                for k, v in db_infos.items()}
        if 'filter_by_min_points' in prepare:
            for name, min_num in prepare['filter_by_min_points'].items():
                if name in db_infos and min_num > 0:
                    db_infos[name] = [
                        x for x in db_infos[name]
                        if x['num_points_in_gt'] >= min_num]

        self.db_infos = db_infos
        self.sample_classes = list(sample_groups.keys())
        self.sample_max_nums = [int(v) for v in sample_groups.values()]
        self.sampler_dict = {
            k: BatchSampler(v, seed=seed + i)
            for i, (k, v) in enumerate(db_infos.items())}

    def sample_all(self, init_pseudo_labels, gt_labels, mask_valid,
                   min_distance=5.0):
        """Sample objects of every class with BEV-distance collision tests
        (sample_all:791). Returns None if nothing was sampled, else a dict
        of stacked GGA fields + concatenated points."""
        avoid = init_pseudo_labels[mask_valid][:, :2]

        out = dict(gt_labels_3d=[], gt_bbox_3ds=[], GGA_box_imgs=[],
                   GGA_lidar2imgs=[], GGA_init_pseudo_labels=[],
                   GGA_mask_valids=[], GGA_bdry_masks=[],
                   GGA_difficulties=[], GGA_num_points_in_box2ds=[],
                   GGA_in_box_points=[], points=[])
        n_sampled = 0
        for class_name, max_num in zip(self.sample_classes,
                                       self.sample_max_nums):
            label = self.cat2label[class_name]
            want = int(max_num - (np.asarray(gt_labels) == label).sum())
            want = int(np.round(self.rate * want))
            if want <= 0 or class_name not in self.sampler_dict:
                continue
            picked = self._sample_class(class_name, want, avoid,
                                        min_distance)
            if not picked:
                continue
            for s in picked:
                out['gt_labels_3d'].append(label)
                out['gt_bbox_3ds'].append(s['box3d_lidar'])
                out['GGA_box_imgs'].append(s['GGA_box_img'])
                out['GGA_lidar2imgs'].append(s['GGA_lidar2img'])
                out['GGA_init_pseudo_labels'].append(
                    s['GGA_init_pseudo_label'])
                out['GGA_mask_valids'].append(
                    bool(s['GGA_mask2d'] and s['GGA_mask_valid']
                         and s['GGA_mask_depth']))
                out['GGA_bdry_masks'].append(s['GGA_bdry_mask'])
                out['GGA_difficulties'].append(s['difficulty'])
                out['GGA_num_points_in_box2ds'].append(
                    s['GGA_num_points_in_box2d'])
                out['GGA_in_box_points'].append(
                    np.asarray(s['GGA_in_box_points']).reshape(-1, 3))
                pts = np.fromfile(
                    os.path.join(self.data_root, s['path']),
                    dtype=np.float32).reshape(-1, 4)
                out['points'].append(pts)  # absolute coords (no translate)
            avoid = np.concatenate(
                [avoid,
                 np.stack([s['GGA_init_pseudo_label'][:2]
                           for s in picked])], 0)
            n_sampled += len(picked)

        if n_sampled == 0:
            return None
        return dict(
            gt_labels_3d=np.asarray(out['gt_labels_3d'], np.int64),
            gt_bbox_3ds=np.stack(out['gt_bbox_3ds']),
            GGA_box_imgs=np.stack(out['GGA_box_imgs']),
            GGA_lidar2imgs=np.stack(out['GGA_lidar2imgs']),
            GGA_init_pseudo_labels=np.stack(out['GGA_init_pseudo_labels']),
            GGA_mask_valids=np.asarray(out['GGA_mask_valids'], bool),
            GGA_bdry_masks=np.stack(out['GGA_bdry_masks']),
            GGA_difficulties=np.asarray(out['GGA_difficulties']),
            GGA_num_points_in_box2ds=np.asarray(
                out['GGA_num_points_in_box2ds']),
            GGA_in_box_points=out['GGA_in_box_points'],
            points=np.concatenate(out['points'])
            if out['points'] else np.zeros((0, 4), np.float32),
        )

    def _sample_class(self, name, num, avoid_xy, min_distance):
        """BEV pairwise-distance collision filter (sample_class_GGA:961)."""
        sampled = copy.deepcopy(self.sampler_dict[name].sample(num))
        sampled = [s for s in sampled if s['GGA_mask_valid']]
        if not sampled:
            return []
        num_gt = avoid_xy.shape[0]
        sp_xy = np.stack([s['GGA_init_pseudo_label'][:2] for s in sampled])
        total = np.concatenate([avoid_xy, sp_xy], 0)
        d = np.linalg.norm(total[:, None, :] - total[None, :, :], axis=-1)
        coll = d < min_distance
        coll[:num_gt, :num_gt] = False
        np.fill_diagonal(coll, False)
        valid = []
        for i in range(num_gt, num_gt + len(sampled)):
            if coll[i].any():
                coll[i] = False
                coll[:, i] = False
            else:
                valid.append(sampled[i - num_gt])
        return valid
