"""Stage 1: KITTI data preparation with GGA weak-label generation (the
port's copy of ``tools/create_data_gga.py``).

Writes the info pkls augmented with the GGA fields (train, val and
trainval = train + val), the frustum-reduced clouds and the pseudo GT
database; the per-scene weak labels run in a process pool per split, like
the reference's Pool(60) (kitti_converter_gga.py:74-79). Host code only:
the region grow runs in the repository's C++ library (``make -C native``,
built on first use) or, where it cannot be built, in numpy with the same
results; the tool prints which.

Usage:
    python -m gga_tpu_torch.tools.create_data_gga kitti \\
        --root-path data/kitti --out-dir data/kitti [--workers 16]
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import pickle
import time

import numpy as np

from ..data.kitti import io as kio
from ..data.kitti import native
from ..data.kitti.gga_labels import calculate_gga_labels
from ..data.kitti.gt_database import (create_gga_gt_database,
                                      create_reduced_point_clouds)


def _process_scene(args):
    root, split, idx = args
    info = kio.create_scene_info(root, split, idx)
    if 'annos' in info:
        kio.compute_num_points_in_gt(root, info)
        pts = kio.load_velodyne(
            os.path.join(root, info['point_cloud']['velodyne_path']))
        calculate_gga_labels(pts, info, rng=np.random.RandomState(idx))
    return info


def kitti_data_prep(root, out_dir, workers=16):
    """Returns dict(seconds, region_grow ('native' or 'numpy'), scenes per
    split)."""
    t0 = time.perf_counter()
    # build or load the C++ region grow once, before the pool forks
    region_grow = 'native' if native.available() else 'numpy'
    print(f'region grow: {region_grow}')
    os.makedirs(out_dir, exist_ok=True)
    split_infos = {}
    for split in ('train', 'val'):
        try:
            ids = kio.read_split_ids(root, split)
        except FileNotFoundError:
            print(f'split file for {split!r} missing, skipping')
            continue
        print(f'[{split}] {len(ids)} scenes: generating GGA weak labels...')
        # fork, as gga_tpu and torch's DataLoader: the workers run numpy
        # only (no torch op, no CUDA), and spawn would import anew in each
        with mp.get_context('fork').Pool(workers) as pool:
            infos = pool.map(_process_scene,
                             [(root, split, i) for i in ids])
        split_infos[split] = infos
        path = os.path.join(out_dir, f'kitti_infos_{split}_GGA.pkl')
        with open(path, 'wb') as f:
            pickle.dump(infos, f)
        print(f'  -> {path}')

    if 'train' in split_infos and 'val' in split_infos:
        trainval = split_infos['train'] + split_infos['val']
        path = os.path.join(out_dir, 'kitti_infos_trainval_GGA.pkl')
        with open(path, 'wb') as f:
            pickle.dump(trainval, f)
        print(f'  -> {path}')
    else:
        trainval = split_infos.get('train', [])

    print('creating reduced point clouds...')
    create_reduced_point_clouds(root, trainval)
    print('creating GGA GT database...')
    create_gga_gt_database(root, split_infos.get('train', trainval))
    seconds = time.perf_counter() - t0
    print(f'done in {seconds:.2f} s.')
    return dict(seconds=seconds, region_grow=region_grow,
                scenes={k: len(v) for k, v in split_infos.items()})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('dataset', choices=['kitti'])
    p.add_argument('--root-path', default='data/kitti')
    p.add_argument('--out-dir', default=None)
    p.add_argument('--workers', type=int, default=16)
    a = p.parse_args(argv)
    return kitti_data_prep(a.root_path, a.out_dir or a.root_path, a.workers)


if __name__ == '__main__':
    main()
