"""KITTI GGA train view over an info pkl, and the epoch loader of it and
of the stage-4 mono dataset (the port's copy of ``gga_tpu/data/dataset.py``
on ``torch.utils.data``).

Items are numpy dicts of fixed shapes; a batch is their ``collate``, which
``apis.train_step`` moves to the device in one call. Nothing here touches
a CUDA tensor, so loader workers can be forked from a process that uses
the card.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch.utils.data as tud

from . import pipelines as pl


class KittiGGADataset(tud.Dataset):
    CLASSES = ('Pedestrian', 'Cyclist', 'Car')

    def __init__(self, root, info_path, *, db_sampler=None,
                 pc_range=(0, -40, -3, 70.4, 40, 1), num_points_range=15,
                 pts_prefix='velodyne_reduced', max_points=24000,
                 max_objs=128, max_cluster_pts=256, min_distance=5.0,
                 test_mode=False, seed=0):
        with open(info_path, 'rb') as f:
            self.infos = pickle.load(f)
        self.root = root
        self.db_sampler = db_sampler
        self.pc_range = tuple(pc_range)
        self.num_points_range = num_points_range
        self.pts_prefix = pts_prefix
        self.shapes = (max_points, max_objs, max_cluster_pts)
        self.min_distance = min_distance
        self.test_mode = test_mode
        self._rng_seed = seed

    def __len__(self):
        return len(self.infos)

    epoch = 0  # set by the loader; mixed into per-item rng keys

    def _item_rng(self, idx):
        # per-item rng derived from (seed, epoch, idx), as gga_tpu: the
        # point shuffle and cluster subsampling do not depend on the
        # loader's worker count, yet vary across epochs
        return np.random.RandomState(
            (self._rng_seed * 1000003 + self.epoch * 7919
             + idx * 9176) % (2 ** 31 - 1))

    def get_sample(self, idx, rng=None):
        """Raw pipeline output (pre-formatting), for eval/inspection."""
        rng = rng or self._item_rng(idx)
        s = pl.load_sample(self.infos[idx], self.root,
                           pts_prefix=self.pts_prefix,
                           classes=self.CLASSES)
        if not self.test_mode:
            if self.db_sampler is not None:
                s = pl.object_sample_gga(s, self.db_sampler,
                                         self.min_distance, rng)
            s = pl.points_range_filter(s, self.pc_range)
            s = pl.object_range_filter_gga(s, self.pc_range,
                                           self.num_points_range)
            s = pl.point_shuffle(s, rng)
        else:
            s = pl.points_range_filter(s, self.pc_range)
        return s

    def __getitem__(self, idx):
        rng = self._item_rng(idx)
        s = self.get_sample(idx, rng)
        P, M, Pc = self.shapes
        item = pl.format_gga_batch_item(s, P, M, Pc, rng)
        item['sample_idx'] = np.asarray(s['sample_idx'], np.int64)
        return item


class EpochBatchSampler(tud.Sampler):
    """The batches of ``gga_tpu``'s ``PrefetchLoader.epoch``: the scene
    order is ``RandomState(seed + epoch).shuffle``, cut into full batches
    (the last partial batch dropped). ``skip`` leaves out the first
    batches of the epoch (a resume inside an epoch).

    With ``world`` ranks ``batch_size`` is the global batch and rank
    ``rank`` takes its rows of each (``parallel.mesh.shard_rows``'s
    rows ``r*b ... (r+1)*b``, ``b = batch_size // world``)."""

    def __init__(self, n, batch_size, seed=0, rank=0, world=1):
        if batch_size % world:
            raise ValueError(f'a global batch of {batch_size} does not split '
                             f'over {world} ranks')
        self.n = n
        self.batch_size = batch_size
        self.seed = seed
        self.rows = slice(rank * batch_size // world,
                          (rank + 1) * batch_size // world)
        self.epoch = 0
        self.skip = 0

    def __len__(self):
        return self.n // self.batch_size - self.skip

    def __iter__(self):
        order = np.arange(self.n)
        np.random.RandomState(self.seed + self.epoch).shuffle(order)
        for b in range(self.skip, self.n // self.batch_size):
            batch = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield batch[self.rows].tolist()


class EpochLoader:
    """``torch.utils.data.DataLoader`` over a ``KittiGGADataset`` (or the
    stage-4 ``KittiMonoDataset``, whose ``epoch_batches`` order at seed 0
    is the sampler's) with the batch order of ``EpochBatchSampler`` and
    ``pipelines.collate``.

    ``epoch(e)`` sets the epoch on the dataset and the sampler before the
    iterator is made, so forked workers see it. As gga_tpu's
    ``PrefetchLoader.epoch``, ``num_workers <= 1`` loads in the calling
    process, so the database sampler's stateful rng carries from epoch to
    epoch: it reproduces ``PrefetchLoader(num_workers=1)`` batch for batch
    over any number of epochs. Two or more workers are forked per epoch
    and each advances its own copy of that rng, so what is pasted depends
    on ``num_workers``, as in gga_tpu. With ``world`` ranks
    (``batch_size`` the global batch) it loads rank ``rank``'s rows of
    each batch; each rank's database sampler then draws on its own scenes
    only, so what is pasted also depends on the world size, as in
    gga_tpu's forked workers."""

    def __init__(self, dataset, batch_size, num_workers=0, seed=0, rank=0,
                 world=1):
        self.dataset = dataset
        self.sampler = EpochBatchSampler(len(dataset), batch_size, seed,
                                         rank, world)
        workers = num_workers if num_workers > 1 else 0
        self.loader = tud.DataLoader(
            dataset, batch_sampler=self.sampler, num_workers=workers,
            collate_fn=pl.collate,
            multiprocessing_context='fork' if workers else None)

    def __len__(self):
        return len(self.sampler)

    def epoch(self, epoch_idx, skip=0):
        self.dataset.epoch = epoch_idx
        self.sampler.epoch = epoch_idx
        self.sampler.skip = skip
        return iter(self.loader)
