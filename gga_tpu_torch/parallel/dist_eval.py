"""Distributed (multi-process) evaluation: shard scenes over processes,
collect per-shard results through the filesystem (the port's copy of
``gga_tpu/parallel/dist_eval.py``).

Behavioral rebuild of the reference's ``multi_gpu_test`` tmpdir collect
(mmdet apis, as the reference's tools/generate_pseudo_labels_gga.py
calls it): every rank processes an interleaved shard (DistributedSampler
order: idx % world == rank), dumps ``part_<rank>.pkl``, and rank 0 polls
until all parts exist and merges them back into dataset order. The
collect through a shared filesystem works for ranks of one
``torch.distributed`` group and for plain processes launched with
``--rank`` / ``--world``; the results are host-side Python objects, so
there is no tensor collective to make.
"""
from __future__ import annotations

import os
import pickle
import time

from . import mesh


def shard_indices(num_items: int, rank: int, world: int):
    """Interleaved shard (torch DistributedSampler without padding)."""
    return list(range(rank, num_items, world))


def dump_part(results, rank: int, tmpdir: str):
    os.makedirs(tmpdir, exist_ok=True)
    tmp = os.path.join(tmpdir, f'.part_{rank}.pkl.tmp')
    with open(tmp, 'wb') as f:
        pickle.dump(results, f)
    os.replace(tmp, os.path.join(tmpdir, f'part_{rank}.pkl'))


def collect_parts(num_items: int, world: int, tmpdir: str,
                  timeout_s: float = 3600.0, poll_s: float = 1.0):
    """Rank-0 side: wait for every part file, merge to dataset order.

    Each part holds the rank's results in ITS shard order; the merge
    inverts the interleaving. Returns a list of length ``num_items``.
    """
    paths = [os.path.join(tmpdir, f'part_{r}.pkl') for r in range(world)]
    deadline = time.time() + timeout_s
    while not all(os.path.exists(p) for p in paths):
        if time.time() > deadline:
            missing = [p for p in paths if not os.path.exists(p)]
            raise TimeoutError(f'missing eval parts: {missing}')
        time.sleep(poll_s)
    merged = [None] * num_items
    for r, path in enumerate(paths):
        with open(path, 'rb') as f:
            part = pickle.load(f)
        idxs = shard_indices(num_items, r, world)
        if len(part) != len(idxs):
            raise ValueError(
                f'part {r} has {len(part)} results, expected {len(idxs)}')
        for i, res in zip(idxs, part):
            merged[i] = res
    return merged


def run_sharded_inference(bundle, cfg, infos, batch_size, tmpdir, rank=None,
                          world=None, max_points=None):
    """Shard ``infos`` over processes, run ``tools_lib.run_inference`` on
    the local shard, collect on rank 0 (returns the merged detections
    there, ``None`` elsewhere).

    ``rank`` / ``world`` default to the ``torch.distributed`` group when
    one is up, else 0 and 1. A world of 1 runs every scene and returns
    the detections without touching ``tmpdir`` (the merge of one part is
    the identity).
    """
    from ..tools_lib import run_inference

    rank = mesh.rank() if rank is None else rank
    world = mesh.world_size() if world is None else world
    if not 0 <= rank < world:
        raise ValueError(f'rank {rank} is outside a world of {world}')
    if world == 1:
        return run_inference(bundle, cfg, infos, batch_size,
                             max_points=max_points)
    # clear stale part files so a rerun with the same tmpdir cannot
    # silently merge a previous run's shards (the reference uses a fresh
    # random tmpdir; here the dir is caller-chosen, so rank 0 scrubs it)
    if rank == 0 and os.path.isdir(tmpdir):
        for r in range(world):
            stale = os.path.join(tmpdir, f'part_{r}.pkl')
            if os.path.exists(stale):
                os.remove(stale)
    if world > 1 and mesh.world_size() == world:
        # ranks of one group: no rank dumps before the scrub (plain
        # processes rely on rank 0 scrubbing before its own, equally long,
        # inference pass)
        mesh.barrier()
    local = [infos[i] for i in shard_indices(len(infos), rank, world)]
    part = run_inference(bundle, cfg, local, batch_size,
                         max_points=max_points)
    dump_part(part, rank, tmpdir)
    if rank != 0:
        return None
    return collect_parts(len(infos), world, tmpdir)
