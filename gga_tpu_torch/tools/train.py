"""Stage 2: GGA weak training, data-parallel over the processes of a
``torchrun`` launch (the port's copy of ``tools/train.py``).

Reads a config file, writes ``config_dump.py`` into the work dir, trains
with ``apis.train_step`` on batches of the epoch loader, appends one JSON
line per ``log_interval`` steps to ``train_log.jsonl`` (the step, epoch,
the lr the step ran at, scenes/s, the share of the wall time spent waiting
on the loader, and the step's logs), keeps a checkpoint every
``checkpoint_interval`` epochs under ``<work-dir>/checkpoints`` and runs
the KITTI eval every ``eval_interval`` epochs.

The step count sizes the schedules as gga_tpu does: ``total_steps`` is
``len(dataset) // samples_per_gpu * max_epochs``, capped by
``--max-steps``. ``--resume`` continues from the newest checkpoint
(weights, optimizer, step, SRL generator) at the batch after it, in its
epoch; ``--load-from DIR`` loads the weights of DIR's newest checkpoint
and starts at step 0. The database sampler's rng is not checkpointed.

One process per card, as PyTorch runs DDP (gga_tpu runs one process
per host over a device mesh): under ``torchrun`` each rank joins the
group (``nccl`` on cards, ``gloo`` with ``--device cpu``;
``--dist-url``, by default ``env://``), runs on ``cuda:LOCAL_RANK``, and
takes its rows of each global batch of ``samples_per_gpu x world``
scenes, as gga_tpu's global batch is ``samples_per_gpu x devices``. The batch norms' moments and the loss
normalisers span the global batch and the gradients are summed over the
ranks (``parallel.mesh``), so the ranks take the one-process step on the
global batch. Each rank's database sampler draws on its own scenes, so the
pasted objects differ from one process's, as gga_tpu's forked workers'
do. Rank 0 alone writes ``config_dump.py``, ``train_log.jsonl`` and the
checkpoints, in the one-process format; every rank reads the same
checkpoint on ``--resume``, under any world size. The periodic eval shards
the scenes over the ranks (``parallel.dist_eval``) and rank 0 scores them.

Differences from gga_tpu: the seeded initial weights are drawn from a
``torch.Generator`` seeded with ``cfg.seed`` (``apis.init_detector``), not
from ``PRNGKey(cfg.seed)``. Without a card the tool raises unless
``--device cpu``.

Usage:
    [torchrun --nproc-per-node N] -m gga_tpu_torch.tools.train \\
        configs/gga/gga_kitti.py \\
        [--work-dir D] [--resume | --load-from DIR] [--max-steps N] \\
        [--device cuda|cpu] [--no-eval] [--eval-info PKL] \\
        [--dist-url URL] \\
        [--cfg-options k.ey=val ...]
(``python -m gga_tpu_torch.tools.train ...`` for one process.)
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from .. import apis
from ..config import Config
from ..data.dataset import EpochLoader, KittiGGADataset
from ..data.sampler import GGADataBaseSampler
from ..device import resolve_device
from ..parallel import mesh
from ..parallel.dist_eval import run_sharded_inference
from ..train import checkpoints as ckpt
from ..tools_lib import model_config_from_cfg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('config')
    p.add_argument('--work-dir', default=None)
    p.add_argument('--device', default='cuda')
    p.add_argument('--resume', action='store_true',
                   help='resume from the newest checkpoint in the work dir')
    p.add_argument('--load-from', default=None,
                   help='weights-only init from a checkpoint dir')
    p.add_argument('--max-steps', type=int, default=None,
                   help='cap total steps (debug)')
    p.add_argument('--eval-info', default=None,
                   help='info pkl for periodic eval (EvalHook equivalent); '
                        'defaults to the train info')
    p.add_argument('--no-eval', action='store_true')
    add_dist_args(p)
    p.add_argument('--cfg-options', nargs='*', default=[])
    return p.parse_args(argv)


def add_dist_args(p):
    """The process-group flag of the CLIs (read under torchrun)."""
    p.add_argument('--dist-url', default=None,
                   help='rendezvous of the group (default env://; '
                        'file:///path for a FileStore)')


def launch(args):
    """(device, rank, world) of this process: ``mesh.init_from_env`` on
    the flags (it joins a group when world > 1), then the device
    resolved."""
    device, rank, world = mesh.init_from_env(args.device, args.dist_url)
    return resolve_device(device), rank, world


def load_config(path, options):
    cfg = Config.fromfile(path)
    cfg.merge_from_options(dict(kv.split('=', 1) for kv in options))
    return cfg


def build_dataset(cfg):
    d = cfg.data
    sampler = GGADataBaseSampler(
        os.path.join(cfg.data_root, d.db_info), cfg.data_root,
        classes=KittiGGADataset.CLASSES,
        sample_groups=d.db_sampler.sample_groups,
        rate=d.db_sampler.rate, prepare=d.db_sampler.prepare,
        seed=cfg.seed)
    return KittiGGADataset(
        cfg.data_root, os.path.join(cfg.data_root, d.train_info),
        db_sampler=sampler, pc_range=cfg.point_cloud_range,
        num_points_range=d.num_points_range, pts_prefix=d.pts_prefix,
        max_points=d.max_points, max_objs=cfg.head.max_objs,
        max_cluster_pts=d.max_cluster_pts, min_distance=d.min_distance,
        seed=cfg.seed)


def main(argv=None):
    """Returns a summary: the steps taken, the step it started at, the
    wall time of the steps after the first, scenes/s over them (loader
    included), the share of it spent waiting on the loader, and the
    checkpoints' sizes and save/load times."""
    args = parse_args(argv)
    dev, rank, world = launch(args)
    try:
        return _train(args, dev, rank, world)
    finally:
        if world > 1:
            mesh.shutdown()


def _train(args, dev, rank, world):
    lead = rank == 0
    cfg = load_config(args.config, args.cfg_options)
    work_dir = args.work_dir or cfg.get('work_dir', './work_dirs/run')
    os.makedirs(work_dir, exist_ok=True)
    if lead:
        with open(os.path.join(work_dir, 'config_dump.py'), 'w') as f:
            f.write(cfg.dump())

    model_cfg = model_config_from_cfg(cfg)
    apis.check_compute_dtype(model_cfg, dev)
    dataset = build_dataset(cfg)
    # the global batch, as gga_tpu's samples_per_gpu x devices
    batch_size = cfg.data.samples_per_gpu * world
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    total_steps = steps_per_epoch * cfg.max_epochs
    if args.max_steps:
        total_steps = min(total_steps, args.max_steps)
    print(f'rank {rank}/{world} device={dev} batch={batch_size} '
          f'steps/epoch={steps_per_epoch} total={total_steps}')

    trainer = apis.init_trainer(model_cfg, total_steps, device=dev,
                                seed=cfg.seed,
                                optimizer=dict(cfg.optimizer))
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f'params: {n_params / 1e6:.2f}M')

    ckpt_dir = os.path.join(work_dir, 'checkpoints')
    summary = dict(ckpt_save_ms=[], ckpt_bytes=None, ckpt_load_ms=None)
    t0 = time.perf_counter()
    if args.resume:
        _, ok = ckpt.resume_from(ckpt_dir, trainer)
        print(f'resume: {"ok, step " + str(trainer.step) if ok else "no checkpoint"}')
    elif args.load_from:
        _, ok = ckpt.load_from(args.load_from, trainer)
        print(f'load_from: {"ok" if ok else "no checkpoint"}')
    if args.resume or args.load_from:
        summary['ckpt_load_ms'] = (time.perf_counter() - t0) * 1e3

    loader = EpochLoader(dataset, batch_size,
                         num_workers=cfg.get('loader_workers', 8),
                         seed=cfg.seed, rank=rank, world=world)
    log_path = os.path.join(work_dir, 'train_log.jsonl')
    start = step = trainer.step
    first_epoch, skip = divmod(start, steps_per_epoch)
    done = args.max_steps is not None and step >= args.max_steps
    # the steps after the first (which holds the warm-up): their wall
    # time, loader included, and the part of it spent waiting on batches
    steady_s = wait_s = 0.0
    warm = False
    t_last, n_last = time.perf_counter(), start
    for epoch in range(first_epoch, cfg.max_epochs):
        if done:
            break
        # the loader's time: making the epoch's iterator (forking its
        # workers), waiting on each batch, and the wait that ends the epoch
        t_mark = time.perf_counter() if warm else None
        it = loader.epoch(epoch, skip if epoch == first_epoch else 0)
        if warm:
            wait_s += time.perf_counter() - t_mark
        for_epoch = 0
        while True:
            t_ask = time.perf_counter()
            if warm and t_mark is None:
                t_mark = t_ask
            batch = next(it, None)
            if warm:
                wait_s += time.perf_counter() - t_ask
            if batch is None:
                break
            lr = trainer.optimizer.lr_schedule(trainer.optimizer.count)
            logs = apis.train_step(trainer, batch)
            step = trainer.step
            for_epoch += 1
            if not warm:
                float(logs['loss'])
                warm = True
            if step % cfg.log_interval == 0:
                logs = {k: float(v) for k, v in logs.items()}
                now = time.perf_counter()
                dt = (now - t_last) / max(step - n_last, 1)
                t_last, n_last = now, step
                line = dict(step=step, epoch=epoch, lr=lr,
                            scenes_per_sec=batch_size / dt,
                            loader_wait_share=(
                                wait_s / (steady_s + now - t_mark)
                                if t_mark is not None else 0.0), **logs)
                if lead:
                    print(f'step {step} loss {logs["loss"]:.3f} lr '
                          f'{lr:.3g} ({batch_size / dt:.1f} scenes/s)')
                    with open(log_path, 'a') as f:
                        f.write(json.dumps(line) + '\n')
            if args.max_steps and step >= args.max_steps:
                done = True
                break
        if for_epoch:
            float(logs['loss'])             # the epoch's steps are done
        if t_mark is not None:
            steady_s += time.perf_counter() - t_mark
        if lead and ((epoch + 1) % cfg.checkpoint_interval == 0 or done):
            t = time.perf_counter()
            ckpt.save_checkpoint(ckpt_dir, trainer, step=step)
            summary['ckpt_save_ms'].append((time.perf_counter() - t) * 1e3)
            summary['ckpt_bytes'] = os.path.getsize(
                os.path.join(ckpt_dir, f'step_{step}.pt'))
            print(f'saved checkpoint @ step {step}')
        if (not args.no_eval
                and (epoch + 1) % cfg.get('eval_interval', 5) == 0):
            run_eval(args, cfg, trainer, cfg.data.samples_per_gpu, work_dir)
    steady = step - start - 1
    summary.update(
        start_step=start, steps=step - start, end_step=step,
        steady_steps=steady, steady_s=steady_s,
        scenes_per_s=steady * batch_size / steady_s if steady > 0
        else math.nan,
        loader_wait_share=wait_s / steady_s if steady > 0 else math.nan,
        log=log_path)
    print(f'training complete: {summary["steps"]} steps from step {start}; '
          f'{summary["scenes_per_s"]:.2f} scenes/s after the first step '
          f'(loader wait {100 * summary["loader_wait_share"]:.1f} % of it)')
    return summary


def run_eval(args, cfg, trainer, batch_size, work_dir):
    """Periodic KITTI eval (the reference's EvalHook,
    apis/train.py:287-308): each rank runs its shard of the scenes in
    batches of ``batch_size`` through ``<work_dir>/eval_parts``, and rank 0
    scores the merged detections."""
    import pickle

    from ..eval.kitti_eval import kitti_eval
    from ..eval.submission import detections_to_kitti_annos

    info_path = os.path.join(
        cfg.data_root, args.eval_info or cfg.data.train_info)
    with open(info_path, 'rb') as f:
        infos = pickle.load(f)
    model = trainer.model.eval()
    bundle = apis.DetectorBundle(model, model.cfg,
                                 next(model.parameters()).device)
    with torch.no_grad():
        dets = run_sharded_inference(bundle, cfg, infos, batch_size,
                                     os.path.join(work_dir, 'eval_parts'))
    model.train()
    if dets is None:
        return
    det_annos = detections_to_kitti_annos(
        dets, infos, class_names=('Pedestrian', 'Cyclist', 'Car'))
    gt_annos = [info['annos'] for info in infos]
    result, _ = kitti_eval(gt_annos, det_annos,
                           ['Pedestrian', 'Cyclist', 'Car'])
    print(result)


if __name__ == '__main__':
    main()
