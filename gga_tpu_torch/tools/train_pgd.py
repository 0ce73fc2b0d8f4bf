"""Stage 4: the PGD monocular retrain on the pseudo labels, on one device
(the port's copy of ``tools/train_pgd.py``; the reference's
``dist_train.sh configs/gga/gga_pdg.py``).

Reads a config file (``configs/gga/gga_pdg.py``; flags override it),
trains ``PGDDetector`` on the ``KittiMonoDataset`` of the pseudo-label
pkl with ``apis.pgd_train_step``, appends one JSON line per
``log_interval`` steps (default 20, as gga_tpu) to
``<work-dir>/train_log.jsonl`` (the step, epoch, the lr the step ran at,
images/s, the share of the wall time spent waiting on the loader, and the
step's logs), and saves ``step_<n>.pt`` under ``<work-dir>/checkpoints``
at the end of every epoch, as gga_tpu does.

The schedule counts ``len(dataset) // batch`` steps an epoch (the last
partial batch is dropped); ``--max-steps`` caps the run. Batches come in
gga_tpu's order (``RandomState(epoch)``) through ``data.dataset
.EpochLoader`` (``loader_workers`` of the config, default 0: in the
training process).

Differences from gga_tpu, by design: the optimizer adds the weight decay
to the gradient before SGD (``train.optim.PGDOptimizer``), where
gga_tpu's tool decays after it; ``--resume`` continues from the newest
checkpoint of the work dir (weights, optimizer, step) at the batch after
it, where gga_tpu parses the flag and ignores it; fewer infos than a
batch raise, where gga_tpu trains 0 steps; the seeded initial weights
come from ``torch.Generator(cfg.seed)``; one device, no mesh. Without a
card the tool raises unless ``--device cpu``.

Usage:
    python -m gga_tpu_torch.tools.train_pgd configs/gga/gga_pdg.py \\
        [--info PKL] [--data-root D] [--work-dir W] [--batch-size N] \\
        [--epochs N] [--lr LR] [--max-steps N] [--resume] [--tiny] \\
        [--min-score S] [--device cuda|cpu] [--cfg-options k.ey=val ...]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from pathlib import Path

from .. import apis
from ..data.dataset import EpochLoader
from ..data.kitti.mono_dataset import KittiMonoDataset
from ..device import resolve_device
from ..models.detectors.pgd import PGDModelConfig
from ..train import checkpoints as ckpt
from ..tools_lib import model_config_from_cfg
from .train import load_config

DEFAULT_CONFIG = str(Path(__file__).resolve().parents[2] / 'configs' / 'gga'
                     / 'gga_pdg.py')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('config', nargs='?', default=DEFAULT_CONFIG)
    p.add_argument('--info', default=None,
                   help='override cfg.data.info (pseudo-label pkl)')
    p.add_argument('--data-root', default=None)
    p.add_argument('--work-dir', default=None)
    p.add_argument('--batch-size', type=int, default=None)
    p.add_argument('--epochs', type=int, default=None)
    p.add_argument('--lr', type=float, default=None)
    p.add_argument('--max-steps', type=int, default=None)
    p.add_argument('--resume', action='store_true',
                   help='resume from the newest checkpoint in the work dir')
    p.add_argument('--tiny', action='store_true')
    p.add_argument('--min-score', type=float, default=None,
                   help='filter pseudo labels below this score')
    p.add_argument('--device', default='cuda')
    p.add_argument('--cfg-options', nargs='*', default=[])
    return p.parse_args(argv)


def main(argv=None):
    """Returns a summary: the steps taken and the step it started at, the
    wall time of the steps after the first, images/s over them (loader
    included), the share of it spent waiting on the loader, and the
    checkpoints' size and save / load ms."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.cfg_options)
    work_dir = args.work_dir or cfg.get('work_dir', './work_dirs/kitti_pgd')
    os.makedirs(work_dir, exist_ok=True)
    model_cfg = (PGDModelConfig.tiny() if args.tiny
                 else model_config_from_cfg(cfg))

    info = args.info or cfg.data.info
    data_root = args.data_root or cfg.data.get('data_root', 'data/kitti')
    min_score = (args.min_score if args.min_score is not None
                 else cfg.data.get('min_score'))
    dataset = KittiMonoDataset(data_root, info, min_score=min_score)
    batch_size = args.batch_size or cfg.data.samples_per_gpu
    if len(dataset) < batch_size:
        raise ValueError(f'{info} holds {len(dataset)} infos, fewer than one '
                         f'batch of {batch_size}: an epoch would train no '
                         'step (the last partial batch is dropped)')
    epochs = args.epochs or cfg.get('max_epochs', 48)
    steps_per_epoch = len(dataset) // batch_size
    total_steps = steps_per_epoch * epochs
    if args.max_steps:
        total_steps = min(total_steps, args.max_steps)
    print(f'device={dev} batch={batch_size} steps/epoch={steps_per_epoch} '
          f'total={total_steps}')

    opt = dict(cfg.get('optimizer', {}))
    if args.lr:
        opt['lr'] = args.lr
    trainer = apis.init_pgd_trainer(model_cfg, steps_per_epoch, device=dev,
                                    seed=cfg.get('seed', 0), optimizer=opt)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f'params: {n_params / 1e6:.2f}M')

    ckpt_dir = os.path.join(work_dir, 'checkpoints')
    summary = dict(ckpt_save_ms=[], ckpt_bytes=None, ckpt_load_ms=None,
                   ckpt_dir=ckpt_dir)
    if args.resume:
        t0 = time.perf_counter()
        _, ok = ckpt.resume_from(ckpt_dir, trainer)
        summary['ckpt_load_ms'] = (time.perf_counter() - t0) * 1e3
        print(f'resume: {"ok, step " + str(trainer.step) if ok else "no checkpoint"}')

    loader = EpochLoader(dataset, batch_size,
                         num_workers=cfg.get('loader_workers', 0))
    log_path = os.path.join(work_dir, 'train_log.jsonl')
    log_interval = cfg.get('log_interval', 20)
    start = step = trainer.step
    first_epoch, skip = divmod(start, steps_per_epoch)
    # the steps after the first (which holds the warm-up): their wall
    # time, loader included and checkpoints not, and the part of it spent
    # waiting on batches
    wait_s = ckpt_s = 0.0
    t_mark = None
    t_last, n_last = time.perf_counter(), start
    for epoch in range(first_epoch, epochs):
        if step >= total_steps:
            break
        t_ask = time.perf_counter()
        it = loader.epoch(epoch, skip if epoch == first_epoch else 0)
        while step < total_steps:
            batch = next(it, None)
            if t_mark is not None:
                wait_s += time.perf_counter() - t_ask
            if batch is None:
                break
            lr = trainer.optimizer.lr_schedule(trainer.optimizer.count)
            logs = apis.pgd_train_step(trainer, batch)
            step = trainer.step
            if t_mark is None:
                float(logs['loss'])                 # the first step is done
                t_mark = time.perf_counter()
            if step % log_interval == 0:
                logs = {k: float(v) for k, v in logs.items()}
                now = time.perf_counter()
                dt = (now - t_last) / max(step - n_last, 1)
                t_last, n_last = now, step
                line = dict(step=step, epoch=epoch, lr=lr,
                            images_per_sec=batch_size / dt,
                            loader_wait_share=wait_s / max(
                                now - t_mark - ckpt_s, 1e-9),
                            **logs)
                print(f'step {step} loss {logs["loss"]:.3f} lr {lr:.3g} '
                      f'({batch_size / dt:.1f} images/s)')
                with open(log_path, 'a') as f:
                    f.write(json.dumps(line) + '\n')
            t_ask = time.perf_counter()
        float(logs['loss'])                 # the epoch's steps are done
        t = time.perf_counter()
        ckpt.save_checkpoint(ckpt_dir, trainer, step=step)
        ckpt_s += time.perf_counter() - t
        summary['ckpt_save_ms'].append((time.perf_counter() - t) * 1e3)
        summary['ckpt_bytes'] = os.path.getsize(
            os.path.join(ckpt_dir, f'step_{step}.pt'))
        print(f'saved checkpoint @ step {step}')
    steady_s = (0.0 if t_mark is None
                else time.perf_counter() - t_mark - ckpt_s)
    steady = step - start - 1
    summary.update(
        start_step=start, steps=step - start, end_step=step,
        steady_steps=steady, steady_s=steady_s,
        images_per_s=steady * batch_size / steady_s if steady > 0
        else math.nan,
        loader_wait_share=wait_s / steady_s if steady > 0 else math.nan,
        log=log_path)
    print(f'training complete: {summary["steps"]} steps from step {start}; '
          f'{summary["images_per_s"]:.2f} images/s after the first step '
          f'(loader wait {100 * summary["loader_wait_share"]:.1f} % of it)')
    return summary


if __name__ == '__main__':
    main()
