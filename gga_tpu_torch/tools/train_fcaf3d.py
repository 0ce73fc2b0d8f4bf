"""The indoor GGA retrain: FCAF3D (MinkResNet34 + FCAF3DHead) on SUN
RGB-D pseudo labels or ground truth, data-parallel over the processes of
a ``torchrun`` launch (the port's copy of ``tools/train_fcaf3d.py``; the
reference trains ``configs/fcaf3d/fcaf3d_8x2_sunrgbd-3d-10class.py``).

Reads a config file (``configs/gga/gga_sunrgbd.py``; flags override it),
trains ``FCAF3DDetector`` on the ``SunRgbdDataset`` of the info pkl with
``apis.fcaf3d_train_step``: a global-norm clip of 10, AdamW (lr 1e-3,
weight decay 1e-4), the lr x0.1 at epochs 8 and 11 of 12, an epoch being
``len(dataset) * repeat // batch`` steps (gga_tpu's count, for the
schedule). As in gga_tpu the data pass is the dataset once
(``RandomState(pass)`` order, the last partial batch dropped), run
``epochs * repeat`` times; ``--max-steps`` caps the run. It appends one
JSON line per ``log_interval`` steps (default 20, as gga_tpu) to
``<work-dir>/train_log.jsonl`` (the step, pass, the lr the step ran at,
scenes/s, the share of the wall time spent waiting on the loader, and the
step's logs), and saves ``step_<n>.pt`` under ``<work-dir>/checkpoints``
at the end of every pass, as gga_tpu does.

Differences from gga_tpu, by design: ``--resume`` continues from the
newest checkpoint of the work dir (weights, optimizer, step) at the batch
after it, which gga_tpu's tool cannot do; the augmentation draws after a
resume start afresh from the dataset's seed; fewer infos than a batch
raise, where gga_tpu trains 0 steps; the seeded initial weights come from
``torch.Generator(cfg.seed)`` (gga_tpu's initializers, another stream).
Like gga_tpu, the tool reads one item before training (gga_tpu
initializes its variables on it), so the augmentation stream is
gga_tpu's. Without a card the tool raises unless ``--device cpu``.

Under ``torchrun`` the tool trains data-parallel, one process per card
(``nccl`` on cards, ``gloo`` with ``--device cpu``; ``--dist-url``, by
default ``env://``): rank r runs on
``cuda:LOCAL_RANK``, the global batch is ``--batch-size x world``
(``--batch-size`` is per process, as ``samples_per_gpu``) and rank r takes
its rows of each; the batch norms and loss normalisers span the global
batch and the gradients are summed over the ranks (``parallel.mesh``), so
the step is the one-process step on the global batch. Rank 0 alone logs
and writes the checkpoints, in the one-process format; ``--resume`` reads
them under any world size.

Usage:
    [torchrun --nproc-per-node N] -m gga_tpu_torch.tools.train_fcaf3d \\
        configs/gga/gga_sunrgbd.py \\
        [--info PKL] [--data-root D] [--work-dir W] [--batch-size N] \\
        [--epochs N] [--repeat N] [--lr LR] [--num-points N] \\
        [--max-steps N] [--resume] [--tiny] [--device cuda|cpu] \\
        [--dist-url URL] \\
        [--cfg-options k.ey=val ...]
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

from .. import apis
from ..data.sunrgbd import SunRgbdDataset
from ..models.detectors.fcaf3d import FCAF3DModelConfig
from ..parallel import mesh
from ..tools_lib import model_config_from_cfg, train_passes
from .train import add_dist_args, launch, load_config

DEFAULT_CONFIG = str(Path(__file__).resolve().parents[2] / 'configs' / 'gga'
                     / 'gga_sunrgbd.py')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('config', nargs='?', default=DEFAULT_CONFIG)
    p.add_argument('--info', default=None, help='override cfg.data.info')
    p.add_argument('--data-root', default=None)
    p.add_argument('--work-dir', default=None)
    p.add_argument('--batch-size', type=int, default=None)
    p.add_argument('--epochs', type=int, default=None)
    p.add_argument('--repeat', type=int, default=None,
                   help='RepeatDataset times (ref: 3)')
    p.add_argument('--lr', type=float, default=None)
    p.add_argument('--num-points', type=int, default=None)
    p.add_argument('--max-steps', type=int, default=None)
    p.add_argument('--resume', action='store_true',
                   help='resume from the newest checkpoint in the work dir')
    p.add_argument('--tiny', action='store_true')
    p.add_argument('--device', default='cuda')
    add_dist_args(p)
    p.add_argument('--cfg-options', nargs='*', default=[])
    return p.parse_args(argv)


def main(argv=None):
    """Returns a summary: the steps taken and the step it started at, the
    wall time of the steps after the first, scenes/s over them (loader
    included), the share of it spent waiting on the loader, the
    checkpoints' size and save / load ms, and the schedule's
    ``steps_per_epoch``."""
    args = parse_args(argv)
    dev, rank, world = launch(args)
    try:
        return _train(args, dev, rank, world)
    finally:
        if world > 1:
            mesh.shutdown()


def _train(args, dev, rank, world):
    cfg = load_config(args.config, args.cfg_options)
    work_dir = args.work_dir or cfg.get('work_dir',
                                        './work_dirs/sunrgbd_fcaf3d')
    os.makedirs(work_dir, exist_ok=True)
    model_cfg = (FCAF3DModelConfig.tiny() if args.tiny
                 else model_config_from_cfg(cfg))

    info = args.info or cfg.data.info
    data_root = args.data_root or cfg.data.get('data_root', 'data/sunrgbd')
    num_points = args.num_points or cfg.data.get('num_points', 20000)
    dataset = SunRgbdDataset(data_root, info, num_points=num_points,
                             max_objs=model_cfg.head.max_objs)
    batch_size = (args.batch_size or cfg.data.get('samples_per_gpu', 2)
                  ) * world
    if len(dataset) < batch_size:
        raise ValueError(f'{info} holds {len(dataset)} infos, fewer than one '
                         f'batch of {batch_size}: a pass would train no step '
                         '(the last partial batch is dropped)')
    epochs = args.epochs or cfg.get('max_epochs', 12)
    repeat = args.repeat or cfg.data.get('repeat', 3)
    steps_per_epoch = max(len(dataset) * repeat // batch_size, 1)
    per_pass = len(dataset) // batch_size
    total_steps = epochs * repeat * per_pass
    if args.max_steps:
        total_steps = min(total_steps, args.max_steps)
    print(f'rank {rank}/{world} device={dev} batch={batch_size} '
          f'steps/epoch={steps_per_epoch} total={total_steps}')

    opt = dict(cfg.get('optimizer', {}))
    if args.lr:
        opt['lr'] = args.lr
    trainer = apis.init_fcaf3d_trainer(model_cfg, steps_per_epoch,
                                       device=dev, seed=cfg.get('seed', 0),
                                       optimizer=opt)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f'params: {n_params / 1e6:.2f}M')
    dataset[0]      # gga_tpu's variable init reads it: the same draws follow

    summary = train_passes(trainer, dataset, apis.fcaf3d_train_step,
                           batch_size=batch_size, passes=epochs * repeat,
                           total_steps=total_steps, work_dir=work_dir,
                           resume=args.resume,
                           loader_workers=cfg.get('loader_workers', 0),
                           log_interval=cfg.get('log_interval', 20),
                           rank=rank, world=world)
    summary['steps_per_epoch'] = steps_per_epoch
    return summary


if __name__ == '__main__':
    main()
