"""Stage 4: the PGD monocular retrain on the pseudo labels, data-parallel
over the processes of a ``torchrun`` launch (the port's copy of
``tools/train_pgd.py``; the reference's ``dist_train.sh
configs/gga/gga_pdg.py``).

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
come from ``torch.Generator(cfg.seed)``. Without a card the tool raises
unless ``--device cpu``.

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
    [torchrun --nproc-per-node N] -m gga_tpu_torch.tools.train_pgd \\
        configs/gga/gga_pdg.py \\
        [--info PKL] [--data-root D] [--work-dir W] [--batch-size N] \\
        [--epochs N] [--lr LR] [--max-steps N] [--resume] [--tiny] \\
        [--min-score S] [--device cuda|cpu] [--dist-url URL] \\
        [--cfg-options k.ey=val ...]
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

from .. import apis
from ..data.kitti.mono_dataset import KittiMonoDataset
from ..models.detectors.pgd import PGDModelConfig
from ..parallel import mesh
from ..tools_lib import model_config_from_cfg, train_passes
from .train import add_dist_args, launch, load_config

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
    add_dist_args(p)
    p.add_argument('--cfg-options', nargs='*', default=[])
    return p.parse_args(argv)


def main(argv=None):
    """Returns a summary: the steps taken and the step it started at, the
    wall time of the steps after the first, images/s over them (loader
    included), the share of it spent waiting on the loader, and the
    checkpoints' size and save / load ms."""
    args = parse_args(argv)
    dev, rank, world = launch(args)
    try:
        return _train(args, dev, rank, world)
    finally:
        if world > 1:
            mesh.shutdown()


def _train(args, dev, rank, world):
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
    batch_size = (args.batch_size or cfg.data.samples_per_gpu) * world
    if len(dataset) < batch_size:
        raise ValueError(f'{info} holds {len(dataset)} infos, fewer than one '
                         f'batch of {batch_size}: an epoch would train no '
                         'step (the last partial batch is dropped)')
    epochs = args.epochs or cfg.get('max_epochs', 48)
    steps_per_epoch = len(dataset) // batch_size
    total_steps = steps_per_epoch * epochs
    if args.max_steps:
        total_steps = min(total_steps, args.max_steps)
    print(f'rank {rank}/{world} device={dev} batch={batch_size} '
          f'steps/epoch={steps_per_epoch} total={total_steps}')

    opt = dict(cfg.get('optimizer', {}))
    if args.lr:
        opt['lr'] = args.lr
    trainer = apis.init_pgd_trainer(model_cfg, steps_per_epoch, device=dev,
                                    seed=cfg.get('seed', 0), optimizer=opt)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f'params: {n_params / 1e6:.2f}M')

    return train_passes(trainer, dataset, apis.pgd_train_step,
                        batch_size=batch_size, passes=epochs,
                        total_steps=total_steps, work_dir=work_dir,
                        resume=args.resume,
                        loader_workers=cfg.get('loader_workers', 0),
                        log_interval=cfg.get('log_interval', 20),
                        unit='images', rank=rank, world=world)


if __name__ == '__main__':
    main()
