"""Fully supervised anchor-head training of the KITTI voxel detectors on
one device (the port's copy of ``tools/train_supervised.py``).

Builds the detector of the config (``SECONDDetector`` in f32 or, for the
_fp16_ configs, bf16; ``PointPillars``; ``DynamicVoxelNet``;
``DVSECONDDetector``; ``SASSD``; ``PartA2Detector``), streams
``KittiDetDataset`` batches of ``data.samples_per_gpu`` scenes (pass e in
``RandomState(e)`` order with the dataset's epoch set to e, the last
partial batch dropped) and takes ``apis.anchor_train_step``s: a
train-mode forward, anchors at the map's size, max-IoU assignment, the
anchor loss (for SASSD plus its auxiliary point losses), backward, a
global-norm clip and AdamW with the cyclic lr and beta1 over
``max_epochs`` epochs, or ``--max-steps``; for PartA2 the same optimizer
on ``apis.parta2_train_step``s (the two-stage forward, with the RoI
sampler's draws and the dropout masks from the trainer's generator, and
``parta2_loss``: RPN + semantic + RCNN). As gga_tpu's,
it reads only ``lr``, ``weight_decay``, ``grad_clip`` and ``betas`` of
the config's optimizer: a config that names another schedule
(``lr_policy='cosine'`` of the dv_second 2x8 config) trains on the cyclic
one, at ``data.samples_per_gpu``. At step 1 and every ``log_interval``
steps it appends a JSON line to ``<work-dir>/train_log.jsonl`` (gga_tpu's
keys: the step's logs, the step, the epoch and scenes/s since the start;
and the lr the step ran at, the gradients' norm and SASSD's auxiliary
losses), and at the end of each epoch it saves ``step_<n>.pt`` under ``<work-dir>/checkpoints``, where gga_tpu
writes its orbax checkpoint.

Differences from gga_tpu, by design: ``--device`` (without a card the
tool raises unless ``--device cpu``); ``torch.save`` checkpoints; fewer
infos than a batch raise, where gga_tpu's loop would never take a step;
the seeded initial weights come from ``torch.Generator(cfg.seed)``; one
device, no mesh: a ``torchrun`` launch of more than one process is
refused, since the anchor and PartA2 steps do not reduce their loss
normalisers over ranks; SASSD trains, where gga_tpu's CLI cannot (it inits
without the auxiliary branch and reads the train-mode tuple as a dict);
PartA2 trains, where gga_tpu's CLI cannot (it inits with
``train=False``, gives no RoI sampler rng, and reads ``preds['cls']``
of a forward that returns ``{'rpn', 'sem', 'samples', 'rcnn', ...}``).
As in gga_tpu there is no ``--resume``.

Usage:
    python -m gga_tpu_torch.tools.train_supervised \\
        configs/second/hv_second_secfpn_6x8_80e_kitti-3d-3class.py \\
        [--work-dir DIR] [--max-steps N] [--device cuda|cpu] \\
        [--cfg-options k=v ...]
"""
from __future__ import annotations

import argparse
import json
import os
import time

from .. import apis
from ..data.kitti_det import KittiDetDataset
from ..device import resolve_device
from ..models.detectors.parta2 import PartA2Config
from ..tools_lib import model_config_from_cfg
from ..train import checkpoints as ckpt
from .train import load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('config')
    p.add_argument('--work-dir', default=None)
    p.add_argument('--max-steps', type=int, default=None)
    p.add_argument('--cfg-options', nargs='*', default=[])
    p.add_argument('--device', default='cuda')
    return p.parse_args(argv)


def main(argv=None):
    """Returns a summary: the steps, the schedule's total, the steps of an
    epoch, the wall time of the steps after the first and scenes/s over
    them (loading included, checkpoints not), the checkpoints' size and
    save ms, and the paths of the log and the checkpoint dir."""
    args = parse_args(argv)
    if int(os.environ.get('WORLD_SIZE', '1')) > 1:
        raise NotImplementedError('train_supervised trains in one process: '
                                  'launch it without torchrun')
    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.cfg_options)
    work_dir = (args.work_dir or cfg.get('work_dir')
                or './work_dirs/supervised')
    os.makedirs(work_dir, exist_ok=True)
    model_cfg = model_config_from_cfg(cfg)

    d = cfg.data
    ds = KittiDetDataset(
        cfg.data_root, os.path.join(cfg.data_root, d.train_info),
        pc_range=cfg.point_cloud_range, pts_prefix=d.pts_prefix,
        max_points=d.max_points, max_objs=d.get('max_objs', 64),
        seed=cfg.seed)
    batch_size = d.samples_per_gpu
    if len(ds) < batch_size:
        raise ValueError(f'{d.train_info} holds {len(ds)} infos, fewer than '
                         f'one batch of {batch_size}: an epoch would train '
                         'no step (the last partial batch is dropped)')
    steps_per_epoch = max(len(ds) // batch_size, 1)
    total = args.max_steps or steps_per_epoch * cfg.max_epochs
    print(f'device={dev} batch={batch_size} total_steps={total}')

    o = cfg.optimizer
    init, train_step = ((apis.init_parta2_trainer, apis.parta2_train_step)
                        if isinstance(model_cfg, PartA2Config)
                        else (apis.init_anchor_trainer,
                              apis.anchor_train_step))
    trainer = init(
        model_cfg, total, device=dev, seed=cfg.seed,
        optimizer=dict(lr=o.lr, weight_decay=o.weight_decay,
                       grad_clip=o.grad_clip,
                       betas=tuple(o.get('betas', (0.95, 0.99)))))
    log_path = os.path.join(work_dir, 'train_log.jsonl')
    ckpt_dir = os.path.join(work_dir, 'checkpoints')
    log_interval = cfg.get('log_interval', 50)
    summary = dict(ckpt_save_ms=[], ckpt_bytes=None, ckpt_dir=ckpt_dir,
                   log=log_path, steps_per_epoch=steps_per_epoch,
                   total_steps=total)
    step = epoch = 0
    ckpt_s = 0.0
    t0 = time.time()
    t_first = None
    while step < total:
        ds.epoch = epoch
        for batch in ds.epoch_batches(batch_size, seed=epoch):
            lr = trainer.optimizer.lr_schedule(trainer.optimizer.count)
            logs = train_step(trainer, batch)
            step += 1
            if t_first is None:
                float(logs['loss'])                 # the first step is done
                t_first = time.perf_counter()
            if step % log_interval == 0 or step == 1:
                rec = {k: float(v) for k, v in logs.items()}
                rec.update(step=step, epoch=epoch, lr=lr,
                           scenes_per_sec=batch_size * step
                           / max(time.time() - t0, 1e-6))
                print(f'step {step}: loss={rec["loss"]:.3f}')
                with open(log_path, 'a') as f:
                    f.write(json.dumps(rec) + '\n')
            if step >= total:
                break
        epoch += 1
        float(logs['loss'])                         # the epoch's steps are done
        t = time.perf_counter()
        ckpt.save_checkpoint(ckpt_dir, trainer, step=step)
        ckpt_s += time.perf_counter() - t
        summary['ckpt_save_ms'].append((time.perf_counter() - t) * 1e3)
        summary['ckpt_bytes'] = os.path.getsize(
            os.path.join(ckpt_dir, f'step_{step}.pt'))
    steady_s = time.perf_counter() - t_first - ckpt_s
    summary.update(steps=step, epochs=epoch, steady_steps=step - 1,
                   steady_s=steady_s,
                   scenes_per_s=((step - 1) * batch_size / steady_s
                                 if step > 1 else float('nan')))
    print(f'training complete: {step} steps; {summary["scenes_per_s"]:.2f} '
          'scenes/s after the first step')
    return summary


if __name__ == '__main__':
    main()
