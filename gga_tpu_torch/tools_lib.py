"""Shared helpers for the command-line tools: config -> detector on a
device, checkpoint restore, batched inference over scene infos (the
port's copy of ``gga_tpu/tools_lib.py``; the single_gpu_test equivalent,
mmdet3d/apis/test.py:12), the stage-4 PGD evaluation
(``tools/accuracy_bench_stage4.py:146-196 evaluate_pgd``), and the train
loop of the stage-4 and indoor retrain tools (``train_passes``)."""
from __future__ import annotations

import json
import math
import os
import pickle
import time

import numpy as np
import torch

from . import apis
from .data import pipelines as pl
from .data.dataset import EpochLoader
from .eval.kitti_eval import kitti_eval
from .eval.submission import mono_detections_to_kitti_annos
from .models.builder import build_detector
from .models.detectors.centerpoint_gga import GGAModelConfig
from .train import checkpoints as ckpt


def model_config_from_cfg(cfg) -> GGAModelConfig:
    return build_detector(cfg)[1]


def build_model_from_cfg(cfg, checkpoint_dir=None, device='cuda'):
    """File-level Config (+ the newest checkpoint of ``checkpoint_dir``)
    -> ``apis.DetectorBundle`` on ``device``, in eval mode. Raises
    FileNotFoundError if the dir holds no checkpoint, and as
    ``apis.init_detector`` for the device and the model's dtype."""
    model_cfg = model_config_from_cfg(cfg)
    state_dict = (ckpt.load_variables(checkpoint_dir) if checkpoint_dir
                  else None)
    return apis.init_detector(model_cfg, state_dict, device,
                              seed=cfg.get('seed', 0))


def padded_batch(cfg, infos, batch_size, max_points=None):
    """The scenes of ``infos`` (at most ``batch_size``) as one batch padded
    to ``batch_size`` scenes of ``max_points`` (default
    ``cfg.data.max_points``) points: (points [B, P, 4] f32, valid [B, P])."""
    max_points = max_points or cfg.data.max_points
    pts_b = np.zeros((batch_size, max_points, 4), np.float32)
    val_b = np.zeros((batch_size, max_points), bool)
    for j, info in enumerate(infos):
        s = pl.load_sample(info, cfg.data_root,
                           pts_prefix=cfg.data.pts_prefix)
        s = pl.points_range_filter(s, cfg.point_cloud_range)
        p = s['points'][:max_points]
        pts_b[j, :len(p)] = p[:, :4]
        val_b[j, :len(p)] = True
    return pts_b, val_b


def run_inference(bundle, cfg, infos, batch_size, max_points=None):
    """Batched inference over scenes -> per-scene detection dicts
    (boxes_3d [n, 7] lidar bottom-center, scores_3d, labels_3d; numpy).

    Each batch is padded to ``batch_size`` scenes of ``cfg.data.max_points``
    points, goes through ``apis.infer`` and comes back to the host in one
    copy."""
    detections = []
    n = len(infos)
    for i in range(0, n, batch_size):
        chunk = infos[i:i + batch_size]
        pts_b, val_b = padded_batch(cfg, chunk, batch_size, max_points)
        out = apis.infer(bundle, pts_b, val_b)
        packed = torch.cat([out['boxes'], out['scores'][..., None],
                            out['labels'][..., None].float(),
                            out['valid'][..., None].float()], -1).cpu()
        packed = packed.numpy()
        for j in range(len(chunk)):
            v = packed[j, :, 9] > 0
            detections.append(dict(
                boxes_3d=packed[j, v, :7], scores_3d=packed[j, v, 7],
                labels_3d=packed[j, v, 8].astype(np.int32)))
        if (i // batch_size) % 20 == 0:
            print(f'  inference {i + len(chunk)}/{n}')
    return detections


def load_infos(cfg, name):
    """The info list of the pkl ``name`` under ``cfg.data_root``."""
    with open(os.path.join(cfg.data_root, name), 'rb') as f:
        return pickle.load(f)


# evaluate_mono's metrics: name -> kitti_eval key
MONO_AP_KEYS = dict(
    AP11_3D_mod='KITTI/Car_3D_AP11_moderate_strict',
    AP11_BEV_mod='KITTI/Car_BEV_AP11_moderate_strict',
    AP11_3D_mod_loose='KITTI/Car_3D_AP11_moderate_loose',
    AP11_BEV_mod_loose='KITTI/Car_BEV_AP11_moderate_loose',
    AP11_2D_mod='KITTI/Car_2D_AP11_moderate_strict')


def evaluate_mono(bundle, dataset, batch_size=4):
    """PGD inference over every scene of a ``KittiMonoDataset`` -> KITTI
    Car AP against the annos of its infos: ``apis.infer_mono`` on batches
    of ``batch_size`` images, ``mono_detections_to_kitti_annos``, then
    ``kitti_eval`` over bbox, BEV and 3D. Returns the five metrics of
    ``MONO_AP_KEYS`` (0.0 where kitti_eval gives none), and ``images``,
    ``detections`` and ``infer_s`` (wall seconds of the inference calls,
    the copy of their results to the host included)."""
    detections, infer_s = [], 0.0
    n = len(dataset)
    for i in range(0, n, batch_size):
        batch = pl.collate([dataset[j]
                            for j in range(i, min(i + batch_size, n))])
        t0 = time.perf_counter()
        out = apis.infer_mono(bundle, batch['image'], batch['cam2img'])
        out = {k: v.cpu().numpy() for k, v in out.items()}
        infer_s += time.perf_counter() - t0
        for j in range(len(batch['image'])):
            v = out['valid'][j]
            detections.append(dict(
                boxes_cam=out['boxes'][j][v], scores=out['scores'][j][v],
                labels=out['labels'][j][v], bboxes2d=out['bboxes2d'][j][v]))
    infos = dataset.infos
    det_annos = mono_detections_to_kitti_annos(detections, infos,
                                               class_names=dataset.CLASSES)
    _, m = kitti_eval([info['annos'] for info in infos], det_annos, ['Car'],
                      eval_types=('bbox', 'bev', '3d'))
    res = {name: m.get(key, 0.0) for name, key in MONO_AP_KEYS.items()}
    res.update(images=n, infer_s=infer_s,
               detections=sum(len(d['scores']) for d in detections))
    return res


def train_passes(trainer, dataset, step_fn, *, batch_size, passes,
                 total_steps, work_dir, resume=False, loader_workers=0,
                 log_interval=20, unit='scenes'):
    """The retrain tools' loop: ``step_fn(trainer, batch)`` over
    ``passes`` passes of ``EpochLoader(dataset, batch_size)`` (pass p in
    ``RandomState(p)`` order, the last partial batch dropped) until
    ``total_steps``; one JSON line per ``log_interval`` steps in
    ``<work_dir>/train_log.jsonl`` (the step, pass as ``epoch``, the lr
    the step ran at, ``<unit>_per_sec``, the share of the wall time spent
    waiting on the loader, and the step's logs); ``step_<n>.pt`` under
    ``<work_dir>/checkpoints`` at the end of every pass. With ``resume``
    it continues from the newest checkpoint (weights, optimizer, step) at
    the batch after it.

    Returns a summary: the steps taken and the step it started at, the
    wall time of the steps after the first, ``<unit>_per_s`` over them
    (loader included), the share of it spent waiting on the loader, and
    the checkpoints' size and save / load ms."""
    ckpt_dir = os.path.join(work_dir, 'checkpoints')
    summary = dict(ckpt_save_ms=[], ckpt_bytes=None, ckpt_load_ms=None,
                   ckpt_dir=ckpt_dir)
    if resume:
        t0 = time.perf_counter()
        _, ok = ckpt.resume_from(ckpt_dir, trainer)
        summary['ckpt_load_ms'] = (time.perf_counter() - t0) * 1e3
        print(f'resume: {"ok, step " + str(trainer.step) if ok else "no checkpoint"}')

    loader = EpochLoader(dataset, batch_size, num_workers=loader_workers)
    per_pass = len(dataset) // batch_size
    log_path = os.path.join(work_dir, 'train_log.jsonl')
    start = step = trainer.step
    first_pass, skip = divmod(start, per_pass)
    # the steps after the first (which holds the warm-up): their wall
    # time, loader included and checkpoints not, and the part of it spent
    # waiting on batches
    wait_s = ckpt_s = 0.0
    t_mark = None
    t_last, n_last = time.perf_counter(), start
    for epoch in range(first_pass, passes):
        if step >= total_steps:
            break
        t_ask = time.perf_counter()
        it = loader.epoch(epoch, skip if epoch == first_pass else 0)
        while step < total_steps:
            batch = next(it, None)
            if t_mark is not None:
                wait_s += time.perf_counter() - t_ask
            if batch is None:
                break
            lr = trainer.optimizer.lr_schedule(trainer.optimizer.count)
            logs = step_fn(trainer, batch)
            step = trainer.step
            if t_mark is None:
                float(logs['loss'])                 # the first step is done
                t_mark = time.perf_counter()
            if step % log_interval == 0:
                logs = {k: float(v) for k, v in logs.items()}
                now = time.perf_counter()
                dt = (now - t_last) / max(step - n_last, 1)
                t_last, n_last = now, step
                line = {'step': step, 'epoch': epoch, 'lr': lr,
                        f'{unit}_per_sec': batch_size / dt,
                        'loader_wait_share': wait_s / max(
                            now - t_mark - ckpt_s, 1e-9), **logs}
                print(f'step {step} loss {logs["loss"]:.3f} lr {lr:.3g} '
                      f'({batch_size / dt:.1f} {unit}/s)')
                with open(log_path, 'a') as f:
                    f.write(json.dumps(line) + '\n')
            t_ask = time.perf_counter()
        float(logs['loss'])                 # the pass's steps are done
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
    summary.update({
        'start_step': start, 'steps': step - start, 'end_step': step,
        'steady_steps': steady, 'steady_s': steady_s,
        f'{unit}_per_s': (steady * batch_size / steady_s if steady > 0
                          else math.nan),
        'loader_wait_share': wait_s / steady_s if steady > 0 else math.nan,
        'log': log_path})
    print(f'training complete: {summary["steps"]} steps from step {start}; '
          f'{summary[unit + "_per_s"]:.2f} {unit}/s after the first step '
          f'(loader wait {100 * summary["loader_wait_share"]:.1f} % of it)')
    return summary
