"""Shared helpers for the command-line tools: config -> detector on a
device, checkpoint restore, batched inference over scene infos (the
port's copy of ``gga_tpu/tools_lib.py``; the single_gpu_test equivalent,
mmdet3d/apis/test.py:12), and the stage-4 PGD evaluation
(``tools/accuracy_bench_stage4.py:146-196 evaluate_pgd``)."""
from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from . import apis
from .data import pipelines as pl
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
