"""Shared helpers for the command-line tools: config -> detector on a
device, checkpoint restore, batched inference over scene infos (the
port's copy of ``gga_tpu/tools_lib.py``; the single_gpu_test equivalent,
mmdet3d/apis/test.py:12)."""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from . import apis
from .data import pipelines as pl
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
