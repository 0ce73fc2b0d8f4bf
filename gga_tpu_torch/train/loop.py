"""Training state and the train steps: the GGA weak step (port of
``gga_tpu/train/loop.py``: forward in train mode, GGA targets, loss,
backward through every sparse conv, global-norm clip and AdamW) and the
stage-4 PGD step (``tools/train_pgd.py:128-149``: FCOS-mono targets, the
PGD loss, backward, clip and SGD) and the indoor FCAF3D step
(``tools/train_fcaf3d.py:126-139``: forward in train mode, targets and
loss, backward through every sparse conv, clip and AdamW).
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.dense_heads import centerpoint_head_gga as gga
from ..models.dense_heads import fcaf3d_head
from ..models.dense_heads import pgd_head
from ..models.detectors.centerpoint_gga import GGADetector
from .optim import GGAOptimizer


@dataclasses.dataclass
class TrainState:
    model: GGADetector          # or PGDDetector, FCAF3DDetector
    optimizer: GGAOptimizer     # or PGDOptimizer
    step: int
    # draws the per-step SRL prior samples (gga_tpu folds its key with the
    # step; the two streams differ, the distribution is the same); the
    # PGD and FCAF3D steps draw nothing
    generator: torch.Generator


def gga_train_step(state: TrainState, batch, head_cfg, mark=None,
                   srl_normal=None):
    """One optimization step; updates ``state`` in place.

    Args:
        batch: dict of tensors on the model's device: points [B, P, 4],
            points_valid [B, P], labels [B, M], obj_valid [B, M],
            init_pseudo [B, M, 7], boxes_img [B, M, 4], bdry_masks
            [B, M, 4], lidar2img [B, M, 4, 4], ibp_xy [B, M, Pc, 2],
            ibp_valid [B, M, Pc].
        mark: called with the name of each stage as it is enqueued
            ('forward', 'loss', 'backward', 'optimizer'); a timer hook.
        srl_normal: the [T, B] standard-normal draw of the SRL prior;
            drawn from ``state.generator`` when None.
    Returns:
        logs: 0-d tensors: 'loss', each task's terms, 'grad_norm' (of the
        unclipped gradients) and the encoder's 'diag.occupancy_*'.
    """
    mark = mark or (lambda _: None)
    model = state.model
    model.train()
    state.optimizer.zero_grad()
    diag = {}
    preds = model(batch['points'], batch['points_valid'], diag)
    mark('forward')
    if srl_normal is None:
        srl_normal = torch.randn(
            (len(head_cfg.task_num_classes), batch['labels'].shape[0]),
            generator=state.generator)
    srl_normal = srl_normal.to(batch['labels'].device)
    targets = gga.build_targets(
        head_cfg, srl_normal, batch['labels'], batch['obj_valid'],
        batch['init_pseudo'], batch['boxes_img'], batch['bdry_masks'],
        batch['lidar2img'])
    total, logs = gga.loss(head_cfg, preds, targets, batch['ibp_xy'],
                           batch['ibp_valid'])
    mark('loss')
    total.backward()
    mark('backward')
    logs['grad_norm'] = state.optimizer.step()
    mark('optimizer')
    for name, value in diag.items():
        logs[f'diag.{name}'] = value
    state.step += 1
    return {k: v.detach() for k, v in logs.items()}


def pgd_train_step(state: TrainState, batch):
    """One PGD optimization step; updates ``state`` in place.

    Args:
        batch: dict of tensors on the model's device: images [B, 3, H, W]
            (normalized), cam2img [B, 4, 4], gt_bboxes [B, M, 4],
            gt_labels [B, M], gt_cam3d [B, M, 7], centers2d [B, M, 2],
            depths [B, M], obj_valid [B, M].
    Returns:
        logs: 0-d tensors: the loss terms, 'loss', 'num_pos' and
        'grad_norm' (of the unclipped gradients).
    """
    model = state.model
    model.train()
    cfg = model.cfg.head
    state.optimizer.zero_grad()
    images = batch['images']
    fsz = [(images.shape[2] // s, images.shape[3] // s) for s in cfg.strides]
    targets = pgd_head.build_targets(
        cfg, *pgd_head.flat_points(cfg, fsz, images.device),
        batch['gt_bboxes'], batch['gt_labels'], batch['gt_cam3d'],
        batch['centers2d'], batch['depths'], batch['obj_valid'])
    preds, fuse = model(images)
    total, logs = pgd_head.loss(cfg, preds, fuse, targets, batch['cam2img'],
                                fsz)
    total.backward()
    logs['grad_norm'] = state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in logs.items()}


def fcaf3d_train_step(state: TrainState, batch, diag=None):
    """One FCAF3D optimization step; updates ``state`` in place.

    Args:
        batch: dict of tensors on the model's device: points [B, P, 3],
            colors [B, P, 3], points_valid [B, P], gt_boxes [B, M, 7],
            gt_labels [B, M], obj_valid [B, M].
        diag: a dict for the forward's active-site counts, or None.
    Returns:
        logs: 0-d tensors: the three loss terms, 'loss', 'num_pos' and
        'grad_norm' (of the unclipped gradients).
    """
    model = state.model
    model.train()
    state.optimizer.zero_grad()
    outs = model(batch['points'], batch['colors'], batch['points_valid'],
                 diag)
    total, logs = fcaf3d_head.loss(model.cfg.head, outs, batch['gt_boxes'],
                                   batch['gt_labels'], batch['obj_valid'])
    total.backward()
    logs['grad_norm'] = state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in logs.items()}
