"""Training state and the GGA weak train step (port of
``gga_tpu/train/loop.py``): forward in train mode, GGA targets, loss,
backward through every sparse conv, global-norm clip and AdamW.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.dense_heads import centerpoint_head_gga as gga
from ..models.detectors.centerpoint_gga import GGADetector
from .optim import GGAOptimizer


@dataclasses.dataclass
class TrainState:
    model: GGADetector
    optimizer: GGAOptimizer
    step: int
    # draws the per-step SRL prior samples (gga_tpu folds its key with the
    # step; the two streams differ, the distribution is the same)
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
