"""Training state and the train steps: the GGA weak step (port of
``gga_tpu/train/loop.py``: forward in train mode, GGA targets, loss,
backward through every sparse conv, global-norm clip and AdamW) and the
stage-4 PGD step (``tools/train_pgd.py:128-149``: FCOS-mono targets, the
PGD loss, backward, clip and SGD), the indoor FCAF3D step
(``tools/train_fcaf3d.py:126-139``: forward in train mode, targets and
loss, backward through every sparse conv, clip and AdamW) and the fully
supervised anchor step of SECOND, PointPillars, DynamicVoxelNet, DVSECOND
and SASSD (``tools/train_supervised.py:86-108``: forward in train mode,
anchors at the map's size, max-IoU assignment, the anchor loss, for SASSD
plus its auxiliary point losses, backward, clip and AdamW), and the fully
supervised nuScenes CenterPoint step (gga_tpu's ``centerpoint_loss``
under ``value_and_grad``, then the clip and AdamW of a config's
``optimizer`` block: forward in train mode, targets at the head's map
size, the loss, backward, clip and AdamW), and the two-stage PartA2 step
(gga_tpu's ``parta2_loss`` under ``value_and_grad``, then the clip and
AdamW of the KITTI recipe: voxelize and the UNet, the BEV stack, the RPN,
the semantic head, the proposals, their sampling, RoI-aware pooling and
the RCNN, the loss, backward, clip and AdamW).
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.dense_heads import anchor3d_head as ah
from ..models.dense_heads import centerpoint_head_gga as gga
from ..models.dense_heads import fcaf3d_head
from ..models.dense_heads import pgd_head
from ..models.detectors.centerpoint import centerpoint_loss
from ..models.detectors.centerpoint_gga import GGADetector
from ..models.detectors.parta2 import parta2_draws, parta2_loss
from ..models.detectors.sassd import sassd_aux_loss
from .optim import GGAOptimizer


@dataclasses.dataclass
class TrainState:
    # or PGDDetector, FCAF3DDetector or an anchor detector
    model: GGADetector
    optimizer: GGAOptimizer     # or PGDOptimizer
    step: int
    # draws the per-step SRL prior samples of the GGA step and the RoI
    # sampler's draw and dropout masks of the PartA2 step (gga_tpu folds
    # its key with the step; the streams differ, the distributions are the
    # same); the other steps draw nothing
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


def anchor_loss(model, batch, diag=None, mark=None):
    """The anchor step's loss on a train-mode forward (the body of
    gga_tpu's ``tools/train_supervised.py`` step): anchors at the map's
    size, max-IoU assignment and the anchor loss. A SASSD forward also
    gives its auxiliary tuple, whose two losses are summed into the total
    with weight 1, as mmdet3d's SASSD and its runner sum them (gga_tpu's
    CLI cannot train SASSD; every term is a gga_tpu function).

    Returns (total, logs): 'loss' (the total), 'loss_cls', 'loss_bbox',
    'loss_dir', 'num_pos', and for SASSD 'aux_loss_cls' and
    'aux_loss_reg'."""
    mark = mark or (lambda _: None)
    out = model(batch['points'], batch['points_valid'], diag)
    preds, aux = out if isinstance(out, tuple) else (out, None)
    mark('forward')
    cfg = model.cfg.head
    anchors = ah.make_anchors(cfg, tuple(preds['cls'].shape[1:3]),
                              preds['cls'].device)
    targets = ah.assign_targets(cfg, anchors, batch['gt_boxes'],
                                batch['gt_labels'], batch['gt_valid'])
    total, logs = ah.loss(cfg, preds, anchors, targets)
    if aux is not None:
        logs.update(sassd_aux_loss(aux, batch['gt_boxes'],
                                   batch['gt_valid']))
        total = total + logs['aux_loss_cls'] + logs['aux_loss_reg']
        logs['loss'] = total
    mark('loss')
    return total, logs


def anchor_train_step(state: TrainState, batch, mark=None, diag=None):
    """One anchor-detector optimization step (SECOND, PointPillars,
    DynamicVoxelNet, DVSECOND or SASSD); updates ``state`` in place.

    Args:
        batch: dict of tensors on the model's device: points [B, P, 4],
            points_valid [B, P], gt_boxes [B, M, 7] (bottom-centre lidar),
            gt_labels [B, M], gt_valid [B, M].
        mark: called with the name of each stage as it is enqueued
            ('forward', 'loss', 'backward', 'optimizer'); a timer hook.
        diag: a dict for the encoder's budget occupancy, or None.
    Returns:
        logs: 0-d tensors: ``anchor_loss``'s and 'grad_norm' (of the
        unclipped gradients).
    """
    mark = mark or (lambda _: None)
    model = state.model
    model.train()
    state.optimizer.zero_grad()
    total, logs = anchor_loss(model, batch, diag, mark)
    total.backward()
    mark('backward')
    logs['grad_norm'] = state.optimizer.step()
    mark('optimizer')
    state.step += 1
    return {k: v.detach() for k, v in logs.items()}


def centerpoint_train_step(state: TrainState, batch, mark=None, diag=None):
    """One CenterPoint optimization step; updates ``state`` in place.

    Args:
        batch: dict of tensors on the model's device: points [B, P, 5],
            points_valid [B, P], gt_boxes [B, M, 9] (bottom-centre lidar
            and velocity; 7 without velocity), gt_labels [B, M], gt_valid
            [B, M].
        mark: called with the name of each stage as it is enqueued
            ('encoder': voxelize and the sparse encoder or the pillar
            scatter; 'forward': backbone, neck and head; 'loss': targets
            and loss; 'backward'; 'optimizer': clip and AdamW); a timer
            hook.
        diag: a dict for the encoder's budget occupancy, or None.
    Returns:
        logs: 0-d tensors: each task's 'task<t>.loss_heatmap' and
        'task<t>.loss_bbox', 'loss', 'grad_norm' (of the unclipped
        gradients) and the diagnostics as 'diag.<name>'.
    """
    mark = mark or (lambda _: None)
    model = state.model
    model.train()
    state.optimizer.zero_grad()
    diag = {} if diag is None else diag
    bev = model.extract_bev(batch['points'], batch['points_valid'], diag)
    mark('encoder')
    preds = model.head(bev)
    mark('forward')
    total, logs = centerpoint_loss(model.cfg, preds, batch['gt_boxes'],
                                   batch['gt_labels'], batch['gt_valid'])
    mark('loss')
    total.backward()
    mark('backward')
    logs['grad_norm'] = state.optimizer.step()
    mark('optimizer')
    for name, value in diag.items():
        logs[f'diag.{name}'] = value
    state.step += 1
    return {k: v.detach() for k, v in logs.items()}


def parta2_train_step(state: TrainState, batch, mark=None, diag=None,
                      draws=None):
    """One PartA2 optimization step; updates ``state`` in place.

    Args:
        batch: dict of tensors on the model's device: points [B, P, 4],
            points_valid [B, P], gt_boxes [B, M, 7] (bottom-centre lidar),
            gt_labels [B, M], gt_valid [B, M].
        mark: called with the name of each stage as it is enqueued
            ('encoder': voxelize and the UNet; 'forward': the BEV stack,
            the RPN, the semantic head, the proposals, their sampling, the
            pooling and the RCNN; 'loss'; 'backward'; 'optimizer': clip
            and AdamW); a timer hook.
        diag: a dict for the UNet's budget occupancy, or None.
        draws: the step's random draws (``parta2_draws``' dict); drawn
            from ``state.generator`` when None.
    Returns:
        logs: 0-d tensors: ``parta2_loss``'s, 'grad_norm' (of the
        unclipped gradients) and the diagnostics as 'diag.<name>'.
    """
    mark = mark or (lambda _: None)
    model = state.model
    model.train()
    if draws is None:
        draws = parta2_draws(model, batch['points'].shape[0], state.generator,
                             batch['points'].device)
    state.optimizer.zero_grad()
    diag = {} if diag is None else diag
    enc = model.encode(batch['points'], batch['points_valid'], diag)
    mark('encoder')
    out = model.heads(enc, batch['gt_boxes'], batch['gt_labels'],
                      batch['gt_valid'], draws)
    mark('forward')
    total, logs = parta2_loss(model.cfg, out, batch['gt_boxes'],
                              batch['gt_labels'], batch['gt_valid'])
    mark('loss')
    total.backward()
    mark('backward')
    logs['grad_norm'] = state.optimizer.step()
    mark('optimizer')
    for name, value in diag.items():
        logs[f'diag.{name}'] = value
    state.step += 1
    return {k: v.detach() for k, v in logs.items()}
