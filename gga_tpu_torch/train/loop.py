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
plus its auxiliary point losses, backward, clip and AdamW; FreeAnchor's
the same with ``free_anchor_loss`` in place of assignment and loss), and
SSN's (``shape_aware_loss`` over each class's anchors at its task
group's map size, then the clip and AdamW), and the fully
supervised nuScenes CenterPoint step (gga_tpu's ``centerpoint_loss``
under ``value_and_grad``, then the clip and AdamW of a config's
``optimizer`` block: forward in train mode, targets at the head's map
size, the loss, backward, clip and AdamW), and the two-stage PartA2 step
(gga_tpu's ``parta2_loss`` under ``value_and_grad``, then the clip and
AdamW of the KITTI recipe: voxelize and the UNet, the BEV stack, the RPN,
the semantic head, the proposals, their sampling, RoI-aware pooling and
the RCNN, the loss, backward, clip and AdamW), and the indoor VoteNet
step (gga_tpu's ``vote_head.loss`` of ``build_targets`` under
``value_and_grad``, as ``tests/test_models/test_votenet.py`` composes
them, then the clip and AdamW of ``configs/_base_/schedules/
schedule_3x.py``), and the point-based KITTI steps, as
``tests/test_models/test_ssd3d.py`` and ``test_point_rcnn.py`` compose
them: 3DSSD (``ssd3d_loss`` of a train-mode forward, then the clip and
AdamW with the lr stepped down at the config's epochs) and PointRCNN
(``point_rcnn_loss`` of the two-stage train-mode forward with the RoI
sampler's draw, then the clip and the cyclic AdamW), and the
VoteNet-derived indoor steps, as gga_tpu's tests compose them:
GroupFree3D (``groupfree3d_loss`` of a train-mode forward with the
decoder's dropout keep masks), H3DNet (``h3dnet_loss``) and ImVoteNet
(``imvotenet_loss`` of the three towers, with the seed sampling's draw),
each then the clip and AdamW with the lr stepped down at the config's
epochs; and the segmentors' step (EncoderDecoder3D, DGCNN, PAConv):
``segmentation_loss`` of a train-mode forward with the head's dropout
keep mask, plus, for PAConv, ``paconv_regularization_loss`` at weight 1.0
(the PAConv configs' recipe), then the clip and the cyclic AdamW of
``build_optimizer``, as gga_tpu's ``tools/train_supervised.py`` builds it
for every config; and the image-fusion and image-to-voxel steps: MVXNet
(the anchor step's body on the fused points' maps, then the clip and
the cyclic AdamW) and ImVoxelNet (KITTI: the anchor step's body on the
lifted volume's BEV maps; indoor: ``imvoxel_head.loss``; each then the
clip and AdamW with the lr stepped down at the config's epochs).

Under a ``torch.distributed`` group (``parallel.mesh``) the GGA, PGD and
FCAF3D steps train data-parallel: each rank runs its rows of the global
batch, the norms and loss normalisers reduce over the global batch, and
the gradients are summed over the ranks before the clip, so every rank's
clip and optimizer see the one-process gradient and the weights stay in
step. Their logged loss terms are global values. The other steps refuse
a group of more than one rank.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.backbones.paconv import (PAConvSegmentor,
                                      paconv_regularization_loss)
from ..models.dense_heads import anchor3d_head as ah
from ..models.dense_heads import centerpoint_head_gga as gga
from ..models.dense_heads import fcaf3d_head
from ..models.dense_heads import imvoxel_head
from ..models.dense_heads import pgd_head
from ..models.dense_heads import shape_aware_head as sah
from ..models.dense_heads import vote_head
from ..models.dense_heads.free_anchor3d_head import (FreeAnchor3DConfig,
                                                    free_anchor_loss)
from ..models.dense_heads.ssd_3d_head import ssd3d_loss
from ..models.detectors.centerpoint import centerpoint_loss
from ..models.dense_heads.groupfree3d_head import (groupfree3d_draws,
                                                  groupfree3d_loss)
from ..models.detectors.centerpoint_gga import GGADetector
from ..models.detectors.h3dnet import h3dnet_loss
from ..models.detectors.imvotenet import imvotenet_draws, imvotenet_loss
from ..models.detectors.imvoxelnet import ImVoxelNetIndoor
from ..models.detectors.parta2 import parta2_draws, parta2_loss
from ..models.detectors.point_rcnn import point_rcnn_draws, point_rcnn_loss
from ..models.detectors.sassd import sassd_aux_loss
from ..models.segmentors.base import segmentor_draws
from ..models.segmentors.encoder_decoder import segmentation_loss
from ..parallel import mesh
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


def _global_logs(logs, means=()):
    """The logs of a data-parallel step as global values: each rank's
    loss terms are its shares of the global terms (local sums over global
    normalisers) and are summed over the ranks; the keys starting with
    one of ``means`` (per-scene means) are averaged; 'grad_norm' and
    'num_pos' are global already. One all-reduce; the logs as they are in
    one process."""
    if not mesh.distributed():
        return logs
    keys = [k for k in logs if k not in ('grad_norm', 'num_pos')]
    world = mesh.world_size()
    for k, v in zip(keys, mesh.sum_over_ranks([logs[k] for k in keys])):
        logs[k] = v / world if k.startswith(means) else v
    return logs


def _single_process(step):
    if mesh.distributed():
        raise NotImplementedError(
            f'{step} does not train data-parallel: run it in one process')


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
            ('forward', 'loss', 'backward', under a process group
            'all_reduce', then 'optimizer'); a timer hook.
        srl_normal: the [T, B] standard-normal draw of the SRL prior for
            this rank's rows; when None, every rank draws the
            [T, B x world] draw of the global batch from
            ``state.generator`` (the same on every rank) and keeps its own
            columns, as gga_tpu draws once for the global batch.
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
        b, r = batch['labels'].shape[0], mesh.rank()
        srl_normal = torch.randn(
            (len(head_cfg.task_num_classes), b * mesh.world_size()),
            generator=state.generator)[:, r * b:(r + 1) * b]
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
    if mesh.distributed():
        mesh.all_reduce_grads(state.optimizer.params)
        mark('all_reduce')
    logs['grad_norm'] = state.optimizer.step()
    mark('optimizer')
    for name, value in diag.items():
        logs[f'diag.{name}'] = value
    state.step += 1
    return _global_logs({k: v.detach() for k, v in logs.items()},
                        means=('diag.',))


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
    mesh.all_reduce_grads(state.optimizer.params)
    logs['grad_norm'] = state.optimizer.step()
    state.step += 1
    return _global_logs({k: v.detach() for k, v in logs.items()})


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
    mesh.all_reduce_grads(state.optimizer.params)
    logs['grad_norm'] = state.optimizer.step()
    state.step += 1
    return _global_logs({k: v.detach() for k, v in logs.items()})


def anchor_terms(cfg, preds, batch):
    """The anchor head's loss on its maps ``preds``: anchors at the map's
    size, then max-IoU assignment and ``anchor3d_head.loss`` (logs 'loss',
    'loss_cls', 'loss_bbox', 'loss_dir', 'num_pos'), or, for a
    ``FreeAnchor3DConfig``, ``free_anchor_loss`` (logs 'loss',
    'positive_bag_loss', 'negative_bag_loss', 'num_pos'). Returns (total,
    logs)."""
    anchors = ah.make_anchors(cfg, tuple(preds['cls'].shape[1:3]),
                              preds['cls'].device)
    if isinstance(cfg, FreeAnchor3DConfig):
        return free_anchor_loss(cfg, preds, anchors, batch['gt_boxes'],
                                batch['gt_labels'], batch['gt_valid'])
    targets = ah.assign_targets(cfg, anchors, batch['gt_boxes'],
                                batch['gt_labels'], batch['gt_valid'])
    return ah.loss(cfg, preds, anchors, targets)


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
    total, logs = anchor_terms(model.cfg.head, preds, batch)
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
    _single_process('anchor_train_step')
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


def ssn_loss(model, batch, mark=None):
    """SSN's loss on a train-mode forward: each class's anchors at its
    task group's map size, then ``shape_aware_loss``."""
    mark = mark or (lambda _: None)
    outs = model(batch['points'], batch['points_valid'])
    mark('forward')
    cfg = model.cfg.head
    anchors = sah.shape_aware_anchors(cfg, sah.feat_sizes(outs),
                                      outs[0]['cls'].device)
    total, logs = sah.shape_aware_loss(cfg, outs, anchors, batch['gt_boxes'],
                                       batch['gt_labels'], batch['gt_valid'])
    mark('loss')
    return total, logs


def ssn_train_step(state: TrainState, batch, mark=None):
    """One SSN optimization step (forward in train mode, ``ssn_loss``,
    backward, clip and AdamW); updates ``state`` in place. ``batch`` and
    ``mark`` as ``anchor_train_step``'s. Returns the logs of
    ``shape_aware_loss`` and 'grad_norm' as 0-d tensors."""
    _single_process('ssn_train_step')
    mark = mark or (lambda _: None)
    model = state.model
    model.train()
    state.optimizer.zero_grad()
    total, logs = ssn_loss(model, batch, mark)
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
    _single_process('centerpoint_train_step')
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
    _single_process('parta2_train_step')
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


def votenet_loss(model, batch, mark=None):
    """VoteNet's loss on a forward in the module's mode: the targets of
    the forward's seeds and proposals (``vote_head.build_targets``), then
    ``vote_head.loss``. Returns (total, logs)."""
    mark = mark or (lambda _: None)
    preds = model(batch['points'], batch['points_valid'])
    mark('forward')
    cfg = model.cfg.head
    targets = vote_head.build_targets(
        cfg, preds['seed_xyz'], preds['seed_valid'], preds['agg_xyz'],
        preds['agg_valid'], batch['gt_boxes'], batch['gt_labels'],
        batch['obj_valid'])
    total, logs = vote_head.loss(cfg, preds, targets)
    mark('loss')
    return total, logs


def votenet_train_step(state: TrainState, batch, mark=None):
    """One VoteNet optimization step; updates ``state`` in place.

    Args:
        batch: dict of tensors on the model's device: points [B, P, C]
            (xyz and the features), points_valid [B, P], gt_boxes
            [B, M, 7] (bottom-centre depth boxes), gt_labels [B, M],
            obj_valid [B, M].
        mark: called with the name of each stage as it is enqueued
            ('forward', 'loss': targets and loss, 'backward',
            'optimizer': clip and AdamW); a timer hook.
    Returns:
        logs: 0-d tensors: the loss terms, 'loss', 'num_pos' and
        'grad_norm' (of the unclipped gradients).
    """
    _single_process('votenet_train_step')
    mark = mark or (lambda _: None)
    model = state.model
    model.train()
    state.optimizer.zero_grad()
    total, logs = votenet_loss(model, batch, mark)
    total.backward()
    mark('backward')
    logs['grad_norm'] = state.optimizer.step()
    mark('optimizer')
    state.step += 1
    return {k: v.detach() for k, v in logs.items()}


def _point_step(state: TrainState, name, loss_fn, mark):
    """Zero the gradients, ``loss_fn()`` (which marks 'forward' and
    'loss'), backward, clip and the optimizer; updates ``state`` in
    place. Returns the logs, detached, with 'grad_norm'."""
    _single_process(name)
    mark = mark or (lambda _: None)
    state.model.train()
    state.optimizer.zero_grad()
    total, logs = loss_fn(mark)
    total.backward()
    mark('backward')
    logs['grad_norm'] = state.optimizer.step()
    mark('optimizer')
    state.step += 1
    return {k: v.detach() for k, v in logs.items()}


def ssd3d_train_step(state: TrainState, batch, mark=None):
    """One 3DSSD optimization step; updates ``state`` in place.

    Args:
        batch: dict of tensors on the model's device: points [B, P, 4],
            points_valid [B, P], gt_boxes [B, M, 7] (bottom-centre lidar),
            gt_labels [B, M] (the config's classes from 0), gt_valid [B, M].
        mark: called with the name of each stage as it is enqueued
            ('forward', 'loss': targets and loss, 'backward', 'optimizer':
            clip and AdamW); a timer hook.
    Returns:
        logs: 0-d tensors: ``ssd3d_loss``'s and 'grad_norm' (of the
        unclipped gradients).
    """
    model = state.model

    def loss_fn(mark):
        preds = model(batch['points'], batch['points_valid'])
        mark('forward')
        out = ssd3d_loss(model.cfg.head, preds, batch['gt_boxes'],
                         batch['gt_labels'], batch['gt_valid'])
        mark('loss')
        return out

    return _point_step(state, 'ssd3d_train_step', loss_fn, mark)


def point_rcnn_train_step(state: TrainState, batch, mark=None,
                          sample_u=None):
    """One PointRCNN optimization step; updates ``state`` in place.

    Args:
        batch: as ``ssd3d_train_step``'s (the labels of the config's
            classes).
        mark: as ``ssd3d_train_step``'s; 'forward' covers both stages
            (encoder, neck, RPN, proposals, sampling, pooling, RCNN).
        sample_u: the RoI sampler's draw [B, num_proposals]; drawn from
            ``state.generator`` when None (``point_rcnn_draws``).
    Returns:
        logs: 0-d tensors: ``point_rcnn_loss``'s and 'grad_norm'.
    """
    model = state.model
    if sample_u is None:
        sample_u = point_rcnn_draws(model, batch['points'].shape[0],
                                    state.generator, batch['points'].device)

    def loss_fn(mark):
        out = model(batch['points'], batch['points_valid'],
                    batch['gt_boxes'], batch['gt_labels'], batch['gt_valid'],
                    sample_u)
        mark('forward')
        res = point_rcnn_loss(model.cfg, out, batch['gt_boxes'],
                              batch['gt_labels'], batch['gt_valid'])
        mark('loss')
        return res

    return _point_step(state, 'point_rcnn_train_step', loss_fn, mark)


def groupfree3d_train_step(state: TrainState, batch, mark=None, keep=None):
    """One GroupFree3D optimization step; updates ``state`` in place.

    Args:
        batch: dict of tensors on the model's device: points [B, P, C],
            points_valid [B, P], gt_boxes [B, M, 7] (bottom-centre depth
            boxes), gt_labels [B, M], gt_valid [B, M].
        mark: as ``ssd3d_train_step``'s.
        keep: the decoder's dropout keep masks (``groupfree3d_draws``);
            drawn from ``state.generator`` when None.
    Returns:
        logs: 0-d tensors: ``groupfree3d_loss``'s and 'grad_norm'.
    """
    model = state.model
    if keep is None:
        keep = groupfree3d_draws(model.cfg, batch['points'].shape[0],
                                 state.generator, batch['points'].device)

    def loss_fn(mark):
        preds = model(batch['points'], batch['points_valid'], keep=keep)
        mark('forward')
        out = groupfree3d_loss(model.cfg.head, preds, batch['gt_boxes'],
                               batch['gt_labels'], batch['gt_valid'])
        mark('loss')
        return out

    return _point_step(state, 'groupfree3d_train_step', loss_fn, mark)


def h3dnet_train_step(state: TrainState, batch, mark=None):
    """One H3DNet optimization step; updates ``state`` in place. ``batch``
    and ``mark`` as ``groupfree3d_train_step``'s ('forward' covers the
    towers, the RPN, the primitives and the refinement). Returns the logs:
    ``h3dnet_loss``'s and 'grad_norm'."""
    model = state.model

    def loss_fn(mark):
        out = model(batch['points'], batch['points_valid'])
        mark('forward')
        res = h3dnet_loss(model.cfg, out, batch['gt_boxes'],
                          batch['gt_labels'], batch['gt_valid'])
        mark('loss')
        return res

    return _point_step(state, 'h3dnet_train_step', loss_fn, mark)


def imvotenet_train_step(state: TrainState, batch, mark=None, seed_u=None):
    """One ImVoteNet optimization step; updates ``state`` in place.

    Args:
        batch: as ``groupfree3d_train_step``'s, plus img [B, H, W, 3],
            boxes_2d [B, Kb, 6], boxes_valid [B, Kb] and depth2img
            [B, 4, 4].
        mark: as ``groupfree3d_train_step``'s.
        seed_u: the seed sampling's draw [B, S * K]; drawn from
            ``state.generator`` when None (``imvotenet_draws``).
    Returns:
        logs: 0-d tensors: ``imvotenet_loss``'s and 'grad_norm'.
    """
    model = state.model
    if seed_u is None:
        seed_u = imvotenet_draws(model.cfg, batch['points'].shape[0],
                                 state.generator, batch['points'].device)

    def loss_fn(mark):
        towers = model(batch['points'], batch['points_valid'], batch['img'],
                       batch['boxes_2d'], batch['boxes_valid'],
                       batch['depth2img'], seed_u)
        mark('forward')
        res = imvotenet_loss(model.cfg, towers, batch['gt_boxes'],
                             batch['gt_labels'], batch['gt_valid'])
        mark('loss')
        return res

    return _point_step(state, 'imvotenet_train_step', loss_fn, mark)


def segmentor_loss(model, batch, keep=None, class_weights=None,
                   ignore_index=None, mark=None, picks=None):
    """A segmentor's train loss on ``batch`` (points, points_valid,
    seg_labels): ``segmentation_loss`` of the forward's logits (``picks``
    given to the forward), plus ``paconv_regularization_loss`` at weight
    1.0 for PAConv; ``mark`` is called with 'forward' after the forward.
    Returns (total, logs:
    'loss_sem_seg', PAConv's 'loss_regularize', 'loss')."""
    logits = model(batch['points'], batch['points_valid'], keep=keep,
                   picks=picks)
    if mark is not None:
        mark('forward')
    ce = segmentation_loss(logits, batch['seg_labels'],
                           batch['points_valid'], class_weights, ignore_index)
    logs = {'loss_sem_seg': ce}
    total = ce
    if isinstance(model, PAConvSegmentor):
        reg = paconv_regularization_loss(model, model.cfg.num_kernels)
        logs['loss_regularize'] = reg
        total = total + 1.0 * reg
    logs['loss'] = total
    return total, logs


def segmentor_train_step(state: TrainState, batch, class_weights=None,
                         ignore_index=None, mark=None, keep=None,
                         picks=None):
    """One segmentor optimization step; updates ``state`` in place.

    Args:
        batch: dict of tensors on the model's device: points [B, P, C],
            points_valid [B, P], seg_labels [B, P].
        class_weights: [num_classes] or None (the stage-1 ``seg_info``
            label weights); ignore_index: the label left out, or None.
        mark: as ``ssd3d_train_step``'s.
        keep: the head's dropout keep mask (``segmentor_draws``); drawn
            from ``state.generator`` when None.
        picks: the forward's picks (FPS indices, or DGCNN's graphs), made
            by the forward when None.
    Returns:
        logs: 0-d tensors: ``segmentor_loss``'s and 'grad_norm'.
    """
    model = state.model
    if keep is None:
        B, P = batch['points'].shape[:2]
        keep = segmentor_draws(model.cfg, B, P, state.generator,
                               batch['points'].device)

    def loss_fn(mark):
        out = segmentor_loss(model, batch, keep, class_weights, ignore_index,
                             mark, picks)
        mark('loss')
        return out

    return _point_step(state, 'segmentor_train_step', loss_fn, mark)


def mvxnet_loss(model, batch, diag=None, mark=None):
    """MVXNet's loss on a train-mode forward: the anchor step's body
    (``anchor_terms``) on the maps of the points, the images and their
    projections. Returns (total, ``anchor_terms``' logs)."""
    mark = mark or (lambda _: None)
    preds = model(batch['points'], batch['points_valid'], batch['img'],
                  batch['lidar2img'], diag)
    mark('forward')
    out = anchor_terms(model.cfg.head, preds, batch)
    mark('loss')
    return out


def mvxnet_train_step(state: TrainState, batch, mark=None, diag=None):
    """One MVXNet optimization step; updates ``state`` in place.

    Args:
        batch: dict of tensors on the model's device: points [B, P, 4],
            points_valid [B, P], img [B, 3, H, W] (normalized), lidar2img
            [B, 4, 4], gt_boxes [B, M, 7] (bottom-centre lidar),
            gt_labels [B, M], gt_valid [B, M].
        mark: as ``anchor_train_step``'s; diag: a dict for the encoder's
            budget occupancy, or None.
    Returns:
        logs: 0-d tensors: ``mvxnet_loss``'s and 'grad_norm'.
    """
    return _point_step(state, 'mvxnet_train_step',
                       lambda mark: mvxnet_loss(state.model, batch, diag,
                                                mark), mark)


def imvoxelnet_loss(model, batch, mark=None):
    """ImVoxelNet's loss on a train-mode forward of the images and their
    projections: for the KITTI detector the anchor step's body
    (``anchor_terms``; bottom-centre lidar boxes), for the indoor one
    ``imvoxel_head.loss`` on the head's levels and their projection
    validity (gravity-centred depth boxes). Returns (total, logs)."""
    mark = mark or (lambda _: None)
    out = model(batch['img'], batch['lidar2img'])
    mark('forward')
    if isinstance(model, ImVoxelNetIndoor):
        res = imvoxel_head.loss(model.cfg.head, *out, batch['gt_boxes'],
                                batch['gt_labels'], batch['gt_valid'])
    else:
        res = anchor_terms(model.cfg.head, out, batch)
    mark('loss')
    return res


def imvoxelnet_train_step(state: TrainState, batch, mark=None):
    """One ImVoxelNet optimization step (KITTI or indoor); updates
    ``state`` in place.

    Args:
        batch: dict of tensors on the model's device: img [B, 3, H, W]
            (normalized), lidar2img [B, 4, 4], gt_boxes [B, M, 7],
            gt_labels [B, M], gt_valid [B, M].
        mark: as ``anchor_train_step``'s.
    Returns:
        logs: 0-d tensors: ``imvoxelnet_loss``'s and 'grad_norm'.
    """
    return _point_step(state, 'imvoxelnet_train_step',
                       lambda mark: imvoxelnet_loss(state.model, batch,
                                                    mark), mark)
