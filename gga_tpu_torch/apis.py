"""Entry points (port of ``gga_tpu/apis.py`` and the train step of
``gga_tpu/train``): build the GGA detector (from a config object, or from
a config file and a checkpoint dir) and run stage-3 pseudo-label
inference on a batch of clouds or a list of scene infos, or build a
trainer and take GGA weak train steps; for stage 4, build the PGD
monocular detector or its trainer, take PGD train steps and run its
inference on a batch of images; for the indoor retrain, the same for
the FCAF3D detector on batches of coloured point clouds; and for the
fully supervised KITTI path, the same for the anchor detectors: SECOND,
PointPillars, DynamicVoxelNet, DVSECOND and SASSD; and for the fully
supervised nuScenes path, the same for CenterPoint (voxel and pillar,
with or without the DCN head, rotated or circle NMS); and for the
two-stage KITTI detector, the same for PartA2."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .device import resolve_device
from .models.detectors.centerpoint import (CenterPointConfig,
                                           CenterPointDetector,
                                           decode_centerpoint)
from .models.detectors.centerpoint_gga import (GGADetector, GGAModelConfig,
                                               decode_detections)
from .models.dense_heads import anchor3d_head, fcaf3d_head, pgd_head
from .models.detectors.dynamic_voxelnet import (DVSECONDConfig,
                                                DVSECONDDetector,
                                                DynamicVoxelNet,
                                                DynamicVoxelNetConfig)
from .models.detectors.fcaf3d import FCAF3DDetector, FCAF3DModelConfig
from .models.detectors.parta2 import (PartA2Config, PartA2Detector,
                                      decode_parta2)
from .models.detectors.pgd import PGDDetector, PGDModelConfig
from .models.detectors.sassd import SASSD, SASSDConfig
from .models.detectors.voxelnet import (PointPillars, PointPillarsConfig,
                                        SECONDDetector, SECONDNetConfig)
from .models.layers import init_params
from .train import loop
from .train.loop import TrainState, gga_train_step
from .train.optim import (build_fcaf3d_optimizer, build_optimizer,
                          build_pgd_optimizer)


@dataclasses.dataclass
class DetectorBundle:
    model: GGADetector
    cfg: GGAModelConfig
    device: torch.device


def check_compute_dtype(cfg: GGAModelConfig, device):
    """Raise unless ``cfg`` can run on ``device``: on CUDA the sparse-conv
    kernels take f32 or bf16 features, and a model of any other dtype
    never falls back to the plain version."""
    if (torch.device(device).type == 'cuda'
            and cfg.compute_dtype not in ('float32', 'bfloat16')):
        raise ValueError(
            f'compute_dtype {cfg.compute_dtype!r} on CUDA: the sparse-conv '
            'kernels take float32 or bfloat16')


def init_detector(cfg: GGAModelConfig, state_dict=None, device='cuda',
                  seed=0) -> DetectorBundle:
    """The detector in eval mode on ``device``.

    With a ``state_dict`` (mmdet3d keys, e.g. from
    ``convert.from_jax_variables``) the weights are loaded strictly;
    without one they are drawn from ``torch.Generator().manual_seed(seed)``.
    Raises if ``device`` is CUDA and no card is present, or if ``cfg``
    cannot run there (``check_compute_dtype``)."""
    dev = resolve_device(device)
    check_compute_dtype(cfg, dev)
    model = GGADetector(cfg)
    if state_dict is None:
        gen = torch.Generator().manual_seed(seed)
        init_params(model, gen)
        with torch.no_grad():
            for t, head in enumerate(model.pts_bbox_head.task_heads):
                head.heatmap[-1].bias.fill_(head.init_bias)
                if cfg.task_dim_priors is not None:
                    dims = cfg.task_dim_priors[t]
                    head.dim[-1].bias.copy_(torch.tensor(
                        [math.log(d) for d in dims]))
                    head.height[-1].bias.fill_(cfg.prior_ground_z
                                               + dims[2] / 2.0)
    else:
        model.load_state_dict(state_dict)
    return DetectorBundle(model.to(dev).eval(), cfg, dev)


@torch.no_grad()
def infer(bundle: DetectorBundle, points, points_valid):
    """Stage-3 inference on a batch: forward + decode + rotated NMS.

    Args:
        points: [B, P, 4] f32 (tensor or numpy); points_valid: [B, P] bool.
    Returns:
        dict(boxes [B, n, 7] bottom-center, scores [B, n], labels [B, n],
        valid [B, n], logits [B, n]) on the bundle's device, n = tasks *
        max_per_task. The heatmap logits rank as the scores do where the
        sigmoid saturates at 1.0 (-inf in the empty slots).
    """
    pts = torch.as_tensor(points, dtype=torch.float32, device=bundle.device)
    val = torch.as_tensor(points_valid, dtype=torch.bool,
                          device=bundle.device)
    dets = decode_detections(bundle.cfg, bundle.model(pts, val))
    return {k: dets[k] for k in ('boxes', 'scores', 'labels', 'valid',
                                 'logits')}


def init_model(config, checkpoint=None, device='cuda'):
    """Config path (or ``Config``) + checkpoint dir -> (DetectorBundle,
    Config) (apis/inference.init_model:38). Without a checkpoint the
    weights are seeded random."""
    from . import tools_lib
    from .config import Config
    if isinstance(config, str):
        config = Config.fromfile(config)
    return tools_lib.build_model_from_cfg(config, checkpoint, device), config


def single_device_test(model_bundle, infos, batch_size=8):
    """Batched inference over a list of scene infos with the output of
    ``init_model`` (apis/test.single_gpu_test:12 equivalent)."""
    from . import tools_lib
    bundle, cfg = model_bundle
    return tools_lib.run_inference(bundle, cfg, infos, batch_size)


def inference_detector(bundle: DetectorBundle, points):
    """One point cloud [P, 4] (numpy) -> dict(boxes_3d [n, 7],
    scores_3d [n], labels_3d [n]) of the kept detections, as numpy."""
    pts = np.asarray(points, np.float32)[None, :, :4]
    out = infer(bundle, pts, np.ones(pts.shape[:2], bool))
    v = out['valid'][0]
    return dict(boxes_3d=out['boxes'][0][v].cpu().numpy(),
                scores_3d=out['scores'][0][v].cpu().numpy(),
                labels_3d=out['labels'][0][v].cpu().numpy())


def aug_inference_detector(bundle: DetectorBundle, points,
                           scales=(0.95, 1.0, 1.05), flip=True, nms_thr=0.2,
                           max_num=512):
    """Test-time-augmented inference on one point cloud (gga_tpu
    ``apis.aug_inference_detector``): the scene, padded to
    ``cfg.data.max_points`` points, goes through one forward + decode per
    (scale x flip) variant, and the variants' detections are mapped back
    and merged by a per-class rotated-BEV NMS.

    ``bundle`` is ``init_model``'s (DetectorBundle, Config). Returns
    dict(boxes_3d [n, 7], scores_3d [n], labels_3d [n]) as numpy."""
    from .core.merge_augs import (augment_points, merge_aug_detections,
                                  tta_transforms)
    det, cfg = bundle
    transforms = tta_transforms(scales=scales, flip=flip)
    max_points = cfg.data.max_points
    pts = np.zeros((1, max_points, 4), np.float32)
    val = np.zeros((1, max_points), bool)
    n = min(len(points), max_points)
    pts[0, :n] = np.asarray(points, np.float32)[:n, :4]
    val[0, :n] = True
    pts_t = torch.from_numpy(pts).to(det.device)
    aug_dets = []
    for t in transforms:
        out = infer(det, augment_points(pts_t, t), val)
        aug_dets.append({k: v[0] for k, v in out.items()})
    with torch.no_grad():
        merged = merge_aug_detections(aug_dets, transforms,
                                      len(det.cfg.tasks), nms_thr=nms_thr,
                                      max_num=max_num)
    v = merged['valid']
    return dict(boxes_3d=merged['boxes'][v].cpu().numpy(),
                scores_3d=merged['scores'][v].cpu().numpy(),
                labels_3d=merged['labels'][v].cpu().numpy())


def init_trainer(cfg: GGAModelConfig, total_steps, state_dict=None,
                 device='cuda', seed=0, optimizer=None) -> TrainState:
    """The detector in train mode on ``device`` with the GGA optimizer
    (``build_optimizer(params, total_steps, **optimizer)``, a config
    file's ``optimizer`` block; ``cyclic=False`` there keeps the lr and
    beta1 flat) and a generator for the per-step SRL draws, seeded with
    ``seed``. Weights as ``init_detector``."""
    model = init_detector(cfg, state_dict, device, seed).model.train()
    return TrainState(model=model,
                      optimizer=build_optimizer(model.parameters(),
                                                total_steps,
                                                **(optimizer or {})),
                      step=0, generator=torch.Generator().manual_seed(seed))


_BATCH_DTYPES = dict(points=torch.float32, points_valid=torch.bool,
                     labels=torch.int32, obj_valid=torch.bool,
                     init_pseudo=torch.float32, boxes_img=torch.float32,
                     bdry_masks=torch.bool, lidar2img=torch.float32,
                     ibp_xy=torch.float32, ibp_valid=torch.bool)


def train_step(trainer: TrainState, batch, mark=None):
    """One GGA weak train step on a batch (the dict of
    ``train.loop.gga_train_step``, as tensors or numpy arrays).

    ``mark`` is the step's stage hook (see ``gga_train_step``). Returns
    the step's logs as 0-d tensors on the trainer's device."""
    dev = next(trainer.model.parameters()).device
    b = {k: torch.as_tensor(batch[k], dtype=dt, device=dev)
         for k, dt in _BATCH_DTYPES.items()}
    return gga_train_step(trainer, b, trainer.model.cfg.head, mark)


def init_pgd_detector(cfg: PGDModelConfig, state_dict=None, device='cuda',
                      seed=0) -> DetectorBundle:
    """The PGD detector in eval mode on ``device`` (f32, as gga_tpu's).

    With a ``state_dict`` (mmdet3d keys, e.g. from
    ``convert.from_jax_variables``) the weights are loaded strictly;
    without one the conv weights are drawn from
    ``torch.Generator().manual_seed(seed)``, uniform in +-1/sqrt(fan_in)
    as gga_tpu's ``conv_init``, with the class logits' prior bias. Raises
    if ``device`` is CUDA and no card is present."""
    dev = resolve_device(device)
    model = PGDDetector(cfg)
    if state_dict is None:
        init_params(model, torch.Generator().manual_seed(seed), gain=1.0)
        model.bbox_head.init_biases()
    else:
        model.load_state_dict(state_dict)
    return DetectorBundle(model.to(dev).eval(), cfg, dev)


def init_pgd_trainer(cfg: PGDModelConfig, steps_per_epoch, state_dict=None,
                     device='cuda', seed=0, optimizer=None) -> TrainState:
    """The PGD detector in train mode on ``device`` with the stage-4
    optimizer (``build_pgd_optimizer(params, steps_per_epoch,
    **optimizer)``, a config file's ``optimizer`` block). Weights as
    ``init_pgd_detector``."""
    model = init_pgd_detector(cfg, state_dict, device, seed).model.train()
    return TrainState(model=model,
                      optimizer=build_pgd_optimizer(model.parameters(),
                                                    steps_per_epoch,
                                                    **(optimizer or {})),
                      step=0, generator=torch.Generator().manual_seed(seed))


_MONO_DTYPES = dict(cam2img=torch.float32, gt_bboxes=torch.float32,
                    gt_labels=torch.int32, gt_cam3d=torch.float32,
                    centers2d=torch.float32, depths=torch.float32,
                    obj_valid=torch.bool)


def _images(images, device):
    """[B, H, W, 3] normalized images (``KittiMonoDataset``'s layout) ->
    [B, 3, H, W] f32 on ``device``."""
    t = torch.as_tensor(images, dtype=torch.float32, device=device)
    return t.permute(0, 3, 1, 2).contiguous()


def pgd_train_step(trainer: TrainState, batch):
    """One PGD train step on a batch of ``KittiMonoDataset`` items
    (``image`` [B, H, W, 3] and the padded objects, as tensors or numpy).
    Returns the step's logs as 0-d tensors on the trainer's device."""
    dev = next(trainer.model.parameters()).device
    b = {k: torch.as_tensor(batch[k], dtype=dt, device=dev)
         for k, dt in _MONO_DTYPES.items()}
    b['images'] = _images(batch['image'], dev)
    return loop.pgd_train_step(trainer, b)


@torch.no_grad()
def infer_mono(bundle: DetectorBundle, images, cam2img):
    """PGD inference on a batch: forward in eval mode + decode + NMS.

    Args:
        images: [B, H, W, 3] normalized (tensor or numpy); cam2img:
            [B, 4, 4].
    Returns:
        ``pgd_head.decode``'s dict (camera boxes, scores, labels, valid,
        bboxes2d) on the bundle's device.
    """
    model = bundle.model.eval()
    x = _images(images, bundle.device)
    c2i = torch.as_tensor(cam2img, dtype=torch.float32, device=bundle.device)
    cfg = model.cfg.head
    preds, fuse = model(x)
    fsz = [(x.shape[2] // s, x.shape[3] // s) for s in cfg.strides]
    return pgd_head.decode(cfg, preds, fuse, c2i, fsz)


def init_fcaf3d_detector(cfg: FCAF3DModelConfig, state_dict=None,
                         device='cuda', seed=0) -> DetectorBundle:
    """The FCAF3D detector in eval mode on ``device`` (f32, as gga_tpu's).

    With a ``state_dict`` (e.g. from ``convert.from_jax_variables``) the
    weights are loaded strictly; without one they are drawn from
    ``torch.Generator().manual_seed(seed)`` with gga_tpu's initializers
    (``FCAF3DDetector.init_weights``). Raises if ``device`` is CUDA and no
    card is present."""
    dev = resolve_device(device)
    model = FCAF3DDetector(cfg)
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    return DetectorBundle(model.to(dev).eval(), cfg, dev)


def init_fcaf3d_trainer(cfg: FCAF3DModelConfig, steps_per_epoch,
                        state_dict=None, device='cuda', seed=0,
                        optimizer=None) -> TrainState:
    """The FCAF3D detector in train mode on ``device`` with its optimizer
    (``build_fcaf3d_optimizer(params, steps_per_epoch, **optimizer)``, a
    config file's ``optimizer`` block). Weights as
    ``init_fcaf3d_detector``."""
    model = init_fcaf3d_detector(cfg, state_dict, device,
                                 seed).model.train()
    return TrainState(model=model,
                      optimizer=build_fcaf3d_optimizer(model.parameters(),
                                                       steps_per_epoch,
                                                       **(optimizer or {})),
                      step=0, generator=torch.Generator().manual_seed(seed))


_INDOOR_DTYPES = dict(points=torch.float32, colors=torch.float32,
                      points_valid=torch.bool, gt_boxes=torch.float32,
                      gt_labels=torch.int64, obj_valid=torch.bool)


def fcaf3d_train_step(trainer: TrainState, batch, diag=None):
    """One FCAF3D train step on a batch of ``SunRgbdDataset`` items (as
    tensors or numpy). ``diag``: a dict for the forward's active-site
    counts. Returns the step's logs as 0-d tensors on the trainer's
    device."""
    dev = next(trainer.model.parameters()).device
    b = {k: torch.as_tensor(batch[k], dtype=dt, device=dev)
         for k, dt in _INDOOR_DTYPES.items()}
    return loop.fcaf3d_train_step(trainer, b, diag)


@torch.no_grad()
def infer_indoor(bundle: DetectorBundle, points, colors, points_valid):
    """FCAF3D inference on a batch: forward in eval mode + decode + NMS.

    Args:
        points [B, P, 3], colors [B, P, 3] f32, points_valid [B, P] bool
        (tensors or numpy).
    Returns:
        ``fcaf3d_head.decode``'s dict (boxes [B, K, 7] gravity-centered
        depth boxes, scores, labels, valid) on the bundle's device.
    """
    model = bundle.model.eval()
    dev = bundle.device
    outs = model(torch.as_tensor(points, dtype=torch.float32, device=dev),
                 torch.as_tensor(colors, dtype=torch.float32, device=dev),
                 torch.as_tensor(points_valid, dtype=torch.bool, device=dev))
    return fcaf3d_head.decode(model.cfg.head, outs)


# the anchor detectors by the exact type of their config
_ANCHOR_DETECTORS = {SECONDNetConfig: SECONDDetector,
                     PointPillarsConfig: PointPillars,
                     DynamicVoxelNetConfig: DynamicVoxelNet,
                     DVSECONDConfig: DVSECONDDetector,
                     SASSDConfig: SASSD}


def init_anchor_detector(cfg, state_dict=None, device='cuda',
                         seed=0) -> DetectorBundle:
    """An anchor detector in eval mode on ``device``: SECOND
    (``SECONDNetConfig``), PointPillars (``PointPillarsConfig``),
    DynamicVoxelNet (``DynamicVoxelNetConfig``), DVSECOND
    (``DVSECONDConfig``) or SASSD (``SASSDConfig``).

    With a ``state_dict`` (e.g. from ``convert.from_jax_variables``) the
    weights are loaded strictly; without one they are drawn from
    ``torch.Generator().manual_seed(seed)`` (``init_weights``). Raises if
    ``device`` is CUDA and no card is present, or if ``cfg`` cannot run
    there (``check_compute_dtype``)."""
    dev = resolve_device(device)
    check_compute_dtype(cfg, dev)
    model = _ANCHOR_DETECTORS[type(cfg)](cfg)
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    return DetectorBundle(model.to(dev).eval(), cfg, dev)


def init_anchor_trainer(cfg, total_steps, state_dict=None, device='cuda',
                        seed=0, optimizer=None) -> TrainState:
    """An anchor detector (``init_anchor_detector``'s) in train mode on
    ``device`` with the KITTI recipe's optimizer (``build_optimizer(
    params, total_steps, **optimizer)``: clip, AdamW, the cyclic lr and
    beta1; gga_tpu's ``tools/train_supervised.py:76-79`` passes lr,
    weight_decay, grad_clip and betas). Weights as
    ``init_anchor_detector``."""
    model = init_anchor_detector(cfg, state_dict, device, seed).model.train()
    return TrainState(model=model,
                      optimizer=build_optimizer(model.parameters(),
                                                total_steps,
                                                **(optimizer or {})),
                      step=0, generator=torch.Generator().manual_seed(seed))


_DET_DTYPES = dict(points=torch.float32, points_valid=torch.bool,
                   gt_boxes=torch.float32, gt_labels=torch.int64,
                   gt_valid=torch.bool)


def anchor_train_step(trainer: TrainState, batch, mark=None, diag=None):
    """One supervised train step on a batch of ``KittiDetDataset``
    samples (as tensors or numpy). ``mark`` is the step's stage hook and
    ``diag`` a dict for the encoder's occupancy (``loop.anchor_train_step``).
    Returns the step's logs as 0-d tensors on the trainer's device (for
    SASSD with its two auxiliary losses, which the total includes)."""
    dev = next(trainer.model.parameters()).device
    b = {k: torch.as_tensor(batch[k], dtype=dt, device=dev)
         for k, dt in _DET_DTYPES.items()}
    return loop.anchor_train_step(trainer, b, mark, diag)


@torch.no_grad()
def infer_anchor(bundle: DetectorBundle, points, points_valid):
    """Anchor-detector inference on a batch: forward in eval mode (SASSD
    without its auxiliary branch), anchors at the map's size, decode +
    rotated NMS a class.

    Args:
        points: [B, P, 4] f32 (tensor or numpy); points_valid: [B, P] bool.
    Returns:
        ``anchor3d_head.decode``'s dict (boxes [B, C*max_num, 7]
        bottom-centre lidar, scores, labels, valid) on the bundle's device.
    """
    model = bundle.model.eval()
    preds = model(torch.as_tensor(points, dtype=torch.float32,
                                  device=bundle.device),
                  torch.as_tensor(points_valid, dtype=torch.bool,
                                  device=bundle.device))
    cfg = bundle.cfg.head
    anchors = anchor3d_head.make_anchors(cfg, tuple(preds['cls'].shape[1:3]),
                                         preds['cls'].device)
    return anchor3d_head.decode(cfg, preds, anchors)


def init_centerpoint_detector(cfg: CenterPointConfig, state_dict=None,
                              device='cuda', seed=0) -> DetectorBundle:
    """The CenterPoint detector in eval mode on ``device`` (f32, as
    gga_tpu's, whose config has no compute dtype).

    With a ``state_dict`` (mmdet3d keys, e.g. from
    ``convert.from_jax_variables``) the weights are loaded strictly;
    without one they are drawn from ``torch.Generator().manual_seed(seed)``
    (``CenterPointDetector.init_weights``). Raises if ``device`` is CUDA
    and no card is present."""
    dev = resolve_device(device)
    model = CenterPointDetector(cfg)
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    return DetectorBundle(model.to(dev).eval(), cfg, dev)


def init_centerpoint_trainer(cfg: CenterPointConfig, total_steps,
                             state_dict=None, device='cuda', seed=0,
                             optimizer=None) -> TrainState:
    """The CenterPoint detector (``init_centerpoint_detector``'s) in train
    mode on ``device`` with the nuScenes recipe's optimizer
    (``build_optimizer(params, total_steps, **optimizer)``: the
    global-norm clip, AdamW and the cyclic lr and beta1 of
    configs/_base_/schedules/cyclic_20e.py's ``optimizer`` block)."""
    model = init_centerpoint_detector(cfg, state_dict, device,
                                      seed).model.train()
    return TrainState(model=model,
                      optimizer=build_optimizer(model.parameters(),
                                                total_steps,
                                                **(optimizer or {})),
                      step=0, generator=torch.Generator().manual_seed(seed))


def centerpoint_train_step(trainer: TrainState, batch, mark=None,
                           diag=None):
    """One CenterPoint train step on a batch of ``NuScenesDataset``
    samples (as tensors or numpy). ``mark`` is the step's stage hook and
    ``diag`` a dict for the budgets' occupancy
    (``loop.centerpoint_train_step``). Returns the step's logs as 0-d
    tensors on the trainer's device."""
    dev = next(trainer.model.parameters()).device
    b = {k: torch.as_tensor(batch[k], dtype=dt, device=dev)
         for k, dt in _DET_DTYPES.items()}
    return loop.centerpoint_train_step(trainer, b, mark, diag)


@torch.no_grad()
def infer_centerpoint(bundle: DetectorBundle, points, points_valid):
    """CenterPoint inference on a batch: forward in eval mode, then
    ``decode_centerpoint`` (top-k decode and rotated or circle NMS a
    task).

    Args:
        points: [B, P, 5] f32 (tensor or numpy); points_valid: [B, P] bool.
    Returns:
        dict(boxes [B, n, 9] bottom-centre lidar with velocity (7 without),
        scores, labels, valid, logits, each [B, n]) on the bundle's
        device, n = tasks * min(post_max_size, max_per_task).
    """
    model = bundle.model.eval()
    preds = model(torch.as_tensor(points, dtype=torch.float32,
                                  device=bundle.device),
                  torch.as_tensor(points_valid, dtype=torch.bool,
                                  device=bundle.device))
    return decode_centerpoint(bundle.cfg, preds)


def init_parta2_detector(cfg: PartA2Config, state_dict=None, device='cuda',
                         seed=0) -> DetectorBundle:
    """The PartA2 detector in eval mode on ``device`` (f32, as gga_tpu's,
    whose config has no compute dtype).

    With a ``state_dict`` (e.g. from ``convert.from_jax_variables``) the
    weights are loaded strictly; without one they are drawn from
    ``torch.Generator().manual_seed(seed)``
    (``PartA2Detector.init_weights``). Raises if ``device`` is CUDA and no
    card is present."""
    dev = resolve_device(device)
    model = PartA2Detector(cfg)
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    return DetectorBundle(model.to(dev).eval(), cfg, dev)


def init_parta2_trainer(cfg: PartA2Config, total_steps, state_dict=None,
                        device='cuda', seed=0, optimizer=None) -> TrainState:
    """The PartA2 detector (``init_parta2_detector``'s) in train mode on
    ``device`` with the KITTI recipe's optimizer (``build_optimizer(
    params, total_steps, **optimizer)``: the global-norm clip, AdamW and
    the cyclic lr and beta1 of configs/_base_/schedules/cyclic_40e.py's
    ``optimizer`` block) and a generator, seeded with ``seed``, for the
    RoI sampler's draws and the dropout masks."""
    model = init_parta2_detector(cfg, state_dict, device, seed).model.train()
    return TrainState(model=model,
                      optimizer=build_optimizer(model.parameters(),
                                                total_steps,
                                                **(optimizer or {})),
                      step=0, generator=torch.Generator().manual_seed(seed))


def parta2_train_step(trainer: TrainState, batch, mark=None, diag=None):
    """One PartA2 train step on a batch of ``KittiDetDataset`` samples (as
    tensors or numpy). ``mark`` is the step's stage hook and ``diag`` a
    dict for the UNet's budget occupancy (``loop.parta2_train_step``).
    Returns the step's logs as 0-d tensors on the trainer's device."""
    dev = next(trainer.model.parameters()).device
    b = {k: torch.as_tensor(batch[k], dtype=dt, device=dev)
         for k, dt in _DET_DTYPES.items()}
    return loop.parta2_train_step(trainer, b, mark, diag)


@torch.no_grad()
def infer_parta2(bundle: DetectorBundle, points, points_valid):
    """PartA2 inference on a batch: forward in eval mode (the test
    proposals, their pooling and the RCNN), then ``decode_parta2`` (the
    refined boxes and a class-agnostic rotated NMS).

    Args:
        points: [B, P, 4] f32 (tensor or numpy); points_valid: [B, P] bool.
    Returns:
        dict(boxes [B, R, 7] bottom-centre lidar, scores, labels, valid)
        on the bundle's device, R = ``test_proposals``.
    """
    model = bundle.model.eval()
    out = model(torch.as_tensor(points, dtype=torch.float32,
                                device=bundle.device),
                torch.as_tensor(points_valid, dtype=torch.bool,
                                device=bundle.device))
    return decode_parta2(bundle.cfg, out)
