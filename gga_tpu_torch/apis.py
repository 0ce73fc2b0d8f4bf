"""Entry points (port of ``gga_tpu/apis.py`` and the train step of
``gga_tpu/train``): build the GGA detector (from a config object, or from
a config file and a checkpoint dir) and run stage-3 pseudo-label
inference on a batch of clouds or a list of scene infos, or build a
trainer and take GGA weak train steps; for stage 4, build the PGD
monocular detector or its trainer, take PGD train steps and run its
inference on a batch of images; for the indoor retrain, the same for
the FCAF3D detector on batches of coloured point clouds; and for the
fully supervised KITTI path, the same for the anchor detectors: SECOND,
PointPillars, DynamicVoxelNet, DVSECOND and SASSD, and on nuScenes and
Lyft PointPillars with its RegNet backbones and FPN neck (its bf16
configs refused) and FreeAnchor (the anchor entry points, FreeAnchor's
loss by its head config); and for SSN, the same (``init_ssn_detector``,
..., ``infer_ssn``); and for the fully
supervised nuScenes path, the same for CenterPoint (voxel and pillar,
with or without the DCN head, rotated or circle NMS); and for the
two-stage KITTI detector, the same for PartA2; and for the indoor
point-based detector, the same for VoteNet; and for the point-based KITTI
detectors, the same for 3DSSD and PointRCNN; and for the VoteNet-derived
indoor detectors, the same for GroupFree3D, H3DNet and ImVoteNet (whose
inference takes the images, the 2D boxes and the projection too); and for
the point-cloud segmentors (the PointNet++ EncoderDecoder3D, DGCNN and
PAConv), the same, with per-point labels for a batch
(``infer_segmentor``) or one whole cloud (``inference_segmentor``); and
for the image-fusion detector MVXNet (points, images and their
projections), the same, with ``inference_multi_modality_detector`` for
one sample; and for ImVoxelNet (KITTI and indoor; images and their
projections alone), the same."""
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
from .models.dense_heads import (anchor3d_head, fcaf3d_head, imvoxel_head,
                                 pgd_head)
from .models.dense_heads import shape_aware_head, vote_head
from .models.dense_heads.groupfree3d_head import decode_groupfree3d
from .models.dense_heads.ssd_3d_head import decode_ssd3d
from .models.detectors.dynamic_voxelnet import (DVSECONDConfig,
                                                DVSECONDDetector,
                                                DynamicVoxelNet,
                                                DynamicVoxelNetConfig)
from .models.detectors.fcaf3d import FCAF3DDetector, FCAF3DModelConfig
from .models.detectors.groupfree3d import (GroupFree3DNet,
                                           GroupFree3DNetConfig)
from .models.detectors.h3dnet import H3DNet, H3DNetConfig, decode_h3dnet
from .models.detectors.imvotenet import (ImVoteNet, ImVoteNetConfig,
                                         decode_imvotenet, imvotenet_draws)
from .models.detectors.imvoxelnet import (ImVoxelNet, ImVoxelNetConfig,
                                          ImVoxelNetIndoor,
                                          ImVoxelNetIndoorConfig)
from .models.detectors.mvxnet import MVXNet, MVXNetConfig
from .models.detectors.parta2 import (PartA2Config, PartA2Detector,
                                      decode_parta2)
from .models.detectors.pgd import PGDDetector, PGDModelConfig
from .models.detectors.point_rcnn import (PointRCNNConfig, PointRCNNDetector,
                                          decode_point_rcnn)
from .models.detectors.sassd import SASSD, SASSDConfig
from .models.detectors.ssd3d import SSD3DNet, SSD3DNetConfig
from .models.detectors.ssn import SSNConfig, SSNDetector
from .models.detectors.votenet import VoteNet, VoteNetConfig
from .models.detectors.voxelnet import (FreeAnchorPointPillarsConfig,
                                        PointPillars, PointPillarsConfig,
                                        SECONDDetector, SECONDNetConfig,
                                        refuse_pillars_bf16)
from .models.backbones.dgcnn import DGCNNConfig, DGCNNSegmentor
from .models.backbones.paconv import PAConvConfig, PAConvSegmentor
from .models.layers import init_params
from .models.segmentors.encoder_decoder import (EncoderDecoder3D,
                                                EncoderDecoder3DConfig)
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
                     FreeAnchorPointPillarsConfig: PointPillars,
                     DynamicVoxelNetConfig: DynamicVoxelNet,
                     DVSECONDConfig: DVSECONDDetector,
                     SASSDConfig: SASSD}


def init_anchor_detector(cfg, state_dict=None, device='cuda',
                         seed=0) -> DetectorBundle:
    """An anchor detector in eval mode on ``device``: SECOND
    (``SECONDNetConfig``), PointPillars (``PointPillarsConfig``; or
    ``FreeAnchorPointPillarsConfig``, the same network),
    DynamicVoxelNet (``DynamicVoxelNetConfig``), DVSECOND
    (``DVSECONDConfig``) or SASSD (``SASSDConfig``).

    With a ``state_dict`` (e.g. from ``convert.from_jax_variables``) the
    weights are loaded strictly; without one they are drawn from
    ``torch.Generator().manual_seed(seed)`` (``init_weights``). Raises if
    ``device`` is CUDA and no card is present, if ``cfg`` cannot run
    there (``check_compute_dtype``), or for a bf16 PointPillars config
    (``voxelnet.refuse_pillars_bf16``)."""
    dev = resolve_device(device)
    check_compute_dtype(cfg, dev)
    if type(cfg) in (PointPillarsConfig, FreeAnchorPointPillarsConfig):
        refuse_pillars_bf16(cfg)
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


def _anchor_batch(trainer, batch):
    """A detection batch as tensors on the trainer's device, its boxes'
    7 coded values (nuScenes' velocity columns are not regressed by the
    anchor heads)."""
    dev = next(trainer.model.parameters()).device
    b = {k: torch.as_tensor(batch[k], dtype=dt, device=dev)
         for k, dt in _DET_DTYPES.items()}
    b['gt_boxes'] = b['gt_boxes'][..., :7]
    return b


def anchor_train_step(trainer: TrainState, batch, mark=None, diag=None):
    """One supervised train step on a batch of ``KittiDetDataset``,
    ``NuScenesDataset`` or ``LyftDataset`` samples (as tensors or numpy).
    ``mark`` is the step's stage hook and ``diag`` a dict for the
    encoder's occupancy (``loop.anchor_train_step``). Returns the step's
    logs as 0-d tensors on the trainer's device (for SASSD with its two
    auxiliary losses, which the total includes; for FreeAnchor its
    positive and negative bag losses)."""
    return loop.anchor_train_step(trainer, _anchor_batch(trainer, batch),
                                  mark, diag)


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


def init_ssn_detector(cfg: SSNConfig, state_dict=None, device='cuda',
                      seed=0) -> DetectorBundle:
    """The SSN detector in eval mode on ``device`` (f32, as gga_tpu's).
    With a ``state_dict`` (e.g. from ``convert.from_jax_variables``) the
    weights are loaded strictly; without one they are drawn from
    ``torch.Generator().manual_seed(seed)``. Raises if ``device`` is CUDA
    and no card is present."""
    dev = resolve_device(device)
    model = SSNDetector(cfg)
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    return DetectorBundle(model.to(dev).eval(), cfg, dev)


def init_ssn_trainer(cfg: SSNConfig, total_steps, state_dict=None,
                     device='cuda', seed=0, optimizer=None) -> TrainState:
    """SSN (``init_ssn_detector``'s) in train mode on ``device`` with
    ``build_optimizer(params, total_steps, **optimizer)``: the clip, AdamW
    and the cyclic lr and beta1, as gga_tpu's
    ``tools/train_supervised.py`` builds them for every config."""
    model = init_ssn_detector(cfg, state_dict, device, seed).model.train()
    return TrainState(model=model,
                      optimizer=build_optimizer(model.parameters(),
                                                total_steps,
                                                **(optimizer or {})),
                      step=0, generator=torch.Generator().manual_seed(seed))


def ssn_train_step(trainer: TrainState, batch, mark=None):
    """One SSN train step on a batch of ``NuScenesDataset`` or
    ``LyftDataset`` samples (as tensors or numpy; the boxes' 7 coded
    values are read). Returns ``loop.ssn_train_step``'s logs."""
    return loop.ssn_train_step(trainer, _anchor_batch(trainer, batch), mark)


@torch.no_grad()
def infer_ssn(bundle: DetectorBundle, points, points_valid):
    """SSN inference on a batch: forward in eval mode, each class's
    anchors at its group's map size, ``decode_shape_aware`` (each class's
    best anchors, one rotated BEV NMS over the classes a scene).

    Args:
        points: [B, P, >= 4] f32 (tensor or numpy); points_valid [B, P].
    Returns:
        dict: boxes [B, max_num, 7] bottom-centre lidar, scores, labels
        (the head's class index), valid, on the bundle's device.
    """
    model = bundle.model.eval()
    outs = model(torch.as_tensor(points, dtype=torch.float32,
                                 device=bundle.device),
                 torch.as_tensor(points_valid, dtype=torch.bool,
                                 device=bundle.device))
    cfg = bundle.cfg.head
    anchors = shape_aware_head.shape_aware_anchors(
        cfg, shape_aware_head.feat_sizes(outs), bundle.device)
    return shape_aware_head.decode_shape_aware(cfg, outs, anchors)


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


# configs/_base_/schedules/schedule_3x.py's optimizer block, VoteNet's
VOTENET_OPTIMIZER = dict(lr=0.008, weight_decay=0.01, grad_clip=10.0,
                         lr_policy='step', lr_steps=(24, 32), lr_gamma=0.1)


def init_votenet_detector(cfg: VoteNetConfig, state_dict=None,
                          device='cuda', seed=0) -> DetectorBundle:
    """The VoteNet detector in eval mode on ``device`` (f32, as
    gga_tpu's).

    With a ``state_dict`` (mmdet3d keys, e.g. from
    ``convert.from_jax_variables``) the weights are loaded strictly;
    without one they are drawn from ``torch.Generator().manual_seed(seed)``
    (``VoteNet.init_weights``). Raises if ``device`` is CUDA and no card
    is present."""
    dev = resolve_device(device)
    model = VoteNet(cfg)
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    return DetectorBundle(model.to(dev).eval(), cfg, dev)


def init_votenet_trainer(cfg: VoteNetConfig, steps_per_epoch,
                         state_dict=None, device='cuda', seed=0,
                         optimizer=None) -> TrainState:
    """The VoteNet detector (``init_votenet_detector``'s) in train mode on
    ``device`` with the indoor 3x schedule's optimizer
    (``build_fcaf3d_optimizer(params, steps_per_epoch, **optimizer)``:
    the global-norm clip, AdamW and the lr stepped down at the
    ``lr_steps`` epochs; ``optimizer`` is a config file's ``optimizer``
    block, ``VOTENET_OPTIMIZER`` when None)."""
    return _epoch_trainer(init_votenet_detector(cfg, state_dict, device,
                                                seed).model, steps_per_epoch,
                          optimizer or VOTENET_OPTIMIZER, seed)


_VOTENET_DTYPES = dict(points=torch.float32, points_valid=torch.bool,
                       gt_boxes=torch.float32, gt_labels=torch.int64,
                       obj_valid=torch.bool)


def votenet_train_step(trainer: TrainState, batch, mark=None):
    """One VoteNet train step on a batch (points [B, P, C] with the
    feature channels, points_valid, gt_boxes [B, M, 7] bottom-centre depth
    boxes, gt_labels, obj_valid; tensors or numpy). ``mark`` is the step's
    stage hook (``loop.votenet_train_step``). Returns the step's logs as
    0-d tensors on the trainer's device."""
    dev = next(trainer.model.parameters()).device
    b = {k: torch.as_tensor(batch[k], dtype=dt, device=dev)
         for k, dt in _VOTENET_DTYPES.items()}
    return loop.votenet_train_step(trainer, b, mark)


@torch.no_grad()
def infer_votenet(bundle: DetectorBundle, points, points_valid):
    """VoteNet inference on a batch: forward in eval mode, then
    ``vote_head.decode`` (the boxes and a class-aware axis-aligned NMS).

    Args:
        points: [B, P, C] f32 (tensor or numpy); points_valid: [B, P] bool.
    Returns:
        dict(boxes [B, max_out, 7] bottom-centre depth boxes, scores,
        labels, valid) on the bundle's device; ``eval/indoor_eval.py``
        reads gravity-centred boxes (z + dz / 2).
    """
    model = bundle.model.eval()
    preds = model(torch.as_tensor(points, dtype=torch.float32,
                                  device=bundle.device),
                  torch.as_tensor(points_valid, dtype=torch.bool,
                                  device=bundle.device))
    return vote_head.decode(bundle.cfg.head, preds)


def _init_point_detector(model, state_dict, device, seed):
    dev = resolve_device(device)
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    return DetectorBundle(model.to(dev).eval(), model.cfg, dev)


def _epoch_trainer(model, steps_per_epoch, optimizer, seed):
    """``model`` in train mode with ``build_fcaf3d_optimizer(params,
    steps_per_epoch, **optimizer)`` (the global-norm clip, AdamW and the
    lr stepped down at the ``lr_steps`` epochs) and a generator seeded
    with ``seed`` for the step's draws."""
    return TrainState(model=model.train(),
                      optimizer=build_fcaf3d_optimizer(
                          model.parameters(), steps_per_epoch,
                          **dict(optimizer)),
                      step=0, generator=torch.Generator().manual_seed(seed))


def _det_batch(trainer, batch):
    dev = next(trainer.model.parameters()).device
    return {k: torch.as_tensor(batch[k], dtype=dt, device=dev)
            for k, dt in _DET_DTYPES.items()}


def _points(bundle, points, points_valid):
    return (torch.as_tensor(points, dtype=torch.float32, device=bundle.device),
            torch.as_tensor(points_valid, dtype=torch.bool,
                            device=bundle.device))


# configs/3dssd/3dssd_4x4_kitti-3d-car.py's optimizer block
SSD3D_OPTIMIZER = dict(lr=0.002, weight_decay=0.0, grad_clip=10.0,
                       lr_policy='step', lr_steps=(45, 60), lr_gamma=0.1)


def init_ssd3d_detector(cfg: SSD3DNetConfig, state_dict=None, device='cuda',
                        seed=0) -> DetectorBundle:
    """The 3DSSD detector in eval mode on ``device`` (f32, as gga_tpu's).

    With a ``state_dict`` (mmdet3d keys, e.g. from
    ``convert.from_jax_variables``) the weights are loaded strictly;
    without one they are drawn from ``torch.Generator().manual_seed(seed)``
    (``SSD3DNet.init_weights``). Raises if ``device`` is CUDA and no card
    is present."""
    return _init_point_detector(SSD3DNet(cfg), state_dict, device, seed)


def init_ssd3d_trainer(cfg: SSD3DNetConfig, steps_per_epoch, state_dict=None,
                       device='cuda', seed=0, optimizer=None) -> TrainState:
    """The 3DSSD detector (``init_ssd3d_detector``'s) in train mode on
    ``device`` with its config's optimizer (``build_fcaf3d_optimizer(
    params, steps_per_epoch, **optimizer)``: the global-norm clip, AdamW
    and the lr stepped down at the ``lr_steps`` epochs; ``optimizer`` is a
    config file's ``optimizer`` block, ``SSD3D_OPTIMIZER`` when None)."""
    return _epoch_trainer(init_ssd3d_detector(cfg, state_dict, device,
                                              seed).model, steps_per_epoch,
                          optimizer or SSD3D_OPTIMIZER, seed)


def ssd3d_train_step(trainer: TrainState, batch, mark=None):
    """One 3DSSD train step on a batch of ``KittiDetDataset`` samples (as
    tensors or numpy; the labels of the config's classes, Car 0 for the
    car config). ``mark`` is the step's stage hook
    (``loop.ssd3d_train_step``). Returns the step's logs as 0-d tensors
    on the trainer's device."""
    return loop.ssd3d_train_step(trainer, _det_batch(trainer, batch), mark)


@torch.no_grad()
def infer_ssd3d(bundle: DetectorBundle, points, points_valid):
    """3DSSD inference on a batch: forward in eval mode, then
    ``decode_ssd3d`` (the boxes and a class-aware BEV NMS).

    Args:
        points: [B, P, 4] f32 (tensor or numpy); points_valid: [B, P] bool.
    Returns:
        dict(boxes [B, max_out, 7] bottom-centre lidar, scores, labels,
        valid) on the bundle's device.
    """
    preds = bundle.model.eval()(*_points(bundle, points, points_valid))
    return decode_ssd3d(bundle.cfg.head, preds)


def init_point_rcnn_detector(cfg: PointRCNNConfig, state_dict=None,
                             device='cuda', seed=0) -> DetectorBundle:
    """The PointRCNN detector in eval mode on ``device`` (f32, as
    gga_tpu's); the weights as ``init_ssd3d_detector``'s
    (``PointRCNNDetector.init_weights`` when drawn)."""
    return _init_point_detector(PointRCNNDetector(cfg), state_dict, device,
                                seed)


def init_point_rcnn_trainer(cfg: PointRCNNConfig, total_steps,
                            state_dict=None, device='cuda', seed=0,
                            optimizer=None) -> TrainState:
    """The PointRCNN detector (``init_point_rcnn_detector``'s) in train
    mode on ``device`` with the KITTI recipe's optimizer
    (``build_optimizer(params, total_steps, **optimizer)``: the global-norm
    clip, AdamW and the cyclic lr and beta1 of a config file's
    ``optimizer`` block, configs/_base_/schedules/cyclic_40e.py's under
    the PointRCNN config's lr and betas) and a generator, seeded with
    ``seed``, for the RoI sampler's draws."""
    model = init_point_rcnn_detector(cfg, state_dict, device,
                                     seed).model.train()
    return TrainState(model=model,
                      optimizer=build_optimizer(model.parameters(),
                                                total_steps,
                                                **(optimizer or {})),
                      step=0, generator=torch.Generator().manual_seed(seed))


def point_rcnn_train_step(trainer: TrainState, batch, mark=None,
                          sample_u=None):
    """One PointRCNN train step on a batch of ``KittiDetDataset`` samples
    (as tensors or numpy). ``mark`` is the step's stage hook and
    ``sample_u`` the RoI sampler's draw (``loop.point_rcnn_train_step``).
    Returns the step's logs as 0-d tensors on the trainer's device."""
    return loop.point_rcnn_train_step(trainer, _det_batch(trainer, batch),
                                      mark, sample_u)


@torch.no_grad()
def infer_point_rcnn(bundle: DetectorBundle, points, points_valid):
    """PointRCNN inference on a batch: forward in eval mode (the test
    proposals, their pooling and the RCNN), then ``decode_point_rcnn``
    (the refined boxes and a rotated BEV NMS).

    Args:
        points: [B, P, 4] f32 (tensor or numpy); points_valid: [B, P] bool.
    Returns:
        dict(boxes [B, R, 7] bottom-centre lidar, scores, labels, valid) on
        the bundle's device, R = ``rpn.num_proposals``.
    """
    out = bundle.model.eval()(*_points(bundle, points, points_valid))
    return decode_point_rcnn(bundle.cfg, out)


# configs/groupfree3d/groupfree3d_8x4_scannet-3d-18class-L6-O256.py's
# optimizer block (every GroupFree3D config's)
GROUPFREE3D_OPTIMIZER = dict(lr=0.006, weight_decay=0.0005, grad_clip=0.1,
                             lr_policy='step', lr_steps=(56, 68),
                             lr_gamma=0.1)


def init_groupfree3d_detector(cfg: GroupFree3DNetConfig, state_dict=None,
                              device='cuda', seed=0) -> DetectorBundle:
    """The GroupFree3D detector in eval mode on ``device`` (f32, as
    gga_tpu's); the weights as ``init_ssd3d_detector``'s
    (``GroupFree3DNet.init_weights`` when drawn)."""
    return _init_point_detector(GroupFree3DNet(cfg), state_dict, device,
                                seed)


def init_groupfree3d_trainer(cfg: GroupFree3DNetConfig, steps_per_epoch,
                             state_dict=None, device='cuda', seed=0,
                             optimizer=None) -> TrainState:
    """The GroupFree3D detector (``init_groupfree3d_detector``'s) in train
    mode on ``device`` with its config's optimizer (``optimizer``, a
    config file's ``optimizer`` block, ``GROUPFREE3D_OPTIMIZER`` when
    None: clip 0.1, AdamW lr 0.006, wd 5e-4, x0.1 at epochs 56 and 68)
    and a generator, seeded with ``seed``, for the decoder's dropout."""
    return _epoch_trainer(init_groupfree3d_detector(
        cfg, state_dict, device, seed).model, steps_per_epoch,
        optimizer or GROUPFREE3D_OPTIMIZER, seed)


def groupfree3d_train_step(trainer: TrainState, batch, mark=None, keep=None):
    """One GroupFree3D train step on a batch (points [B, P, C], points_valid,
    gt_boxes [B, M, 7] bottom-centre depth boxes, gt_labels, gt_valid;
    tensors or numpy). ``mark`` is the step's stage hook and ``keep`` the
    dropout keep masks (``loop.groupfree3d_train_step``). Returns the
    step's logs as 0-d tensors on the trainer's device."""
    return loop.groupfree3d_train_step(trainer, _det_batch(trainer, batch),
                                       mark, keep)


@torch.no_grad()
def infer_groupfree3d(bundle: DetectorBundle, points, points_valid):
    """GroupFree3D inference on a batch: forward in eval mode, then
    ``decode_groupfree3d`` (the last stage's boxes and a class-aware
    axis-aligned NMS).

    Args:
        points: [B, P, C] f32 (tensor or numpy); points_valid: [B, P] bool.
    Returns:
        dict(boxes [B, K, 7] bottom-centre depth boxes, scores, labels,
        valid) on the bundle's device, K = min(max_out, num_proposal).
    """
    preds = bundle.model.eval()(*_points(bundle, points, points_valid))
    return decode_groupfree3d(bundle.cfg.head, preds)


def init_h3dnet_detector(cfg: H3DNetConfig, state_dict=None, device='cuda',
                         seed=0) -> DetectorBundle:
    """The H3DNet detector in eval mode on ``device`` (f32, as gga_tpu's);
    the weights as ``init_ssd3d_detector``'s (``H3DNet.init_weights`` when
    drawn)."""
    return _init_point_detector(H3DNet(cfg), state_dict, device, seed)


def init_h3dnet_trainer(cfg: H3DNetConfig, steps_per_epoch, state_dict=None,
                        device='cuda', seed=0, optimizer=None) -> TrainState:
    """The H3DNet detector (``init_h3dnet_detector``'s) in train mode on
    ``device`` with the indoor 3x schedule's optimizer (``optimizer``, a
    config file's ``optimizer`` block, ``VOTENET_OPTIMIZER`` when
    None)."""
    return _epoch_trainer(init_h3dnet_detector(cfg, state_dict, device,
                                               seed).model, steps_per_epoch,
                          optimizer or VOTENET_OPTIMIZER, seed)


def h3dnet_train_step(trainer: TrainState, batch, mark=None):
    """One H3DNet train step on a batch (as ``groupfree3d_train_step``'s).
    ``mark`` is the step's stage hook (``loop.h3dnet_train_step``).
    Returns the step's logs as 0-d tensors on the trainer's device."""
    return loop.h3dnet_train_step(trainer, _det_batch(trainer, batch), mark)


@torch.no_grad()
def infer_h3dnet(bundle: DetectorBundle, points, points_valid):
    """H3DNet inference on a batch: forward in eval mode, then
    ``decode_h3dnet`` (the refined stage's boxes and a class-aware
    axis-aligned NMS).

    Args:
        points: [B, P, C] f32 (tensor or numpy); points_valid: [B, P] bool.
    Returns:
        dict(boxes [B, max_out, 7] bottom-centre depth boxes, scores,
        labels, valid) on the bundle's device.
    """
    out = bundle.model.eval()(*_points(bundle, points, points_valid))
    return decode_h3dnet(bundle.cfg, out)


def init_imvotenet_detector(cfg: ImVoteNetConfig, state_dict=None,
                            device='cuda', seed=0) -> DetectorBundle:
    """The ImVoteNet detector in eval mode on ``device`` (f32, as
    gga_tpu's); the weights as ``init_ssd3d_detector``'s
    (``ImVoteNet.init_weights`` when drawn)."""
    return _init_point_detector(ImVoteNet(cfg), state_dict, device, seed)


def init_imvotenet_trainer(cfg: ImVoteNetConfig, steps_per_epoch,
                           state_dict=None, device='cuda', seed=0,
                           optimizer=None) -> TrainState:
    """The ImVoteNet detector (``init_imvotenet_detector``'s) in train mode
    on ``device`` with the indoor 3x schedule's optimizer (as
    ``init_h3dnet_trainer``'s) and a generator, seeded with ``seed``, for
    the seed sampling's draws."""
    return _epoch_trainer(init_imvotenet_detector(
        cfg, state_dict, device, seed).model, steps_per_epoch,
        optimizer or VOTENET_OPTIMIZER, seed)


_IMAGE_DTYPES = dict(img=None, boxes_2d=torch.float32,
                     boxes_valid=torch.bool, depth2img=torch.float32)


def _image_inputs(dev, img, boxes_2d, boxes_valid, depth2img):
    return [torch.as_tensor(x, dtype=dt, device=dev)
            for x, dt in zip((img, boxes_2d, boxes_valid, depth2img),
                             _IMAGE_DTYPES.values())]


def imvotenet_train_step(trainer: TrainState, batch, mark=None, seed_u=None):
    """One ImVoteNet train step on a batch (``groupfree3d_train_step``'s
    keys plus img [B, H, W, 3] (raw 0-255 pixels, any dtype), boxes_2d
    [B, Kb, 6] (x1, y1, x2, y2, confidence, class), boxes_valid [B, Kb]
    and depth2img [B, 4, 4]). ``mark`` is the step's stage hook and
    ``seed_u`` the seed sampling's draw (``loop.imvotenet_train_step``).
    Returns the step's logs as 0-d tensors on the trainer's device."""
    b = _det_batch(trainer, batch)
    b.update(zip(_IMAGE_DTYPES, _image_inputs(
        b['points'].device, *(batch[k] for k in _IMAGE_DTYPES))))
    return loop.imvotenet_train_step(trainer, b, mark, seed_u)


@torch.no_grad()
def infer_imvotenet(bundle: DetectorBundle, points, points_valid, img,
                    boxes_2d, boxes_valid, depth2img, seed_u=None):
    """ImVoteNet inference on a batch: forward in eval mode (the joint
    tower), then ``decode_imvotenet`` (VoteHead's boxes and a class-aware
    axis-aligned NMS).

    Args:
        points: [B, P, C] f32; points_valid: [B, P] bool; img [B, H, W, 3]
            raw pixels; boxes_2d [B, Kb, 6]; boxes_valid [B, Kb];
            depth2img [B, 4, 4] (tensors or numpy).
        seed_u: the seed sampling's draw [B, S * K]; when None, drawn from
            a generator seeded with 0 (the same draw every call).
    Returns:
        dict(boxes [B, max_out, 7] bottom-centre depth boxes, scores,
        labels, valid) on the bundle's device.
    """
    pts, val = _points(bundle, points, points_valid)
    if seed_u is None:
        seed_u = imvotenet_draws(bundle.cfg, pts.shape[0],
                                 torch.Generator().manual_seed(0),
                                 bundle.device)
    joint, = bundle.model.eval()(pts, val, *_image_inputs(
        bundle.device, img, boxes_2d, boxes_valid, depth2img), seed_u)
    return decode_imvotenet(bundle.cfg, joint)


# configs/pointnet2/pointnet2_ssg_16x2_cosine_200e_scannet_seg-3d-20class.py's
# optimizer block; neither package reads its lr_policy or min_lr_ratio
SEGMENTOR_OPTIMIZER = dict(lr=0.001, weight_decay=0.01, grad_clip=10.0)
_SEGMENTORS = ((EncoderDecoder3DConfig, EncoderDecoder3D),
               (DGCNNConfig, DGCNNSegmentor),
               (PAConvConfig, PAConvSegmentor))
_SEG_DTYPES = dict(points=torch.float32, points_valid=torch.bool,
                   seg_labels=torch.int64)


def init_segmentor(cfg, state_dict=None, device='cuda',
                   seed=0) -> DetectorBundle:
    """The segmentor ``cfg`` describes (an ``EncoderDecoder3DConfig``,
    ``DGCNNConfig`` or ``PAConvConfig``) in eval mode on ``device`` (f32,
    as gga_tpu's); the weights as ``init_ssd3d_detector``'s (the
    segmentor's ``init_weights`` when drawn)."""
    for cfg_cls, model_cls in _SEGMENTORS:
        if isinstance(cfg, cfg_cls):
            return _init_point_detector(model_cls(cfg), state_dict, device,
                                        seed)
    raise TypeError(f'{type(cfg).__name__} is not a segmentor config')


def init_segmentor_trainer(cfg, total_steps, state_dict=None, device='cuda',
                           seed=0, optimizer=None) -> TrainState:
    """The segmentor (``init_segmentor``'s) in train mode on ``device`` with
    ``build_optimizer(params, total_steps, lr, weight_decay, grad_clip,
    betas)`` of a config file's ``optimizer`` block (``SEGMENTOR_OPTIMIZER``
    when None; betas (0.95, 0.99) unless given), as gga_tpu's
    ``tools/train_supervised.py`` treats every config: the global-norm
    clip and AdamW with the cyclic lr and beta1 over ``total_steps``. The
    block's ``lr_policy`` and ``min_lr_ratio`` are read by neither package.
    The generator, seeded with ``seed``, draws the dropout's keep masks."""
    o = dict(optimizer or SEGMENTOR_OPTIMIZER)
    model = init_segmentor(cfg, state_dict, device, seed).model.train()
    return TrainState(
        model=model,
        optimizer=build_optimizer(
            model.parameters(), total_steps, lr=o['lr'],
            weight_decay=o['weight_decay'], grad_clip=o['grad_clip'],
            betas=tuple(o.get('betas', (0.95, 0.99)))),
        step=0, generator=torch.Generator().manual_seed(seed))


def segmentor_train_step(trainer: TrainState, batch, class_weights=None,
                         ignore_index=None, mark=None, keep=None,
                         picks=None):
    """One segmentor train step on a batch (points [B, P, C], points_valid,
    seg_labels; tensors or numpy), with the stage-1 ``seg_info`` label
    weights as ``class_weights`` and the dataset's ignored label as
    ``ignore_index`` (ScanNet's 20), either None. ``mark`` is the step's
    stage hook, ``keep`` the dropout keep mask and ``picks`` the forward's
    picks (``loop.segmentor_train_step``). Returns the step's logs as 0-d
    tensors on the trainer's device."""
    dev = next(trainer.model.parameters()).device
    b = {k: torch.as_tensor(batch[k], dtype=dt, device=dev)
         for k, dt in _SEG_DTYPES.items()}
    if class_weights is not None:
        class_weights = torch.as_tensor(class_weights, dtype=torch.float32,
                                        device=dev)
    return loop.segmentor_train_step(trainer, b, class_weights, ignore_index,
                                     mark, keep, picks)


@torch.no_grad()
def infer_segmentor(bundle: DetectorBundle, points, points_valid):
    """Segmentor inference on a batch: the eval-mode logits' argmax.

    Args:
        points: [B, P, in_channels] f32 (tensor or numpy); points_valid:
            [B, P] bool.
    Returns:
        [B, P] int64 labels on the bundle's device (padding's too).
    """
    return bundle.model.eval()(*_points(bundle, points,
                                        points_valid)).argmax(-1)


def inference_segmentor(bundle: DetectorBundle, points, max_points=40000):
    """Segment one cloud (gga_tpu's ``apis.inference_segmentor``): its first
    ``max_points`` points padded to ``max_points``, the argmax of the
    logits. Returns [n] int64 labels (numpy), n = min(len(points),
    max_points)."""
    points = np.asarray(points, np.float32)
    n = min(len(points), max_points)
    pts = np.zeros((1, max_points, points.shape[1]), np.float32)
    val = np.zeros((1, max_points), bool)
    pts[0, :n] = points[:n]
    val[0, :n] = True
    return infer_segmentor(bundle, pts, val)[0, :n].cpu().numpy()


_MVX_DTYPES = dict(_DET_DTYPES, lidar2img=torch.float32)


def init_mvxnet_detector(cfg: MVXNetConfig, state_dict=None, device='cuda',
                         seed=0) -> DetectorBundle:
    """The MVXNet detector in eval mode on ``device`` (f32, as gga_tpu's);
    the weights as ``init_anchor_detector``'s (``MVXNet.init_weights``
    when drawn)."""
    return _init_point_detector(MVXNet(cfg), state_dict, device, seed)


def init_mvxnet_trainer(cfg: MVXNetConfig, total_steps, optimizer,
                        state_dict=None, device='cuda',
                        seed=0) -> TrainState:
    """The MVXNet detector (``init_mvxnet_detector``'s) in train mode on
    ``device`` with ``build_optimizer(params, total_steps, lr,
    weight_decay, grad_clip, betas)`` of a config file's ``optimizer``
    block (the shipped config's is configs/_base_/schedules/cosine.py's,
    whose lr_policy, warmup and min_lr_ratio neither package reads): the
    global-norm clip and AdamW with the cyclic lr and beta1 over
    ``total_steps``, as gga_tpu's ``tools/train_supervised.py`` treats
    every config."""
    o = dict(optimizer)
    model = init_mvxnet_detector(cfg, state_dict, device, seed).model.train()
    return TrainState(
        model=model,
        optimizer=build_optimizer(
            model.parameters(), total_steps, lr=o['lr'],
            weight_decay=o['weight_decay'], grad_clip=o['grad_clip'],
            betas=tuple(o.get('betas', (0.95, 0.99)))),
        step=0, generator=torch.Generator().manual_seed(seed))


def _image_batch(dev, batch, dtypes):
    """The entries of ``batch`` that ``dtypes`` names as tensors on
    ``dev``, and its images [B, H, W, 3] as [B, 3, H, W] f32."""
    b = {k: torch.as_tensor(batch[k], dtype=dt, device=dev)
         for k, dt in dtypes.items() if k in batch}
    b['img'] = _images(batch['img'], dev)
    return b


def mvxnet_train_step(trainer: TrainState, batch, mark=None, diag=None):
    """One MVXNet train step on a batch (``anchor_train_step``'s keys plus
    img [B, H, W, 3] normalized and lidar2img [B, 4, 4]; tensors or
    numpy). ``mark`` is the step's stage hook and ``diag`` a dict for the
    encoder's occupancy (``loop.mvxnet_train_step``). Returns the step's
    logs as 0-d tensors on the trainer's device."""
    dev = next(trainer.model.parameters()).device
    return loop.mvxnet_train_step(trainer, _image_batch(dev, batch,
                                                        _MVX_DTYPES),
                                  mark, diag)


@torch.no_grad()
def infer_mvxnet(bundle: DetectorBundle, points, points_valid, img,
                 lidar2img):
    """MVXNet inference on a batch: forward in eval mode, anchors at the
    map's size, decode + rotated NMS a class.

    Args:
        points: [B, P, 4] f32; points_valid: [B, P] bool; img [B, H, W, 3]
            normalized; lidar2img [B, 4, 4] (tensors or numpy).
    Returns:
        ``anchor3d_head.decode``'s dict (boxes [B, C*max_num, 7]
        bottom-centre lidar, scores, labels, valid) on the bundle's device.
    """
    b = _image_batch(bundle.device, dict(points=points,
                                         points_valid=points_valid, img=img,
                                         lidar2img=lidar2img), _MVX_DTYPES)
    preds = bundle.model.eval()(b['points'], b['points_valid'], b['img'],
                                b['lidar2img'])
    cfg = bundle.cfg.head
    anchors = anchor3d_head.make_anchors(cfg, tuple(preds['cls'].shape[1:3]),
                                         preds['cls'].device)
    return anchor3d_head.decode(cfg, preds, anchors)


def inference_multi_modality_detector(bundle: DetectorBundle, points, img,
                                      lidar2img, max_points=2048):
    """Run MVXNet on one sample (gga_tpu's
    ``apis.inference_multi_modality_detector``): its first ``max_points``
    points padded to ``max_points``, the image [H, W, 3] (normalized) and
    its lidar2img [4, 4]. Returns dict(boxes_3d [n, 7], scores_3d [n],
    labels_3d [n]) of the kept boxes (numpy)."""
    points = np.asarray(points, np.float32)
    pts = np.zeros((1, max_points, 4), np.float32)
    val = np.zeros((1, max_points), bool)
    n = min(len(points), max_points)
    pts[0, :n] = points[:n, :4]
    val[0, :n] = True
    out = infer_mvxnet(bundle, pts, val, np.asarray(img)[None],
                       np.asarray(lidar2img, np.float32)[None])
    out = {k: v[0].cpu().numpy() for k, v in out.items()}
    v = out['valid']
    return dict(boxes_3d=out['boxes'][v], scores_3d=out['scores'][v],
                labels_3d=out['labels'][v])


_IMVOXEL_DTYPES = dict(lidar2img=torch.float32, gt_boxes=torch.float32,
                       gt_labels=torch.int64, gt_valid=torch.bool)


def init_imvoxelnet_detector(cfg, state_dict=None, device='cuda',
                             seed=0) -> DetectorBundle:
    """ImVoxelNet (``ImVoxelNetConfig``, KITTI) or its indoor detector
    (``ImVoxelNetIndoorConfig``) in eval mode on ``device`` (f32, as
    gga_tpu's); the weights as ``init_anchor_detector``'s (the model's
    ``init_weights`` when drawn)."""
    model = (ImVoxelNetIndoor(cfg) if isinstance(cfg, ImVoxelNetIndoorConfig)
             else ImVoxelNet(cfg))
    return _init_point_detector(model, state_dict, device, seed)


def init_imvoxelnet_trainer(cfg, steps_per_epoch, optimizer,
                            state_dict=None, device='cuda',
                            seed=0) -> TrainState:
    """An ImVoxelNet detector (``init_imvoxelnet_detector``'s) in train
    mode on ``device`` with ``build_fcaf3d_optimizer(params,
    steps_per_epoch, **optimizer)`` of a config file's ``optimizer`` block
    (the shipped configs': the global-norm clip at 35 and AdamW at lr
    1e-4, weight decay 1e-4, the lr times 0.1 at epochs 8 and 11)."""
    return _epoch_trainer(init_imvoxelnet_detector(
        cfg, state_dict, device, seed).model, steps_per_epoch, optimizer,
        seed)


def imvoxelnet_train_step(trainer: TrainState, batch, mark=None):
    """One ImVoxelNet train step on a batch: img [B, H, W, 3] normalized,
    lidar2img [B, 4, 4], gt_boxes [B, M, 7] (KITTI: bottom-centre lidar;
    indoor: gravity-centred depth), gt_labels [B, M], gt_valid [B, M]
    (tensors or numpy). ``mark`` is the step's stage hook
    (``loop.imvoxelnet_train_step``). Returns the step's logs as 0-d
    tensors on the trainer's device."""
    dev = next(trainer.model.parameters()).device
    return loop.imvoxelnet_train_step(
        trainer, _image_batch(dev, batch, _IMVOXEL_DTYPES), mark)


@torch.no_grad()
def infer_imvoxelnet(bundle: DetectorBundle, img, lidar2img):
    """ImVoxelNet inference on a batch of images [B, H, W, 3] (normalized)
    and their lidar2img [B, 4, 4] (tensors or numpy): forward in eval
    mode, then for the KITTI detector anchors at the map's size, decode +
    rotated NMS (``anchor3d_head.decode``: bottom-centre lidar boxes), for
    the indoor one ``imvoxel_head.decode`` (gravity-centred depth boxes).
    Returns dict(boxes [B, K, 7], scores, labels, valid) on the bundle's
    device."""
    b = _image_batch(bundle.device, dict(img=img, lidar2img=lidar2img),
                     _IMVOXEL_DTYPES)
    out = bundle.model.eval()(b['img'], b['lidar2img'])
    if isinstance(bundle.cfg, ImVoxelNetIndoorConfig):
        return imvoxel_head.decode(bundle.cfg.head, *out)
    cfg = bundle.cfg.head
    anchors = anchor3d_head.make_anchors(cfg, tuple(out['cls'].shape[1:3]),
                                         out['cls'].device)
    return anchor3d_head.decode(cfg, out, anchors)
