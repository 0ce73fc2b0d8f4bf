"""The GGA weak detector: voxelize -> HardSimpleVFE -> SparseEncoder ->
SECOND -> SECONDFPN -> CenterHead, and the decode to merged per-scene
detections (port of ``gga_tpu/models/detectors/centerpoint_gga.py``).
In train mode (``model.train()``) every batch norm uses the batch's
statistics and updates its running ones, as gga_tpu's ``train=True``.

Submodules carry mmdet3d's names (``pts_middle_encoder``,
``pts_backbone``, ``pts_neck``, ``pts_bbox_head``), so the state_dict
keys are those of a released GGA checkpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn

from ...ops.voxelize import hard_voxelize
from ..backbones.second import SECOND
from ..dense_heads import centerpoint_head as cp
from ..dense_heads.centerpoint_head_gga import GGAHeadConfig
from ..middle_encoders import SparseEncoder
from ..necks.second_fpn import SECONDFPN
from ..voxel_encoders import HardSimpleVFE


@dataclasses.dataclass(frozen=True)
class GGAModelConfig:
    """Static model config mirroring configs/gga/gga_kitti_config.py:5-91
    (copy of gga_tpu's GGAModelConfig)."""
    voxel_size: Tuple[float, float, float] = (0.05, 0.05, 0.1)
    point_cloud_range: Tuple[float, ...] = (0., -40., -3., 70.4, 40., 1.)
    max_points_per_voxel: int = 5
    max_voxels: int = 16000
    sparse_shape: Tuple[int, int, int] = (41, 1600, 1408)
    encoder_channels: Sequence[Sequence[int]] = (
        (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128))
    encoder_paddings: Sequence = (
        (0, 0, 1), (0, 0, 1), (0, 0, (0, 1, 1)), (0, 0))
    encoder_budgets: Tuple[int, ...] = (16000, 14000, 12000)
    encoder_out_budget: int = 12000
    encoder_out_channels: int = 128
    backbone_channels: Tuple[int, ...] = (128, 256)
    backbone_layers: Tuple[int, ...] = (5, 5)
    backbone_strides: Tuple[int, ...] = (1, 2)
    neck_channels: Tuple[int, ...] = (256, 256)
    neck_strides: Tuple[int, ...] = (1, 2)
    tasks: Tuple[int, ...] = (1, 1, 1)
    share_conv_channel: int = 64
    head: GGAHeadConfig = dataclasses.field(default_factory=GGAHeadConfig)
    max_per_task: int = 100
    score_threshold: float = 0.1
    nms_thr: float = 0.2
    post_max_size: int = 512
    # 'bfloat16' runs the sparse encoder, backbone, neck and head in bf16
    # (params stay f32, head outputs and decode f32)
    compute_dtype: str = 'float32'
    # per-task (dx, dy, dz) class-mean dims: the seeded init starts the dim
    # head's bias at log(prior) and the height head's at the gravity z
    task_dim_priors: Tuple[Tuple[float, float, float], ...] = None
    prior_ground_z: float = -1.73
    # gga_tpu's TPU options; the port refuses all but their defaults
    # (SparseEncoder)
    remat_encoder: bool = False
    encoder_tile_stages: Tuple[int, ...] = ()
    encoder_tile_shape: Tuple[int, int, int] = (2, 4, 4)
    encoder_tile_budgets: Tuple[int, ...] = (0, 7168, 3072, 1536)

    @classmethod
    def small(cls):
        """Accuracy-bench variant: full range at 0.1 m voxels, budgets
        sized for ~8k-point scenes so nothing truncates."""
        head = GGAHeadConfig(grid_size=(704, 800, 40), max_objs=16,
                             voxel_size=(0.1, 0.1, 0.1))
        return cls(
            voxel_size=(0.1, 0.1, 0.1),
            max_voxels=8192, sparse_shape=(41, 800, 704),
            encoder_channels=((16, 16), (16, 32), (32, 64), (64,)),
            encoder_paddings=((0, 1), (0, 1), (0, (0, 1, 1)), (0,)),
            encoder_budgets=(8192, 8192, 6144), encoder_out_budget=6144,
            encoder_out_channels=64,
            backbone_channels=(64, 128), backbone_layers=(2, 2),
            neck_channels=(64, 64),
            share_conv_channel=32,
            head=head, max_per_task=32, post_max_size=32,
            task_dim_priors=((0.8, 0.6, 1.73), (1.76, 0.6, 1.73),
                             (3.9, 1.6, 1.56)))

    @classmethod
    def tiny(cls):
        """Small variant for CPU tests: ~1/6 grid, thin channels."""
        head = GGAHeadConfig(
            grid_size=(224, 256, 40), max_objs=16,
            point_cloud_range=(0., -40., -3., 71.68, 40., 1.),
            voxel_size=(0.32, 0.3125, 0.1))
        return cls(
            voxel_size=(0.32, 0.3125, 0.1),
            point_cloud_range=(0., -40., -3., 71.68, 40., 1.),
            max_voxels=512, sparse_shape=(41, 256, 224),
            encoder_channels=((8, 8), (8, 8), (8, 8), (8,)),
            encoder_paddings=((0, 1), (0, 1), (0, (0, 1, 1)), (0,)),
            encoder_budgets=(512, 512, 512), encoder_out_budget=512,
            encoder_out_channels=16,
            backbone_channels=(16, 32), backbone_layers=(1, 1),
            neck_channels=(16, 16),
            share_conv_channel=16,
            head=head, max_per_task=16, post_max_size=16)


class GGADetector(nn.Module):
    def __init__(self, cfg: GGAModelConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.pts_voxel_encoder = HardSimpleVFE()
        self.pts_middle_encoder = SparseEncoder(
            in_channels=4, sparse_shape=c.sparse_shape,
            base_channels=c.encoder_channels[0][0],
            output_channels=c.encoder_out_channels,
            encoder_channels=c.encoder_channels,
            encoder_paddings=c.encoder_paddings,
            stage_budgets=c.encoder_budgets, out_budget=c.encoder_out_budget,
            tile_stages=c.encoder_tile_stages, remat_blocks=c.remat_encoder,
            tile_shape=c.encoder_tile_shape,
            tile_budgets=c.encoder_tile_budgets)
        self.pts_backbone = SECOND(self.pts_middle_encoder.bev_channels,
                                   c.backbone_channels, c.backbone_layers,
                                   c.backbone_strides)
        self.pts_neck = SECONDFPN(c.backbone_channels, c.neck_channels,
                                  c.neck_strides)
        self.pts_bbox_head = cp.CenterHead(sum(c.neck_channels), c.tasks,
                                           c.share_conv_channel)

    def extract_bev(self, points, points_valid, diag=None):
        """points [B, P, 4] f32; points_valid [B, P] -> BEV NCHW. A dict
        ``diag`` receives the encoder's occupancy diagnostics."""
        c = self.cfg
        vox = hard_voxelize(points, points_valid,
                            voxel_size=tuple(c.voxel_size),
                            pc_range=tuple(c.point_cloud_range),
                            max_points=c.max_points_per_voxel,
                            max_voxels=c.max_voxels)
        feats = self.pts_voxel_encoder(vox['voxels'], vox['num_points'])
        feats = feats.to(getattr(torch, c.compute_dtype))
        vvalid = (torch.arange(c.max_voxels, device=points.device)[None]
                  < vox['num_voxels'][:, None])
        return self.pts_middle_encoder(feats, vox['coords'], vvalid, diag)

    def forward(self, points, points_valid, diag=None):
        """Returns a list over tasks of head-output dicts (NHWC f32 maps)."""
        bev = self.extract_bev(points, points_valid, diag)
        return self.pts_bbox_head(self.pts_neck(self.pts_backbone(bev)))


def decode_detections(cfg: GGAModelConfig, preds):
    """Head outputs -> merged per-scene detections (static shapes).

    The tasks' NMS runs as one batch of B * len(tasks) rows; each row is
    independent, so this equals gga_tpu's per-task loop."""
    h = cfg.head
    decoded = [cp.decode_task(
        tp, voxel_size=h.voxel_size[:2], pc_range=h.point_cloud_range,
        out_size_factor=h.out_size_factor, max_num=cfg.max_per_task,
        score_threshold=cfg.score_threshold,
        post_center_range=h.point_cloud_range) for tp in preds]
    stacked = {key: torch.cat([d[key] for d in decoded])
               for key in decoded[0]}
    dets = cp.get_task_detections(
        stacked, nms_thr=cfg.nms_thr,
        post_max_size=min(cfg.post_max_size, cfg.max_per_task))
    B = preds[0]['heatmap'].shape[0]
    per_task = [{key: v[t * B:(t + 1) * B] for key, v in dets.items()}
                for t in range(len(preds))]
    return cp.merge_task_detections(per_task, cfg.tasks)
