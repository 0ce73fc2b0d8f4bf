"""VoteNet detector: PointNet2SASSG -> VoteHead (port of
``gga_tpu/models/detectors/votenet.py``; mmdet3d's VoteNet with
configs/_base_/models/votenet.py). No sparse conv and no heatmap: the
detector reaches none of the port's CUDA kernels.

The input is ``points [B, P, in_channels]`` (xyz, then the features:
mmdet3d's SUN RGB-D and ScanNet configs give the height above the
floor) and ``valid [B, P]``. Neither package builds the height channel:
their datasets give xyz and colours.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn

from ..backbones.pointnet2 import PointConv, PointNet2SASSG
from ..dense_heads.vote_head import VoteHead, VoteHeadConfig


@dataclasses.dataclass(frozen=True)
class VoteNetConfig:
    in_channels: int = 4    # xyz used as coords; extra = height feature
    num_points: Tuple[int, ...] = (2048, 1024, 512, 256)
    radii: Tuple[float, ...] = (0.2, 0.4, 0.8, 1.2)
    num_samples: Tuple[int, ...] = (64, 32, 16, 16)
    sa_channels: Sequence = ((64, 64, 128), (128, 128, 256),
                             (128, 128, 256), (128, 128, 256))
    fp_channels: Sequence = ((256, 256), (256, 256))
    head: VoteHeadConfig = dataclasses.field(default_factory=VoteHeadConfig)

    @classmethod
    def tiny(cls):
        """gga_tpu's tiny config."""
        head = VoteHeadConfig(
            num_classes=4,
            mean_sizes=((1.0, 1.0, 1.0),) * 4,
            in_channels=32, vote_conv_channels=(32,),
            agg_num_point=32, agg_mlp=(32, 32),
            pred_conv_channels=(32,), max_objs=8, max_out=16,
            pos_distance_thr=0.8, neg_distance_thr=1.2)
        return cls(num_points=(256, 128, 64, 32),
                   sa_channels=((16, 32),) * 4,
                   fp_channels=((32,), (32,)), head=head)


class VoteNet(nn.Module):
    def __init__(self, cfg: VoteNetConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = PointNet2SASSG(
            in_channels=cfg.in_channels, num_points=tuple(cfg.num_points),
            radii=tuple(cfg.radii), num_samples=tuple(cfg.num_samples),
            sa_channels=tuple(tuple(x) for x in cfg.sa_channels),
            fp_channels=tuple(tuple(x) for x in cfg.fp_channels))
        if self.backbone.out_channels != cfg.head.in_channels:
            raise ValueError(
                f'the backbone gives {self.backbone.out_channels} channels, '
                f'the head takes {cfg.head.in_channels}')
        self.bbox_head = VoteHead(cfg.head)

    @torch.no_grad()
    def init_weights(self, generator):
        """gga_tpu's initializers, drawn from ``generator``: every 1x1 conv
        uniform in +-1/sqrt(fan_in), biases 0; norms at 1 and 0."""
        for m in self.modules():
            if isinstance(m, PointConv):
                m.init_weights(generator)

    def forward(self, points, valid):
        """points [B, P, C >= 3]; valid [B, P] -> the VoteHead's proposal
        dict. Train or eval mode as the module is set."""
        return self.bbox_head(self.backbone(points, valid))
