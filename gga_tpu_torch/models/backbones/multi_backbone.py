"""MultiBackbone: parallel PointNet2SASSG towers with a fused output
(port of ``gga_tpu/models/backbones/multi_backbone.py``; mmdet3d's
MultiBackbone of H3DNet): N towers of the same structure run on the
same cloud, each with its own farthest point sampling (deterministic, so
every tower lands on the same seeds), and their last feature
propagation's features, concatenated, go through one ConvBN + ReLU
(``aggregation_layers.layer0``) into the fused ``hd_feature``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from .pointnet2 import PointNet2SASSG, SharedMLP


@dataclasses.dataclass(frozen=True)
class MultiBackboneConfig:
    num_streams: int = 4
    in_channels: int = 4
    num_points: Tuple[int, ...] = (2048, 1024, 512, 256)
    radii: Tuple[float, ...] = (0.2, 0.4, 0.8, 1.2)
    num_samples: Tuple[int, ...] = (64, 32, 16, 16)
    sa_channels: Tuple = ((64, 64, 128), (128, 128, 256),
                          (128, 128, 256), (128, 128, 256))
    fp_channels: Tuple = ((256, 256), (256, 256))
    agg_channels: int = 256


class MultiBackbone(nn.Module):
    def __init__(self, cfg: MultiBackboneConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone_list = nn.ModuleList([PointNet2SASSG(
            in_channels=cfg.in_channels, num_points=tuple(cfg.num_points),
            radii=tuple(cfg.radii), num_samples=tuple(cfg.num_samples),
            sa_channels=tuple(tuple(x) for x in cfg.sa_channels),
            fp_channels=tuple(tuple(x) for x in cfg.fp_channels))
            for _ in range(cfg.num_streams)])
        width = sum(b.out_channels for b in self.backbone_list)
        self.aggregation_layers = SharedMLP(width, (cfg.agg_channels,))
        self.out_channels = cfg.agg_channels

    def forward(self, points, valid, sample_idx=None):
        """points [B, P, in_channels]; valid [B, P]; ``sample_idx`` a list
        of each tower's list of level indices, or None to sample.

        Returns dict: fp_xyz / fp_valid (the last tower's seeds),
        fp_features = hd_feature (the fused features) and sa_indices
        (each tower's sampled indices)."""
        outs = [tower(points, valid,
                      None if sample_idx is None else sample_idx[i])
                for i, tower in enumerate(self.backbone_list)]
        last = outs[-1]
        hd = self.aggregation_layers(
            torch.cat([o['fp_features'] for o in outs], -1), last['fp_valid'])
        return dict(fp_xyz=last['fp_xyz'], fp_features=hd,
                    fp_valid=last['fp_valid'], hd_feature=hd,
                    sa_indices=[o['sa_indices'] for o in outs])
