"""GroupFree3DNet (port of ``gga_tpu/models/detectors/groupfree3d.py``;
mmdet3d's GroupFree3DNet with configs/_base_/models/groupfree3d.py):
PointNet2SASSG (feature propagation to 1024 seeds of 288 channels) ->
GroupFree3DHead (KPS sampling and the transformer decoder). Plain
PyTorch: it reaches none of the port's CUDA kernels.

The input is ``points [B, P, in_channels]`` (xyz only in the shipped
ScanNet configs) and ``valid [B, P]``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..backbones.pointnet2 import PointConv, PointNet2SASSG
from ..dense_heads.groupfree3d_head import GroupFree3DConfig, GroupFree3DHead
from ..model_utils.transformer import MultiheadAttention


@dataclasses.dataclass(frozen=True)
class GroupFree3DNetConfig:
    in_channels: int = 3
    num_points: Tuple[int, ...] = (2048, 1024, 512, 256)
    radii: Tuple[float, ...] = (0.2, 0.4, 0.8, 1.2)
    num_samples: Tuple[int, ...] = (64, 32, 16, 16)
    sa_channels: Tuple = ((64, 64, 128), (128, 128, 256),
                          (128, 128, 256), (128, 128, 256))
    fp_channels: Tuple = ((256, 256), (256, 288))
    head: GroupFree3DConfig = dataclasses.field(
        default_factory=GroupFree3DConfig)

    @classmethod
    def tiny(cls):
        """gga_tpu's tiny config."""
        head = GroupFree3DConfig(
            num_classes=4, in_channels=16, num_proposal=16,
            num_decoder_layers=2, num_heads=2, ffn_dim=32,
            mean_sizes=((1.0, 1.0, 1.0),) * 4, max_out=16)
        return cls(num_points=(128, 64, 32, 16),
                   sa_channels=((16, 16),) * 4,
                   fp_channels=((16,), (16,)), head=head)

    @property
    def num_seeds(self):
        """The seeds of the last feature propagation's level."""
        return self.num_points[len(self.num_points)
                               - len(self.fp_channels) - 1]


class GroupFree3DNet(nn.Module):
    def __init__(self, cfg: GroupFree3DNetConfig):
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
        self.bbox_head = GroupFree3DHead(cfg.head)

    @torch.no_grad()
    def init_weights(self, generator):
        """gga_tpu's initializers, drawn from ``generator``: every 1x1 conv
        and linear uniform in +-1/sqrt(fan_in), an attention's q / k / v
        projections the same, biases 0; norms at 1 and 0."""
        for m in self.modules():
            if isinstance(m, PointConv):
                m.init_weights(generator)
            elif isinstance(m, (nn.Linear, MultiheadAttention)):
                w, b = ((m.weight, m.bias) if isinstance(m, nn.Linear)
                        else (m.in_proj_weight, m.in_proj_bias))
                bound = (1.0 / w.shape[1]) ** 0.5
                w.uniform_(-bound, bound, generator=generator)
                b.zero_()

    def forward(self, points, valid, sample_idx=None, keep=None):
        """points [B, P, C >= 3]; valid [B, P]; ``sample_idx`` dict of
        given picks (``sampled_indices``' layout: 'backbone', a list of
        each level's, and 'kps'), sampled here when None; ``keep`` the
        decoder's dropout keep masks (``groupfree3d_draws``) in train
        mode. Returns the head's dict. Train or eval mode as the module
        is set."""
        s = sample_idx or {}
        feat = self.backbone(points, valid, s.get('backbone'))
        return self.bbox_head(feat, s.get('kps'), keep)

    def sampled_indices(self, out):
        """The picks of the last forward (``out`` its output), in the
        layout ``forward`` takes back."""
        return dict(backbone=[sa.last_idx
                              for sa in self.backbone.SA_modules],
                    kps=out['cand_idx'])
