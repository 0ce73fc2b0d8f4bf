"""3DSSD, the single-stage point-based detector (port of
``gga_tpu/models/detectors/ssd3d.py``; mmdet3d's SSD3DNet with
configs/_base_/models/3dssd.py): ``PointNet2SAMSG`` with F-FPS / FS
sampling (level 1's 'FS' takes 512 by features and 512 by xyz; level 2
samples by features from the first 512, the F-FPS half, and by xyz from
the rest) -> ``SSD3DHead``. Plain PyTorch: it reaches none of the port's
CUDA kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn

from ..backbones.pointnet2 import PointConv, PointNet2SAMSG
from ..dense_heads.ssd_3d_head import SSD3DConfig, SSD3DHead


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, (list, tuple)) else x


@dataclasses.dataclass(frozen=True)
class SSD3DNetConfig:
    in_channels: int = 4
    num_points: Sequence = (4096, 512, (256, 256))
    radii: Sequence[Tuple[float, ...]] = (
        (0.2, 0.4, 0.8), (0.4, 0.8, 1.6), (1.6, 3.2, 4.8))
    num_samples: Sequence[Tuple[int, ...]] = (
        (32, 32, 64), (32, 32, 64), (32, 32, 32))
    sa_channels: Sequence = (
        ((16, 16, 32), (16, 16, 32), (32, 32, 64)),
        ((64, 64, 128), (64, 64, 128), (64, 96, 128)),
        ((128, 128, 256), (128, 192, 256), (128, 256, 256)))
    aggregation_channels: Tuple[int, ...] = (64, 128, 256)
    fps_mods: Sequence = (('D-FPS',), ('FS',), ('F-FPS', 'D-FPS'))
    fps_sample_range_lists: Sequence = ((-1,), (-1,), (512, -1))
    head: SSD3DConfig = dataclasses.field(default_factory=SSD3DConfig)

    @classmethod
    def tiny(cls):
        """gga_tpu's tiny config."""
        head = SSD3DConfig(
            num_candidates=16, vote_conv_channels=(16,),
            agg_radii=(4.8, 6.4), agg_samples=(8, 8),
            agg_mlps=((16, 16), (16, 16)),
            shared_conv_channels=(16, 16), cls_conv_channels=(16,),
            reg_conv_channels=(16,), max_out=16)
        return cls(
            num_points=(128, 32, (16, 16)),
            sa_channels=(((8, 8),) * 3, ((8, 8),) * 3, ((8, 8),) * 3),
            aggregation_channels=(16, 16, 16),
            fps_sample_range_lists=((-1,), (-1,), (32, -1)),
            head=head)


class SSD3DNet(nn.Module):
    def __init__(self, cfg: SSD3DNetConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = PointNet2SAMSG(
            in_channels=cfg.in_channels,
            num_points=_tuples(cfg.num_points), radii=_tuples(cfg.radii),
            num_samples=_tuples(cfg.num_samples),
            sa_channels=_tuples(cfg.sa_channels),
            aggregation_channels=tuple(cfg.aggregation_channels),
            fps_mods=tuple((m,) if isinstance(m, str) else tuple(m)
                           for m in cfg.fps_mods),
            fps_sample_range_lists=tuple(
                tuple(r) if isinstance(r, (list, tuple)) else (r,)
                for r in cfg.fps_sample_range_lists))
        self.bbox_head = SSD3DHead(cfg.head, self.backbone.out_channels)

    @torch.no_grad()
    def init_weights(self, generator):
        """gga_tpu's initializers, drawn from ``generator``: every 1x1 conv
        uniform in +-1/sqrt(fan_in), biases 0; norms at 1 and 0."""
        for m in self.modules():
            if isinstance(m, PointConv):
                m.init_weights(generator)

    def forward(self, points, valid, sample_idx=None):
        """points [B, P, 4] (xyz, reflectance); valid [B, P];
        ``sample_idx`` the backbone levels' centre indices (sampled when
        None). Returns the head's prediction dict plus ``sample_idx``, the
        backbone's sampled indices (what ``sample_idx`` takes). Train or
        eval mode as the module is set."""
        feat = self.backbone(points, valid, sample_idx)
        out = self.bbox_head(feat)
        out['sample_idx'] = feat['sa_indices']
        return out
