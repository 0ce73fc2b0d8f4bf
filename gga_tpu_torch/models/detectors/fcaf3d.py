"""FCAF3D indoor detector: voxelize -> MinkResNet -> FCAF3DHead (port of
``gga_tpu/models/detectors/fcaf3d.py``; mmdet3d's
MinkSingleStage3DDetector with the SUN RGB-D FCAF3D config: voxel 0.01 m,
MinkResNet34 on colours, rotated boxes)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ...ops.scatter import assign_point_voxel_ids, dynamic_scatter_mean
from ...ops.voxelize import dynamic_voxelize, hard_voxelize
from ..backbones.mink_resnet import MinkConv, MinkResNet
from ..dense_heads.fcaf3d_head import Conv1x1, FCAF3DConfig, FCAF3DHead


@dataclasses.dataclass(frozen=True)
class FCAF3DModelConfig:
    voxel_size: float = 0.01
    # static grid (x0, y0, z0, x1, y1, z1); nz * ny * nx < 2^31
    pc_range: Tuple[float, ...] = (-6.4, -6.4, -2.56, 6.4, 6.4, 2.56)
    max_voxels: int = 65536
    in_channels: int = 3   # colours
    depth: int = 34
    base_planes: int = 64
    backbone_budgets: Tuple[int, ...] = (65536, 32768, 16384, 8192, 4096,
                                         2048)
    head: FCAF3DConfig = dataclasses.field(default_factory=FCAF3DConfig)

    @classmethod
    def tiny(cls):
        """gga_tpu's tiny config: budgets above the active counts of a
        ~512-point cloud."""
        head = FCAF3DConfig(
            n_classes=4, in_channels=(8, 16, 32, 64), out_channels=16,
            voxel_size=0.08, level_budgets=(1024, 256, 64, 8), max_objs=8,
            nms_pre=32, max_out=8, pts_assign_threshold=4,
            pts_center_threshold=3)
        return cls(voxel_size=0.08,
                   pc_range=(-5.12, -5.12, -2.56, 5.12, 5.12, 2.56),
                   max_voxels=1024, base_planes=8, depth=18,
                   backbone_budgets=(4096, 2048, 1024, 256, 64, 8),
                   head=head)

    @property
    def grid_zyx(self):
        """(nz, ny, nx) of the voxel grid, rounded as gga_tpu rounds."""
        n = [int(round((self.pc_range[3 + a] - self.pc_range[a])
                       / self.voxel_size)) for a in (2, 1, 0)]
        return tuple(n)


class FCAF3DDetector(nn.Module):
    """State-dict children ``backbone`` (MinkResNet) and ``head``
    (FCAF3DHead), as mmdet3d's."""

    def __init__(self, cfg: FCAF3DModelConfig):
        super().__init__()
        if abs(cfg.voxel_size - cfg.head.voxel_size) >= 1e-9:
            raise ValueError('model and head voxel sizes must match (the '
                             'head derives point positions from its own)')
        self.cfg = cfg
        self.backbone = MinkResNet(cfg.depth, cfg.in_channels,
                                   cfg.base_planes, cfg.backbone_budgets)
        self.head = FCAF3DHead(cfg.head)

    def voxelize(self, points, colors, points_valid):
        """One voxel per occupied cell (``hard_voxelize`` at one point a
        voxel, farthest voxels dropped past ``max_voxels``), carrying the
        mean colour of all its points (a dynamic scatter, MinkowskiEngine's
        TensorField average). Returns (feats [B, V, C], coords [B, V, 3]
        (z, y, x) sorted, valid [B, V])."""
        c = self.cfg
        vs = (c.voxel_size,) * 3
        rng = tuple(c.pc_range)
        vox = hard_voxelize(points, points_valid, voxel_size=vs, pc_range=rng,
                            max_points=1, max_voxels=c.max_voxels)
        pc, ok = dynamic_voxelize(points, points_valid, voxel_size=vs,
                                  pc_range=rng)
        ids = assign_point_voxel_ids(pc, vox['coords'], ok,
                                     vox['coords'][..., 0] >= 0, c.grid_zyx)
        mean_col, _ = dynamic_scatter_mean(colors, ids, ok, c.max_voxels)
        valid = (torch.arange(c.max_voxels, device=points.device)[None]
                 < vox['num_voxels'][:, None])
        return mean_col, vox['coords'], valid

    def forward(self, points, colors, points_valid, diag=None):
        """points [B, P, 3] depth-frame xyz; colors [B, P, C];
        points_valid [B, P]. With a dict ``diag``, records the active
        sites per scene at each budget (``active.voxels``, the backbone's
        and the head's keys).

        Returns the head's list of level dicts, ``points`` in metres."""
        feats, coords, valid = self.voxelize(points, colors, points_valid)
        if diag is not None:
            diag['active.voxels'] = valid.sum(-1)
        outs = self.head(self.backbone(feats, coords, valid,
                                       self.cfg.grid_zyx, diag), diag)
        origin = torch.tensor(self.cfg.pc_range[:3], device=points.device)
        for o in outs:
            o['points'] = o['points'] + origin
        return outs

    @torch.no_grad()
    def init_weights(self, generator):
        """gga_tpu's initializers, drawn from ``generator``: sparse kernels
        uniform in +-1/sqrt(fan_in) (its ``conv_init``, torch's default
        conv init), the 1x1 head convs normal(0, 0.01), the class bias
        -4.595; norms and scales at 1 and 0."""
        for m in self.modules():
            if isinstance(m, MinkConv):
                k, cin, _ = m.kernel.shape
                bound = (1.0 / (k * cin)) ** 0.5
                m.kernel.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, Conv1x1):
                m.kernel.normal_(0.0, 0.01, generator=generator)
        self.head.conv_cls.bias.fill_(-4.595)
