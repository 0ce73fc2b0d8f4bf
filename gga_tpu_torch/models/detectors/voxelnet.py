"""VoxelNet-family detectors (port of
``gga_tpu/models/detectors/voxelnet.py``), the fully supervised KITTI
anchor detectors:

- SECOND (``SECONDDetector``): hard voxelization -> HardSimpleVFE ->
  SparseEncoder (conv_module variant) -> SECOND -> SECONDFPN ->
  Anchor3DHead;
- PointPillars (``PointPillars``): hard voxelization -> PillarFeatureNet
  -> PointPillarsScatter -> SECOND or NoStemRegNet -> SECONDFPN or FPN ->
  Anchor3DHead, in f32 or with the dense stack in bf16; FreeAnchor
  (``FreeAnchorPointPillarsConfig``) is the same network trained with the
  FreeAnchor3D loss.

With ``neck='fpn'`` the FPN's levels are upsampled to the finest one by
``jax.image.resize``'s nearest neighbour (``necks/fpn.py resize_nearest``)
and concatenated for the one-level anchor head, as gga_tpu does. With
``compute_dtype='bfloat16'`` the canvas is cast to bf16 after the scatter
and the backbone (convs in bf16, BN in f32 with a bf16 output) and a
SECONDFPN neck run in bf16; as flax promotes a bf16 input of a conv
without a dtype to its f32 parameters, the FPN neck and the head compute
in f32 on the bf16 maps, so the head's maps, the loss and the decode are
f32, and the parameters stay f32.

The bf16 path matches gga_tpu's bf16 forward on the CPU, but the builder
and the entry points refuse the three ``_fp16_`` PointPillars configs
(``refuse_pillars_bf16``): on an H100 their whole bf16 step does not meet
the bf16 gates against the CPU's (ROADMAP.md §1, "The _fp16_ SECOND
configs (bf16)").

PointPillars reads the first ``POINT_FEATURES`` columns of the points,
(x, y, z, intensity): nuScenes' and Lyft's sweeps' time lag is dropped,
as CenterPoint's voxel path drops it (gga_tpu's flax PillarFeatureNet
sizes its first layer from what it is fed).

In train mode (``model.train()``) every batch norm uses the batch's
statistics and updates its running ones, as gga_tpu's ``train=True``.
Submodules carry mmdet3d's VoxelNet names (``voxel_encoder``,
``middle_encoder``, ``backbone``, ``neck``, ``bbox_head``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn

from ...ops.voxelize import hard_voxelize
from ..backbones.regnet import NoStemRegNet
from ..backbones.second import SECOND
from ..dense_heads.anchor3d_head import Anchor3DConfig, Anchor3DHead
from ..dense_heads.free_anchor3d_head import FreeAnchor3DConfig
from ..layers import init_params
from ..middle_encoders import PointPillarsScatter, SparseEncoder
from ..necks.fpn import FPN, resize_nearest
from ..necks.second_fpn import SECONDFPN
from ..voxel_encoders import HardSimpleVFE, PillarFeatureNet


@dataclasses.dataclass(frozen=True)
class PointPillarsConfig:
    """hv_pointpillars_secfpn_kitti (copy of gga_tpu's config)."""
    voxel_size: Tuple[float, float, float] = (0.16, 0.16, 4.0)
    point_cloud_range: Tuple[float, ...] = (0, -39.68, -3, 69.12, 39.68, 1)
    max_points_per_voxel: int = 32
    max_voxels: int = 16000
    pfn_channels: Tuple[int, ...] = (64,)
    scatter_shape: Tuple[int, int] = (496, 432)     # (ny, nx)
    backbone_channels: Tuple[int, ...] = (64, 128, 256)
    backbone_layers: Tuple[int, ...] = (3, 5, 5)
    backbone_strides: Tuple[int, ...] = (2, 2, 2)
    neck_channels: Tuple[int, ...] = (128, 128, 128)
    neck_strides: Tuple[int, ...] = (1, 2, 4)
    # 'second' or a RegNet arch ('regnetx_400mf', 'regnetx_1.6gf',
    # 'regnetx_3.2gf'): NoStemRegNet, whose stage widths come from the
    # arch (backbone_channels / layers / strides are not read then)
    backbone: str = 'second'
    # 'secfpn' (deconvs, concatenated) or 'fpn' (top-down FPN, its levels
    # upsampled to the finest and concatenated)
    neck: str = 'secfpn'
    # 'bfloat16' runs the backbone (and a SECONDFPN neck) in bf16: the
    # reference's fp16 configs
    compute_dtype: str = 'float32'
    head: Anchor3DConfig = dataclasses.field(default_factory=Anchor3DConfig)

    @classmethod
    def tiny(cls):
        # scatter dims divisible by 8 so SECONDFPN's x4 deconv lines up
        rng = (0, -40.96, -3, 71.68, 40.96, 1)
        head = Anchor3DConfig(
            feat_channels=48, nms_pre=32, max_num=16,
            anchor_ranges=((0, -40.96, -0.6, 71.68, 40.96, -0.6),
                           (0, -40.96, -0.6, 71.68, 40.96, -0.6),
                           (0, -40.96, -1.78, 71.68, 40.96, -1.78)))
        return cls(voxel_size=(0.64, 0.64, 4.0), max_voxels=2048,
                   point_cloud_range=rng,
                   scatter_shape=(128, 112), pfn_channels=(16,),
                   backbone_channels=(16, 32, 32),
                   backbone_layers=(1, 1, 1),
                   neck_channels=(16, 16, 16), head=head)


@dataclasses.dataclass(frozen=True)
class FreeAnchorPointPillarsConfig(PointPillarsConfig):
    """configs/free_anchor: PointPillars' network, trained with the
    FreeAnchor3D loss (``dense_heads/free_anchor3d_head.py``) over the
    Anchor3DHead maps (copy of gga_tpu's config)."""
    head: FreeAnchor3DConfig = dataclasses.field(
        default_factory=FreeAnchor3DConfig)


@dataclasses.dataclass(frozen=True)
class SECONDNetConfig:
    """hv_second_secfpn_kitti: voxel (0.05, 0.05, 0.1), SparseEncoder
    (copy of gga_tpu's config)."""
    voxel_size: Tuple[float, float, float] = (0.05, 0.05, 0.1)
    point_cloud_range: Tuple[float, ...] = (0, -40, -3, 70.4, 40, 1)
    max_points_per_voxel: int = 5
    max_voxels: int = 16000
    sparse_shape: Tuple[int, int, int] = (41, 1600, 1408)
    encoder_channels: Sequence = ((16,), (32, 32, 32), (64, 64, 64),
                                  (64, 64, 64))
    encoder_paddings: Sequence = ((1,), (1, 1, 1), (1, 1, 1),
                                  ((0, 1, 1), 1, 1))
    encoder_budgets: Tuple[int, ...] = (16000, 14000, 12000)
    encoder_out_budget: int = 12000
    backbone_channels: Tuple[int, ...] = (128, 256)
    backbone_layers: Tuple[int, ...] = (5, 5)
    backbone_strides: Tuple[int, ...] = (1, 2)
    neck_channels: Tuple[int, ...] = (256, 256)
    neck_strides: Tuple[int, ...] = (1, 2)
    # gga_tpu's 'bfloat16' (hv_second_secfpn_fp16_*) waits: SECOND
    # refuses it
    compute_dtype: str = 'float32'
    head: Anchor3DConfig = dataclasses.field(
        default_factory=lambda: Anchor3DConfig(
            anchor_ranges=((0, -40, -0.6, 70.4, 40, -0.6),
                           (0, -40, -0.6, 70.4, 40, -0.6),
                           (0, -40, -1.78, 70.4, 40, -1.78))))


POINT_FEATURES = 4     # (x, y, z, intensity): the pillar nets' point width


def refuse_pillars_bf16(cfg):
    """Raise for a bf16 PointPillars config (the ``_fp16_`` ones)."""
    if getattr(cfg, 'compute_dtype', 'float32') == 'bfloat16':
        raise NotImplementedError(
            "compute_dtype 'bfloat16': the _fp16_ PointPillars configs wait "
            'with the _fp16_ SECOND ones (ROADMAP.md §1, "The _fp16_ SECOND '
            'configs (bf16)"): at full width on an H100 the RegNet-400MF '
            "FPN config's whole bf16 step against the CPU's met the loss "
            '(8.7e-4), grad-norm (1.9e-2) and BN (7.8e-3) gates, but 176 of '
            "its 231 gradients fell below the cosine floor 0.97 (the lowest "
            "0.113, where the card's own one-ulp noise reads -0.237)")


def _voxelize(cfg, points, points_valid):
    vox = hard_voxelize(points, points_valid,
                        voxel_size=tuple(cfg.voxel_size),
                        pc_range=tuple(cfg.point_cloud_range),
                        max_points=cfg.max_points_per_voxel,
                        max_voxels=cfg.max_voxels)
    vvalid = (torch.arange(cfg.max_voxels, device=points.device)[None]
              < vox['num_voxels'][:, None])
    return vox, vvalid


class _AnchorDetector(nn.Module):
    """The dense half shared by the anchor detectors: SECOND or
    NoStemRegNet (``arch``) -> SECONDFPN or FPN (``neck``) ->
    Anchor3DHead on an NCHW BEV map. Only PointPillars reads its config's
    ``backbone`` and ``neck``; the others run SECOND and SECONDFPN, as in
    gga_tpu."""

    def _dense(self, cfg, bev_channels, arch='second', neck='secfpn',
               head_cls=Anchor3DHead):
        if arch == 'second':
            self.backbone = SECOND(bev_channels, cfg.backbone_channels,
                                   cfg.backbone_layers, cfg.backbone_strides)
            widths = tuple(cfg.backbone_channels)
        else:
            self.backbone = NoStemRegNet(arch, bev_channels)
            widths = self.backbone.out_channels
        self.fpn = neck == 'fpn'
        if self.fpn:
            self.neck = FPN(widths, cfg.neck_channels[0],
                            num_outs=len(widths))
            fused = cfg.neck_channels[0] * len(widths)
        else:
            self.neck = SECONDFPN(widths, cfg.neck_channels,
                                  cfg.neck_strides)
            fused = sum(cfg.neck_channels)
        self.bbox_head = head_cls(cfg.head, fused)

    def init_weights(self, generator):
        """Seeded weights: He-uniform convs and linears (as the GGA
        detector's, ``layers.init_params``), conv biases zero but an
        anchor head's cls logits' prior bias; the FPN neck's convs, which
        no norm follows, at gain 1 (as the PGD detector's: He scaling
        there grows the head's logits to hundreds, and the box decode's
        ``exp`` overflows)."""
        init_params(self, generator)
        if self.fpn:
            init_params(self.neck, generator, gain=1.0)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    bound = (6.0 / m.in_features) ** 0.5
                    m.weight.uniform_(-bound, bound, generator=generator)
        if isinstance(self.bbox_head, Anchor3DHead):
            self.bbox_head.init_biases()

    def fused(self, bev):
        """The neck's map for the head: SECONDFPN's in the backbone's
        dtype, or the FPN's levels (in f32) upsampled to the finest and
        concatenated."""
        xs = self.backbone(bev)
        if not self.fpn:
            return self.neck(xs)
        levels = self.neck([x.float() for x in xs])
        top = levels[0]
        return torch.cat([top] + [resize_nearest(lv, top.shape[-2:])
                                  for lv in levels[1:]], 1)

    def head(self, bev):
        """The head's NHWC f32 maps (computed in f32 on a bf16 map)."""
        return self.bbox_head(self.fused(bev).float())


def second_encoder_args(cfg: SECONDNetConfig):
    """SparseEncoder arguments of SECOND's conv_module encoder: gga_tpu
    builds it with base 16 and 128 output channels."""
    return dict(in_channels=4, sparse_shape=cfg.sparse_shape,
                base_channels=16, output_channels=128,
                encoder_channels=cfg.encoder_channels,
                encoder_paddings=cfg.encoder_paddings,
                stage_budgets=cfg.encoder_budgets,
                out_budget=cfg.encoder_out_budget, block_type='conv_module')


class SECONDDetector(_AnchorDetector):
    def __init__(self, cfg: SECONDNetConfig):
        super().__init__()
        if cfg.compute_dtype != 'float32':
            raise NotImplementedError(
                f'compute_dtype {cfg.compute_dtype!r}: the _fp16_ SECOND '
                'configs wait for their slice (ROADMAP.md §1, "The _fp16_ '
                'SECOND configs (bf16)"): at full width their whole bf16 '
                "step with the kernels meets the plain step's one-ulp noise "
                'but not the fixed cosine floor of the bf16 gates')
        self.cfg = cfg
        self.voxel_encoder = HardSimpleVFE()
        self.middle_encoder = self.build_encoder(cfg)
        self._dense(cfg, self.middle_encoder.bev_channels)

    @staticmethod
    def build_encoder(cfg):
        return SparseEncoder(**second_encoder_args(cfg))

    def voxel_features(self, points, points_valid):
        """Voxel means of the points a voxel keeps (f32 [B, V, 4]), the
        voxels' (z, y, x) coords and valid mask."""
        vox, vvalid = _voxelize(self.cfg, points, points_valid)
        return (self.voxel_encoder(vox['voxels'], vox['num_points']),
                vox['coords'], vvalid)

    def extract_bev(self, points, points_valid, diag=None):
        """points [B, P, 4] f32; points_valid [B, P] -> BEV NCHW
        [B, 128 * nz, ny, nx]. A dict ``diag`` receives the encoder's
        ``occupancy_out``."""
        feats, coords, vvalid = self.voxel_features(points, points_valid)
        return self.middle_encoder(feats, coords, vvalid, diag)

    def forward(self, points, points_valid, diag=None):
        """Returns the head's dict of NHWC f32 maps."""
        return self.head(self.extract_bev(points, points_valid, diag))


class PointPillars(_AnchorDetector):
    def __init__(self, cfg: PointPillarsConfig):
        super().__init__()
        if cfg.compute_dtype not in ('float32', 'bfloat16'):
            raise ValueError(f'compute_dtype {cfg.compute_dtype!r}: '
                             'PointPillars runs float32 or bfloat16')
        self.cfg = cfg
        self.voxel_encoder = PillarFeatureNet(
            feat_channels=cfg.pfn_channels, voxel_size=cfg.voxel_size,
            point_cloud_range=cfg.point_cloud_range,
            in_channels=POINT_FEATURES)
        self.middle_encoder = PointPillarsScatter(cfg.scatter_shape)
        self._dense(cfg, cfg.pfn_channels[-1], cfg.backbone, cfg.neck)

    def extract_bev(self, points, points_valid, diag=None):
        """points [B, P, >= 4] f32; points_valid [B, P] -> canvas NCHW
        [B, C, ny, nx] in the compute dtype. ``diag`` is not read (no
        budget but the voxels')."""
        return pillar_canvas(self, points, points_valid).to(
            getattr(torch, self.cfg.compute_dtype))

    def forward(self, points, points_valid, diag=None):
        """Returns the head's dict of NHWC f32 maps."""
        return self.head(self.extract_bev(points, points_valid, diag))


def pillar_canvas(model, points, points_valid):
    """The f32 pillar canvas of ``model``'s voxel encoder and scatter on
    the first ``POINT_FEATURES`` columns of the points."""
    points = points[..., :POINT_FEATURES]
    vox, vvalid = _voxelize(model.cfg, points, points_valid)
    feats = model.voxel_encoder(vox['voxels'], vox['num_points'],
                                vox['coords'])
    return model.middle_encoder(feats, vox['coords'], vvalid)
