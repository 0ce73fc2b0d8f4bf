"""ImVoxelNet: a monocular image lifted into a voxel volume (port of
``gga_tpu/models/detectors/imvoxelnet.py``; mmdet3d's ImVoxelNet):

- ``ImVoxelNet`` (``configs/imvoxelnet/imvoxelnet_4x8_kitti-3d-car.py``):
  ResNet + FPN, the level-0 map sampled bilinearly (``point_sample``) at
  every voxel centre of the (Nx, Ny, Nz) grid over the point-cloud range,
  ``OutdoorImVoxelNeck`` down to a BEV map, the 1-class Anchor3DHead.
  Keys ``backbone``, ``neck``, ``neck_3d``, ``bbox_head``.
- ``ImVoxelNetIndoor`` (``imvoxelnet_4x2_sunrgbd-3d-10class.py``): the
  same lift over the head's prior range, ``IndoorImVoxelNeck``'s three
  levels and ``ImVoxelHead``; it also returns each level's projection
  validity (the level's own voxel centres in front of the camera and
  inside the image).

The lift is one batched gather of four taps at every centre of every
scene (642 816 centres a KITTI scene at full width). No hand-written
kernel runs: gga_tpu runs these in XLA, the port on cuDNN's dense convs
(f32, TF32 off).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ...core.geometry import project_to_image
from ..backbones.resnet import ResNet
from ..dense_heads.anchor3d_head import Anchor3DConfig, Anchor3DHead
from ..dense_heads.imvoxel_head import (ImVoxelHead, ImVoxelHeadConfig,
                                        grid_centers, level_points)
from ..fusion_layers.point_fusion import point_sample
from ..layers import init_params
from ..necks.fpn import FPN
from ..necks.imvoxel_neck import IndoorImVoxelNeck, OutdoorImVoxelNeck


@dataclasses.dataclass(frozen=True)
class ImVoxelNetConfig:
    """Copy of gga_tpu's config."""
    n_voxels: Tuple[int, int, int] = (216, 248, 12)      # (x, y, z)
    point_cloud_range: Tuple[float, ...] = (0, -39.68, -3.08, 69.12,
                                            39.68, 0.76)
    img_depth: int = 50
    img_base_planes: int = 64
    fpn_channels: int = 64
    neck3d_out: int = 256
    head: Anchor3DConfig = dataclasses.field(
        default_factory=lambda: Anchor3DConfig(
            num_classes=1,
            anchor_sizes=((3.9, 1.6, 1.56),),
            anchor_ranges=((0, -39.68, -1.78, 69.12, 39.68, -1.78),),
            pos_iou_thr=(0.6,), neg_iou_thr=(0.45,),
            min_pos_iou=(0.45,)))

    @classmethod
    def tiny(cls):
        head = Anchor3DConfig(
            num_classes=1, feat_channels=16, nms_pre=32, max_num=16,
            anchor_sizes=((3.9, 1.6, 1.56),),
            anchor_ranges=((0, -39.68, -1.78, 69.12, 39.68, -1.78),),
            pos_iou_thr=(0.6,), neg_iou_thr=(0.45,), min_pos_iou=(0.45,))
        return cls(n_voxels=(36, 40, 12), img_depth=18, img_base_planes=8,
                   fpn_channels=8, neck3d_out=16, head=head)


@dataclasses.dataclass(frozen=True)
class ImVoxelNetIndoorConfig:
    """Copy of gga_tpu's config: 40 x 40 x 16 voxels over the head's prior
    range, IndoorImVoxelNeck, ImVoxelHead."""
    n_voxels: Tuple[int, int, int] = (40, 40, 16)        # (x, y, z)
    prior_range: Tuple[float, ...] = (-3.2, -0.2, -2.28, 3.2, 6.2, 0.28)
    img_depth: int = 50
    img_base_planes: int = 64
    fpn_channels: int = 256
    neck3d_channels: int = 128
    neck3d_blocks: Tuple[int, ...] = (1, 1, 1)
    head: Optional[ImVoxelHeadConfig] = None

    def __post_init__(self):
        if self.head is None:
            object.__setattr__(self, 'head', ImVoxelHeadConfig(
                prior_range=tuple(self.prior_range)))

    @classmethod
    def tiny(cls):
        return cls(n_voxels=(16, 16, 8), img_depth=18,
                   img_base_planes=8, fpn_channels=16,
                   neck3d_channels=16,
                   head=ImVoxelHeadConfig(
                       n_classes=4, n_channels=16, nms_pre=32,
                       max_out=8,
                       prior_range=(-3.2, -0.2, -2.28, 3.2, 6.2, 0.28)))


def lift(feat, centers, lidar2img, img_shape, n_voxels):
    """The NCHW map ``feat`` [B, C, Hf, Wf] sampled at the centres [N, 3]
    of every scene -> volume NCDHW [B, C, Nx, Ny, Nz]."""
    B = feat.shape[0]
    pts = centers.expand(B, -1, -1)
    ok = torch.ones(pts.shape[:2], dtype=torch.bool, device=feat.device)
    v = point_sample(feat, pts, lidar2img, img_shape, ok)    # [B, N, C]
    return v.transpose(1, 2).reshape(B, -1, *n_voxels)


class _ImageVolume(nn.Module):
    """ResNet + FPN and the level-0 lift shared by both detectors."""

    def _image(self, cfg):
        self.backbone = ResNet(depth=cfg.img_depth,
                               base_planes=cfg.img_base_planes)
        self.neck = FPN(self.backbone.out_channels, cfg.fpn_channels,
                        num_outs=4)

    def _init_convs(self, generator, gain=6.0):
        """He-uniform 2-D convs (``layers.init_params``) and 3-D convs and
        transposed convs, in module order."""
        init_params(self, generator, gain)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.ConvTranspose3d):
                    fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
                elif isinstance(m, nn.Conv3d):
                    fan_in = m.weight[0].numel()
                else:
                    continue
                bound = (gain / fan_in) ** 0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()

    def volume(self, img, lidar2img, rng, n_voxels):
        feat0 = self.neck(self.backbone(img))[0]     # stride 4
        centers = grid_centers(rng, n_voxels, img.device)
        return lift(feat0, centers, lidar2img, img.shape[-2:], n_voxels)


class ImVoxelNet(_ImageVolume):
    def __init__(self, cfg: ImVoxelNetConfig):
        super().__init__()
        self.cfg = cfg
        self._image(cfg)
        self.neck_3d = OutdoorImVoxelNeck(cfg.fpn_channels, cfg.neck3d_out)
        self.bbox_head = Anchor3DHead(cfg.head, cfg.neck3d_out)

    def init_weights(self, generator):
        """Seeded He-uniform convs, the cls logits' prior bias."""
        self._init_convs(generator)
        self.bbox_head.init_biases()

    def forward(self, img, lidar2img):
        """img [B, 3, H, W] (normalized); lidar2img [B, 4, 4] -> the
        head's dict of NHWC f32 maps on the [Ny, Nx] BEV grid."""
        c = self.cfg
        vol = self.volume(img, lidar2img, tuple(c.point_cloud_range),
                          tuple(c.n_voxels))
        return self.bbox_head(self.neck_3d(vol))


class ImVoxelNetIndoor(_ImageVolume):
    def __init__(self, cfg: ImVoxelNetIndoorConfig):
        super().__init__()
        self.cfg = cfg
        self._image(cfg)
        self.neck_3d = IndoorImVoxelNeck(cfg.fpn_channels,
                                         cfg.neck3d_channels,
                                         tuple(cfg.neck3d_blocks))
        self.bbox_head = ImVoxelHead(cfg.head)

    def init_weights(self, generator):
        """Seeded He-uniform convs, the head's own initializers."""
        self._init_convs(generator)
        self.bbox_head.init_weights(generator)

    def forward(self, img, lidar2img):
        """img [B, 3, H, W] (normalized); lidar2img [B, 4, 4] -> (the
        head's levels, the levels' projection validity [B, Nx, Ny, Nz])."""
        c = self.cfg
        volumes = self.neck_3d(self.volume(
            img, lidar2img, tuple(c.head.prior_range), tuple(c.n_voxels)))
        preds = self.bbox_head(volumes)
        H, W = img.shape[-2:]
        valids = []
        for vol in volumes:
            shape = tuple(vol.shape[2:])
            pts = level_points(c.head, [shape], img.device)[0]
            uv, depth = project_to_image(pts.expand(img.shape[0], -1, -1),
                                         lidar2img)
            ok = ((depth > 1e-3) & (uv[..., 0] >= 0) & (uv[..., 0] < W)
                  & (uv[..., 1] >= 0) & (uv[..., 1] < H))
            valids.append(ok.reshape(-1, *shape))
        return preds, valids
