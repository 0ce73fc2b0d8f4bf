"""SMOKE monocular 3D detector (the port of
``gga_tpu/models/detectors/smoke.py``; config
``configs/smoke/smoke_dla34_dlaneck_gn-all_8x4_6x_kitti-mono3d.py``):
DLA-34 (gn-all) + DLANeck to the stride-4 map, then the SMOKE head.
``backbone='resnet'`` keeps gga_tpu's lighter substitute: a ResNet whose
strides 4 / 8 / 16 / 32 are fused down to stride 4 by ``UpFuse`` blocks
(bilinear x2, half-pixel as ``jax.image.resize``, a 3x3 conv, a 1x1
lateral conv, batch norm, ReLU).

State_dict keys: ``backbone.*``, ``neck.*`` (DLA) or ``up_fuses.{i}``
(ResNet), ``bbox_head.*``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..backbones.dla import DLANet
from ..backbones.resnet import ResNet
from ..dense_heads import smoke_head
from ..dense_heads.smoke_head import SMOKEConfig, SMOKEHead
from ..layers import BatchNorm2d, init_params
from ..necks.dla_neck import DLANeck


@dataclasses.dataclass(frozen=True)
class SMOKEModelConfig:
    backbone: str = 'dla'        # 'dla' (reference parity) | 'resnet'
    img_depth: int = 34
    img_base_planes: int = 64
    neck_channels: int = 64
    dla_channels: tuple = ()     # override DLA34 channels (tiny)
    head: SMOKEConfig = dataclasses.field(default_factory=SMOKEConfig)

    @classmethod
    def tiny(cls):
        return cls(backbone='resnet', img_depth=18, img_base_planes=8,
                   neck_channels=16,
                   head=SMOKEConfig(feat_channels=16, max_objs=8, topk=16))

    @classmethod
    def tiny_dla(cls):
        return cls(backbone='dla', dla_channels=(4, 8, 8, 16, 16, 16),
                   head=SMOKEConfig(feat_channels=16, max_objs=8, topk=16))


class UpFuse(nn.Module):
    """Upsample the deeper map to the shallower one's size (bilinear,
    half-pixel) and fuse: ReLU(BN(conv3x3(up) + conv1x1(shallow)))."""

    def __init__(self, deep_channels, shallow_channels, channels):
        super().__init__()
        self.conv_up = nn.Conv2d(deep_channels, channels, 3, padding=1,
                                 bias=False)
        self.conv_lateral = nn.Conv2d(shallow_channels, channels, 1,
                                      bias=False)
        self.bn = BatchNorm2d(channels)

    def forward(self, deep, shallow):
        up = F.interpolate(deep, size=shallow.shape[2:], mode='bilinear',
                           align_corners=False)
        return F.relu(self.bn(self.conv_up(up) + self.conv_lateral(shallow)))


def seeded_init(model, generator):
    """Conv weights uniform in +-sqrt(6 / fan_in) (``init_params``, 1-D
    convs too), biases zero, the DLA neck's upsamplers bilinear."""
    init_params(model, generator)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv1d):
                bound = (6.0 / m.weight[0].numel()) ** 0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    if isinstance(getattr(model, 'neck', None), DLANeck):
        model.neck.reset_upsamplers()


class SMOKEDetector(nn.Module):

    def __init__(self, cfg: SMOKEModelConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.backbone == 'dla':
            self.backbone = DLANet(cfg.img_depth, cfg.dla_channels)
            self.neck = DLANeck(self.backbone.out_channels)
            in_channels = self.backbone.out_channels[self.neck.start_level]
        elif cfg.backbone == 'resnet':
            self.backbone = ResNet(depth=cfg.img_depth,
                                   base_planes=cfg.img_base_planes)
            ch = self.backbone.out_channels
            deep = [ch[3], cfg.neck_channels, cfg.neck_channels]
            self.up_fuses = nn.ModuleList(
                UpFuse(d, s, cfg.neck_channels)
                for d, s in zip(deep, (ch[2], ch[1], ch[0])))
            in_channels = cfg.neck_channels
        else:
            raise ValueError(f"backbone {cfg.backbone!r}: 'dla' or 'resnet'")
        self.bbox_head = SMOKEHead(cfg.head, in_channels)

    def init_weights(self, generator):
        seeded_init(self, generator)

    def forward(self, img):
        """img [B, 3, H, W] (normalized) -> the head's NHWC maps on the
        stride-4 map: dict(heatmap, reg)."""
        if self.cfg.backbone == 'dla':
            x = self.neck(self.backbone(img))
        else:
            stages = self.backbone(img)
            x = stages[-1]
            for fuse, s in zip(self.up_fuses, stages[2::-1]):
                x = fuse(x, s)
        return self.bbox_head(x)

    def loss(self, preds, gt_boxes_cam, labels, centers2d, obj_valid,
             cam2img, trans_mat):
        return smoke_head.loss(self.cfg.head, preds, gt_boxes_cam, labels,
                               centers2d, obj_valid, cam2img, trans_mat)

    def decode(self, preds, cam2img, trans_mat):
        return smoke_head.decode(self.cfg.head, preds, cam2img, trans_mat)
