"""MonoFlex monocular 3D detector (the port of
``gga_tpu/models/detectors/monoflex.py``; config
``configs/monoflex/monoflex_dla34_dlaneck_gn-all_2x4_6x_kitti-mono3d.py``):
DLA-34 (gn-all) + DLANeck to the stride-4 map, then the MonoFlex head.

State_dict keys: ``backbone.*``, ``neck.*``, ``bbox_head.*``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from torch import nn

from ..backbones.dla import DLANet
from ..dense_heads import monoflex_head
from ..dense_heads.monoflex_head import MonoFlexConfig, MonoFlexHead
from ..necks.dla_neck import DLANeck
from .smoke import seeded_init


@dataclasses.dataclass(frozen=True)
class MonoFlexModelConfig:
    img_depth: int = 34
    dla_channels: Tuple[int, ...] = ()      # override for tiny configs
    head: MonoFlexConfig = dataclasses.field(
        default_factory=MonoFlexConfig)

    @classmethod
    def tiny(cls):
        return cls(dla_channels=(4, 8, 8, 16, 16, 16),
                   head=MonoFlexConfig(feat_channels=16, max_objs=8,
                                       topk=16))


class MonoFlexDetector(nn.Module):

    def __init__(self, cfg: MonoFlexModelConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = DLANet(cfg.img_depth, cfg.dla_channels)
        self.neck = DLANeck(self.backbone.out_channels)
        self.bbox_head = MonoFlexHead(
            cfg.head, self.backbone.out_channels[self.neck.start_level])

    def init_weights(self, generator):
        seeded_init(self, generator)
        self.bbox_head.init_biases()

    def forward(self, img):
        """img [B, 3, H, W] (normalized) -> the head's NHWC maps on the
        stride-4 map: dict(heatmap, reg)."""
        return self.bbox_head(self.neck(self.backbone(img)))

    def loss(self, preds, gt_boxes_cam, labels, bboxes2d, centers2d, depths,
             obj_valid, cam2img, img_shape):
        return monoflex_head.loss(self.cfg.head, preds, gt_boxes_cam, labels,
                                  bboxes2d, centers2d, depths, obj_valid,
                                  cam2img, img_shape)

    def decode(self, preds, cam2img):
        return monoflex_head.decode(self.cfg.head, preds, cam2img)
