"""FCOSMono3D / PGD detector: ResNet + FPN + PGDHead (the port of
``gga_tpu/models/detectors/pgd.py``; the reference's FCOSMono3D shell as
configured for the GGA retrain, ``configs/gga/gga_pdg.py``).

State_dict keys are mmdet3d's: ``backbone.*``, ``neck.*``, ``bbox_head.*``.
"""
from __future__ import annotations

import dataclasses

from torch import nn

from ..backbones.resnet import ResNet
from ..dense_heads.pgd_head import PGDConfig, PGDHead
from ..necks.fpn import FPN


@dataclasses.dataclass(frozen=True)
class PGDModelConfig:
    backbone_depth: int = 101
    fpn_channels: int = 256
    fpn_start_level: int = 0
    fpn_num_outs: int = 4
    head: PGDConfig = dataclasses.field(default_factory=PGDConfig)

    @classmethod
    def tiny(cls):
        head = PGDConfig(
            feat_channels=32, stacked_convs=1,
            cls_branch=(32,), reg_branch=((32,),) * 6,
            dir_branch=(32,), centerness_branch=(32,),
            depth_branch=(32,), weight_branch=((32,),),
            pos_budget=128, nms_pre=32, max_per_img=8)
        return cls(backbone_depth=18, fpn_channels=32, head=head)


class PGDDetector(nn.Module):

    def __init__(self, cfg: PGDModelConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNet(depth=cfg.backbone_depth)
        self.neck = FPN(self.backbone.out_channels, cfg.fpn_channels,
                        cfg.fpn_start_level, cfg.fpn_num_outs)
        self.bbox_head = PGDHead(cfg.head, cfg.fpn_channels)

    def forward(self, images):
        """images [B, 3, H, W] (normalized) -> (per-level head outputs,
        NHWC, and fuse_lambda)."""
        return self.bbox_head(self.neck(self.backbone(images)))
