"""SASSD, the structure-aware single-stage detector (port of
``gga_tpu/models/detectors/sassd.py``): SECOND's voxel stack plus a
train-time point-wise auxiliary branch. The first three encoder layers'
sparse features are interpolated back to the voxel-mean points (three
nearest sites, inverse squared-distance weights), and point_fc /
point_cls / point_reg (linear, no bias) predict each point's foreground
logit and its offset to its box's centre; ``sassd_aux_loss`` adds a
focal and a smooth-L1 loss on them. The branch runs in train mode only.

The detector computes in f32 (bf16 is refused as SECOND's; gga_tpu's
SASSD ignores ``compute_dtype``), and, as in gga_tpu, the offset
target's z is the box's gravity centre
``z_bottom + h / 2``, where mmdet3d's SparseEncoderSASSD regresses to
``z_bottom * 1.5`` (gga_tpu's note: an apparent bug there).

The three linear layers live in the middle encoder, as mmdet3d's
``SparseEncoderSASSD`` holds them (state_dict ``middle_encoder.point_fc``
and so on).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ...core.geometry import points_in_rbbox
from ...ops.points import three_interpolate, three_nn
from ..dense_heads.anchor3d_head import Anchor3DConfig
from ..losses import smooth_l1_loss
from ..middle_encoders import SparseEncoder
from .voxelnet import SECONDDetector, SECONDNetConfig, second_encoder_args


@dataclasses.dataclass(frozen=True)
class SASSDConfig(SECONDNetConfig):
    """SECOND's stack and the auxiliary branch's width (copy of gga_tpu's
    config)."""
    aux_channels: int = 64

    @classmethod
    def tiny(cls):
        head = Anchor3DConfig(
            feat_channels=32, nms_pre=32, max_num=16,
            anchor_ranges=((0, -40, -0.6, 71.68, 40, -0.6),
                           (0, -40, -0.6, 71.68, 40, -0.6),
                           (0, -40, -1.78, 71.68, 40, -1.78)))
        return cls(voxel_size=(0.32, 0.3125, 0.1), max_voxels=1024,
                   point_cloud_range=(0, -40, -3, 71.68, 40, 1),
                   sparse_shape=(41, 256, 224),
                   encoder_channels=((8,), (8, 8), (8, 8), (8, 8)),
                   encoder_paddings=((1,), (1, 1), (1, 1), ((0, 1, 1), 1)),
                   encoder_budgets=(1024, 1024, 1024),
                   encoder_out_budget=1024,
                   backbone_channels=(16, 32), backbone_layers=(1, 1),
                   backbone_strides=(1, 2), neck_channels=(16, 16),
                   neck_strides=(1, 2), aux_channels=16, head=head)


class SparseEncoderSASSD(SparseEncoder):
    """The conv_module SparseEncoder with SASSD's auxiliary point branch
    (mmdet3d's SparseEncoderSASSD). In train mode it returns (bev, aux)
    with aux = (pts_xyz [B, V, 3], pts_valid [B, V], point_cls
    [B, V, 1], point_reg [B, V, 3]), the reference's ``point_misc``; in
    eval mode the BEV map alone."""

    def __init__(self, voxel_size, point_cloud_range, aux_channels=64,
                 **kwargs):
        super().__init__(return_stages=True, **kwargs)
        # stage 0's site size and the grid's origin (xyz), on the module's
        # device; not in the state_dict
        self.register_buffer('site_size', torch.tensor(voxel_size,
                                                       dtype=torch.float32),
                             persistent=False)
        self.register_buffer('origin', torch.tensor(point_cloud_range[:3],
                                                    dtype=torch.float32),
                             persistent=False)
        width = sum(blocks[-1] for blocks in kwargs['encoder_channels'][:3])
        self.point_fc = nn.Linear(width, aux_channels, bias=False)
        self.point_cls = nn.Linear(aux_channels, 1, bias=False)
        self.point_reg = nn.Linear(aux_channels, 3, bias=False)

    def forward(self, feats, coords, valid, diag=None):
        bev, stages = super().forward(feats, coords, valid, diag)
        if not self.training:
            return bev
        # the voxel means' xyz (mmdet3d's voxel_features[:, :3])
        pts_xyz = feats[..., :3]
        interp = []
        for si, (sf, sc, sv, _) in enumerate(stages[:3]):
            # the sites' centres in xyz from their (z, y, x) coords
            src = ((sc.flip(-1).float() + 0.5) * (self.site_size * 2 ** si)
                   + self.origin)
            d2, idx = three_nn(pts_xyz, src, s_valid=sv)
            interp.append(three_interpolate(sf, idx, d2))
        pw = self.point_fc(torch.cat(interp, -1))
        return bev, (pts_xyz, valid, self.point_cls(pw), self.point_reg(pw))


class SASSD(SECONDDetector):
    """SECOND with the auxiliary branch: ``forward`` returns (preds, aux)
    in train mode and ``preds`` in eval mode, as gga_tpu's ``train``."""

    @staticmethod
    def build_encoder(cfg: SASSDConfig):
        return SparseEncoderSASSD(cfg.voxel_size, cfg.point_cloud_range,
                                  cfg.aux_channels, **second_encoder_args(cfg))

    def forward(self, points, points_valid, diag=None):
        out = self.extract_bev(points, points_valid, diag)
        if not self.training:
            return self.head(out)
        bev, aux = out
        return self.head(bev), aux


def sassd_aux_loss(aux, gt_boxes, gt_valid, enlarge=1.0, gamma=2.0,
                   alpha=0.25):
    """The auxiliary point losses (gga_tpu ``sassd_aux_loss``, mmdet3d's
    sparse_encoder.py:412-454): a point is foreground inside a valid GT
    box (sizes times ``enlarge``); an alpha-balanced sigmoid focal loss
    over the valid points and a smooth-L1 (beta 1/9) of the offset to the
    first such box's gravity centre over the foreground, each over the
    foreground count (at least 1) and the batch size.

    Args:
        aux: the train-mode SASSD's (pts_xyz, pts_valid, point_cls,
            point_reg).
        gt_boxes: [B, M, 7] bottom-centre LiDAR boxes; gt_valid [B, M].
    Returns:
        dict(aux_loss_cls=..., aux_loss_reg=...), 0-d tensors.
    """
    pts_xyz, pts_valid, point_cls, point_reg = aux
    B = pts_xyz.shape[0]
    with torch.no_grad():
        big = torch.cat([gt_boxes[..., :3], gt_boxes[..., 3:6] * enlarge,
                         gt_boxes[..., 6:]], -1)
        inside = points_in_rbbox(pts_xyz, big) & gt_valid[:, None, :]
        label = inside.any(-1)
        first = inside.to(torch.uint8).argmax(-1)       # the first box
        center = torch.cat([gt_boxes[..., :2], gt_boxes[..., 2:3]
                            + gt_boxes[..., 5:6] / 2.0], -1)
        off = pts_xyz - center.gather(1, first[..., None].expand(-1, -1, 3))
        offsets = torch.where(label[..., None], off, 0.0)
        pos = (label & pts_valid).float()
        pos_norm = pos.sum().clamp(min=1.0)

    logit = point_cls[..., 0]
    p = torch.sigmoid(logit)
    t = pos
    ce = -(t * F.logsigmoid(logit) + (1 - t) * F.logsigmoid(-logit))
    pt = t * p + (1 - t) * (1 - p)
    w = (alpha * t + (1 - alpha) * (1 - t)) * (1 - pt) ** gamma
    cls_loss = torch.where(pts_valid, ce * w, 0.0).sum() / pos_norm / B
    reg = smooth_l1_loss(point_reg, offsets, beta=1 / 9.)
    reg_loss = (reg * pos[..., None]).sum() / pos_norm / B
    return dict(aux_loss_cls=cls_loss, aux_loss_reg=reg_loss)
