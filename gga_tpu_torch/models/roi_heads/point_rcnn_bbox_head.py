"""PointRCNN's RoI bbox head (port of ``gga_tpu/models/roi_heads/
point_rcnn_bbox_head.py``; mmdet3d's PointRCNNBboxHead): each RoI's pooled
points carry (RoI-frame xyz, the RPN's score, the normalised depth, the
backbone features); an MLP lifts the first five channels, a ConvBN merges
them with the backbone's, and a stack of PointNet set abstractions (the
last one over all of an RoI's points) gives one feature an RoI, from
which two branches predict the IoU logit and the RoI-frame box deltas.
The targets and losses are PartA2's (``parta2_bbox_head.py``
``canonical_targets``, ``bbox_head_loss``) at PointRCNN's 0.7 / 0.25
thresholds.

State_dict names: ``xyz_up_layer.{k}`` and ``merge_down_layer`` (Conv2d
ConvBN, as mmdet3d's), ``SA_modules.{i}.mlps.0.layer{k}``, and the
branches ``cls_layer`` / ``reg_layer``: Conv1d ConvBN ``{k}``, then the
output conv with bias at index ``len(channels)``. gga_tpu's head, and so
the port's, has batch norms where mmdet3d's up, merge and SA layers have
none, and no dropout.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn

from ..backbones.pointnet2 import ConvBN, PointConv, PointSAModule, SharedMLP


@dataclasses.dataclass(frozen=True)
class PointRCNNBboxConfig:
    num_classes: int = 1
    in_channels: int = 5          # canonical xyz + score + depth
    mlp_channels: Tuple[int, ...] = (128, 128)
    num_points: Tuple[int, ...] = (128, 32, -1)   # -1 = group all
    radii: Tuple[float, ...] = (0.2, 0.4, 100.0)
    num_samples: Tuple[int, ...] = (16, 16, 16)
    sa_channels: Sequence[Tuple[int, ...]] = (
        (128, 128, 128), (128, 128, 256), (256, 256, 512))
    cls_channels: Tuple[int, ...] = (256, 256)
    reg_channels: Tuple[int, ...] = (256, 256)
    with_corner_loss: bool = True
    # rcnn train cfg (configs/_base_/models/point_rcnn.py:124-125)
    cls_pos_thr: float = 0.7
    cls_neg_thr: float = 0.25
    loss_bbox_weight: float = 1.0
    loss_cls_weight: float = 1.0
    # test cfg
    test_nms_thr: float = 0.1
    test_score_thr: float = 0.1


class GroupAllSA(nn.Module):
    """A set abstraction over all of a group's points (mmdet3d's
    PointSAModule with GroupAll): [xyz, features] through the MLP, the max
    over the valid points, 0 where none is."""

    def __init__(self, in_channels, mlp_channels):
        super().__init__()
        self.mlps = nn.ModuleList([SharedMLP(3 + in_channels, mlp_channels,
                                             conv2d=True)])

    def forward(self, xyz, features, valid):
        g = self.mlps[0](torch.cat([xyz, features], -1), valid)
        pooled = torch.where(valid[..., None], g,
                             torch.finfo(g.dtype).min).amax(1, keepdim=True)
        any_valid = valid.any(-1)
        return (xyz[:, :1], torch.where(any_valid[:, None, None], pooled, 0.0),
                any_valid[:, None])


class ConvBranch(nn.Module):
    """ConvBN layers ``{k}`` then the output conv with bias."""

    def __init__(self, in_channels, channels, out_channels):
        super().__init__()
        for k, ch in enumerate(channels):
            self.add_module(str(k), ConvBN(in_channels, ch))
            in_channels = ch
        self.n = len(channels)
        self.add_module(str(self.n), PointConv(in_channels, out_channels,
                                               bias=True))

    def forward(self, x, valid):
        for k in range(self.n):
            x = getattr(self, str(k))(x, valid)
        return getattr(self, str(self.n))(x)


class PointRCNNBboxHead(nn.Module):
    def __init__(self, cfg: PointRCNNBboxConfig, rpn_channels):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.xyz_up_layer = SharedMLP(c.in_channels, c.mlp_channels,
                                      prefix='', conv2d=True)
        ch = c.mlp_channels[-1]
        self.merge_down_layer = ConvBN(ch + rpn_channels, ch, conv2d=True)
        self.SA_modules = nn.ModuleList()
        for i, chans in enumerate(c.sa_channels):
            self.SA_modules.append(
                PointSAModule(c.num_points[i], c.radii[i], c.num_samples[i],
                              ch, chans) if c.num_points[i] > 0
                else GroupAllSA(ch, chans))
            ch = chans[-1]
        self.cls_layer = ConvBranch(ch, c.cls_channels, c.num_classes)
        self.reg_layer = ConvBranch(ch, c.reg_channels, 7 * c.num_classes)

    def forward(self, pooled, roi_valid, sample_idx=None):
        """pooled [R, S, in_channels + C_rpn] each RoI's points (RoI-frame
        xyz first); roi_valid [R] (sampled and not empty); ``sample_idx``
        the sampling set abstractions' centre indices, sampled when None.

        Returns (cls_score [R, 1], bbox_pred [R, 7], the sampled indices
        of each sampling set abstraction)."""
        c = self.cfg
        R, S = pooled.shape[:2]
        pt_valid = roi_valid[:, None].expand(R, S)
        xyz_feat = self.xyz_up_layer(pooled[..., :c.in_channels], pt_valid)
        feats = self.merge_down_layer(
            torch.cat([xyz_feat, pooled[..., c.in_channels:]], -1), pt_valid)
        xyz, valid, indices = pooled[..., :3], pt_valid, []
        for sa in self.SA_modules:
            if isinstance(sa, GroupAllSA):
                xyz, feats, valid = sa(xyz, feats, valid)
            else:
                xyz, feats, valid = sa(
                    xyz, feats, valid, None if sample_idx is None
                    else sample_idx[len(indices)])
                indices.append(sa.last_idx)
        x, rv = feats[:, 0], valid[:, 0]
        return self.cls_layer(x, rv), self.reg_layer(x, rv), indices
