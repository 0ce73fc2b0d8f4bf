"""PAConv: the position-adaptive convolution segmentor (port of
``gga_tpu/models/backbones/paconv.py``; mmdet3d's PAConv op without its
CUDA path, its ScoreNet, the PAConv SSG segmentor of ``configs/paconv/``
with PAConvHead, and the kernel-correlation regulariser): each
neighbour's filter is a ScoreNet-weighted mixture of M weight-bank
kernels; the ScoreNet reads the pair geometry [centre | offset |
distance] and the kernel the features [feature - first member's |
feature].

gga_tpu's choices are kept: the "centre" feature is the ball's first
member's (its first slot); a set abstraction's offsets are not divided by
the radius; the PAConv layer's BatchNorm is flax's unmasked one (momentum
0.9, eps 1e-5, variance E[x^2] - E[x]^2), so its statistics count the
zeroed slots of balls with fewer members than ``num_sample``; the
ScoreNet's BatchNorms are masked by the ball.

mmdet3d's names: ``backbone.SA_modules.{i}.mlps.0.layer{k}.weight_bank``
[2C, M * out], ``.scorenet.mlps.layer{0,1}`` (ConvBN, Conv2d weights),
``.scorenet.mlps.layer2.conv`` (weight and bias), ``.bn``; the head's
``decode_head.FP_modules.{i}.mlps.layer{k}``, ``pre_seg_conv``,
``conv_seg``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import points as po
from ..decode_heads.pointnet2_head import PointNet2SegHead
from ..model_utils.transformer import BatchNorm
from ..segmentors.base import Segmentor
from .pointnet2 import PointConv, SharedMLP, centres


class _ConvOut(nn.Module):
    """A ConvModule without norm or activation: ``conv`` with a bias."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv = PointConv(in_channels, out_channels, bias=True,
                              conv2d=True)


class ScoreNet(nn.Module):
    """MLP on the pair geometry -> softmax kernel scores (mmdet3d's
    ScoreNet, gga_tpu's: hidden ConvBNs, then a conv with a bias)."""

    def __init__(self, num_kernels, hidden=(16, 16), temp=1.0):
        super().__init__()
        self.temp = temp
        self.mlps = SharedMLP(7, hidden, conv2d=True)
        self.out_name = f'layer{len(hidden)}'
        self.mlps.add_module(self.out_name, _ConvOut(hidden[-1], num_kernels))

    def forward(self, pair, mask):
        """pair [..., 7]; mask over the leading dims -> scores [..., M]."""
        h = self.mlps(pair, mask)
        s = getattr(self.mlps, self.out_name).conv(h)
        return torch.softmax(s / self.temp, dim=-1)


class PAConvLayer(nn.Module):
    """One PAConv on grouped neighbourhoods; ``in_channels`` the grouped
    feature width C."""

    def __init__(self, in_channels, out_channels, num_kernels=8):
        super().__init__()
        self.num_kernels = num_kernels
        self.out_channels = out_channels
        self.weight_bank = nn.Parameter(
            torch.zeros(2 * in_channels, num_kernels * out_channels))
        self.scorenet = ScoreNet(num_kernels)
        self.bn = BatchNorm(out_channels)

    def forward(self, feats, rel_xyz, center_xyz, mask):
        """feats [B, S, K, C]; rel_xyz [B, S, K, 3]; center_xyz [B, S, 3];
        mask [B, S, K] -> [B, S, K, out_channels]."""
        B, S, K, _ = feats.shape
        kin = torch.cat([feats - feats[:, :, :1], feats], -1)
        dist = (rel_xyz * rel_xyz).sum(-1, keepdim=True).sqrt()
        pair = torch.cat([center_xyz[:, :, None, :].expand_as(rel_xyz),
                          rel_xyz, dist], -1)
        scores = self.scorenet(pair, mask)                  # [B, S, K, M]
        mixed = (kin @ self.weight_bank).reshape(
            B, S, K, self.num_kernels, self.out_channels)
        out = (scores[..., None, :] @ mixed)[..., 0, :]
        return F.relu(self.bn(out))


class PAConvMLP(nn.Module):
    """The PAConv layers of a set abstraction, named ``layer{k}``."""

    def __init__(self, in_channels, channels, num_kernels):
        super().__init__()
        self.names = []
        for k, ch in enumerate(channels):
            self.add_module(f'layer{k}', PAConvLayer(in_channels, ch,
                                                     num_kernels))
            self.names.append(f'layer{k}')
            in_channels = ch

    def forward(self, h, rel, center_xyz, mask):
        for name in self.names:
            h = getattr(self, name)(h, rel, center_xyz, mask)
        return h


def paconv_regularization_loss(model, num_kernels=8, reduction='mean'):
    """The mean (or sum), over every PAConv weight bank of ``model``, of
    the upper-triangular squared cosine similarities between its M
    kernels (mmdet3d's paconv_regularization_loss, gga_tpu's)."""
    out = []
    for name, bank in model.named_parameters():
        if not name.endswith('weight_bank'):
            continue
        cin, m = bank.shape[0], num_kernels
        flat = bank.reshape(cin, m, -1).permute(1, 0, 2).reshape(m, -1)
        inner = flat @ flat.T
        norms = (flat * flat).sum(-1, keepdim=True).sqrt()
        cos = inner / (norms @ norms.T).clamp(min=1e-8)
        out.append((torch.triu(cos, 1) ** 2).sum())
    if not out:
        return torch.zeros(())
    total = torch.stack(out).sum()
    return total / len(out) if reduction == 'mean' else total


class PAConvSAModule(nn.Module):
    """Set abstraction with PAConv layers in place of the shared MLP
    (gga_tpu's ``PAConvSAModule``): farthest point sampling, a ball query,
    the PAConv layers, the max over each ball's members; 0 where the ball
    is empty or the centre invalid."""

    def __init__(self, num_point, radius, num_sample, in_channels, channels,
                 num_kernels=8):
        super().__init__()
        self.num_point = num_point
        self.radius = radius
        self.num_sample = num_sample
        self.mlps = nn.ModuleList([PAConvMLP(in_channels, channels,
                                             num_kernels)])

    def forward(self, xyz, feats, valid, sample_idx=None):
        """xyz [B, N, 3]; feats [B, N, C]; valid [B, N]; ``sample_idx``
        [B, S] the centres' indices, sampled here when None (kept in
        ``last_idx``). Returns (new_xyz, pooled [B, S, out], new_valid)."""
        new_xyz, new_valid, self.last_idx = centres(
            xyz, valid, None, None, sample_idx,
            lambda: po.furthest_point_sample(xyz, valid, self.num_point))
        grouped, mask = po.query_and_group(xyz, feats, new_xyz, self.radius,
                                           self.num_sample, p_valid=valid)
        h = self.mlps[0](grouped[..., 3:], grouped[..., :3], new_xyz, mask)
        pooled = torch.where(mask[..., None], h,
                             torch.finfo(h.dtype).min).amax(-2)
        return (new_xyz, torch.where((mask.any(-1) & new_valid)[..., None],
                                     pooled, 0.0), new_valid)


@dataclasses.dataclass(frozen=True)
class PAConvConfig:
    in_channels: int = 9
    num_points: Tuple[int, ...] = (1024, 256, 64, 16)
    radii: Tuple[float, ...] = (0.1, 0.2, 0.4, 0.8)
    num_samples: Tuple[int, ...] = (32, 32, 32, 32)
    sa_channels: Sequence[Tuple[int, ...]] = (
        (32, 32, 64), (64, 64, 128), (128, 128, 256), (256, 256, 512))
    fp_channels: Sequence[Tuple[int, ...]] = (
        (256, 256), (256, 256), (256, 128), (128, 128, 128))
    num_kernels: int = 8
    num_classes: int = 13
    head_channels: int = 128
    dropout: float = 0.5


class PAConvBackbone(nn.Module):
    def __init__(self, cfg: PAConvConfig):
        super().__init__()
        c = cfg
        self.SA_modules = nn.ModuleList()
        feat = c.in_channels - 3
        self.level_channels = [feat]
        for i, npoint in enumerate(c.num_points):
            self.SA_modules.append(PAConvSAModule(
                npoint, c.radii[i], c.num_samples[i], feat,
                c.sa_channels[i], c.num_kernels))
            feat = c.sa_channels[i][-1]
            self.level_channels.append(feat)


class PAConvSegmentor(Segmentor):
    """The PAConv SSG segmentor: PAConv set abstractions, then PAConvHead,
    whose last feature propagation takes the raw features (gga_tpu passes
    ``sa_feats[0]``, unlike PointNet2Head) and whose logits are not masked."""

    def __init__(self, cfg: PAConvConfig):
        super().__init__(cfg)
        self.backbone = PAConvBackbone(cfg)
        self.decode_head = PointNet2SegHead(
            self.backbone.level_channels, cfg.num_classes, cfg.fp_channels,
            cfg.head_channels, paconv=True)

    def forward(self, points, valid, keep=None, picks=None):
        """points [B, P, in_channels]; valid [B, P]; ``keep`` the dropout's
        keep mask (train mode); ``picks`` each level's [B, S] sampled
        indices, sampled here when None (kept in ``last_picks``).

        Returns per-point class logits [B, P, num_classes]."""
        self.check_input(points)
        xyz = points[..., :3].contiguous()
        sa_xyz, sa_feats, sa_valid = [xyz], [points[..., 3:]], [valid]
        for i, sa in enumerate(self.backbone.SA_modules):
            x, f, v = sa(sa_xyz[-1], sa_feats[-1], sa_valid[-1],
                         None if picks is None else picks[i])
            sa_xyz.append(x)
            sa_feats.append(f)
            sa_valid.append(v)
        self.last_picks = [sa.last_idx for sa in self.backbone.SA_modules]
        return self.decode_head(sa_xyz, sa_feats, sa_valid,
                                lambda h: self.dropout(h, keep))
