"""PointNet++ single-scale-grouping backbone (port of ``gga_tpu/models/
backbones/pointnet2.py`` ``SharedMLP``, ``PointSAModule``,
``PointFPModule`` and ``PointNet2SASSG``; mmdet3d's PointNet2SASSG): set
abstraction layers (farthest point sampling, ball query, a shared MLP,
max pool, ``normalize_xyz``) then feature propagation layers (three-NN
inverse-distance interpolation + MLP), on the plain point ops of
``ops/points.py``.

Each MLP layer is a bias-free 1x1 conv, the port's ``MaskedBatchNorm``
and a ReLU, under mmdet3d's state_dict names (``mlps.0.layer{k}.conv``
/ ``.bn`` in a set abstraction, ``mlps.layer{k}`` in a feature
propagation). A backbone set abstraction's conv weights are Conv2d
``[O, I, 1, 1]``, every other 1x1 weight Conv1d ``[O, I, 1]``, as
gga_tpu's ``tools/model_converters/torch2flax.py export_votenet`` lays
them out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import points as po
from ..layers import MaskedBatchNorm


class PointConv(nn.Module):
    """A 1x1 conv over the last dim: ``weight`` [O, I, 1] (or [O, I, 1, 1]
    with ``conv2d``), optional ``bias`` [O]."""

    def __init__(self, in_channels, out_channels, bias=False, conv2d=False):
        super().__init__()
        shape = (out_channels, in_channels) + ((1, 1) if conv2d else (1,))
        self.weight = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight.reshape(self.weight.shape[:2]),
                        self.bias)

    def init_weights(self, generator):
        """gga_tpu's ``conv_init`` (uniform in +-1/sqrt(fan_in)), bias 0."""
        bound = (1.0 / self.weight.shape[1]) ** 0.5
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.zero_()


class ConvBN(nn.Module):
    """1x1 conv (no bias) + MaskedBatchNorm + ReLU (mmdet3d ConvModule)."""

    def __init__(self, in_channels, out_channels, conv2d=False):
        super().__init__()
        self.conv = PointConv(in_channels, out_channels, conv2d=conv2d)
        self.bn = MaskedBatchNorm(out_channels)

    def forward(self, x, valid):
        return F.relu(self.bn(self.conv(x), valid))


class SharedMLP(nn.Module):
    """gga_tpu ``SharedMLP``: ConvBN layers named ``{prefix}{k}``
    (mmdet3d's ``layer{k}``; the vote module's bare Sequential has
    ``prefix=''``)."""

    def __init__(self, in_channels, channels, prefix='layer', conv2d=False):
        super().__init__()
        self.names = []
        for k, ch in enumerate(channels):
            self.add_module(f'{prefix}{k}', ConvBN(in_channels, ch, conv2d))
            self.names.append(f'{prefix}{k}')
            in_channels = ch

    def forward(self, x, valid):
        """x [..., C]; valid: a mask over the leading dims."""
        for name in self.names:
            x = getattr(self, name)(x, valid)
        return x


class PointSAModule(nn.Module):
    """Set abstraction (gga_tpu ``PointSAModule``; mmdet3d's with max
    pool, use_xyz and normalize_xyz). ``in_channels`` counts the input
    features, not the xyz."""

    def __init__(self, num_point, radius, num_sample, in_channels,
                 mlp_channels, conv2d=True):
        super().__init__()
        self.num_point = num_point
        self.radius = radius
        self.num_sample = num_sample
        self.mlps = nn.ModuleList([SharedMLP(3 + in_channels, mlp_channels,
                                             conv2d=conv2d)])

    def forward(self, xyz, features, valid):
        """xyz [B, N, 3]; features [B, N, C] or None; valid [B, N].

        Returns (new_xyz [B, S, 3], pooled features [B, S, C'], new_valid
        [B, S]): the S centres by farthest point sampling, each with the
        max over its ball's members of the MLP's output (``finfo.min``
        where the ball is empty), 0 where the ball is empty or the centre
        invalid."""
        idx = po.furthest_point_sample(xyz, valid, self.num_point)
        new_xyz = po.gather_points(xyz, idx)
        new_valid = valid.gather(1, idx)
        grouped, mask = po.query_and_group(xyz, features, new_xyz,
                                           self.radius, self.num_sample,
                                           p_valid=valid)
        rel = grouped[..., :3] / self.radius            # normalize_xyz
        grouped = torch.cat([rel, grouped[..., 3:]], -1)
        g = self.mlps[0](grouped, mask)
        pooled = torch.where(mask[..., None], g,
                             torch.finfo(g.dtype).min).amax(-2)
        pooled = torch.where((mask.any(-1) & new_valid)[..., None], pooled,
                             0.0)
        return new_xyz, pooled, new_valid


class PointFPModule(nn.Module):
    """Feature propagation (gga_tpu ``PointFPModule``): three-NN
    interpolation of the source features onto the targets, the targets'
    own features appended, then the MLP."""

    def __init__(self, in_channels, mlp_channels):
        super().__init__()
        self.mlps = SharedMLP(in_channels, mlp_channels)

    def forward(self, target_xyz, target_feats, source_xyz, source_feats,
                source_valid, target_valid):
        d, idx = po.three_nn(target_xyz, source_xyz, s_valid=source_valid)
        up = po.three_interpolate(source_feats, idx, d)
        if target_feats is not None:
            up = torch.cat([up, target_feats], -1)
        return self.mlps(up, target_valid)


class PointNet2SASSG(nn.Module):
    """gga_tpu ``PointNet2SASSG``: ``len(num_points)`` set abstractions,
    then ``len(fp_channels)`` feature propagations back up the levels."""

    def __init__(self, in_channels=4, num_points=(2048, 1024, 512, 256),
                 radii=(0.2, 0.4, 0.8, 1.2), num_samples=(64, 32, 16, 16),
                 sa_channels=((64, 64, 128), (128, 128, 256),
                              (128, 128, 256), (128, 128, 256)),
                 fp_channels=((256, 256), (256, 256))):
        super().__init__()
        self.SA_modules = nn.ModuleList()
        feat = in_channels - 3
        sa_out = [feat]
        for i, npoint in enumerate(num_points):
            self.SA_modules.append(PointSAModule(
                npoint, radii[i], num_samples[i], feat, sa_channels[i]))
            feat = sa_channels[i][-1]
            sa_out.append(feat)
        self.FP_modules = nn.ModuleList()
        for i, ch in enumerate(fp_channels):
            tgt = len(sa_out) - 2 - i
            self.FP_modules.append(PointFPModule(feat + sa_out[tgt], ch))
            feat = ch[-1]
        self.out_channels = feat

    def forward(self, points, valid):
        """points [B, P, in_channels] (xyz + features); valid [B, P].

        Returns dict: fp_xyz / fp_features / fp_valid (the last feature
        propagation's level) and the sa_xyz / sa_features / sa_valid
        lists (input level first)."""
        xyz = points[..., :3].contiguous()
        feats = points[..., 3:] if points.shape[-1] > 3 else None
        sa_xyz, sa_feats, sa_valid = [xyz], [feats], [valid]
        for sa in self.SA_modules:
            x, f, v = sa(sa_xyz[-1], sa_feats[-1], sa_valid[-1])
            sa_xyz.append(x)
            sa_feats.append(f)
            sa_valid.append(v)
        fp_x, fp_f, fp_v = sa_xyz[-1], sa_feats[-1], sa_valid[-1]
        for i, fp in enumerate(self.FP_modules):
            tgt = len(sa_xyz) - 2 - i
            fp_f = fp(sa_xyz[tgt], sa_feats[tgt], fp_x, fp_f, fp_v,
                      sa_valid[tgt])
            fp_x, fp_v = sa_xyz[tgt], sa_valid[tgt]
        return dict(fp_xyz=fp_x, fp_features=fp_f, fp_valid=fp_v,
                    sa_xyz=sa_xyz, sa_features=sa_feats, sa_valid=sa_valid)
