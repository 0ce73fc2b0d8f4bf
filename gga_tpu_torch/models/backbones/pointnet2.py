"""PointNet++ backbones (port of ``gga_tpu/models/backbones/pointnet2.py``
``SharedMLP``, ``PointSAModule``, ``PointFPModule``, ``PointNet2SASSG``,
``sample_points_multi_mode``, ``PointSAModuleMSG`` and ``PointNet2SAMSG``;
mmdet3d's PointNet2SASSG and PointNet2SAMSG): set abstraction layers
(farthest point sampling, ball query, a shared MLP, max pool) then, in
the single-scale encoder, feature propagation layers (three-NN
inverse-distance interpolation + MLP), on the plain point ops of
``ops/points.py``. The multi-scale encoder groups each level's centres at
several radii, one MLP a radius, concatenates the pooled branches and
applies a 1x1 aggregation layer; its sampling mixes D-FPS (xyz), F-FPS
(xyz and features) and FS (both) over ranges of the points (3DSSD).

Each MLP layer is a bias-free 1x1 conv, the port's ``MaskedBatchNorm``
and a ReLU, under mmdet3d's state_dict names (``mlps.{j}.layer{k}.conv``
/ ``.bn`` in a set abstraction, ``mlps.layer{k}`` in a feature
propagation, ``aggregation_mlps.{i}.conv`` / ``.bn`` after a multi-scale
level). A set abstraction's conv weights are Conv2d ``[O, I, 1, 1]``,
every other 1x1 weight Conv1d ``[O, I, 1]``, as gga_tpu's
``tools/model_converters/torch2flax.py export_votenet`` lays them out.

A set abstraction groups around given centres (``target_xyz``) or
samples its own; it keeps the indices it sampled (``last_idx``; both
encoders return them as ``sa_indices``) and takes them back through
``sample_idx``: a forward on the card can be given the CPU's picks, where
near-ties of the distances (features out of matrix products differ in
their last bits) would otherwise part the two.
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


def group_pool(mlp, xyz, features, valid, centers, center_valid, radius,
               num_sample, normalize_xyz):
    """One grouping branch of a set abstraction: ball query around
    ``centers``, the members' xyz relative to their centre (over the
    radius where ``normalize_xyz``) before their features, ``mlp``, and
    the max over each ball's members; 0 where the ball is empty or the
    centre invalid. Returns [B, S, C']."""
    grouped, mask = po.query_and_group(xyz, features, centers, radius,
                                       num_sample, p_valid=valid)
    if normalize_xyz:
        grouped = torch.cat([grouped[..., :3] / radius, grouped[..., 3:]],
                            -1)
    g = mlp(grouped, mask)
    pooled = torch.where(mask[..., None], g,
                         torch.finfo(g.dtype).min).amax(-2)
    return torch.where((mask.any(-1) & center_valid)[..., None], pooled, 0.0)


def centres(xyz, valid, target_xyz, target_valid, sample_idx, sample):
    """A set abstraction's centres: ``target_xyz`` / ``target_valid`` where
    given (H3DNet's matchers, 3DSSD's 'spec' grouping), else the points at
    ``sample_idx``, ``sample()``'s indices when None. Returns (new_xyz
    [B, S, 3], new_valid [B, S], the indices or None)."""
    if target_xyz is not None:
        return target_xyz, target_valid, None
    idx = sample() if sample_idx is None else sample_idx
    return po.gather_points(xyz, idx), valid.gather(1, idx), idx


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

    def forward(self, xyz, features, valid, sample_idx=None, target_xyz=None,
                target_valid=None):
        """xyz [B, N, 3]; features [B, N, C] or None; valid [B, N];
        ``target_xyz`` [B, S, 3] / ``target_valid`` [B, S] the given
        centres; else ``sample_idx`` [B, S] their indices, sampled here
        when None.

        Returns (new_xyz [B, S, 3], pooled features [B, S, C'], new_valid
        [B, S]): the S centres (by farthest point sampling unless given),
        each with the max over its ball's members of the MLP's output
        (``finfo.min`` where the ball is empty), 0 where the ball is empty
        or the centre invalid. The sampled indices (None for given
        centres) are kept in ``self.last_idx``."""
        new_xyz, new_valid, self.last_idx = centres(
            xyz, valid, target_xyz, target_valid, sample_idx,
            lambda: po.furthest_point_sample(xyz, valid, self.num_point))
        pooled = group_pool(self.mlps[0], xyz, features, valid, new_xyz,
                            new_valid, self.radius, self.num_sample, True)
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

    def forward(self, points, valid, sample_idx=None):
        """points [B, P, in_channels] (xyz + features); valid [B, P];
        ``sample_idx`` a list of each level's [B, S] centre indices, or
        None to sample.

        Returns dict: fp_xyz / fp_features / fp_valid (the last feature
        propagation's level), the sa_xyz / sa_features / sa_valid lists
        (input level first) and sa_indices (each level's sampled
        indices)."""
        xyz = points[..., :3].contiguous()
        feats = points[..., 3:] if points.shape[-1] > 3 else None
        sa_xyz, sa_feats, sa_valid = [xyz], [feats], [valid]
        for i, sa in enumerate(self.SA_modules):
            x, f, v = sa(sa_xyz[-1], sa_feats[-1], sa_valid[-1],
                         None if sample_idx is None else sample_idx[i])
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
                    sa_xyz=sa_xyz, sa_features=sa_feats, sa_valid=sa_valid,
                    sa_indices=[sa.last_idx for sa in self.SA_modules])


def sample_points_multi_mode(xyz, features, valid, num_points, fps_mods,
                             fps_sample_ranges):
    """Multi-mode farthest point sampling over consecutive ranges of the
    points (gga_tpu ``sample_points_multi_mode``, mmcv's PointsSampler),
    batched over scenes: each (mode, range, count) triple samples from
    the next ``range`` points (-1: the rest); 'D-FPS' by xyz distance,
    'F-FPS' by the distance over [xyz, features], 'FS' both, the F-FPS
    half first (3DSSD's next level takes that half by its range).

    Args:
        xyz: [B, N, 3]; features: [B, N, C]; valid: [B, N].
    Returns:
        [B, sum of the counts (twice for 'FS')] int64 indices into N.
    """
    N = xyz.shape[1]
    parts = []
    start = 0
    for mod, rng, npt in zip(fps_mods, fps_sample_ranges, num_points):
        end = N if rng == -1 else start + rng
        sub_xyz, sub_valid = xyz[:, start:end], valid[:, start:end]
        if mod in ('F-FPS', 'FS'):
            sub = torch.cat([sub_xyz, features[:, start:end]], -1)
            parts.append(po.furthest_point_sample(sub, sub_valid, npt)
                         + start)
        if mod in ('D-FPS', 'FS'):
            parts.append(po.furthest_point_sample(sub_xyz, sub_valid, npt)
                         + start)
        start = end
    return torch.cat(parts, -1)


class PointSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (gga_tpu ``PointSAModuleMSG``
    without its aggregation layer, which mmdet3d keeps in the backbone:
    ``PointNet2SAMSG.aggregation_mlps``): one set of centres, one branch
    (radius, samples, MLP) a scale, the pooled branches concatenated.
    The centres come from ``sample_points_multi_mode`` or, 3DSSD's 'spec'
    grouping, are given (``target_xyz``). gga_tpu's MSG module does not
    normalize the relative xyz (both consumers' sa_cfg set
    ``normalize_xyz=False``)."""

    def __init__(self, num_point, radii, num_samples, in_channels,
                 mlp_channels, fps_mods=('D-FPS',), fps_sample_ranges=(-1,),
                 normalize_xyz=False):
        super().__init__()
        self.num_point = ((num_point,) if isinstance(num_point, int)
                          else tuple(num_point))
        self.radii = tuple(radii)
        self.num_samples = tuple(num_samples)
        self.fps_mods = tuple(fps_mods)
        self.fps_sample_ranges = tuple(fps_sample_ranges)
        self.normalize_xyz = normalize_xyz
        self.mlps = nn.ModuleList([SharedMLP(3 + in_channels, m, conv2d=True)
                                   for m in mlp_channels])
        self.out_channels = sum(m[-1] for m in mlp_channels)

    def forward(self, xyz, features, valid, target_xyz=None,
                target_valid=None, sample_idx=None):
        """xyz [B, N, 3]; features [B, N, C] or None; valid [B, N].
        ``target_xyz`` [B, S, 3] / ``target_valid`` [B, S] the given
        centres; else ``sample_idx`` [B, S] their indices, sampled here
        when None.

        Returns (new_xyz [B, S, 3], features [B, S, sum of the branches'
        widths], new_valid [B, S]); the sampled indices (None for given
        centres) are kept in ``self.last_idx``."""
        feats = (features if features is not None
                 else xyz.new_zeros(xyz.shape[:-1] + (0,)))
        new_xyz, new_valid, self.last_idx = centres(
            xyz, valid, target_xyz, target_valid, sample_idx,
            lambda: sample_points_multi_mode(
                xyz, feats, valid, self.num_point, self.fps_mods,
                self.fps_sample_ranges))
        outs = [group_pool(mlp, xyz, features, valid, new_xyz, new_valid,
                           radius, nsample, self.normalize_xyz)
                for mlp, radius, nsample in zip(self.mlps, self.radii,
                                                self.num_samples)]
        return new_xyz, torch.cat(outs, -1), new_valid


class PointNet2SAMSG(nn.Module):
    """Multi-scale-grouping PointNet++ encoder (gga_tpu ``PointNet2SAMSG``,
    mmdet3d's): a ``PointSAModuleMSG`` a level, each followed by its
    aggregation layer (a ConvBN + ReLU of ``aggregation_channels[i]``, none
    at 0), with per-level sampling modes and ranges (``fps_mods``,
    ``fps_sample_range_lists``; D-FPS over all points where None).
    ``in_channels`` counts xyz."""

    def __init__(self, in_channels=4, num_points=(4096, 512, 256),
                 radii=((0.2, 0.4, 0.8), (0.4, 0.8, 1.6), (1.6, 3.2, 4.8)),
                 num_samples=((32, 32, 64), (32, 32, 64), (32, 32, 32)),
                 sa_channels=(((16, 16, 32), (16, 16, 32), (32, 32, 64)),
                              ((64, 64, 128), (64, 64, 128), (64, 96, 128)),
                              ((128, 128, 256), (128, 192, 256),
                               (128, 256, 256))),
                 aggregation_channels=(64, 128, 256), fps_mods=None,
                 fps_sample_range_lists=None):
        super().__init__()
        self.SA_modules = nn.ModuleList()
        self.aggregation_mlps = nn.ModuleList()
        feat = in_channels - 3
        self.level_channels = [feat]
        for i, npt in enumerate(num_points):
            sa = PointSAModuleMSG(
                npt, radii[i], num_samples[i], feat, sa_channels[i],
                fps_mods=('D-FPS',) if fps_mods is None else fps_mods[i],
                fps_sample_ranges=((-1,) if fps_sample_range_lists is None
                                   else fps_sample_range_lists[i]))
            self.SA_modules.append(sa)
            feat = sa.out_channels
            agg = aggregation_channels[i]
            self.aggregation_mlps.append(
                ConvBN(feat, agg) if agg else None)
            feat = agg or feat
            self.level_channels.append(feat)
        self.out_channels = feat

    def forward(self, points, valid, sample_idx=None):
        """points [B, P, in_channels] (xyz + features); valid [B, P];
        ``sample_idx`` a list of each level's [B, S] centre indices, or
        None to sample.

        Returns dict: sa_xyz / sa_features / sa_valid lists (input level
        first), fp_xyz / fp_features / fp_valid (the last level) and
        sa_indices (each level's sampled indices)."""
        xyz = points[..., :3].contiguous()
        feats = points[..., 3:] if points.shape[-1] > 3 else None
        sa_xyz, sa_feats, sa_valid, sa_idx = [xyz], [feats], [valid], []
        for i, (sa, agg) in enumerate(zip(self.SA_modules,
                                          self.aggregation_mlps)):
            x, f, v = sa(sa_xyz[-1], sa_feats[-1], sa_valid[-1],
                         sample_idx=None if sample_idx is None
                         else sample_idx[i])
            if agg is not None:
                f = agg(f, v)
            sa_xyz.append(x)
            sa_feats.append(f)
            sa_valid.append(v)
            sa_idx.append(sa.last_idx)
        return dict(sa_xyz=sa_xyz, sa_features=sa_feats, sa_valid=sa_valid,
                    fp_xyz=sa_xyz[-1], fp_features=sa_feats[-1],
                    fp_valid=sa_valid[-1], sa_indices=sa_idx)
