"""Sparse 3D ResNet backbone of the FCAF3D detector (port of
``gga_tpu/models/backbones/mink_resnet.py``; mmdet3d's MinkResNet on
MinkowskiEngine): conv1 k3 s2 + instance norm + ReLU + max pool k2 s2,
then four stages of BasicBlocks whose first block carries the stride 2
(a k3 s2 conv beside a 1x1 s2 identity projection evaluated at the same
output sites, as MinkowskiEngine's shared coordinate manager gives).

Every conv runs batch-flat on ``[B*N, C]`` rows: strided convs through
``ops.sparse.RulebookConvFunction`` on ``downsample_rulebook_batched``'s
maps, submanifold convs through ``SubMConvFunction`` on one neighbor map
per coordinate set, shared by the stride-1 blocks of a stage; both launch
``kernels.sparse_conv``'s gather-GEMM kernels on the card. The 1x1
identity is a row gather and ``torch.matmul``, as gga_tpu computes it
outside Pallas. Norms run on ``[B, N, C]``.

State-dict names follow mmdet3d's MinkResNet (``conv1.kernel``,
``norm1.weight``, ``layer1.0.conv1.kernel``, ``layer1.0.norm1.bn.*``,
``layer1.0.downsample.0.kernel``, ``layer1.0.downsample.1.bn.*``), but the
kernels keep gga_tpu's ``[K, C, D]`` layout with its (z, y, x) row-major
offset order (the 1x1 projection ``[1, C, D]``), and the instance norm's
affine parameters are ``[C]``: a MinkowskiEngine checkpoint needs its
kernels reordered to load.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import sparse as sp
from ..layers import MaskedBatchNorm, flatten_nmap

ARCH = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


class MinkConv(nn.Module):
    """A sparse conv's kernel ``[K, C, D]`` (MinkowskiConvolution's
    ``kernel``); the conv itself is the caller's, on its own map."""

    def __init__(self, k, in_channels, out_channels):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(k, in_channels, out_channels))


class MinkBatchNorm(nn.Module):
    """``MaskedBatchNorm`` under MinkowskiBatchNorm's ``bn`` child."""

    def __init__(self, channels):
        super().__init__()
        self.bn = MaskedBatchNorm(channels)

    def forward(self, x, valid):
        return self.bn(x, valid)


class MaskedInstanceNorm(nn.Module):
    """Per-scene instance norm over the active voxels (eps 1e-5;
    MinkowskiInstanceNorm after conv1); 0 on padding rows."""

    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, valid):
        """x [B, N, C]; valid [B, N]."""
        m = valid[..., None].float()
        cnt = m.sum(1, keepdim=True).clamp(min=1.0)
        mean = (x * m).sum(1, keepdim=True) / cnt
        var = (((x - mean) ** 2) * m).sum(1, keepdim=True) / cnt
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return torch.where(valid[..., None], y, 0.0)


def subm(kernel, feats, valid, nmap):
    """Batch-flat submanifold conv of [B, N, C] rows on a flat map."""
    B, N, C = feats.shape
    out = sp.SubMConvFunction.apply(feats.reshape(B * N, C),
                                    valid.reshape(-1), nmap, kernel)
    return out.reshape(B, N, kernel.shape[-1])


def subm_map(coords, valid, grid):
    """The flat [27, B*N] neighbor map of a coordinate set."""
    return flatten_nmap(sp.build_neighbor_map(coords, valid, grid))


def strided_conv(kernel, feats, coords, valid, grid, out_budget):
    """k3 s2 p1 sparse conv on a fresh rulebook -> (feats [B, M, D],
    coords, valid, grid)."""
    B, N, C = feats.shape
    oc, ov, og, fwd, bwd = sp.downsample_rulebook_batched(
        coords, valid, grid, 3, 2, 1, out_budget)
    out = sp.RulebookConvFunction.apply(
        feats.reshape(B * N, C), kernel, fwd, bwd, ov.reshape(-1))
    return out.reshape(B, out_budget, kernel.shape[-1]), oc, ov, og


class MinkBasicBlock(nn.Module):
    """BasicBlock; ``stride=2`` downsamples inside the block (gga_tpu
    ``MinkBasicBlock``). ``forward`` returns (feats, coords, valid, grid,
    nmap): ``nmap`` is the output set's flat neighbor map, which the
    stride-1 blocks of the stage reuse."""

    def __init__(self, in_channels, channels, stride=1, out_budget=4096):
        super().__init__()
        self.stride = stride
        self.out_budget = out_budget
        self.conv1 = MinkConv(27, in_channels, channels)
        self.norm1 = MinkBatchNorm(channels)
        self.conv2 = MinkConv(27, channels, channels)
        self.norm2 = MinkBatchNorm(channels)
        self.downsample = None
        if stride != 1 or in_channels != channels:
            self.downsample = nn.ModuleList([
                MinkConv(1, in_channels, channels), MinkBatchNorm(channels)])

    def forward(self, feats, coords, valid, grid, nmap=None):
        B, N, cin = feats.shape
        if self.stride == 1:
            if nmap is None:
                nmap = subm_map(coords, valid, grid)
            x = subm(self.conv1.kernel, feats, valid, nmap)
            oc, ov, og = coords, valid, grid
            identity = feats
        else:
            x, oc, ov, og = strided_conv(self.conv1.kernel, feats, coords,
                                         valid, grid, self.out_budget)
            nmap = subm_map(oc, ov, og)
            # identity: the input row at 2 * site, gathered through the
            # INPUT set's rows (n_in = N), then the 1x1 projection
            pos = flatten_nmap(sp.neighbor_map(coords, valid, grid, oc, ov,
                                               1, 2, 0), n_in=N)[0]
            rows = feats.reshape(B * N, cin)[pos.long().clamp(min=0)]
            idf = torch.where(pos[:, None] >= 0, rows, 0).reshape(
                B, self.out_budget, cin)
            proj, bn_down = self.downsample
            identity = bn_down(torch.matmul(idf, proj.kernel[0]), ov)
        x = F.relu(self.norm1(x, ov))
        x = self.norm2(subm(self.conv2.kernel, x, ov, nmap), ov)
        if self.stride == 1 and self.downsample is not None:
            proj, bn_down = self.downsample
            identity = bn_down(torch.matmul(identity, proj.kernel[0]), ov)
        out = torch.where(ov[..., None], F.relu(x + identity), 0.0)
        return out, oc, ov, og, nmap


class MinkResNet(nn.Module):
    """MinkResNet 18 / 34. ``budgets``: the active sites a scene keeps
    after conv1, after the pool, then after each stage's stride."""

    def __init__(self, depth=34, in_channels=3, base_planes=64,
                 budgets=(65536, 32768, 16384, 8192, 4096, 2048)):
        super().__init__()
        self.budgets = tuple(budgets)
        self.conv1 = MinkConv(27, in_channels, base_planes)
        self.norm1 = MaskedInstanceNorm(base_planes)
        cin, planes = base_planes, base_planes
        for i, n_blocks in enumerate(ARCH[depth]):
            blocks = []
            for j in range(n_blocks):
                blocks.append(MinkBasicBlock(
                    cin, planes, stride=2 if j == 0 else 1,
                    out_budget=self.budgets[i + 2]))
                cin = planes
            setattr(self, f'layer{i + 1}', nn.ModuleList(blocks))
            planes *= 2
        self.n_stages = len(ARCH[depth])

    def forward(self, feats, coords, valid, grid, diag=None):
        """feats [B, N, C]; coords [B, N, 3] (z, y, x), each scene sorted;
        valid [B, N]. With a dict ``diag``, records the active sites of
        each scene ([B]) after each budget: ``active.conv1``,
        ``active.pool`` and ``active.layer1`` .. ``active.layer4``.

        Returns a list over the stages of (feats, coords, valid, grid)."""
        diag = {} if diag is None else diag
        f, c, v, g = strided_conv(self.conv1.kernel, feats, coords, valid,
                                  tuple(grid), self.budgets[0])
        diag['active.conv1'] = v.sum(-1)
        f = F.relu(self.norm1(f, v))
        pooled = sp.sparse_max_pool(sp.SparseTensor(f, c, v, g),
                                    out_budget=self.budgets[1])
        f, c, v, g = pooled.features, pooled.coords, pooled.valid, pooled.grid
        diag['active.pool'] = v.sum(-1)
        outs = []
        for i in range(self.n_stages):
            nmap = None
            for block in getattr(self, f'layer{i + 1}'):
                f, c, v, g, nmap = block(f, c, v, g, nmap)
            diag[f'active.layer{i + 1}'] = v.sum(-1)
            outs.append((f, c, v, g))
        return outs
