"""DGCNN backbone and segmentor (port of
``gga_tpu/models/backbones/dgcnn.py``; mmdet3d's DGCNNBackbone, its GF and
FA modules, and DGCNNHead): each graph-feature module builds a k-NN graph
(D-KNN on the last three channels for the first module, F-KNN on all the
features after), forms edge features [neighbour - centre | centre], runs a
shared MLP and takes the max over the valid neighbours; the FA module
concatenates the GF outputs, lifts them and appends their global max; the
head is an MLP, the pre-seg ConvBN, dropout and the class layer.

The graph is gga_tpu's ``masked_knn_graph`` on the CPU's bits: the
squared distance ``((f_i - f_j) ** 2).sum(-1)`` accumulated in XLA's CPU
order (``ops.points.pairwise_squared_diff``), invalid columns at inf, the
k smallest with ties by the lower index (``jax.lax.top_k``'s order), so a
row with fewer than k valid points takes padding in index order. The
[B, N, N, C] difference gga_tpu builds (137 GB at the S3DIS config) is
never held: the distances come one coordinate at a time, for as many
scenes and query rows as ``KNN_ELEMENTS`` allows.

An edge MLP's BatchNorm is masked by ``valid[:, :, None]``, as gga_tpu's:
its count is the valid points, not the valid edges, while its sums run
over every neighbour slot.

mmdet3d's names: ``backbone.GF_modules.{i}.mlps.layer{k}`` (Conv2d
weights), ``backbone.FA_module.mlps.layer{k}``,
``decode_head.FP_module.mlps.layer{k}``, ``decode_head.pre_seg_conv`` and
``decode_head.conv_seg``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn

from ...ops import points as po
from ..segmentors.base import Segmentor
from .pointnet2 import ConvBN, PointConv, SharedMLP

# entries of the [scenes, query rows, N] distance blocks one pass of
# ``masked_knn_graph`` holds (float64 at D <= 32: 512 MB); the S3DIS
# config's 4 096 points a scene take four scenes a pass
KNN_ELEMENTS = 1 << 26


def masked_knn_graph(feats, valid, k):
    """[B, N, C] features, [B, N] valid -> [B, N, k] int64 indices of each
    point's k nearest valid points by squared distance (itself included),
    nearest first, ties by the lower index. No gradient flows."""
    B, N, _ = feats.shape
    per = max(1, KNN_ELEMENTS // max(N, 1))
    scenes, rows = max(1, per // N), min(N, per)
    out = torch.empty(B, N, k, dtype=torch.long, device=feats.device)
    with torch.no_grad():
        for s in range(0, B, scenes):
            f, v = feats[s:s + scenes], valid[s:s + scenes]
            for r in range(0, N, rows):
                d = po.pairwise_squared_diff(f[:, r:r + rows], f)
                d = torch.where(v[:, None, :], d, float('inf'))
                out[s:s + scenes, r:r + rows] = po.smallest(d, k)[1]
    return out


class DGCNNGFModule(nn.Module):
    """Graph-feature module (mmdet3d's DGCNNGFModule); ``in_channels`` is
    the input feature width."""

    def __init__(self, in_channels, mlp_channels, num_sample=20,
                 knn_mode='F-KNN'):
        super().__init__()
        self.num_sample = num_sample
        self.knn_mode = knn_mode
        self.mlps = SharedMLP(2 * in_channels, mlp_channels, conv2d=True)
        self.last_graph = None

    def forward(self, feats, valid, graph=None):
        """feats [B, N, C]; valid [B, N]; ``graph`` [B, N, k], built here
        when None (kept in ``last_graph``). Returns [B, N, mlp[-1]], 0 at
        padding."""
        if graph is None:
            key = feats[..., -3:] if self.knn_mode == 'D-KNN' else feats
            graph = masked_knn_graph(key, valid, self.num_sample)
        self.last_graph = graph
        B, N, K = graph.shape
        ctr = feats[:, :, None, :]
        grouped = po.group_points(feats, graph)
        edge = torch.cat([grouped - ctr, ctr.expand_as(grouped)], -1)
        g = self.mlps(edge, valid[:, :, None])
        nb_valid = valid.gather(1, graph.reshape(B, N * K)).reshape(B, N, K)
        pooled = torch.where(nb_valid[..., None], g,
                             torch.finfo(g.dtype).min).amax(-2)
        return torch.where(valid[..., None], pooled, 0.0)


@dataclasses.dataclass(frozen=True)
class DGCNNConfig:
    in_channels: int = 9         # s3dis: xyz + rgb + normalized xyz
    num_samples: Tuple[int, ...] = (20, 20, 20)
    knn_modes: Tuple[str, ...] = ('D-KNN', 'F-KNN', 'F-KNN')
    gf_channels: Sequence[Tuple[int, ...]] = ((64, 64), (64, 64), (64,))
    fa_channels: Tuple[int, ...] = (1024,)
    # head (mmdet3d's decode_heads/dgcnn_head.py + the s3dis config)
    num_classes: int = 13
    fp_channels: Tuple[int, ...] = (512,)
    head_channels: int = 256
    dropout: float = 0.5


class DGCNNFAModule(nn.Module):
    def __init__(self, in_channels, mlp_channels):
        super().__init__()
        self.mlps = SharedMLP(in_channels, mlp_channels)


class DGCNNBackbone(nn.Module):
    def __init__(self, cfg: DGCNNConfig):
        super().__init__()
        c = cfg
        self.GF_modules = nn.ModuleList()
        feat, cat = c.in_channels, 0
        for i, mlps in enumerate(c.gf_channels):
            self.GF_modules.append(DGCNNGFModule(
                feat, mlps, c.num_samples[i], c.knn_modes[i]))
            feat = mlps[-1]
            cat += feat
        self.FA_module = DGCNNFAModule(cat, c.fa_channels)
        self.out_channels = c.fa_channels[-1] + cat

    def forward(self, points, valid, graphs=None):
        """points [B, N, C]; ``graphs`` each GF module's [B, N, k] or None.
        Returns the FA features [B, N, fa[-1] + the GF widths]: the global
        max of the lifted features, then the GF outputs."""
        gf = [points]
        for i, m in enumerate(self.GF_modules):
            gf.append(m(gf[-1], valid, None if graphs is None else graphs[i]))
        cat = torch.cat(gf[1:], -1)
        lifted = self.FA_module.mlps(cat, valid)
        gmax = torch.where(valid[..., None], lifted,
                           torch.finfo(lifted.dtype).min).amax(1, keepdim=True)
        return torch.cat([gmax.expand_as(lifted), cat], -1)


class DGCNNHead(nn.Module):
    def __init__(self, in_channels, cfg: DGCNNConfig):
        super().__init__()
        self.FP_module = DGCNNFAModule(in_channels, cfg.fp_channels)
        self.pre_seg_conv = ConvBN(cfg.fp_channels[-1], cfg.head_channels)
        self.conv_seg = PointConv(cfg.head_channels, cfg.num_classes,
                                  bias=True)

    def forward(self, fa, valid, dropout):
        """The FA features [B, N, C] -> logits [B, N, num_classes];
        ``dropout`` applied to the pre-seg features."""
        h = self.pre_seg_conv(self.FP_module.mlps(fa, valid), valid)
        return self.conv_seg(dropout(h))


class DGCNNSegmentor(Segmentor):
    """``DGCNNBackbone`` + ``DGCNNHead`` (gga_tpu's ``DGCNNSegmentor``)."""

    def __init__(self, cfg: DGCNNConfig):
        super().__init__(cfg)
        self.backbone = DGCNNBackbone(cfg)
        self.decode_head = DGCNNHead(self.backbone.out_channels, cfg)

    def forward(self, points, valid, keep=None, picks=None):
        """points [B, N, in_channels]; valid [B, N]; ``keep`` the dropout's
        keep mask (train mode); ``picks`` each GF module's [B, N, k] graph,
        built here when None (kept in ``last_picks``).

        Returns per-point class logits [B, N, num_classes] (padding not
        zeroed, as gga_tpu's)."""
        self.check_input(points)
        fa = self.backbone(points, valid, picks)
        self.last_picks = [m.last_graph for m in self.backbone.GF_modules]
        return self.decode_head(fa, valid, lambda h: self.dropout(h, keep))
