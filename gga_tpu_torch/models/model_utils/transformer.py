"""Transformer pieces for GroupFree3D (port of
``gga_tpu/models/model_utils/transformer.py``): mmdet3d's
ConvBNPositionalEncoding (``PositionalMLP``) and one decoder layer of
the BaseTransformerLayer stack of configs/_base_/models/groupfree3d.py
(self-attention -> norm -> cross-attention -> norm -> FFN -> norm, the
positional encodings added to the queries and keys, identity shortcuts).

The arithmetic is flax's, written out by hand:

- the attention is ``nn.MultiHeadDotProductAttention``'s: separate q / k
  / v projections with biases, the query divided by sqrt(head_dim)
  before the dot, masked keys set to ``finfo.min`` before the softmax,
  the weighted sum of the values and the out projection;
- the norms are flax's ``LayerNorm`` (eps 1e-6) and ``BatchNorm`` (eps
  1e-5, running statistics 0.9 old + 0.1 batch, biased), both with
  flax's variance E[x^2] - E[x]^2 clamped at 0;
- dropout is gga_tpu's: on the attention weights, one keep mask [M, N]
  shared by the scenes and heads (``broadcast_dropout``), and on the FFN
  hidden, one keep mask an entry; the kept entries are divided by the
  keep probability. The masks are inputs (``groupfree3d_draws`` draws
  them from the trainer's generator).

State_dict names are mmdet3d's: ``attentions.{0,1}.attn.in_proj_weight``
[3C, C] (q, k, v rows), ``in_proj_bias``, ``out_proj.weight`` /
``bias``; ``ffns.0.layers.0.0`` and ``ffns.0.layers.1`` (Linear);
``norms.{0,1,2}``; ``position_embedding_head.{0,1,3}`` (Conv1d, BN,
Conv1d).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..backbones.pointnet2 import PointConv


def _moments(x, dims):
    """flax's mean and fast variance over ``dims``."""
    mean = x.mean(dims)
    return mean, ((x * x).mean(dims) - mean * mean).clamp(min=0.0)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9)`` over the last dim of [..., C]
    (every entry counts, as flax's unmasked norm)."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x):
        if self.training:
            mean, var = _moments(x, tuple(range(x.dim() - 1)))
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm()`` over the last dim (eps 1e-6)."""

    def __init__(self, num_features, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        mean, var = _moments(x, -1)
        return (x - mean[..., None]) * (
            torch.rsqrt(var[..., None] + self.eps) * self.weight) + self.bias


class PositionalMLP(nn.Module):
    """ConvBNPositionalEncoding: 1x1 conv + BN + ReLU + 1x1 conv."""

    def __init__(self, in_channels, embed_dim):
        super().__init__()
        self.position_embedding_head = nn.Sequential(
            PointConv(in_channels, embed_dim, bias=True), BatchNorm(embed_dim),
            nn.ReLU(), PointConv(embed_dim, embed_dim, bias=True))

    def forward(self, x):
        h = self.position_embedding_head
        return h[3](F.relu(h[1](h[0](x))))


class MultiheadAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` under the names of torch's
    ``nn.MultiheadAttention``."""

    def __init__(self, embed_dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, key, value, key_valid=None, keep=None,
                keep_prob=1.0):
        """query [B, M, C]; key, value [B, N, C]; key_valid [B, N] or
        None; ``keep`` [M, N] bool, the dropout's keep mask of the
        attention weights (None: no dropout). Returns [B, M, C]."""
        B, M, C = query.shape
        h = self.num_heads
        w_q, w_k, w_v = self.in_proj_weight.chunk(3)
        b_q, b_k, b_v = self.in_proj_bias.chunk(3)
        q = F.linear(query, w_q, b_q).reshape(B, M, h, C // h)
        k = F.linear(key, w_k, b_k).reshape(B, -1, h, C // h)
        v = F.linear(value, w_v, b_v).reshape(B, -1, h, C // h)
        q = q / torch.tensor(C // h, dtype=q.dtype).sqrt()
        w = torch.einsum('bqhd,bkhd->bhqk', q, k)
        if key_valid is not None:
            w = torch.where(key_valid[:, None, None, :], w,
                            torch.finfo(w.dtype).min)
        w = torch.softmax(w, -1)
        if keep is not None:
            w = w * (keep.to(w.dtype) / keep_prob)
        x = torch.einsum('bhqk,bkhd->bqhd', w, v).reshape(B, M, C)
        return self.out_proj(x)


class GroupFree3DMHA(nn.Module):
    """mmdet3d's GroupFree3DMHA: the attention under ``attn``."""

    def __init__(self, embed_dim, num_heads):
        super().__init__()
        self.attn = MultiheadAttention(embed_dim, num_heads)

    def forward(self, *args, **kwargs):
        return self.attn(*args, **kwargs)


class FFN(nn.Module):
    def __init__(self, embed_dim, ffn_dim):
        super().__init__()
        self.layers = nn.Sequential(nn.Sequential(nn.Linear(embed_dim,
                                                            ffn_dim)),
                                    nn.Linear(ffn_dim, embed_dim))

    def forward(self, x, keep=None, keep_prob=1.0):
        h = F.relu(self.layers[0][0](x))
        if keep is not None:
            h = torch.where(keep, h / keep_prob, 0.0)
        return self.layers[1](h)


class GroupFree3DDecoderLayer(nn.Module):
    def __init__(self, embed_dim, num_heads=8, ffn_dim=2048, dropout=0.1):
        super().__init__()
        self.dropout = dropout
        self.attentions = nn.ModuleList([
            GroupFree3DMHA(embed_dim, num_heads) for _ in range(2)])
        self.ffns = nn.ModuleList([FFN(embed_dim, ffn_dim)])
        self.norms = nn.ModuleList([LayerNorm(embed_dim) for _ in range(3)])

    def forward(self, query, query_pos, key, key_pos, key_valid, keep=None):
        """query [B, M, C]; key [B, N, C]; key_valid [B, N]; ``keep`` the
        layer's dropout keep masks (dict: 'self' [M, M], 'cross' [M, N],
        'ffn' [B, M, ffn_dim]) in train mode at a dropout above 0, else
        None."""
        p = 1.0 - self.dropout
        keep = keep or {}
        q_in = query + query_pos
        attn = self.attentions[0](q_in, q_in, query, keep=keep.get('self'),
                                  keep_prob=p)
        query = self.norms[0](query + attn)
        attn = self.attentions[1](query + query_pos, key + key_pos, key,
                                  key_valid, keep.get('cross'), p)
        query = self.norms[1](query + attn)
        return self.norms[2](query + self.ffns[0](query, keep.get('ffn'), p))
