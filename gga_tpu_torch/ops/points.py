"""Point-cloud neighbour ops (port of the parts of ``gga_tpu/ops/points.py``
that SASSD's auxiliary branch needs): squared distances, k nearest
neighbours, three-NN and inverse-distance interpolation, batched over
scenes.

gga_tpu computes these with XLA, not Pallas, so they are plain PyTorch.
Distances follow gga_tpu's formula ``|a|^2 + |b|^2 - 2 a.b`` (clamped at
0), which loses most of its digits to cancellation far from the origin;
the port keeps the formula, since the neighbours it picks are part of
the result. The norms accumulate as XLA's reduction does on the CPU (one
fused multiply-add a coordinate, emulated in float64), the dot product is
a full f32 matrix product (TF32 is off on the card, ``device.py``), and
neighbours are ordered by (distance, index), so equal distances keep
``jax.lax.top_k``'s order: the lower index first.
"""
from __future__ import annotations

import torch

BIG = 1e10
# query rows a block of the [B, rows, M] distance matrix holds: SASSD's
# 16 000 voxel means against 16 000 sites would otherwise take 1 GB a
# scene and stage
QUERY_BLOCK = 2048


def squared_norm(x):
    """[..., 3] -> [...] f32 ``x0^2 + x1^2 + x2^2``, accumulated as XLA's
    CPU reduction does: x0 * x0 rounded, then one fused multiply-add for
    each further coordinate (exact products in float64, one rounding a
    step)."""
    x64 = x.double()
    acc = (x[..., 0] * x[..., 0]).double()
    for i in range(1, x.shape[-1]):
        acc = (acc + x64[..., i] * x64[..., i]).float().double()
    return acc.float()


def square_distance(a, b, a_valid=None, b_valid=None):
    """[B, N, 3] x [B, M, 3] -> [B, N, M] squared euclidean distances
    (gga_tpu ``square_distance``); entries of invalid points are ``BIG``."""
    d = (squared_norm(a)[..., :, None] + squared_norm(b)[..., None, :]
         - 2 * torch.matmul(a, b.transpose(-1, -2)))
    d = d.clamp(min=0.0)
    if a_valid is not None:
        d = torch.where(a_valid[..., :, None], d, BIG)
    if b_valid is not None:
        d = torch.where(b_valid[..., None, :], d, BIG)
    return d


def _smallest(d, k):
    """The k smallest entries of each row of ``d`` (>= 0) and their
    columns, by the lower column first among equal values.

    A top-(k + 1) of the values, its candidates ordered by (value,
    column): where the k-th candidate is below the (k + 1)-th, no entry
    outside them can tie it, so the first k are the answer. The rows
    where they tie (exact ties at the boundary, or fewer than k + 1 valid
    entries) are taken again by a top-k of int64 keys (the f32 bits,
    monotone for non-negative floats, above the column)."""
    vals, idx = torch.topk(d, k + 1, dim=-1, largest=False)
    o = torch.argsort(idx, dim=-1)      # by column, then stably by value
    vals, idx = vals.gather(-1, o), idx.gather(-1, o)
    o = torch.sort(vals, dim=-1, stable=True).indices
    vals, idx = vals.gather(-1, o), idx.gather(-1, o)
    tied = vals[..., k - 1] == vals[..., k]
    vals, idx = vals[..., :k], idx[..., :k]
    if bool(tied.any()):
        rows = d[tied]
        cols = torch.arange(d.shape[-1], device=d.device)
        key = ((rows + 0.0).view(torch.int32).long() << 32) | cols
        i = torch.topk(key, k, dim=-1, largest=False, sorted=True).indices
        vals[tied], idx[tied] = rows.gather(-1, i), i
    return vals, idx


def knn(query, support, k, q_valid=None, s_valid=None):
    """k nearest supports of each query -> (indices [B, Q, k] int64,
    squared distances [B, Q, k]), nearest first (gga_tpu ``knn``). No
    gradient flows; the distance matrix is built ``QUERY_BLOCK`` query
    rows at a time."""
    dists, idx = [], []
    with torch.no_grad():
        for s in range(0, query.shape[-2], QUERY_BLOCK):
            q = query[..., s:s + QUERY_BLOCK, :]
            qv = None if q_valid is None else q_valid[..., s:s + QUERY_BLOCK]
            d, i = _smallest(square_distance(q, support, qv, s_valid), k)
            dists.append(d)
            idx.append(i)
    return torch.cat(idx, -2), torch.cat(dists, -2)


def three_nn(query, support, s_valid=None):
    """3 nearest supports a query -> (squared distances [B, Q, 3],
    indices [B, Q, 3]) (gga_tpu ``three_nn``)."""
    idx, d = knn(query, support, 3, s_valid=s_valid)
    return d, idx


def three_interpolate(features, idx, dist2, eps=1e-8):
    """Inverse-distance weighted interpolation (gga_tpu
    ``three_interpolate``, mmcv's).

    Args:
        features: [B, M, C] support features.
        idx: [B, Q, 3]; dist2: [B, Q, 3] squared distances.
    Returns:
        [B, Q, C] in the features' dtype; the gradient reaches
        ``features`` only.
    """
    w = 1.0 / dist2.clamp(min=eps)
    w = w / w.sum(-1, keepdim=True)
    B, Q, S = idx.shape
    g = features.gather(1, idx.reshape(B, Q * S, 1).expand(
        B, Q * S, features.shape[-1])).reshape(B, Q, S, -1)
    return torch.einsum('bqs,bqsc->bqc', w.to(g.dtype), g)
