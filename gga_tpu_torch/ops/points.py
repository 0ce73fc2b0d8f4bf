"""Point-cloud ops (port of ``gga_tpu/ops/points.py``): squared
distances, k nearest neighbours, three-NN and inverse-distance
interpolation (SASSD's auxiliary branch, PointNet++'s feature
propagation), farthest point sampling, ball query and grouping
(PointNet++'s set abstraction), batched over scenes.

gga_tpu computes these with XLA, not Pallas, so they are plain PyTorch.
Distances follow gga_tpu's formula ``|a|^2 + |b|^2 - 2 a.b`` (clamped at
0), which loses most of its digits to cancellation far from the origin;
the port keeps the formula, since the neighbours it picks are part of
the result. The norms accumulate as XLA's reduction does on the CPU
(``squared_norm``), and so does the dot product (``pairwise_dot``: one
fused multiply-add a coordinate, emulated in float64, on every device),
so that the card's distances are the CPU's bits: a point's squared
distance to itself is all cancellation at KITTI's ranges (|a|^2 near
5 000 has an ulp of 5e-4), and three-NN's inverse-distance weight of a
point that coincides with its source swings from 1e8 to 2e3 with one
ulp. Neighbours are ordered by (distance, index), so equal distances
keep ``jax.lax.top_k``'s order: the lower index first. Farthest point
sampling, over xyz or over any wider feature (3DSSD's F-FPS),
accumulates its ``|p - last|^2`` as ``squared_norm`` does, and its
argmax, like ``jnp.argmax``, takes the first of equal values.
"""
from __future__ import annotations

import torch

BIG = 1e10
# query rows a block of the [B, rows, M] distance matrix holds: SASSD's
# 16 000 voxel means against 16 000 sites would otherwise take 1 GB a
# scene and stage
QUERY_BLOCK = 2048
# entries of the [scenes, queries, supports] arrays one pass of
# ``ball_query`` holds (about 1 GB of int64 ranks): SUN RGB-D's first set
# abstraction, 2 048 centres on 20 000 points, takes three scenes a pass
BALL_QUERY_ELEMENTS = 1 << 27


# XLA's CPU compiler splits a reduction longer than this into windows of
# this size (its TreeReductionRewriter)
XLA_REDUCE_WINDOW = 32


def squared_norm(x):
    """[..., D] -> [...] f32 sum of squares over the last dim, accumulated
    as XLA's CPU reduction of ``jnp.sum(x ** 2, -1)`` does, so that the
    bits are gga_tpu's:

    - D <= 32: the square fuses into the reduction, so x0 * x0 rounded,
      then one fused multiply-add for each further entry (exact products
      in float64, one rounding a step);
    - D > 32: XLA rewrites the reduction as a reduce-window of 32 entries,
      stride 32, over the row padded with zeros, ``pad // 2`` before and
      the rest after (to a multiple of 32), and then a reduction of the
      window sums (the same rule again while they are more than 32). The
      squares are rounded on their own, each window and the last
      reduction add in order from 0.
    """
    D = x.shape[-1]
    if D <= XLA_REDUCE_WINDOW:
        x64 = x.double()
        acc = (x[..., 0] * x[..., 0]).double()
        for i in range(1, D):
            acc = (acc + x64[..., i] * x64[..., i]).float().double()
        return acc.float()
    vals = x * x
    while vals.shape[-1] > XLA_REDUCE_WINDOW:
        n = vals.shape[-1]
        pad = -n % XLA_REDUCE_WINDOW
        vals = torch.nn.functional.pad(vals, (pad // 2, pad - pad // 2))
        vals = vals.reshape(*vals.shape[:-1], -1, XLA_REDUCE_WINDOW)
        acc = vals[..., 0]
        for i in range(1, XLA_REDUCE_WINDOW):
            acc = acc + vals[..., i]
        vals = acc
    acc = vals[..., 0]
    for i in range(1, vals.shape[-1]):
        acc = acc + vals[..., i]
    return acc


def pairwise_squared_diff(q, s):
    """[..., R, D] x [..., N, D] -> [..., R, N] f32 sums over D of
    ``(q_r - s_n) ** 2`` (gga_tpu's ``((a[:, None] - b[None]) ** 2)
    .sum(-1)``), accumulated in ``squared_norm``'s order, which is XLA's on
    the CPU: an FMA chain at D <= 32, else windows of 32 coordinates (the
    row padded as there) summed in order and then their sums. Built one
    coordinate at a time, so no [..., R, N, D] array is held."""
    D = q.shape[-1]

    def diff(i):
        return q[..., :, None, i] - s[..., None, :, i]

    if D <= XLA_REDUCE_WINDOW:
        d = diff(0)
        acc = (d * d).double()
        for i in range(1, D):
            d = diff(i).double()
            acc = (acc + d * d).float().double()
        return acc.float()
    # windows of the row padded with pad // 2 zeros before (a zero adds
    # nothing), each summed in order as its coordinates come
    pad = -D % XLA_REDUCE_WINDOW
    sums, acc = [], None
    for p in range(D + pad):
        i = p - pad // 2
        if 0 <= i < D:
            d = diff(i)
            acc = d * d if acc is None else acc + d * d
        if (p + 1) % XLA_REDUCE_WINDOW == 0:
            sums.append(acc)
            acc = None
    while len(sums) > XLA_REDUCE_WINDOW:
        pad = -len(sums) % XLA_REDUCE_WINDOW
        padded = [None] * (pad // 2) + sums + [None] * (pad - pad // 2)
        sums = []
        for w in range(0, len(padded), XLA_REDUCE_WINDOW):
            part = [v for v in padded[w:w + XLA_REDUCE_WINDOW]
                    if v is not None]
            acc = part[0]
            for v in part[1:]:
                acc = acc + v
            sums.append(acc)
    acc = sums[0]
    for v in sums[1:]:
        acc = acc + v
    return acc


def pairwise_dot(a, b):
    """[..., N, D] x [..., M, D] -> [..., N, M] f32 dot products,
    accumulated as XLA's CPU dot (and torch's CPU matmul) does at these
    widths: a0 * b0 rounded, then one fused multiply-add a coordinate
    (exact products in float64, one rounding a step), on any device."""
    acc = (a[..., :, None, 0] * b[..., None, :, 0]).double()
    for i in range(1, a.shape[-1]):
        acc = (acc + a[..., :, None, i].double()
               * b[..., None, :, i].double()).float().double()
    return acc.float()


def square_distance(a, b, a_valid=None, b_valid=None):
    """[B, N, 3] x [B, M, 3] -> [B, N, M] squared euclidean distances
    (gga_tpu ``square_distance``); entries of invalid points are ``BIG``."""
    d = (squared_norm(a)[..., :, None] + squared_norm(b)[..., None, :]
         - 2 * pairwise_dot(a, b))
    d = d.clamp(min=0.0)
    if a_valid is not None:
        d = torch.where(a_valid[..., :, None], d, BIG)
    if b_valid is not None:
        d = torch.where(b_valid[..., None, :], d, BIG)
    return d


def smallest(d, k):
    """The k smallest entries of each row of ``d`` (>= 0) and their
    columns, by the lower column first among equal values.

    A top-(k + 1) of the values, its candidates ordered by (value,
    column): where the k-th candidate is below the (k + 1)-th, no entry
    outside them can tie it, so the first k are the answer. The rows
    where they tie (exact ties at the boundary, or fewer than k + 1 valid
    entries) are taken again by a top-k of int64 keys (the f32 bits,
    monotone for non-negative floats, above the column)."""
    if d.shape[-1] <= k:            # no (k + 1)-th candidate to compare
        return _smallest_by_key(d, k)
    vals, idx = torch.topk(d, k + 1, dim=-1, largest=False)
    o = torch.argsort(idx, dim=-1)      # by column, then stably by value
    vals, idx = vals.gather(-1, o), idx.gather(-1, o)
    o = torch.sort(vals, dim=-1, stable=True).indices
    vals, idx = vals.gather(-1, o), idx.gather(-1, o)
    tied = vals[..., k - 1] == vals[..., k]
    vals, idx = vals[..., :k], idx[..., :k]
    if bool(tied.any()):
        vals[tied], idx[tied] = _smallest_by_key(d[tied], k)
    return vals, idx


def _smallest_by_key(d, k):
    """``smallest`` by a top-k of int64 keys alone (the f32 bits of each
    entry, monotone for non-negative floats, above its column)."""
    cols = torch.arange(d.shape[-1], device=d.device)
    key = ((d + 0.0).view(torch.int32).long() << 32) | cols
    i = torch.topk(key, k, dim=-1, largest=False, sorted=True).indices
    return d.gather(-1, i), i


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
            d, i = smallest(square_distance(q, support, qv, s_valid), k)
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

    The arithmetic is XLA's on the CPU, so that the bits are gga_tpu's
    (rows whose neighbours share one feature vector stay equal to one
    another, as there): the weights as XLA rewrites ``(1 / d) / sum``,
    1 / (d * sum), and the weighted sum as its dot, the first product
    rounded, then one fused multiply-add a neighbour (exact products in
    float64, one rounding a step), on any device.

    Args:
        features: [B, M, C] support features.
        idx: [B, Q, 3]; dist2: [B, Q, 3] squared distances.
    Returns:
        [B, Q, C] in the features' dtype; the gradient reaches
        ``features`` only.
    """
    d = dist2.clamp(min=eps)
    r = 1.0 / d
    w = (1.0 / (d * (r[..., 0] + r[..., 1] + r[..., 2])[..., None])).to(
        features.dtype)
    B, Q, S = idx.shape
    g = features.gather(1, idx.reshape(B, Q * S, 1).expand(
        B, Q * S, features.shape[-1])).reshape(B, Q, S, -1)
    acc = w[..., 0, None] * g[..., 0, :]
    for i in range(1, S):
        acc = (acc.double() + w[..., i, None].double()
               * g[..., i, :].double()).to(g.dtype)
    return acc


def furthest_point_sample(points, valid, num_samples):
    """Iterative farthest point sampling (gga_tpu
    ``furthest_point_sample``, mmcv's), batched over scenes.

    The first sample is the first valid point; each further one is the
    point farthest from those taken, invalid points at distance -1 (so
    they are taken only where no valid point is left, and the samples
    repeat where a scene has fewer valid points than ``num_samples``).
    ``num_samples - 1`` sequential argmax steps, with no host sync.

    Args:
        points: [B, P, D] (xyz, or 3DSSD's [xyz, features]); valid: [B, P]
            bool.
    Returns:
        [B, num_samples] int64 indices.
    """
    B, _, D = points.shape
    with torch.no_grad():
        start = valid.to(torch.uint8).argmax(-1)
        idxs = torch.empty(B, num_samples, dtype=torch.long,
                           device=points.device)
        idxs[:, 0] = start
        min_d = torch.where(valid, BIG, -1.0)
        last = start
        for i in range(1, num_samples):
            lp = points.gather(1, last[:, None, None].expand(B, 1, D))
            d = torch.where(valid, squared_norm(points - lp), -1.0)
            min_d = torch.minimum(min_d, d)
            last = min_d.argmax(-1)
            idxs[:, i] = last
    return idxs


def ball_query(query, support, radius, num_samples, q_valid=None,
               s_valid=None):
    """Up to ``num_samples`` supports within ``radius`` of each query
    (gga_tpu ``ball_query``, mmcv's semantics): the hits in support
    order, the free slots filled with the first hit, index 0 with count 0
    for a query that hits nothing. A support hits where its squared
    distance (``square_distance``) is below ``radius ** 2``; its slot is
    its rank among the row's hits. No gradient flows. The [queries,
    supports] arrays are built for as many scenes at a time as
    ``BALL_QUERY_ELEMENTS`` allows.

    Args:
        query: [B, Q, 3]; support: [B, P, 3]; q_valid [B, Q] and s_valid
            [B, P] bool, or None.
    Returns:
        (indices [B, Q, num_samples] int64, counts [B, Q] int64).
    """
    B, Q, _ = query.shape
    P = support.shape[1]
    S = num_samples
    step = max(1, BALL_QUERY_ELEMENTS // max(Q * P, 1))
    cols = torch.arange(P, device=query.device).expand(step, Q, P)
    idx, counts = [], []
    with torch.no_grad():
        for s in range(0, B, step):
            e = min(s + step, B)
            d = square_distance(
                query[s:e], support[s:e],
                None if q_valid is None else q_valid[s:e],
                None if s_valid is None else s_valid[s:e])
            hit = d < radius ** 2
            del d
            rank = hit.cumsum(-1) - 1
            slot = torch.where(hit & (rank < S), rank, S)
            del rank
            out = torch.full((e - s, Q, S + 1), -1, dtype=torch.long,
                             device=query.device)
            out.scatter_(-1, slot, cols[:e - s])
            del slot
            out = out[..., :S]
            first = out[..., :1].clamp(min=0)
            idx.append(torch.where(out >= 0, out, first))
            counts.append(hit.sum(-1).clamp(max=S))
    return torch.cat(idx), torch.cat(counts)


def gather_points(points, idx):
    """[B, P, C] gathered at [B, S] -> [B, S, C] (mmcv gather_points); the
    gradient reaches ``points``."""
    B, S = idx.shape
    return points.gather(1, idx[..., None].expand(B, S, points.shape[-1]))


def group_points(points, idx):
    """[B, P, C] gathered at [B, Q, S] -> [B, Q, S, C] (mmcv
    grouping_operation); the gradient reaches ``points``."""
    B, Q, S = idx.shape
    return gather_points(points, idx.reshape(B, Q * S)).reshape(B, Q, S, -1)


def query_and_group(points, features, centers, radius, num_samples,
                    p_valid=None, use_xyz=True):
    """QueryAndGroup (gga_tpu ``query_and_group``, mmcv's): ball query,
    then each member's xyz relative to its centre, concatenated before
    its features where ``use_xyz``; members past a query's count are 0.

    Args:
        points: [B, P, 3]; features: [B, P, C] or None; centers: [B, Q, 3];
            p_valid: [B, P] bool or None.
    Returns:
        ([B, Q, S, C (+3)] grouped features, [B, Q, S] in-ball mask).
    """
    idx, counts = ball_query(centers, points, radius, num_samples,
                             s_valid=p_valid)
    grouped_xyz = group_points(points, idx) - centers[:, :, None, :]
    mask = (torch.arange(num_samples, device=idx.device)
            < counts[..., None])
    if features is None:
        out = grouped_xyz
    elif use_xyz:
        out = torch.cat([grouped_xyz, group_points(features, idx)], -1)
    else:
        out = group_points(features, idx)
    return torch.where(mask[..., None], out, 0.0), mask
