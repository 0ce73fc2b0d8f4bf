"""Scatters (port of ``gga_tpu/ops/scatter.py``, batched over scenes):
the pillars' features onto PointPillars' BEV canvas (``pillar_scatter``),
and the point-to-voxel mean colour of the FCAF3D detector
(``dynamic_scatter_mean``, ``assign_point_voxel_ids``), and the voxel max
of MVXNet's DynamicVFE (``dynamic_scatter_max``)."""
from __future__ import annotations

import torch


def pillar_scatter(voxel_features, coords, valid, grid_hw):
    """Scatter pillar features onto a dense BEV canvas.

    A scene's valid pillars have distinct (y, x), so every write of a
    canvas cell is its only one; padding pillars write zeros to an
    overflow cell that is cut away.

    Args:
        voxel_features: [B, V, C].
        coords: [B, V, 3] int (z, y, x) voxel coords (z ignored).
        valid: [B, V] bool (real pillars).
        grid_hw: (H, W) = (ny, nx).
    Returns:
        [B, C, H, W] canvas in the features' dtype.
    """
    B, V, C = voxel_features.shape
    H, W = grid_hw
    c = coords.long()
    lin = torch.where(valid, c[..., 1] * W + c[..., 2], H * W)
    rows = (torch.arange(B, device=lin.device)[:, None] * (H * W + 1)
            + lin).reshape(-1)
    canvas = voxel_features.new_zeros(B * (H * W + 1), C)
    canvas[rows] = torch.where(valid[..., None], voxel_features,
                               0).reshape(-1, C)
    canvas = canvas.reshape(B, H * W + 1, C)[:, :H * W]
    return canvas.permute(0, 2, 1).reshape(B, C, H, W)


def dynamic_scatter_mean(point_features, point_voxel_ids, valid, num_voxels):
    """Mean-reduce point features into voxels (DynamicScatter 'mean').

    The sums are added in point order, one pass per rank of a point in
    its voxel, so that no voxel takes two adds in one ``index_add``:
    on the card, where ``index_add`` adds with atomics in no set order,
    a voxel's mean then has the same bits from run to run (a reloaded
    checkpoint decodes exactly as the weights in memory), and the order
    is the one of gga_tpu's scatter on the CPU. The points are sorted by
    (rank, point) once, so pass r adds the slice of rank-r points: the
    passes are as many as the most points a voxel holds, and each point
    is added once. Points that fell in no voxel (out of range, or in a
    voxel the budget dropped) are added nowhere.

    Args:
        point_features: [B, P, C].
        point_voxel_ids: [B, P] int slot of each point in its scene's voxel
            list; a point that fell in no voxel carries ``num_voxels``.
        valid: [B, P] bool.
        num_voxels: the voxel budget V.
    Returns:
        ([B, V, C] means, [B, V] int32 counts).
    """
    B, P, C = point_features.shape
    V = num_voxels
    dev = point_voxel_ids.device
    live = (valid & (point_voxel_ids < V)).reshape(-1)
    ids = torch.where(live.reshape(B, P), point_voxel_ids.long(), V)
    rows = (torch.arange(B, device=dev)[:, None] * (V + 1) + ids).reshape(-1)
    # each point's rank among the points of its voxel, in point order
    rows_s, order = torch.sort(rows, stable=True)
    idx = torch.arange(rows.numel(), device=dev)
    first = torch.ones_like(rows_s, dtype=torch.bool)
    first[1:] = rows_s[1:] != rows_s[:-1]
    rank_s = idx - torch.cummax(torch.where(first, idx, 0), 0).values
    rank = torch.empty_like(rank_s).scatter_(0, order, rank_s)
    # the live points by (rank, point), and how many of each rank
    by_rank = torch.sort(torch.where(live, rank, rows.numel()),
                         stable=True).indices
    per_rank = torch.bincount(torch.where(live, rank + 1, 0))[1:].tolist()
    feat = point_features.reshape(-1, C)
    sums = point_features.new_zeros(B * (V + 1), C)
    start = 0
    for n in per_rank:
        sel = by_rank[start:start + n]
        sums.index_add_(0, rows[sel], feat[sel])
        start += n
    cnt = torch.zeros(B * (V + 1), dtype=torch.int32, device=dev).index_add(
        0, rows, live.int())
    mean = sums / cnt.clamp(min=1)[:, None]
    return (mean.reshape(B, V + 1, C)[:, :V],
            cnt.reshape(B, V + 1)[:, :V])


class _ScatterMax(torch.autograd.Function):
    """``out[r] = max(fill, max of feat[i] over rows[i] == r)`` by
    ``scatter_reduce('amax')`` (an atomic max on the card: its result does
    not depend on the order). The gradient is ``jax.grad``'s of
    ``.at[].max``: each of the n entries tied at a row's maximum takes
    ``g * (1 / n)``; the ties are counted by an integer ``index_add``, so
    the backward has the same bits on every run."""

    @staticmethod
    def forward(ctx, feat, rows, n_rows, fill):
        C = feat.shape[1]
        out = feat.new_full((n_rows, C), fill).scatter_reduce_(
            0, rows[:, None].expand(-1, C), feat, 'amax', include_self=True)
        ctx.save_for_backward(feat, rows, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        feat, rows, out = ctx.saved_tensors
        tied = feat == out[rows]
        n = torch.zeros(out.shape, dtype=torch.int32,
                        device=out.device).index_add_(0, rows, tied.int())
        coef = 1.0 / n[rows].clamp(min=1).to(dout.dtype)
        return torch.where(tied, dout[rows] * coef, 0.0), None, None, None


def dynamic_scatter_max(point_features, point_voxel_ids, valid, num_voxels):
    """Max-reduce point features into voxels (DynamicScatter 'max').

    Args:
        point_features: [B, P, C].
        point_voxel_ids: [B, P] int slot of each point in its scene's voxel
            list; a point that fell in no voxel carries ``num_voxels``.
        valid: [B, P] bool.
        num_voxels: the voxel budget V.
    Returns:
        ([B, V, C] maxima, 0 in a voxel no valid point reaches; [B, V]
        int32 counts). Invalid points and points of no voxel go to a dump
        row that is cut away.
    """
    B, P, C = point_features.shape
    V = num_voxels
    dev = point_voxel_ids.device
    ids = torch.where(valid, point_voxel_ids.long(), V)
    rows = (torch.arange(B, device=dev)[:, None] * (V + 1) + ids).reshape(-1)
    neg = torch.finfo(point_features.dtype).min
    feat = torch.where(valid[..., None], point_features, neg).reshape(-1, C)
    out = _ScatterMax.apply(feat, rows, B * (V + 1), neg)
    cnt = torch.zeros(B * (V + 1), dtype=torch.int32, device=dev).index_add_(
        0, rows, valid.reshape(-1).int())
    out = torch.where(cnt[:, None] > 0, out, 0.0)
    return (out.reshape(B, V + 1, C)[:, :V],
            cnt.reshape(B, V + 1)[:, :V])


def assign_point_voxel_ids(coords_zyx_points, coords_zyx_voxels,
                           valid_points, valid_voxels, grid_zyx):
    """Each point's slot in its scene's voxel list, by a binary search of
    the sorted linear ids (``torch.searchsorted``, left side, as
    ``jnp.searchsorted``).

    Args:
        coords_zyx_points: [B, P, 3] int per-point voxel coords (z, y, x).
        coords_zyx_voxels: [B, V, 3] int voxel coords.
        valid_points / valid_voxels: [B, P] / [B, V] bool.
        grid_zyx: (nz, ny, nx).
    Returns:
        [B, P] int32 slots (V for misses and invalid points).
    """
    nz, ny, nx = grid_zyx
    big = nz * ny * nx

    def lin(c, ok):
        c = c.long()
        return torch.where(ok, c[..., 0] * (ny * nx) + c[..., 1] * nx
                           + c[..., 2], big)

    vp = lin(coords_zyx_points, valid_points)
    vv = lin(coords_zyx_voxels, valid_voxels)
    vv_sorted, order = torch.sort(vv, dim=-1, stable=True)
    V = vv.shape[-1]
    pos = torch.searchsorted(vv_sorted, vp).clamp(0, V - 1)
    hit = (vv_sorted.gather(1, pos) == vp) & valid_points & (vp < big)
    return torch.where(hit, order.gather(1, pos), V).int()
