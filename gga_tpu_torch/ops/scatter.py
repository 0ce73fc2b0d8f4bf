"""Point-to-voxel scatter (port of ``gga_tpu/ops/scatter.py``
``dynamic_scatter_mean`` and ``assign_point_voxel_ids``, batched over
scenes): the mean colour of each voxel of the FCAF3D detector."""
from __future__ import annotations

import torch


def dynamic_scatter_mean(point_features, point_voxel_ids, valid, num_voxels):
    """Mean-reduce point features into voxels (DynamicScatter 'mean').

    The sums are added in point order, one pass per rank of a point in
    its voxel, so that no voxel takes two adds in one ``index_add``:
    on the card, where ``index_add`` adds with atomics in no set order,
    a voxel's mean then has the same bits from run to run (a reloaded
    checkpoint decodes exactly as the weights in memory), and the order
    is the one of gga_tpu's scatter on the CPU. The passes are as many as
    the most points a voxel holds.

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
    ids = torch.where(valid, point_voxel_ids.long(), V)
    rows = (torch.arange(B, device=dev)[:, None] * (V + 1) + ids).reshape(-1)
    dump = (torch.arange(B, device=dev)[:, None] * (V + 1) + V).expand(
        B, P).reshape(-1)
    # each point's rank among the points of its voxel, in point order
    rows_s, order = torch.sort(rows, stable=True)
    idx = torch.arange(rows.numel(), device=dev)
    first = torch.ones_like(rows_s, dtype=torch.bool)
    first[1:] = rows_s[1:] != rows_s[:-1]
    rank_s = idx - torch.cummax(torch.where(first, idx, 0), 0).values
    rank = torch.empty_like(rank_s).scatter_(0, order, rank_s)
    live = valid.reshape(-1)
    feat = point_features.reshape(-1, C)
    sums = point_features.new_zeros(B * (V + 1), C)
    n_pass = int(torch.where(live, rank, -1).max()) + 1 if P else 0
    for r in range(n_pass):
        sums.index_add_(0, torch.where(live & (rank == r), rows, dump), feat)
    cnt = torch.zeros(B * (V + 1), dtype=torch.int32, device=dev).index_add(
        0, rows, live.int())
    mean = sums / cnt.clamp(min=1)[:, None]
    return (mean.reshape(B, V + 1, C)[:, :V],
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
