"""RoI-aware 3D pooling (port of ``gga_tpu/ops/roiaware_pool.py``, the
static-shape replacement of mmcv's ``roiaware_pool3d`` that PartA2's RoI
extractors use), batched over scenes.

Each RoI takes up to ``pts_budget`` of the voxels inside it, the first in
index order, and pools their features into its [S, S, S] cell grid (cell
layout (x, y, z) in the RoI's frame): a max (``mode='max'``) or a mean
(``'avg'``).

The mean's sums are added in index order, so that no cell takes two adds
in one ``index_add`` (``ops.scatter.dynamic_scatter_mean``): on the card,
where ``index_add`` adds with atomics in no set order, a cell's mean then
has the same bits from run to run, and they are gga_tpu's. The max is
``scatter_reduce('amax')``, whose gradient splits evenly among the voxels
of a cell that tie for its max, as JAX's scatter-max VJP splits it.
"""
from __future__ import annotations

import torch

from .scatter import dynamic_scatter_mean


def roiaware_pool3d(feats, centers, valid, rois, out_size=14, mode='max',
                    pts_budget=512):
    """Pool voxel features into per-RoI voxel grids.

    Args:
        feats: [B, N, C] features.
        centers: [B, N, 3] lidar xyz positions.
        valid: [B, N] bool.
        rois: [B, R, 7] lidar bottom-centre boxes (x, y, z, dx, dy, dz,
            yaw).
        out_size: cells a side (S).
        mode: 'max' or 'avg'.
        pts_budget: the most voxels a RoI pools (its first in-box ones in
            index order, as the CUDA op's first-come capping).
    Returns:
        (pooled [B, R, S, S, S, C], occupancy [B, R, S, S, S] bool), zero
        in the empty cells.
    """
    S = out_size
    B, N, C = feats.shape
    R = rois.shape[1]
    dev = feats.device
    dx, dy, dz = rois[..., 3:4], rois[..., 4:5], rois[..., 5:6]  # [B, R, 1]
    cos = torch.cos(-rois[..., 6:7])
    sin = torch.sin(-rois[..., 6:7])
    px = centers[:, None, :, 0] - rois[..., 0:1]                 # [B, R, N]
    py = centers[:, None, :, 1] - rois[..., 1:2]
    pz = centers[:, None, :, 2] - rois[..., 2:3]
    lx = px * cos - py * sin
    ly = px * sin + py * cos
    ix = torch.floor((lx / dx.clamp(min=1e-6) + 0.5) * S)
    iy = torch.floor((ly / dy.clamp(min=1e-6) + 0.5) * S)
    iz = torch.floor(pz / dz.clamp(min=1e-6) * S)
    in_box = ((ix >= 0) & (ix < S) & (iy >= 0) & (iy < S) & (iz >= 0)
              & (iz < S) & valid[:, None, :])
    cell = (ix.long() * (S * S) + iy.long() * S + iz.long())

    # the first pts_budget in-box voxels of each RoI, in index order
    budget = min(pts_budget, N)
    idx = torch.arange(N, device=dev)
    key = torch.where(in_box, idx, N)
    sel = torch.sort(key, dim=-1, stable=True).values[..., :budget]
    sel_ok = sel < N                                           # [B, R, K]
    sel_c = sel.clamp(max=N - 1)
    rows = (torch.arange(B, device=dev)[:, None, None] * N + sel_c)
    sel_feats = feats.reshape(B * N, C)[rows.reshape(-1)].reshape(
        B * R, budget, C)
    n_cells = S * S * S
    sel_cell = torch.where(sel_ok, cell.gather(2, sel_c), n_cells).reshape(
        B * R, budget)
    ok = sel_ok.reshape(B * R, budget)
    if mode == 'max':
        slots = (torch.arange(B * R, device=dev)[:, None] * (n_cells + 1)
                 + sel_cell).reshape(-1)
        src = torch.where(ok[..., None], sel_feats, -torch.inf).reshape(-1, C)
        grid = sel_feats.new_full((B * R * (n_cells + 1), C), -torch.inf)
        grid = grid.scatter_reduce(0, slots[:, None].expand(-1, C), src,
                                   'amax')
        cnt = torch.zeros(B * R * (n_cells + 1), dtype=torch.int32,
                          device=dev).index_add(0, slots, ok.reshape(-1).int())
        grid = grid.reshape(B * R, n_cells + 1, C)[:, :n_cells]
        occ = cnt.reshape(B * R, n_cells + 1)[:, :n_cells] > 0
        out = torch.where(occ[..., None], grid, 0.0)
    elif mode == 'avg':
        out, cnt = dynamic_scatter_mean(sel_feats, sel_cell, ok, n_cells)
        occ = cnt > 0
        out = torch.where(occ[..., None], out, 0.0)
    else:
        raise ValueError(f'mode {mode!r}: max or avg')
    return out.reshape(B, R, S, S, S, C), occ.reshape(B, R, S, S, S)
