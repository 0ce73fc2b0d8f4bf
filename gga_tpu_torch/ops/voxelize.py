"""Hard voxelization over a batch of point clouds (port of
``gga_tpu/ops/voxelize.py``).

Sort-based with static output shapes: points are sorted by voxel id
(stable, so ties keep point order and the same points of a voxel survive
the per-voxel cap as in gga_tpu), segment starts mark voxels, a cumulative
sum gives each point its voxel slot and its rank inside the voxel. When
the voxels overflow ``max_voxels`` the farthest are dropped
(``ops.sparse._budget_keep``).
"""
from __future__ import annotations

import numpy as np
import torch

from .sparse import _budget_keep


def _grid(voxel_size, pc_range):
    """Voxel grid (nx, ny, nz), rounded in f32 as gga_tpu computes it."""
    vs = np.asarray(voxel_size, np.float32)
    lo = np.asarray(pc_range[:3], np.float32)
    hi = np.asarray(pc_range[3:], np.float32)
    return tuple(int(g) for g in np.round((hi - lo) / vs))


def point_voxel_coords(points, voxel_size, pc_range):
    """Integer voxel coords and in-range mask of points.

    Args:
        points: [..., P, C>=3] f32.
    Returns:
        coords [..., P, 3] int64 (x, y, z order), in_range [..., P] bool.
    """
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=points.device)
    lo = torch.tensor(pc_range[:3], dtype=torch.float32, device=points.device)
    grid = torch.tensor(_grid(voxel_size, pc_range), device=points.device)
    coords = torch.floor((points[..., :3] - lo) / vs).long()
    in_range = ((coords >= 0) & (coords < grid)).all(-1)
    return coords, in_range


def hard_voxelize(points, valid, *, voxel_size, pc_range, max_points=5,
                  max_voxels=16000):
    """Hard voxelization with static output shapes.

    Args:
        points: [B, P, C] f32 (xyz + features); padded rows allowed.
        valid: [B, P] bool mask of real points.
    Returns dict:
        voxels [B, V, max_points, C] zero padded; coords [B, V, 3] int32
        (z, y, x), -1 padded; num_points [B, V] int32; num_voxels [B]
        int32; V = max_voxels.
    """
    B, P, C = points.shape
    V, T = max_voxels, max_points
    dev = points.device
    coords, in_range = point_voxel_coords(points, voxel_size, pc_range)
    ok = in_range & valid
    gx, gy, gz = _grid(voxel_size, pc_range)
    lin = coords[..., 2] * (gy * gx) + coords[..., 1] * gx + coords[..., 0]
    big = gx * gy * gz
    lin = torch.where(ok, lin, big)

    lin_s, order = torch.sort(lin, dim=-1, stable=True)
    pts_s = points.gather(1, order[..., None].expand(B, P, C))
    coords_s = coords.gather(1, order[..., None].expand(B, P, 3))
    ok_s = ok.gather(1, order)

    prev = torch.cat([lin_s.new_full((B, 1), -1), lin_s[:, :-1]], 1)
    newv = (lin_s != prev) & ok_s
    vkeep = _budget_keep(lin_s, newv, big, (gz, gy, gx), V)
    newv = newv & vkeep
    slot = torch.cumsum(newv, dim=-1) - 1
    slot = torch.where(ok_s, slot, V)
    pidx = torch.arange(P, device=dev)
    seg_start = torch.cummax(torch.where(newv, pidx, 0), dim=-1).values
    rank = pidx - seg_start

    keep = ok_s & vkeep & (slot < V) & (rank < T)
    vslot = torch.where(keep, slot, V)                    # V = dump row
    prank = torch.where(keep, rank, 0)
    row = torch.arange(B, device=dev)[:, None] * (V + 1) + vslot

    voxels = points.new_zeros(B * (V + 1) * T, C)
    voxels[(row * T + prank).reshape(-1)] = torch.where(
        keep[..., None], pts_s, 0).reshape(-1, C)
    num_points = torch.zeros(B * (V + 1), dtype=torch.int32, device=dev)
    num_points.index_add_(0, row.reshape(-1), keep.int().reshape(-1))
    out_coords = torch.full((B * (V + 1), 3), -1, dtype=torch.int32,
                            device=dev)
    out_coords[row.reshape(-1)] = coords_s.flip(-1).int().reshape(-1, 3)

    return dict(
        voxels=voxels.reshape(B, V + 1, T, C)[:, :V],
        coords=out_coords.reshape(B, V + 1, 3)[:, :V],
        num_points=num_points.reshape(B, V + 1)[:, :V],
        num_voxels=newv.sum(-1).clamp(max=V).int(),
    )


def dynamic_voxelize(points, valid, *, voxel_size, pc_range):
    """Per-point voxel coords, no clustering (gga_tpu ``dynamic_voxelize``,
    ``voxelize.py:138``; mmcv's dynamic Voxelization).

    Args:
        points: [..., P, C>=3] f32; valid: [..., P] bool.
    Returns:
        (coords [..., P, 3] int64 (z, y, x), -1 for a point outside the
        range or invalid; ok [..., P] bool).
    """
    coords, in_range = point_voxel_coords(points, voxel_size, pc_range)
    ok = in_range & valid
    return torch.where(ok[..., None], coords.flip(-1), -1), ok
