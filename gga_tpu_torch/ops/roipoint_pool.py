"""RoI point pooling (port of ``gga_tpu/ops/roipoint_pool.py``; mmcv's
RoIPointPool3d as mmdet3d's Single3DRoIPointExtractor uses it), batched
over scenes: for each RoI the first ``num_sampled`` valid points inside
it, in point order, repeated cyclically where it holds fewer (the CUDA
op's ``pooled_idx[j] = pooled_idx[j % cnt]``), moved into the RoI's frame
(centre subtracted, yaw undone), their features after them; an RoI with
no point inside is zeroed and flagged.

gga_tpu runs it in XLA, not Pallas, so it is plain PyTorch: the first
in-box points of an RoI are the ``num_sampled`` smallest of the keys
``index`` (inside) or ``N + index`` (outside), all distinct.
"""
from __future__ import annotations

import torch

from ..core.geometry import points_in_rbbox


def roipoint_pool3d(points_xyz, feats, valid, rois, num_sampled=512):
    """Pool each RoI's points.

    Args:
        points_xyz: [B, N, 3] lidar coords; feats: [B, N, C] features
            pooled beside them; valid: [B, N] bool; rois: [B, R, 7] lidar
            bottom-centre boxes.
    Returns:
        pooled [B, R, num_sampled, 3 + C]: the RoI-frame xyz, then the
        features; empty [B, R] bool, True where no valid point is inside.
        The gradient reaches ``feats`` and ``points_xyz``.
    """
    B, N, _ = points_xyz.shape
    R = rois.shape[1]
    with torch.no_grad():
        inbox = (points_in_rbbox(points_xyz, rois).transpose(1, 2)
                 & valid[:, None, :])                          # [B, R, N]
        order = torch.arange(N, device=points_xyz.device)
        key = torch.where(inbox, order, N + order)
        idx = torch.topk(key, min(num_sampled, N), dim=-1, largest=False,
                         sorted=True).indices                 # [B, R, S]
        cnt = inbox.sum(-1)
        slot = torch.arange(num_sampled, device=points_xyz.device)
        idx = idx.gather(-1, slot % cnt.clamp(min=1)[..., None])
    flat = idx.reshape(B, R * num_sampled)

    def gather(x):
        return x.gather(1, flat[..., None].expand(B, R * num_sampled,
                                                  x.shape[-1])).reshape(
            B, R, num_sampled, x.shape[-1])

    rel = gather(points_xyz) - rois[..., None, :3]
    yaw = rois[..., 6]
    c, s = torch.cos(-yaw)[..., None], torch.sin(-yaw)[..., None]
    local = torch.stack([rel[..., 0] * c - rel[..., 1] * s,
                         rel[..., 0] * s + rel[..., 1] * c, rel[..., 2]], -1)
    pooled = torch.cat([local, gather(feats)], -1)
    empty = cnt == 0
    return torch.where(empty[..., None, None], 0.0, pooled), empty
