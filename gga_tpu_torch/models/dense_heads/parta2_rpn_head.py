"""PartA2's RPN head (port of
``gga_tpu/models/dense_heads/parta2_rpn_head.py``): ``Anchor3DHead``'s
convs, targets and loss, and class-agnostic proposals. Every class's
anchors are decoded with its own scores and direction, the classes are
pooled, the ``nms_pre`` best kept and one rotated BEV NMS run over them
(mmdet3d's parta2_rpn_head.py:13, train_cfg.rpn_proposal)."""
from __future__ import annotations

import numpy as np
import torch

from ...core.coders import delta_decode
from ...core.geometry import limit_period
from ...core.nms import nms_bev
from .anchor3d_head import Anchor3DConfig, _flat


@torch.no_grad()
def rpn_proposals(cfg: Anchor3DConfig, preds, anchors, nms_pre=1024,
                  nms_thr=0.8, num_proposals=512, score_thr=0.0):
    """A static proposal set a scene from the RPN's maps (no gradient: the
    proposals are the RoIs' boxes, which gga_tpu stops).

    The ``nms_pre`` best scores come by a stable descending sort, which
    puts the lower index first among equal scores as ``jax.lax.top_k``.

    Args:
        preds: the head's NHWC maps; anchors [C, A, 7].
    Returns dict: boxes [B, R, 7], scores [B, R] (sigmoid of the box's
    class score), labels [B, R] int32, valid [B, R]; R = num_proposals.
    """
    C = cfg.num_classes
    R = len(cfg.rotations)
    cls = torch.sigmoid(_flat(preds['cls'], C, R, C))
    reg = _flat(preds['reg'], C, R, 7)
    dirp = _flat(preds['dir'], C, R, 2)
    scores, boxes, labels = [], [], []
    for ci in range(C):
        score = cls[:, ci, :, ci]
        bx = delta_decode(reg[:, ci], anchors[ci][None])
        rot = limit_period(bx[..., 6] - cfg.dir_offset, 1.0, np.pi)
        yaw = rot + cfg.dir_offset + np.pi * dirp[:, ci].argmax(-1).float()
        scores.append(score)
        boxes.append(torch.cat([bx[..., :6], yaw[..., None]], -1))
        labels.append(torch.full(score.shape, ci, dtype=torch.int32,
                                 device=score.device))
    scores = torch.cat(scores, 1)
    boxes = torch.cat(boxes, 1)
    labels = torch.cat(labels, 1)
    k = min(nms_pre, scores.shape[-1])
    top_s, top_i = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    top_b = boxes.gather(1, top_i[..., None].expand(-1, -1, 7))
    top_l = labels.gather(1, top_i)
    idx, _ = nms_bev(top_b[..., [0, 1, 3, 4, 6]], top_s, nms_thr,
                     post_max_size=num_proposals, valid=top_s > score_thr)
    safe = idx.clamp(min=0)
    kept = idx >= 0
    return dict(boxes=top_b.gather(1, safe[..., None].expand(-1, -1, 7)),
                scores=torch.where(kept, top_s.gather(1, safe), 0.0),
                labels=top_l.gather(1, safe), valid=kept)
