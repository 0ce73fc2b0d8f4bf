"""PartA2's point-wise semantic and part-location head (port of
``gga_tpu/models/roi_heads/semantic_head.py``; mmdet3d's
pointwise_semantic_head.py:13), batched over scenes: two linear layers on
the voxel features predict a foreground logit and the part offsets inside
the object; targets from the (enlarged) GT boxes; a sigmoid focal seg loss
and a BCE part loss."""
from __future__ import annotations

import torch
from torch import nn

from ...core.geometry import points_in_rbbox


class PointwiseSemanticHead(nn.Module):
    """``seg_cls_layer`` (C -> 1) and ``seg_reg_layer`` (C -> 3), with
    biases."""

    def __init__(self, in_channels, seg_score_thr=0.3):
        super().__init__()
        self.seg_score_thr = seg_score_thr
        self.seg_cls_layer = nn.Linear(in_channels, 1)
        self.seg_reg_layer = nn.Linear(in_channels, 3)

    def forward(self, x):
        """x [B, N, C] -> dict(seg_preds [B, N, 1], part_preds [B, N, 3],
        part_feats [B, N, 4]): part_feats are detached, the offsets zero
        below the score threshold (pointwise_semantic_head.py:66-76)."""
        seg_preds = self.seg_cls_layer(x)
        part_preds = self.seg_reg_layer(x)
        with torch.no_grad():
            seg_scores = torch.sigmoid(seg_preds)
            offsets = torch.where(seg_scores > self.seg_score_thr,
                                  torch.sigmoid(part_preds), 0.0)
            part_feats = torch.cat([offsets, seg_scores], -1)
        return dict(seg_preds=seg_preds, part_preds=part_preds,
                    part_feats=part_feats)


def _first_box_idx(mask):
    """[..., P, G] bool -> the first containing box a point (-1 if none),
    points_in_boxes_part's single assignment."""
    return torch.where(mask.any(-1), mask.to(torch.uint8).argmax(-1), -1)


@torch.no_grad()
def semantic_targets(num_classes, extra_width, voxel_centers, voxel_valid,
                     gt_boxes, gt_labels, gt_valid):
    """Seg and part targets (get_targets_single:80-127), batched.

    Args:
        voxel_centers: [B, N, 3]; voxel_valid: [B, N].
        gt_boxes: [B, G, 7] lidar bottom-centre; gt_labels: [B, G];
            gt_valid: [B, G].
    Returns:
        seg_targets [B, N] int64 in {-1 (ignore), 0..C-1 (foreground),
        C (background)}, part_targets [B, N, 3] f32.
    """
    big = points_in_rbbox(voxel_centers, gt_boxes) & gt_valid[:, None, :]
    enl = torch.cat([gt_boxes[..., :2],
                     gt_boxes[..., 2:3] - extra_width,
                     gt_boxes[..., 3:6] + extra_width * 2,
                     gt_boxes[..., 6:]], -1)
    big_enl = points_in_rbbox(voxel_centers, enl) & gt_valid[:, None, :]
    box_idx = _first_box_idx(big)
    enl_idx = _first_box_idx(big_enl)

    fg = box_idx > -1
    labels_pad = torch.cat([gt_labels.new_full((gt_labels.shape[0], 1),
                                               num_classes), gt_labels], 1)
    seg_targets = labels_pad.gather(1, box_idx + 1)
    ignore = fg ^ (enl_idx > -1)
    seg_targets = torch.where(ignore | ~voxel_valid, -1, seg_targets)

    # part offsets in the containing box's canonical frame
    b = gt_boxes.gather(1, box_idx.clamp(min=0)[..., None].expand(-1, -1, 7))
    rel = voxel_centers - b[..., :3]
    c, s = torch.cos(-b[..., 6]), torch.sin(-b[..., 6])
    lx = rel[..., 0] * c - rel[..., 1] * s
    ly = rel[..., 0] * s + rel[..., 1] * c
    part = torch.stack([lx / b[..., 3].clamp(min=1e-6) + 0.5,
                        ly / b[..., 4].clamp(min=1e-6) + 0.5,
                        rel[..., 2] / b[..., 5].clamp(min=1e-6)], -1)
    part = torch.where((fg & voxel_valid)[..., None], part.clamp(min=0.0),
                       0.0)
    return seg_targets.long(), part


def semantic_loss(num_classes, seg_preds, part_preds, seg_targets,
                  part_targets, gamma=2.0, alpha=0.25):
    """Focal seg loss + BCE part loss (pointwise_semantic_head.py:162-205)
    over the batch. Returns (loss_seg, loss_part)."""
    binary = ((seg_targets > -1) & (seg_targets < num_classes)).float()
    neg = (seg_targets == num_classes).float()
    weights = (binary + neg) / binary.sum().clamp(min=1.0)
    p = torch.sigmoid(seg_preds[..., 0])
    is_pos = binary > 0
    pt = torch.where(is_pos, 1 - p, p)
    alpha_t = torch.where(is_pos, alpha, 1 - alpha)
    ce = -torch.log(torch.where(is_pos, p, 1 - p).clamp(1e-12, 1.0))
    loss_seg = (alpha_t * pt ** gamma * ce * weights).sum()

    logits = part_preds
    bce = (logits.clamp(min=0) - logits * part_targets
           + torch.log1p(torch.exp(-logits.abs())))
    loss_part = torch.where(is_pos[..., None], bce, 0.0).sum() / (
        3.0 * is_pos.sum().clamp(min=1).float())
    return loss_seg, loss_part
