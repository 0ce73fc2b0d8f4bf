"""Loss functions shared by the port's heads (port of
``gga_tpu/models/losses.py`` ``smooth_l1_loss``, ``focal_loss``,
``axis_aligned_iou_loss`` and MonoFlex's ``multibin_loss``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def smooth_l1_loss(pred, target, beta=1.0):
    """Elementwise smooth L1: 0.5 d^2 / beta below ``beta``, d - 0.5 beta
    above it, d = |pred - target|."""
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def focal_loss(logits, labels, num_classes, gamma=2.0, alpha=0.25):
    """Sigmoid focal loss summed over the classes; a label outside [0,
    num_classes) (the background, num_classes, or a padding -1) is all
    negative, as ``jax.nn.one_hot`` gives it."""
    onehot = (labels[..., None] == torch.arange(
        num_classes, device=labels.device)).float()
    p = torch.sigmoid(logits)
    pt = p * onehot + (1 - p) * (1 - onehot)
    w = alpha * onehot + (1 - alpha) * (1 - onehot)
    ce = -(onehot * F.logsigmoid(logits)
           + (1 - onehot) * F.logsigmoid(-logits))
    return (w * (1 - pt) ** gamma * ce).sum(-1)


def axis_aligned_iou_loss(pred, target):
    """1 - IoU of [..., 6] (x1, y1, z1, x2, y2, z2) boxes (gga_tpu
    ``axis_aligned_iou_loss``, mmdet3d's AxisAlignedIoULoss without its
    reduction); negative extents count as 0."""
    lo = torch.maximum(pred[..., :3], target[..., :3])
    hi = torch.minimum(pred[..., 3:], target[..., 3:])
    inter = (hi - lo).clamp(min=0.0).prod(-1)
    vp = (pred[..., 3:] - pred[..., :3]).clamp(min=0.0).prod(-1)
    vt = (target[..., 3:] - target[..., :3]).clamp(min=0.0).prod(-1)
    return 1.0 - inter / (vp + vt - inter).clamp(min=1e-8)


def multibin_loss(pred_orientations, gt_orientations, num_dir_bins=4):
    """MonoFlex's multi-bin orientation loss a row (gga_tpu
    ``multibin_loss``): each bin's 2-way cross entropy, averaged over the
    bins, plus the smooth-L1 of (sin, cos) of the residual on the bins
    whose label is 1, averaged over those bins.

    Args:
        pred_orientations: [N, bins * 4]: the bins' (2) logits, then their
            (sin, cos).
        gt_orientations: [N, bins * 2]: the bins' labels, then their
            residuals.
    Returns:
        [N].
    """
    nb = num_dir_bins
    cls_losses = reg_losses = reg_cnt = 0.0
    for i in range(nb):
        ce = -F.log_softmax(pred_orientations[:, i * 2:i * 2 + 2], -1)
        label = gt_orientations[:, i].long()
        cls_losses = cls_losses + ce.gather(1, label[:, None])[:, 0]
        s = nb * 2 + i * 2
        res = gt_orientations[:, nb + i]
        reg = (smooth_l1_loss(pred_orientations[:, s], torch.sin(res))
               + smooth_l1_loss(pred_orientations[:, s + 1], torch.cos(res)))
        mask = label == 1
        reg_losses = reg_losses + torch.where(mask, reg, 0.0)
        reg_cnt = reg_cnt + mask.float()
    return cls_losses / nb + reg_losses / torch.clamp(reg_cnt, min=1.0)
