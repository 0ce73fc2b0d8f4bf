"""Loss functions shared by the port's heads (port of
``gga_tpu/models/losses.py smooth_l1_loss``)."""
from __future__ import annotations

import torch


def smooth_l1_loss(pred, target, beta=1.0):
    """Elementwise smooth L1: 0.5 d^2 / beta below ``beta``, d - 0.5 beta
    above it, d = |pred - target|."""
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
