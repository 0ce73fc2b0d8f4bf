"""Optimizer and schedules of the GGA recipe (port of
``gga_tpu/train/optim.py``; reference gga_kitti_config.py:233-248):
AdamW (lr 1.5e-3, betas (0.95, 0.99), weight decay 0.01), a global-norm
clip of 35, and a one-cycle cosine schedule of the lr (x10 up over 40 %,
down to x1e-4) and of beta1.
"""
from __future__ import annotations

import math

import torch


def cyclic_cos_schedule(base_value, target_ratio=(10, 1e-4),
                        step_ratio_up=0.4, total_steps=1000, cyclic_times=1):
    """mmcv's CyclicLrUpdaterHook with cosine annealing, as a function of
    the step: one cycle rises from ``base`` to ``base * ratio[0]``, then
    falls to ``base * ratio[1]``. Computed in float64 (gga_tpu computes
    in float32)."""
    cycle_len = max(total_steps // cyclic_times, 1)
    up_len = int(cycle_len * step_ratio_up)
    hi = base_value * target_ratio[0]
    lo = base_value * target_ratio[1]

    def cos_anneal(start, end, pct):
        return end + 0.5 * (start - end) * (1 + math.cos(math.pi * pct))

    def schedule(step):
        s = step % cycle_len
        if s < up_len:
            return cos_anneal(base_value, hi, min(s / max(up_len, 1), 1.0))
        return cos_anneal(hi, lo, min(max(
            (s - up_len) / max(cycle_len - up_len, 1), 0.0), 1.0))

    return schedule


class GGAOptimizer:
    """Global-norm clip, then AdamW with the lr and beta1 of the step.

    ``step()`` reads the gradients of ``params``, returns their global
    norm before clipping, and updates the parameters. The clip matches
    ``optax.clip_by_global_norm``: gradients are scaled by
    ``grad_clip / norm`` only where ``norm >= grad_clip``, with no epsilon
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm). The
    schedules are read at the optimizer's own count, starting at 0, as
    ``optax.inject_hyperparams`` does; AdamW (eps 1e-8) decays every
    parameter, as ``optax.adamw`` without a mask."""

    def __init__(self, params, lr_schedule, b1_schedule, b2, weight_decay,
                 grad_clip):
        self.params = [p for p in params if p.requires_grad]
        self.lr_schedule = lr_schedule
        self.b1_schedule = b1_schedule
        self.b2 = b2
        self.grad_clip = grad_clip
        self.count = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=lr_schedule(0), betas=(b1_schedule(0), b2),
            eps=1e-8, weight_decay=weight_decay)

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def state_dict(self):
        """AdamW's moments and step plus the schedules' count."""
        return dict(adamw=self.adamw.state_dict(), count=self.count)

    def load_state_dict(self, state):
        self.adamw.load_state_dict(state['adamw'])
        self.count = int(state['count'])

    @torch.no_grad()
    def step(self):
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        if self.grad_clip is not None:
            scale = torch.where(norm < self.grad_clip, 1.0,
                                self.grad_clip / norm)
            for g in grads:
                g.mul_(scale)
        for group in self.adamw.param_groups:
            group['lr'] = self.lr_schedule(self.count)
            group['betas'] = (self.b1_schedule(self.count), self.b2)
        self.adamw.step()
        self.count += 1
        return norm


def build_optimizer(params, total_steps, lr=1.5e-3, betas=(0.95, 0.99),
                    weight_decay=0.01, grad_clip=35.0,
                    lr_target_ratio=(10, 1e-4),
                    momentum_target_ratio=(0.8947368421052632, 1.0),
                    step_ratio_up=0.4):
    """AdamW + cyclic schedules + global-norm clip (config :233-247)."""
    return GGAOptimizer(
        params,
        cyclic_cos_schedule(lr, lr_target_ratio, step_ratio_up, total_steps),
        cyclic_cos_schedule(betas[0], momentum_target_ratio, step_ratio_up,
                            total_steps),
        betas[1], weight_decay, grad_clip)
