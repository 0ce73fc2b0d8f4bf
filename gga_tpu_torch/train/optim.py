"""Optimizers and schedules of the GGA recipe (port of
``gga_tpu/train/optim.py``; reference gga_kitti_config.py:233-248):
AdamW (lr 1.5e-3, betas (0.95, 0.99), weight decay 0.01), a global-norm
clip of 35, and a one-cycle cosine schedule of the lr (x10 up over 40 %,
down to x1e-4) and of beta1; and of the stage-4 PGD retrain
(``configs/gga/gga_pdg.py``, ``tools/train_pgd.py:86-101``): SGD with
momentum 0.9 and weight decay 1e-4, the same clip, a linear warmup then
step decay; and of the indoor FCAF3D retrain (``configs/fcaf3d``,
``tools/train_fcaf3d.py:97-104``): a global-norm clip of 10, then AdamW
(lr 1e-3, weight decay 1e-4) with the lr x0.1 at epochs 8 and 11.
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


def step_schedule(lr, steps_per_epoch, warmup_iters=500, warmup_ratio=1 / 3,
                  lr_steps=(32, 44), lr_gamma=0.1):
    """gga_tpu's stage-4 schedule (``tools/train_pgd.py:89-97``) as a
    function of the step: a linear warmup from ``lr * warmup_ratio`` to
    ``lr`` over ``warmup_iters`` steps, then ``lr`` times ``lr_gamma`` for
    each boundary passed. The boundaries are the ``lr_steps`` epochs in
    steps less the warmup (at least 1), as optax's
    ``piecewise_constant_schedule`` after ``join_schedules`` counts them;
    boundaries that coincide count once, as keys of gga_tpu's dict do.
    Computed in float64 (gga_tpu computes in float32)."""
    bounds = sorted({max(steps_per_epoch * e - warmup_iters, 1)
                     for e in lr_steps})
    start = lr * warmup_ratio

    def schedule(step):
        if step < warmup_iters:
            return (start - lr) * (1 - max(step, 0) / warmup_iters) + lr
        return lr * lr_gamma ** sum(step - warmup_iters >= b for b in bounds)

    return schedule


def piecewise_constant_schedule(lr, boundaries_and_scales):
    """``optax.piecewise_constant_schedule`` as a function of the step:
    ``lr`` times the scale of every boundary the step has reached.
    Computed in float64 (optax computes in float32)."""
    bounds = sorted(boundaries_and_scales.items())

    def schedule(step):
        v = lr
        for b, scale in bounds:
            if step >= b:
                v *= scale
        return v

    return schedule


@torch.no_grad()
def clip_by_global_norm(grads, max_norm):
    """Scale ``grads`` in place by ``max_norm / norm`` where their global
    norm reaches ``max_norm``, as ``optax.clip_by_global_norm`` (no
    epsilon; ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm).
    Returns the norm before clipping."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    if max_norm is not None:
        scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
        for g in grads:
            g.mul_(scale)
    return norm


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
        norm = clip_by_global_norm(
            [p.grad for p in self.params if p.grad is not None],
            self.grad_clip)
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


class PGDOptimizer:
    """Global-norm clip, then SGD with the lr of the step, momentum and
    coupled weight decay: ``torch.optim.SGD(momentum, weight_decay)``,
    which adds ``weight_decay * p`` to the gradient before the momentum
    and the lr, as mmdet3d's optimizer does and as
    ``optax.chain(clip_by_global_norm, add_decayed_weights, sgd)`` in
    ``tools/accuracy_bench_stage4.py:351`` does. (``tools/train_pgd.py``
    chains the decay after the SGD, so the lr does not scale it.)

    The interface is ``GGAOptimizer``'s: ``step()`` returns the unclipped
    global norm; the schedule is read at the optimizer's own count."""

    def __init__(self, params, lr_schedule, momentum, weight_decay,
                 grad_clip):
        self.params = [p for p in params if p.requires_grad]
        self.lr_schedule = lr_schedule
        self.grad_clip = grad_clip
        self.count = 0
        self.sgd = torch.optim.SGD(self.params, lr=lr_schedule(0),
                                   momentum=momentum,
                                   weight_decay=weight_decay)

    def zero_grad(self):
        self.sgd.zero_grad(set_to_none=True)

    def state_dict(self):
        """SGD's momentum buffers plus the schedule's count."""
        return dict(sgd=self.sgd.state_dict(), count=self.count)

    def load_state_dict(self, state):
        self.sgd.load_state_dict(state['sgd'])
        self.count = int(state['count'])

    @torch.no_grad()
    def step(self):
        norm = clip_by_global_norm(
            [p.grad for p in self.params if p.grad is not None],
            self.grad_clip)
        for group in self.sgd.param_groups:
            group['lr'] = self.lr_schedule(self.count)
        self.sgd.step()
        self.count += 1
        return norm


def build_pgd_optimizer(params, steps_per_epoch, lr=0.001, momentum=0.9,
                        weight_decay=1e-4, grad_clip=35.0, lr_policy='step',
                        lr_steps=(32, 44), lr_gamma=0.1, warmup_iters=500,
                        warmup_ratio=1 / 3):
    """SGD + warmup and step decay + global-norm clip (the ``optimizer``
    block of ``configs/gga/gga_pdg.py``)."""
    if lr_policy != 'step':
        raise ValueError(f'lr_policy {lr_policy!r}: the PGD recipe has the '
                         "'step' policy only")
    return PGDOptimizer(
        params,
        step_schedule(lr, steps_per_epoch, warmup_iters, warmup_ratio,
                      lr_steps, lr_gamma),
        momentum, weight_decay, grad_clip)


def build_fcaf3d_optimizer(params, steps_per_epoch, lr=0.001,
                           weight_decay=1e-4, grad_clip=10.0,
                           lr_policy='step', lr_steps=(8, 11), lr_gamma=0.1):
    """Global-norm clip, then AdamW (betas (0.9, 0.999), eps 1e-8,
    decoupled weight decay on every parameter, as ``optax.adamw``) with
    the lr times ``lr_gamma`` at each of the ``lr_steps`` epochs (the
    ``optimizer`` block of ``configs/fcaf3d/fcaf3d_8x2_sunrgbd-3d-10class
    .py``; gga_tpu's ``tools/train_fcaf3d.py:97-104`` chain). Boundaries
    that coincide count once, as keys of gga_tpu's dict do."""
    if lr_policy != 'step':
        raise ValueError(f'lr_policy {lr_policy!r}: the FCAF3D recipe has '
                         "the 'step' policy only")
    sched = piecewise_constant_schedule(
        lr, {steps_per_epoch * e: lr_gamma for e in lr_steps})
    return GGAOptimizer(params, sched, lambda _: 0.9, 0.999, weight_decay,
                        grad_clip)
