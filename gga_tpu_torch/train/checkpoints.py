"""Checkpoints of a ``TrainState`` with the reference's two load semantics:
``resume_from`` (weights + optimizer + step) and ``load_from`` (weights
only) (mmdet3d/apis/train.py:317-320), plus resume from the latest
checkpoint (apis/train.py:310-315). The port's copy of
``gga_tpu/train/checkpoints.py``, on ``torch.save`` instead of orbax.

One file per step, ``step_<step>.pt`` under the checkpoint dir, written
to a temporary name and renamed, so a reader never sees half a file. It
holds a dict of plain tensors and numbers (``torch.load(weights_only=
True)`` reads it): the model's state_dict (mmdet3d keys, as
``convert.from_jax_variables`` gives them), the optimizer's state (AdamW
moments and the schedules' count), the step and the SRL generator's state.
The newest ``max_to_keep`` files are kept.
"""
from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r'^step_(\d+)\.pt$')


def _path(ckpt_dir, step):
    return os.path.join(ckpt_dir, f'step_{int(step)}.pt')


def _steps(ckpt_dir):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                os.listdir(ckpt_dir)) if m)


def save_checkpoint(ckpt_dir, state, step=None, max_to_keep=5):
    """Save the model, optimizer, step and generator; returns the newest
    step in the dir."""
    step = int(state.step if step is None else step)
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = dict(model=state.model.state_dict(),
                   optimizer=state.optimizer.state_dict(), step=step,
                   generator=state.generator.get_state())
    path = _path(ckpt_dir, step)
    tmp = f'{path}.tmp{os.getpid()}'
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(_path(ckpt_dir, old))
    return latest_step(ckpt_dir)


def latest_step(ckpt_dir):
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _load(ckpt_dir, step):
    """The payload on the CPU (``load_state_dict`` copies to the model's
    device; AdamW keeps its step counts on the CPU)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None
    return torch.load(_path(ckpt_dir, step), map_location='cpu',
                      weights_only=True)


def load_variables(ckpt_dir, step=None):
    """The model's state_dict of a checkpoint, on the CPU (the inference
    path's weights-only load). Raises FileNotFoundError if the dir has no
    step."""
    payload = _load(ckpt_dir, step)
    if payload is None:
        raise FileNotFoundError(f'no checkpoint found in {ckpt_dir}')
    return payload['model']


def resume_from(ckpt_dir, state, step=None):
    """Full resume (weights, optimizer, step, SRL generator), in place;
    returns (state, ok)."""
    payload = _load(ckpt_dir, step)
    if payload is None:
        return state, False
    state.model.load_state_dict(payload['model'])
    state.optimizer.load_state_dict(payload['optimizer'])
    state.step = int(payload['step'])
    state.generator.set_state(payload['generator'])
    return state, True


def load_from(ckpt_dir, state, step=None):
    """Weights-only load (the optimizer and step stay fresh), in place;
    returns (state, ok)."""
    payload = _load(ckpt_dir, step)
    if payload is None:
        return state, False
    state.model.load_state_dict(payload['model'])
    return state, True
