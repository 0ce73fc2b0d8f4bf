"""One supervised CenterPoint train step of the port against gga_tpu's,
tiny voxel config with the DCN head and velocity, f32, CPU.

gga_tpu has no CenterPoint trainer: its step is ``centerpoint_loss``
under ``jax.value_and_grad`` (``tests/test_models/test_centerpoint.py``)
followed by the optax chain of ``gga_tpu.train.optim.build_optimizer``
(the global-norm clip, AdamW and the cyclic lr and beta1), built from
configs/_base_/schedules/cyclic_20e.py's ``optimizer`` block. The port
takes ``apis.centerpoint_train_step`` with ``init_centerpoint_trainer``
on the same block, from the same weights, on the same batch:

- the loss, every logged term and the unclipped gradient norm at rtol
  1e-4;
- the gradients that reach AdamW (after the clip) at rtol 1e-4 plus 1e-4
  of each tensor's largest entry, except the biases of the convs that
  feed a train-mode batch norm, whose gradient is zero up to noise;
- after the step the batch-norm statistics at 1e-4 and the parameters at
  1e-4 where |g| > 1e-3 max|g| of their tensor; elsewhere within 2 lr
  (Adam's first step is about lr * sign(g), and the sign of a gradient
  near zero can flip under summation-order noise).

gga_tpu's step is jitted once.
"""
import os

import jax
import numpy as np
import optax
import pytest
import torch

from gga_tpu.models.detectors import centerpoint as jcp
from gga_tpu.train import optim as jopt
from gga_tpu_torch import apis, convert
from gga_tpu_torch.config import Config
from gga_tpu_torch.models.detectors import centerpoint as tcp

from .test_torch_centerpoint import B, clouds, configs, jax_variables

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOTAL_STEPS = 100
M = 8


def _batch(pts, seed=3):
    """Cars and pedestrians of both tasks on the clouds' clusters, some
    padding slots."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((B, M, 9), np.float32)
    labels = np.zeros((B, M), np.int64)
    valid = np.zeros((B, M), bool)
    for b in range(B):
        for g in range(6):
            c = pts[b, g * 60:(g + 1) * 60, :2].mean(0) if g < 4 else \
                rng.uniform(-20, 20, 2)
            gt[b, g] = [*c, -1.8, rng.uniform(3.5, 4.6), rng.uniform(1.6, 2),
                        1.5, rng.uniform(-3, 3), *rng.uniform(-5, 5, 2)]
            labels[b, g] = g % 2
            valid[b, g] = True
    return dict(points=pts, points_valid=np.ones(pts.shape[:2], bool),
                gt_boxes=gt, gt_labels=labels, gt_valid=valid)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope='module')
def step():
    jcfg, tcfg = configs('voxel', True, True)
    pts, valid = clouds(2)
    batch = _batch(pts)
    model, variables = jax_variables(jcfg, pts, valid, seed=1)
    block = dict(Config.fromfile(os.path.join(
        ROOT, 'configs', '_base_', 'schedules', 'cyclic_20e.py')).optimizer)

    def loss_fn(params):
        preds, updates = model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch['points'], batch['points_valid'], train=True,
            mutable=['batch_stats', 'diagnostics'])
        total, logs = jcp.centerpoint_loss(
            jcfg, preds, batch['gt_boxes'], batch['gt_labels'],
            batch['gt_valid'])
        return total, (logs, updates['batch_stats'])

    tx = jopt.build_optimizer(total_steps=TOTAL_STEPS, **block)

    @jax.jit
    def jstep(params):
        (_, (logs, new_bs)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        clipped, _ = optax.clip_by_global_norm(block['grad_clip']).update(
            grads, None)
        logs['grad_norm'] = optax.global_norm(grads)
        return logs, new_bs, optax.apply_updates(params, updates), clipped

    logs, new_bs, new_params, clipped = jstep(variables['params'])
    ref = dict(logs=_np_tree(logs), clipped=_np_tree(clipped),
               params=_np_tree(new_params), batch_stats=_np_tree(new_bs))
    trainer = apis.init_centerpoint_trainer(
        tcfg, TOTAL_STEPS, convert.from_jax_variables(variables, tcfg),
        device='cpu', optimizer=block)
    out = apis.centerpoint_train_step(trainer, batch)
    return tcfg, variables, ref, trainer, out


def _in_port_layout(tcfg, tree):
    """A gga_tpu {'params', 'batch_stats'} tree as the port's named
    parameters and buffers."""
    m = tcp.CenterPointDetector(tcfg)
    m.load_state_dict(convert.from_jax_variables(tree, tcfg))
    return dict(m.named_parameters()), dict(m.named_buffers())


def test_step_logs_match_gga_tpu(step):
    _, _, ref, _, out = step
    assert {k for k in out if not k.startswith('diag.')} == set(ref['logs'])
    assert {k for k in out if k.startswith('diag.')} == {
        'diag.occupancy_out'}
    for key, v in ref['logs'].items():
        np.testing.assert_allclose(float(out[key]), float(v), rtol=1e-4,
                                   err_msg=key)
    assert float(ref['logs']['grad_norm']) > 35.0     # the clip is active


def _before_bn(name):
    """A conv bias followed by a batch norm: its gradient is zero."""
    return name.endswith('.conv.bias')


def test_step_gradients_match_gga_tpu(step):
    tcfg, variables, ref, trainer, _ = step
    grads, _ = _in_port_layout(tcfg, dict(
        params=ref['clipped'], batch_stats=variables['batch_stats']))
    port = dict(trainer.model.named_parameters())
    assert any('feature_adapt' in n for n in port)
    for name, p in port.items():
        g, out = grads[name].detach().numpy(), p.grad.numpy()
        if _before_bn(name):
            scale = np.abs(port[name[:-len('conv.bias')] + 'bn.bias']
                           .grad.numpy()).max()
            assert max(np.abs(out).max(), np.abs(g).max()) < 1e-4 * scale
            continue
        np.testing.assert_allclose(out, g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max(), err_msg=name)


def test_step_updates_match_gga_tpu(step):
    tcfg, _, ref, trainer, _ = step
    params, stats = _in_port_layout(tcfg, dict(
        params=ref['params'], batch_stats=ref['batch_stats']))
    lr = trainer.optimizer.lr_schedule(0)
    for name, buf in trainer.model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), stats[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for name, p in trainer.model.named_parameters():
        want = params[name].detach().numpy()
        got = p.detach().numpy()
        g = np.abs(p.grad.numpy())
        big = (g > 1e-3 * g.max()) & (not _before_bn(name))
        np.testing.assert_allclose(got[big], want[big], rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        assert (np.abs(got - want)[~big] <= 2 * lr).all(), name
    assert trainer.step == 1 and trainer.optimizer.count == 1
