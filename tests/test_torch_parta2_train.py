"""One PartA2 train step of the port against gga_tpu's, tiny config, f32,
CPU, and the supervised CLI on PartA2.

gga_tpu has no PartA2 trainer (its ``tools/train_supervised.py`` cannot
train PartA2): its step is ``parta2_loss`` under ``jax.value_and_grad``,
with the RoI sampler's key, followed by the optax chain of
``gga_tpu.train.optim.build_optimizer`` (the global-norm clip, AdamW and
the cyclic lr and beta1) built from configs/_base_/schedules/
cyclic_40e.py's ``optimizer`` block. The port takes
``loop.parta2_train_step`` with ``init_parta2_trainer`` on the same block,
from the same weights (the RPN's deltas zero, as in
``tests/test_torch_parta2.py``), on the same batch, with gga_tpu's
sampler draw:

- the train-mode forward: the RPN's maps, the semantic head's outputs and
  the RCNN's outputs within 1e-4, the sampled RoIs within 1e-4 and their
  masks exactly;
- the loss, every logged term and the unclipped gradient norm at rtol
  1e-4;
- the gradients that reach AdamW (after the clip) at rtol 1e-4 plus 1e-4
  of each tensor's largest entry;
- after the step the batch-norm statistics at 1e-4 and the parameters at
  1e-4 where |g| > 1e-3 max|g| of their tensor; elsewhere within 2 lr
  (Adam's first step is about lr * sign(g), and the sign of a gradient
  near zero can flip under summation-order noise).

The CLI (``tools/train_supervised.py --device cpu``) trains the tiny
PartA2 on the mini KITTI of ``tests/test_torch_supervised.py`` for 2 steps
of 2 scenes across an epoch boundary: the logged keys, each step's lr on
the cyclic schedule, finite losses and both checkpoints. gga_tpu's step
is jitted once.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from gga_tpu.models.detectors import parta2 as jp2
from gga_tpu.train import optim as jopt
from gga_tpu_torch import apis, convert
from gga_tpu_torch.config import Config
from gga_tpu_torch.models.detectors import parta2 as tp2
from gga_tpu_torch.tools import train_supervised
from gga_tpu_torch.train import loop
from gga_tpu_torch.train.optim import cyclic_cos_schedule

from .test_torch_parta2 import (close, jax_variables, sampler_draw, scenes,
                                state_grads, to_jax_tree)
from .test_torch_supervised import kitti  # noqa: F401 (the mini KITTI)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOTAL_STEPS = 100
PARTA2 = 'parta2/hv_PartA2_secfpn_2x8_cyclic_80e_kitti-3d-3class.py'


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope='module')
def step():
    jcfg, tcfg = jp2.PartA2Config.tiny(), tp2.PartA2Config.tiny()
    batch = scenes()
    model = jp2.PartA2Detector(jcfg)
    variables = jax_variables(model, batch)
    rng = jax.random.PRNGKey(11)
    block = dict(Config.fromfile(os.path.join(
        ROOT, 'configs', '_base_', 'schedules', 'cyclic_40e.py')).optimizer)
    gt = [batch[k] for k in ('gt_boxes', 'gt_labels', 'gt_valid')]

    def loss_fn(params):
        out, upd = model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch['points'], batch['points_valid'], rng, *gt, train=True,
            mutable=['batch_stats'])
        total, logs = jp2.parta2_loss(jcfg, out, *gt)
        out.pop('feature_map_size')
        return total, (logs, upd['batch_stats'], out)

    tx = jopt.build_optimizer(total_steps=TOTAL_STEPS, **block)

    @jax.jit
    def jstep(params):
        (_, (logs, new_bs, out)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        clipped, _ = optax.clip_by_global_norm(block['grad_clip']).update(
            grads, None)
        logs['grad_norm'] = optax.global_norm(grads)
        return (logs, new_bs, optax.apply_updates(params, updates), clipped,
                out)

    logs, new_bs, new_params, clipped, jout = jstep(variables['params'])
    ref = dict(logs=_np_tree(logs), clipped=_np_tree(clipped),
               params=_np_tree(new_params), batch_stats=_np_tree(new_bs),
               out=jout)
    sd = convert.from_jax_variables(variables, tcfg)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = dict(sample_u=torch.from_numpy(sampler_draw(
        rng, tcfg.train_proposals)), dropout=[])
    # the train-mode forward alone, on a copy of the weights
    net = tp2.PartA2Detector(tcfg)
    net.load_state_dict(sd)
    with torch.no_grad():
        ref['tout'] = net.train()(t['points'], t['points_valid'],
                                  t['gt_boxes'], t['gt_labels'],
                                  t['gt_valid'], draws)
    trainer = apis.init_parta2_trainer(tcfg, TOTAL_STEPS, sd, device='cpu',
                                       optimizer=block)
    out = loop.parta2_train_step(trainer, t, draws=draws)
    return tcfg, variables, ref, trainer, out


def _port_tree(tcfg, trainer, grads=False):
    """The port trainer's parameters (or their gradients, in the
    state_dict layout) and buffers as gga_tpu's trees."""
    state = trainer.model.state_dict()
    if grads:
        state.update(state_grads(trainer.model))
    return to_jax_tree(convert.parta2_rules(tcfg), state)


def test_train_forward_matches_gga_tpu(step):
    ref, out = step[2]['out'], step[2]['tout']
    for k in ('cls', 'reg', 'dir'):
        close(out['rpn'][k], ref['rpn'][k], f'rpn.{k}')
    for k in ('seg_preds', 'part_preds', 'part_feats'):
        close(out['sem'][k], ref['sem'][k], f'sem.{k}')
    close(out['centers'], ref['centers'], 'centers', 1e-6)
    for k in ('roi_valid', 'pos_mask', 'gt_label_of_roi'):
        np.testing.assert_array_equal(out['samples'][k].numpy(),
                                      np.asarray(ref['samples'][k]),
                                      err_msg=k)
    for k in ('rois', 'ious', 'gt_of_roi'):
        close(out['samples'][k], ref['samples'][k], f'samples.{k}')
    for k in ('cls', 'reg'):
        close(out['rcnn'][k], ref['rcnn'][k], f'rcnn.{k}')
    assert out['samples']['roi_valid'].all()
    assert np.abs(np.asarray(ref['rcnn']['reg'])).max() > 0.1


def test_step_logs_match_gga_tpu(step):
    _, _, ref, _, out = step
    assert {k for k in out if not k.startswith('diag.')} == set(ref['logs'])
    assert {k for k in out if k.startswith('diag.')} == {
        'diag.occupancy_stage1', 'diag.occupancy_stage2',
        'diag.occupancy_stage3', 'diag.occupancy_out'}
    for key, v in ref['logs'].items():
        np.testing.assert_allclose(float(out[key]), float(v), rtol=1e-4,
                                   atol=1e-7, err_msg=key)
    assert float(ref['logs']['grad_norm']) > 10.0     # the clip is active


def _leaves(tree):
    return {'/'.join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_step_gradients_match_gga_tpu(step):
    tcfg, _, ref, trainer, _ = step
    got = _leaves(_port_tree(tcfg, trainer, grads=True)['params'])
    want = _leaves(ref['clipped'])
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max(), err_msg=name)
    # the UNet's decoder and the RCNN head take gradients
    assert np.abs(want['SparseUNet_0/inv_1']).max() > 0
    assert np.abs(want['PartA2BboxHead_0/Dense_0/kernel']).max() > 0


def test_step_updates_match_gga_tpu(step):
    tcfg, _, ref, trainer, _ = step
    port = _port_tree(tcfg, trainer)
    for name, v in _leaves(ref['batch_stats']).items():
        np.testing.assert_allclose(_leaves(port['batch_stats'])[name], v,
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    lr = trainer.optimizer.lr_schedule(0)
    grads = _leaves(ref['clipped'])
    got = _leaves(port['params'])
    for name, want in _leaves(ref['params']).items():
        g = np.abs(grads[name])
        big = g > 1e-3 * g.max()
        np.testing.assert_allclose(got[name][big], want[big], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
        assert (np.abs(got[name] - want)[~big] <= 2 * lr).all(), name
    assert trainer.step == 1 and trainer.optimizer.count == 1


def test_cli_trains_parta2(kitti, tmp_path):  # noqa: F811
    root, _ = kitti
    model = dataclasses.asdict(tp2.PartA2Config.tiny())

    def plain(v):
        if isinstance(v, (tuple, list)):
            return [plain(x) for x in v]
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        return v

    cfg_path = str(tmp_path / 'parta2_tiny.py')
    with open(cfg_path, 'w') as f:
        f.write(f'''_base_ = [{os.path.join(ROOT, 'configs', PARTA2)!r}]
model = {plain(model)!r}
data = dict(samples_per_gpu=2, max_points=4000)
data_root = {root + "/"!r}
log_interval = 1
''')
    work = str(tmp_path / 'work')
    summ = train_supervised.main([cfg_path, '--work-dir', work,
                                  '--max-steps', '2', '--device', 'cpu'])
    assert summ['steps'] == 2 and summ['steps_per_epoch'] == 1
    with open(os.path.join(work, 'train_log.jsonl')) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln['step'] for ln in lines] == [1, 2]
    assert [ln['epoch'] for ln in lines] == [0, 1]
    assert {'loss', 'loss_rpn', 'loss_seg', 'loss_part', 'loss_rcnn',
            'rpn_num_pos', 'grad_norm', 'lr'} <= set(lines[0])
    cfg = Config.fromfile(cfg_path)
    sched = cyclic_cos_schedule(cfg.optimizer.lr, total_steps=2)
    assert [ln['lr'] for ln in lines] == [sched(0), sched(1)]
    assert all(np.isfinite(ln['loss']) for ln in lines)
    assert sorted(os.listdir(os.path.join(work, 'checkpoints'))) == [
        'step_1.pt', 'step_2.pt']
