"""The port's whole GGA weak train step against gga_tpu's, tiny config,
f32, on the CPU.

gga_tpu's variables (shapes from its init, values drawn with numpy) are
carried into the port by ``convert.from_jax_variables``; both packages
then take one step on the same batch with the same SRL draw.

(a) The loss, every logged term (``diag.*`` included) and the unclipped
    gradient norm agree at rtol 1e-4, and the gradients that reach AdamW
    (after the clip) at rtol 1e-4 plus 1e-4 of each tensor's largest
    entry: 21 sparse convs, 16 dense convs, their batch norms and the
    losses, summed in f32 in another order; 1e-4 is the forward's
    tolerance (tests/test_torch_detector.py). The biases of the convs that
    feed a train-mode batch norm (``*.conv.bias`` of the ConvModules) have
    an exactly zero gradient, since the norm subtracts the batch mean: both
    packages must leave them at rounding noise, below 1e-4 of the gradient
    of that norm's bias.
(b) After the step the batch-norm running statistics agree at 1e-4 and
    the parameters at 1e-4 where |g| > 1e-3 max|g| of their tensor. Where
    the gradient is smaller, or zero up to noise, they agree within 2 lr:
    Adam's first step is about lr * sign(g), and the sign of a gradient
    near zero can flip under summation-order noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gga_tpu.models.dense_heads import centerpoint_head_gga as jgga
from gga_tpu.models.detectors import centerpoint_gga as jdet
from gga_tpu.train import optim as jopt
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models.detectors import centerpoint_gga as tdet
from gga_tpu_torch.train.loop import gga_train_step

from .test_torch_detector import _clouds, _fill
from .test_torch_gga_head import _batch

torch.set_num_threads(1)

TOTAL_STEPS = 100


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope='module')
def step():
    cfg = jdet.GGAModelConfig.tiny()
    model = jdet.GGADetector(cfg)
    pts, valid = _clouds(seed=1)
    batch = dict(_batch(seed=4, edge_cases=False), points=pts,
                 points_valid=valid)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), pts, valid, train=False))
    variables = _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                      np.random.RandomState(1))
    head = cfg.head
    key = jax.random.PRNGKey(7)

    # gga_tpu's loss_fn of train/loop.py, with the step key given
    def loss_fn(params):
        preds, updates = model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch['points'], batch['points_valid'], train=True,
            mutable=['batch_stats', 'diagnostics'])
        targets = jgga.build_targets(
            head, key, batch['labels'], batch['obj_valid'],
            batch['init_pseudo'], batch['boxes_img'], batch['bdry_masks'],
            batch['lidar2img'])
        total, logs = jgga.loss(head, preds, targets, batch['ibp_xy'],
                                batch['ibp_valid'])
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                updates.get('diagnostics', {})):
            logs[f'diag.{path[-2].key}'] = jnp.asarray(leaf).mean()
        return total, (logs, updates['batch_stats'])

    (_, (logs, new_bs)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables['params'])
    # the rest of gga_train_step: clip + AdamW on those gradients
    tx = jopt.build_optimizer(total_steps=TOTAL_STEPS)
    params = variables['params']
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)
    clipped, _ = optax.clip_by_global_norm(35.0).update(grads, None)
    logs['grad_norm'] = optax.global_norm(grads)
    keys = jax.random.split(key, len(head.task_num_classes))
    draw = np.stack([np.asarray(jax.random.normal(k, (pts.shape[0],)))
                     for k in keys])
    ref = dict(logs=_np_tree(logs), clipped=_np_tree(clipped),
               params=_np_tree(new_params), batch_stats=_np_tree(new_bs))

    tcfg = tdet.GGAModelConfig.tiny()
    trainer = apis.init_trainer(
        tcfg, TOTAL_STEPS, convert.from_jax_variables(variables, tcfg),
        device='cpu')
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    out = gga_train_step(trainer, tb, tcfg.head,
                         srl_normal=torch.from_numpy(draw))
    return tcfg, variables, ref, trainer, out


def _in_port_layout(tcfg, tree):
    """A gga_tpu {'params', 'batch_stats'} tree as the port's named
    parameters and buffers (module layout)."""
    m = tdet.GGADetector(tcfg)
    m.load_state_dict(convert.from_jax_variables(tree, tcfg))
    return dict(m.named_parameters()), dict(m.named_buffers())


def test_step_logs_match_gga_tpu(step):
    _, _, ref, _, out = step
    assert set(out) == set(ref['logs'])
    assert {k for k in out if k.startswith('diag.')} == {
        'diag.occupancy_stage0', 'diag.occupancy_stage1',
        'diag.occupancy_stage2', 'diag.occupancy_out'}
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
    assert any(_before_bn(n) for n in port)
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
