"""The port's VoteNet against gga_tpu's, ``VoteNetConfig.tiny()``, f32,
CPU, on the scene of ``tests/test_models/test_votenet.py`` (B = 2 x 1024
points: a floor of clutter and two clusters, the height channel z + 1)
with its two boxes.

gga_tpu's variables (shapes from ``jax.eval_shape`` of its init, values
drawn with numpy) reach the port through ``convert.from_jax_variables``,
which equals gga_tpu's ``export_votenet`` key for key and bit for bit.
Both packages then run:

- the train-mode forward (batch statistics): every prediction at 1e-4 of
  its largest entry (integer and mask outputs exactly), the eval-mode
  forward the same;
- ``build_targets`` on gga_tpu's predictions: assignments and masks
  exactly, the float targets at 1e-5 of their largest entry;
- every loss term at rtol 1e-4 on gga_tpu's predictions and targets:
  the SUN RGB-D-like head, with ``iou_loss_weight`` (10 / 3) and with
  ``with_rot=False`` (one direction bin);
- ``decode`` on gga_tpu's eval-mode predictions, every second
  proposal's centre moved next to the one before it, and a slot for
  every proposal: boxes and scores at 1e-5, labels and valid exactly,
  some proposals suppressed;
- one ``votenet_train_step`` against ``value_and_grad`` of gga_tpu's loss
  with ``optax.chain(clip_by_global_norm(10), adamw(piecewise_constant
  lr 0.008, weight_decay=0.01))``: the logs at rtol 1e-4, each gradient
  at 1e-4 of its largest entry, the updated weights and BN statistics at
  1e-4.

gga_tpu's functions are jitted once per case.
"""
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from gga_tpu.models.dense_heads import vote_head as jvh
from gga_tpu.models.detectors import votenet as jdet
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models.dense_heads import vote_head as tvh
from gga_tpu_torch.models.detectors import votenet as tdet
from tools.model_converters.torch2flax import export_votenet

torch.set_num_threads(1)

B, P = 2, 1024
TERMS = ('vote_loss', 'objectness_loss', 'center_loss', 'dir_class_loss',
         'dir_res_loss', 'size_class_loss', 'size_res_loss',
         'semantic_loss', 'loss', 'num_pos')
HEADS = dict(base={}, iou=dict(iou_loss_weight=10.0 / 3.0),
             norot=dict(with_rot=False, num_dir_bins=1))


def scene(seed=0):
    rng = np.random.RandomState(seed)
    bg = rng.uniform(-3, 3, (B, P - 300, 3)) * [1, 1, 0.4]
    c1 = np.array([1.0, 1.0, 0.4]) + rng.randn(B, 150, 3) * 0.25
    c2 = np.array([-1.5, -1.0, 0.3]) + rng.randn(B, 150, 3) * 0.2
    xyz = np.concatenate([bg, c1, c2], 1).astype(np.float32)
    pts = np.concatenate([xyz, xyz[..., 2:3] + 1.0], -1).astype(np.float32)
    return pts, np.ones((B, P), bool)


def objects(M):
    gt = np.zeros((B, M, 7), np.float32)
    gt[:, 0] = [1.0, 1.0, 0.0, 1.2, 1.2, 0.9, 0.3]
    gt[:, 1] = [-1.5, -1.0, 0.0, 0.9, 0.9, 0.7, -0.4]
    labels = np.full((B, M), -1, np.int32)
    labels[:, :2] = [0, 2]
    valid = np.zeros((B, M), bool)
    valid[:, :2] = True
    return gt, labels, valid


def _fill(tree, rng, path=()):
    """Numpy values for gga_tpu's shapes: kernels uniform in
    +-1/sqrt(fan_in), BN scales and variances near 1, small biases and
    means."""
    if hasattr(tree, 'items'):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    name = path[-1]
    if name == 'kernel':
        v = rng.uniform(-1, 1, tree.shape) / np.sqrt(tree.shape[0])
    elif name in ('scale', 'var'):
        v = rng.uniform(0.8, 1.2, tree.shape)
    else:
        v = rng.uniform(-0.1, 0.1, tree.shape)
    return np.asarray(v, np.float32)


def _close(got, ref, tol, err=''):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    if ref.dtype == bool or ref.dtype.kind in 'iu':
        np.testing.assert_array_equal(got, ref, err_msg=err)
    else:
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=tol * max(float(np.abs(ref).max()), 1e-30),
            err_msg=err)


def _targets_fn(head):
    return jax.jit(jax.vmap(lambda p, pv, ax, av, b, l, v: jvh.build_targets(
        head, p, pv, ax, av, b, l, v)))


def _target_args(preds, objs):
    return (preds['seed_xyz'], preds['seed_valid'], preds['agg_xyz'],
            preds['agg_valid'], *objs)


@pytest.fixture(scope='module')
def setup():
    cfg = jdet.VoteNetConfig.tiny()
    model = jdet.VoteNet(cfg)
    inputs = scene()
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               *inputs, train=False))
    rng = np.random.RandomState(1)
    variables = {c: _fill(shapes[c], rng) for c in ('params', 'batch_stats')}
    objs = objects(cfg.head.max_objs)
    tcfg = tdet.VoteNetConfig.tiny()
    return cfg, model, variables, inputs, objs, tcfg


@pytest.fixture(scope='module')
def train_pass(setup):
    """gga_tpu's train-mode loss, its gradient and one optax step; the
    port's ``votenet_train_step`` from the same weights, with the
    train-mode predictions captured."""
    cfg, model, variables, inputs, objs, tcfg = setup
    spe = 10
    tx = optax.chain(
        optax.clip_by_global_norm(10.0),
        optax.adamw(optax.piecewise_constant_schedule(
            0.008, {spe * 24: 0.1, spe * 32: 0.1}), weight_decay=0.01))

    def step(params, stats):
        def loss_fn(p):
            preds, upd = model.apply({'params': p, 'batch_stats': stats},
                                     *inputs, train=True,
                                     mutable=['batch_stats'])
            targets = jax.vmap(lambda *a: jvh.build_targets(cfg.head, *a))(
                *_target_args(preds, objs))
            total, logs = jvh.loss(cfg.head, preds, targets)
            return total, (logs, preds, upd['batch_stats'])

        (_, (logs, preds, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        logs['grad_norm'] = optax.global_norm(grads)
        return (logs, preds, grads, optax.apply_updates(params, updates),
                new_stats)

    jlogs, jpreds, jgrads, jparams, jstats = jax.tree_util.tree_map(
        np.asarray, jax.jit(step)(variables['params'],
                                  variables['batch_stats']))

    trainer = apis.init_votenet_trainer(
        tcfg, spe, convert.from_jax_variables(variables, tcfg),
        device='cpu')
    captured = {}
    real = trainer.model.forward

    def keep(*a, **k):
        captured.update(real(*a, **k))
        return captured

    trainer.model.forward = keep
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.clone()))
        for n, p in trainer.model.named_parameters()]
    batch = dict(points=inputs[0], points_valid=inputs[1], gt_boxes=objs[0],
                 gt_labels=objs[1], obj_valid=objs[2])
    logs = apis.votenet_train_step(trainer, batch)
    for h in hooks:
        h.remove()
    del trainer.model.forward
    return dict(jlogs=jlogs, jpreds=jpreds, logs=logs, preds=captured,
                grads=grads,
                ref_grads=convert.from_jax_variables({'params': jgrads},
                                                     tcfg),
                state=trainer.model.state_dict(),
                ref_state=convert.from_jax_variables(
                    {'params': jparams, 'batch_stats': jstats}, tcfg))


def test_conversion_equals_export_votenet(setup):
    cfg, _, variables, _, _, tcfg = setup
    sd = convert.from_jax_variables(variables, tcfg)
    ref = export_votenet(variables, cfg)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        v = np.asarray(v, np.float32)
        assert tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    # the port's module has exactly these tensors and loads them strictly
    model = tdet.VoteNet(tcfg)
    assert set(model.state_dict()) == set(ref)
    model.load_state_dict(sd)


def test_train_forward_matches_gga_tpu(train_pass):
    ref, got = train_pass['jpreds'], train_pass['preds']
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], 1e-4, k)


@pytest.fixture(scope='module')
def jax_eval(setup):
    """gga_tpu's eval-mode forward, jitted once for the forward and the
    decode tests."""
    _, model, variables, inputs, _, _ = setup
    return jax.jit(lambda v, p, m: model.apply(v, p, m, train=False))(
        variables, *inputs)


def test_eval_forward_matches_gga_tpu(setup, jax_eval):
    cfg, model, variables, inputs, _, tcfg = setup
    ref = jax_eval
    bundle = apis.init_votenet_detector(
        tcfg, convert.from_jax_variables(variables, tcfg), device='cpu')
    with torch.no_grad():
        got = bundle.model(*map(torch.from_numpy, inputs))
    for k in ref:
        _close(got[k], ref[k], 1e-4, k)


@pytest.mark.parametrize('head', sorted(HEADS))
def test_targets_match_gga_tpu(setup, train_pass, head):
    cfg, objs = setup[0], setup[4]
    jhead = dataclasses.replace(cfg.head, **HEADS[head])
    thead = dataclasses.replace(setup[5].head, **HEADS[head])
    args = _target_args(train_pass['jpreds'], objs)
    ref = _targets_fn(jhead)(*args)
    got = tvh.build_targets(thead, *(torch.from_numpy(np.array(a))
                                     for a in args))
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], 1e-5, k)
    assert int(np.asarray(ref['objectness_t']).sum()) > 0


@pytest.fixture(scope='module', params=sorted(HEADS))
def loss_pair(request, setup, train_pass):
    cfg, objs = setup[0], setup[4]
    jhead = dataclasses.replace(cfg.head, **HEADS[request.param])
    thead = dataclasses.replace(setup[5].head, **HEADS[request.param])
    jpreds = train_pass['jpreds']
    if request.param == 'norot':
        # one direction bin: the first bin of each direction output
        jpreds = dict(jpreds, dir_cls=jpreds['dir_cls'][..., :1],
                      dir_res_norm=jpreds['dir_res_norm'][..., :1])
    args = _target_args(jpreds, objs)
    ref = jax.jit(lambda p, t: jvh.loss(jhead, p, t)[1])(
        jpreds, _targets_fn(jhead)(*args))
    preds = {k: torch.from_numpy(np.array(v)) for k, v in jpreds.items()}
    _, got = tvh.loss(thead, preds, tvh.build_targets(
        thead, *(torch.from_numpy(np.array(a)) for a in args)))
    return request.param, ref, got


@pytest.mark.parametrize('term', TERMS + ('iou_loss',))
def test_loss_terms_match_gga_tpu(loss_pair, term):
    head, ref, got = loss_pair
    if term == 'iou_loss':
        assert (term in ref) == (term in got) == (head == 'iou')
        if head != 'iou':
            return
    assert float(ref['num_pos']) > 0
    np.testing.assert_allclose(float(got[term]), float(ref[term]),
                               rtol=1e-4, err_msg=term)


def test_decode_matches_gga_tpu(setup, jax_eval):
    cfg, model, variables, inputs, _, tcfg = setup
    jpreds = jax_eval
    # a slot for every proposal, and every second proposal moved 0.1 m
    # from the one before it, so that they suppress one another
    jpreds = {k: np.array(v) for k, v in jpreds.items()}
    jpreds['center'][:, 1::2] = jpreds['center'][:, ::2] + 0.1
    over = dict(max_out=cfg.head.agg_num_point)
    ref = jax.jit(lambda p: jvh.decode(
        dataclasses.replace(cfg.head, **over), p))(jpreds)
    got = tvh.decode(dataclasses.replace(tcfg.head, **over),
                     {k: torch.from_numpy(v) for k, v in jpreds.items()})
    assert set(got) == set(ref)
    for k in ('labels', 'valid'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    for k in ('boxes', 'scores'):
        _close(got[k], ref[k], 1e-5, k)
    assert 0 < int(np.asarray(ref['valid']).sum()) < ref['valid'].size


def test_train_step_logs_match_gga_tpu(train_pass):
    ref, got = train_pass['jlogs'], train_pass['logs']
    for k in TERMS + ('grad_norm',):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)


def test_train_step_gradients_match_gga_tpu(train_pass):
    ref, got = train_pass['ref_grads'], train_pass['grads']
    assert set(got) == set(ref)
    for k, r in ref.items():
        _close(got[k], r.numpy(), 1e-4, k)


def test_train_step_update_matches_gga_tpu(train_pass):
    ref, state = train_pass['ref_state'], train_pass['state']
    assert set(ref) == set(state)
    for k, r in ref.items():
        _close(state[k], r.numpy(), 1e-4, k)
