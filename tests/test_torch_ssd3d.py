"""The port's 3DSSD against gga_tpu's, ``SSD3DNetConfig.tiny()``, f32,
CPU, B = 2 x 256 points (``scene``: three large boxes, so that the tiny
model's votes meet positives).

gga_tpu's variables (``jax_variables``: the conversion rules' paths and
shapes, values drawn with numpy) reach the port through
``convert.from_jax_variables``.
Both packages then run:

- the eval-mode and the train-mode forward: the sampled indices exactly
  (D-FPS, then FS, then F-FPS over the first 32 seeds and D-FPS over the
  rest), every prediction at 1e-4 of its largest entry;
- ``ssd3d_targets`` against gga_tpu's vmapped ``ssd3d_targets_single`` on
  gga_tpu's predictions: masks and classes exactly, the rest at 1e-5 of
  their largest entry;
- every term of ``ssd3d_loss`` at rtol 1e-4;
- ``decode_ssd3d`` on gga_tpu's eval predictions, every second
  proposal's centre next to the one before it and every box 2 m wide:
  boxes and scores at 1e-5,
  labels and valid exactly, some proposals suppressed;
- one ``ssd3d_train_step`` against ``value_and_grad`` of gga_tpu's loss
  with ``optax.chain(clip_by_global_norm(10), adamw(piecewise_constant
  lr 0.002, weight_decay=0))`` (the car config's optimizer): the logs at
  rtol 1e-4, each gradient at 1e-4 of its largest entry, the updated
  weights and BN statistics at 1e-4.

gga_tpu's functions are jitted once per case, the inputs passed as
arguments: closed over, they would be constants that XLA folds at
compile time in another summation order, and three-NN's squared
distance of a point to itself (all cancellation at KITTI's ranges) would
no longer be gga_tpu's run-time value.
"""
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from gga_tpu.models.dense_heads import ssd_3d_head as jhead
from gga_tpu.models.detectors import ssd3d as jdet
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models.dense_heads import ssd_3d_head as thead
from gga_tpu_torch.models.detectors import ssd3d as tdet

torch.set_num_threads(1)

B, P, G = 2, 256, 3
TERMS = ('centerness_loss', 'center_loss', 'dir_class_loss', 'dir_res_loss',
         'size_res_loss', 'corner_loss', 'vote_loss', 'loss')


def scene(seed=1):
    """(points, valid, gt boxes, labels, gt valid): a 40 x 20 x 3 m slab
    of points with a reflectance, and three 9 x 12 x 3.5 m boxes that hold
    about 40 % of it, so that the tiny model's votes meet positives and
    negatives."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform([0, -10, -2], [40, 10, 1], (B, P, 3)),
                          rng.uniform(0, 1, (B, P, 1))], -1).astype(
        np.float32)
    gt = np.zeros((B, G, 7), np.float32)
    gt[..., 0] = [7.0, 20.0, 33.0]
    gt[..., 1] = rng.uniform(-1, 1, (B, G))
    gt[..., 2] = -2.2
    gt[..., 3:6] = [9.0, 12.0, 3.5]
    gt[..., 6] = rng.uniform(-0.3, 0.3, (B, G))
    return (pts, np.ones((B, P), bool), gt, np.zeros((B, G), np.int32),
            np.ones((B, G), bool))


def fill(tree, rng, path=()):
    """Numpy values for gga_tpu's shapes: kernels uniform in
    +-1/sqrt(fan_in), BN scales and variances near 1, small biases and
    means."""
    if hasattr(tree, 'items'):
        return {k: fill(v, rng, path + (k,)) for k, v in tree.items()}
    name = path[-1]
    if name == 'kernel':
        v = rng.uniform(-1, 1, tree.shape) / np.sqrt(tree.shape[0])
    elif name in ('scale', 'var'):
        v = rng.uniform(0.8, 1.2, tree.shape)
    else:
        v = rng.uniform(-0.1, 0.1, tree.shape)
    return np.asarray(v, np.float32)


def jax_variables(tcfg, model, rng):
    """gga_tpu's variables of ``tcfg``'s detector, values as ``fill``
    gives them; their paths and shapes are read off the port's ``model``
    through ``convert.rules_of`` (quicker than tracing gga_tpu's init: a
    path gga_tpu lacks or misses fails its forward)."""
    sd = model.state_dict()
    tree = {'params': {}, 'batch_stats': {}}
    for key, coll, path, transform in convert.rules_of(tcfg):
        shape = tuple(sd[key].shape)
        if transform in ('conv1x1', 'conv1x1_2d', 'linear'):
            shape = shape[1::-1]
        node = tree[coll]
        *parents, leaf = path.split('/')
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.empty(shape, np.float32)
    return {c: fill(tree[c], rng) for c in tree}


def close(got, ref, tol, err=''):
    """Integer and bool arrays exactly, floats at ``tol`` of the largest
    reference entry."""
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    if ref.dtype == bool or ref.dtype.kind in 'iu':
        np.testing.assert_array_equal(got, ref, err_msg=err)
    else:
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=tol * max(float(np.abs(ref).max()), 1e-30),
            err_msg=err)


def t(x):
    return torch.from_numpy(np.array(x))


def _batch(inputs):
    pts, pv, gt, gl, gv = inputs
    return dict(points=pts, points_valid=pv, gt_boxes=gt, gt_labels=gl,
                gt_valid=gv)


@pytest.fixture(scope='module')
def setup():
    cfg = jdet.SSD3DNetConfig.tiny()
    model = jdet.SSD3DNet(cfg)
    tcfg = tdet.SSD3DNetConfig.tiny()
    variables = jax_variables(tcfg, tdet.SSD3DNet(tcfg),
                              np.random.RandomState(2))
    return cfg, model, variables, scene(), tcfg


def _targets_fn(head):
    return jax.jit(jax.vmap(lambda gb, gl, gv, ax, sx:
                            jhead.ssd3d_targets_single(head, gb, gl, gv, ax,
                                                       sx)))


@pytest.fixture(scope='module')
def train_pass(setup):
    """gga_tpu's train-mode loss, its gradient and one optax step; the
    port's ``ssd3d_train_step`` from the same weights, its train-mode
    predictions captured."""
    cfg, model, variables, inputs, tcfg = setup
    spe = 10
    opt = dict(apis.SSD3D_OPTIMIZER)
    tx = optax.chain(
        optax.clip_by_global_norm(opt['grad_clip']),
        optax.adamw(optax.piecewise_constant_schedule(
            opt['lr'], {spe * e: opt['lr_gamma'] for e in opt['lr_steps']}),
            weight_decay=opt['weight_decay']))

    def step(params, stats, pts, pv, *gt):
        def loss_fn(p):
            preds, upd = model.apply({'params': p, 'batch_stats': stats},
                                     pts, pv, train=True,
                                     mutable=['batch_stats'])
            total, logs = jhead.ssd3d_loss(cfg.head, preds, *gt)
            return total, (logs, preds, upd['batch_stats'])

        (_, (logs, preds, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        logs['grad_norm'] = optax.global_norm(grads)
        return (logs, preds, grads, optax.apply_updates(params, updates),
                new_stats)

    jlogs, jpreds, jgrads, jparams, jstats = jax.tree_util.tree_map(
        np.asarray, jax.jit(step)(variables['params'],
                                  variables['batch_stats'], *inputs))
    trainer = apis.init_ssd3d_trainer(
        tcfg, spe, convert.from_jax_variables(variables, tcfg), device='cpu')
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
    logs = apis.ssd3d_train_step(trainer, _batch(inputs))
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


def test_conversion_loads_strictly(setup):
    _, _, variables, _, tcfg = setup
    sd = convert.from_jax_variables(variables, tcfg)
    model = tdet.SSD3DNet(tcfg)
    assert set(model.state_dict()) == set(sd)
    n_flax = sum(v.size for c in variables.values()
                 for v in jax.tree_util.tree_leaves(c))
    assert sum(v.numel() for v in sd.values()) == n_flax
    model.load_state_dict(sd)


@pytest.fixture(scope='module')
def jax_eval(setup):
    """gga_tpu's eval-mode forward, jitted once for the forward and the
    decode tests."""
    _, model, variables, inputs, _ = setup
    return jax.jit(lambda v, p, m: model.apply(v, p, m, train=False))(
        variables, *inputs[:2])


def test_eval_forward_matches_gga_tpu(setup, jax_eval):
    _, model, variables, inputs, tcfg = setup
    ref = jax_eval
    bundle = apis.init_ssd3d_detector(
        tcfg, convert.from_jax_variables(variables, tcfg), device='cpu')
    with torch.no_grad():
        got = bundle.model(t(inputs[0]), t(inputs[1]))
    # level 1's FS seeds: 32 by features, then 32 by xyz; level 2 samples
    # by features from the first 32
    assert [tuple(i.shape) for i in got['sample_idx']] == [
        (B, 128), (B, 64), (B, 32)]
    for k in ref:
        close(got[k], ref[k], 1e-4, k)


def test_train_forward_matches_gga_tpu(train_pass):
    ref, got = train_pass['jpreds'], train_pass['preds']
    for k in ref:
        close(got[k], ref[k], 1e-4, k)


def test_sampled_indices_are_given_back(setup):
    """The backbone's indices passed back give the same forward: the
    cross-device comparison's lever."""
    _, _, variables, inputs, tcfg = setup
    model = tdet.SSD3DNet(tcfg)
    model.load_state_dict(convert.from_jax_variables(variables, tcfg))
    model.eval()
    with torch.no_grad():
        first = model(t(inputs[0]), t(inputs[1]))
        idx = [torch.flip(i, [-1]) for i in first['sample_idx']]
        again = model(t(inputs[0]), t(inputs[1]), sample_idx=idx)
    for a, b in zip(again['sample_idx'], idx):
        assert torch.equal(a, b)
    assert not torch.equal(again['seed_xyz'], first['seed_xyz'])


def test_targets_match_gga_tpu(setup, train_pass):
    cfg, _, _, inputs, tcfg = setup
    jp = train_pass['jpreds']
    args = (*inputs[2:], jp['agg_xyz'], jp['seed_xyz'])
    ref = _targets_fn(cfg.head)(*args)
    got = thead.ssd3d_targets(tcfg.head, *map(t, args))
    assert set(got) == set(ref)
    for k in ref:
        close(got[k], ref[k], 1e-5, k)
    assert int(np.asarray(ref['positive']).sum()) > 0
    assert int(np.asarray(ref['vote_mask']).sum()) > 0


@pytest.fixture(scope='module')
def loss_pair(setup, train_pass):
    cfg, _, _, inputs, tcfg = setup
    jp = train_pass['jpreds']
    ref = jax.jit(lambda p, *gt: jhead.ssd3d_loss(cfg.head, p, *gt)[1])(
        jp, *inputs[2:])
    _, got = thead.ssd3d_loss(tcfg.head, {k: t(v) for k, v in jp.items()},
                              *map(t, inputs[2:]))
    return ref, got


@pytest.mark.parametrize('term', TERMS)
def test_loss_terms_match_gga_tpu(loss_pair, term):
    ref, got = loss_pair
    assert float(got['num_pos']) > 0
    np.testing.assert_allclose(float(got[term]), float(ref[term]), rtol=1e-4,
                               err_msg=term)


def test_decode_matches_gga_tpu(setup, jax_eval):
    cfg, model, variables, inputs, tcfg = setup
    jp = {k: np.array(v) for k, v in jax_eval.items()}
    # every second proposal 0.1 m from the one before it, both 2 m wide,
    # so that they suppress one another
    jp['center'][:, 1::2] = jp['center'][:, ::2] + 0.1
    jp['size'][:] = 1.0
    head = dataclasses.replace(cfg.head, max_out=cfg.head.num_candidates)
    ref = jax.jit(lambda p: jhead.decode_ssd3d(head, p))(jp)
    got = thead.decode_ssd3d(dataclasses.replace(
        tcfg.head, max_out=tcfg.head.num_candidates),
        {k: t(v) for k, v in jp.items()})
    assert set(got) == set(ref)
    for k in ('labels', 'valid'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    for k in ('boxes', 'scores'):
        close(got[k], ref[k], 1e-5, k)
    assert 0 < int(np.asarray(ref['valid']).sum()) < ref['valid'].size
    assert float(np.asarray(ref['boxes'])[..., 3:6].min()) >= 0.1


def test_train_step_logs_match_gga_tpu(train_pass):
    ref, got = train_pass['jlogs'], train_pass['logs']
    assert float(got['num_pos']) > 0
    for k in TERMS + ('grad_norm',):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)


def test_train_step_gradients_match_gga_tpu(train_pass):
    ref, got = train_pass['ref_grads'], train_pass['grads']
    assert set(got) == set(ref)
    for k, r in ref.items():
        close(got[k], r.numpy(), 1e-4, k)


def test_train_step_update_matches_gga_tpu(train_pass):
    ref, state = train_pass['ref_state'], train_pass['state']
    assert set(ref) == set(state)
    for k, r in ref.items():
        close(state[k], r.numpy(), 1e-4, k)
