"""The port's GroupFree3D against gga_tpu's, ``GroupFree3DNetConfig.tiny()``
(xyz only, 2 decoder layers of 2 heads), f32, CPU, on a dense scene
(``scene``: B = 2 x 1024 points, two clusters) with its two boxes.

gga_tpu's variables (shapes from ``jax.eval_shape`` of its init, values
drawn with numpy) reach the port through ``convert.from_jax_variables``;
the attentions' q / k / v kernels are stacked into torch's
``in_proj_weight``. Both packages then run, at dropout 0 (the dropout's
draws are the port's own, checked apart):

- the eval-mode and the train-mode forward: each level's farthest point
  sampling and the KPS candidates exactly, every output of every stage
  at 1e-5 of its largest entry;
- ``groupfree3d_targets`` against gga_tpu's vmapped
  ``groupfree3d_targets_single``: masks and classes exactly, the rest at
  1e-5 of their largest entry;
- every loss term at rtol 1e-4;
- ``decode_groupfree3d`` on gga_tpu's eval predictions, every second
  candidate's centre next to the one before it: boxes and scores at
  1e-5, labels and valid exactly, some candidates suppressed;
- one ``groupfree3d_train_step`` against ``value_and_grad`` of gga_tpu's
  loss with ``optax.chain(clip_by_global_norm(0.1), adamw(piecewise
  lr 0.006, weight_decay=5e-4))`` (the configs' optimizer): the logs at
  rtol 1e-4, each gradient at 1e-4 of the model's largest gradient
  entry, the weights and BN statistics after the step as
  ``test_torch_point_rcnn.py`` holds them.

gga_tpu's functions are jitted once, the inputs passed as arguments.
``step_pass`` and ``update_within`` serve the H3DNet and ImVoteNet files.
"""
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from gga_tpu.models.dense_heads import groupfree3d_head as jhead
from gga_tpu.models.detectors import groupfree3d as jdet
from gga_tpu.ops import points as jpo
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models.dense_heads import groupfree3d_head as thead
from gga_tpu_torch.models.detectors import groupfree3d as tdet
from tests.test_torch_ssd3d import close, fill, t

torch.set_num_threads(1)

B = 2
OPTIMIZER = apis.GROUPFREE3D_OPTIMIZER
SPE = 10


def scene(seed=0, P=1024):
    """(points [B, P, 3], valid, gt boxes [B, 2, 7] bottom-centre, labels,
    gt valid): a 3 x 3 x 0.8 m slab of clutter and two clusters, each in
    a box, dense enough that every ball of the first set abstraction
    holds points besides its centre (an isolated centre's features are
    its MLP's at 0, the same for every such centre, and their scores then
    tie to the last bit only by each package's own summation order)."""
    rng = np.random.RandomState(seed)
    bg = rng.uniform([-1.5, -1.5, 0.0], [1.5, 1.5, 0.8], (B, P - 400, 3))
    c1 = np.array([0.6, 0.5, 0.3]) + rng.randn(B, 200, 3) * 0.12
    c2 = np.array([-0.7, -0.6, 0.25]) + rng.randn(B, 200, 3) * 0.1
    pts = np.concatenate([bg, c1, c2], 1).astype(np.float32)
    gt = np.zeros((B, 2, 7), np.float32)
    gt[:, 0] = [0.6, 0.5, 0.0, 0.7, 0.7, 0.6, 0.0]
    gt[:, 1] = [-0.7, -0.6, 0.0, 0.6, 0.6, 0.5, 0.0]
    return (pts, np.ones((B, P), bool), gt, np.array([[0, 2]] * B, np.int32),
            np.ones((B, 2), bool))


def fps_chain(xyz, valid, nums):
    """gga_tpu's sampled indices of each level of a PointNet2SASSG (jax)."""
    out = []
    for n in nums:
        idx = jax.vmap(lambda p, v, n=n: jpo.furthest_point_sample(p, v, n))(
            xyz, valid)
        out.append(idx)
        xyz = jax.numpy.take_along_axis(xyz, idx[..., None], 1)
        valid = jax.numpy.take_along_axis(valid, idx, 1)
    return out


def optax_step(opt, spe):
    """gga_tpu's chain of a config's ``optimizer`` block."""
    return optax.chain(
        optax.clip_by_global_norm(opt['grad_clip']),
        optax.adamw(optax.piecewise_constant_schedule(
            opt['lr'], {spe * e: opt['lr_gamma'] for e in opt['lr_steps']}),
            weight_decay=opt['weight_decay']))


def step_pass(trainer, step):
    """Run ``step()`` (one of the port's train steps on ``trainer``) with
    the train-mode forward's output and every parameter's gradient
    captured. Returns (logs, output, grads)."""
    captured = []
    real = trainer.model.forward

    def keep(*a, **k):
        captured.append(real(*a, **k))
        return captured[-1]

    trainer.model.forward = keep
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.clone()))
        for n, p in trainer.model.named_parameters()]
    try:
        logs = step()
    finally:
        for h in hooks:
            h.remove()
        del trainer.model.forward
    return logs, captured[0], grads


def grad_scale(grads):
    return max(float(g.abs().max()) for g in grads.values())


def check_grads(ref, got):
    """Each gradient at 1e-4 of the model's largest gradient entry."""
    assert set(got) == set(ref)
    tol = 1e-4 * grad_scale(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=0,
                                   atol=tol, err_msg=k)


def update_within(ref, state, grads, lr, wd):
    """The weights and BN statistics after one AdamW step at 1e-4 of each
    tensor's largest entry; where gga_tpu's gradient is within the
    gradient tolerance of 0, AdamW's first step (lr g / (|g| + 1e-8)) is
    set by rounding, and the two are held within 2 lr (1 + wd |w|)."""
    assert set(ref) == set(state)
    unresolved = 1e-4 * grad_scale(grads)
    for k, r in ref.items():
        r, g = r.numpy(), state[k].numpy()
        tol = np.full(r.shape, 1e-4 * max(float(np.abs(r).max()), 1e-30))
        if k in grads:
            free = np.abs(grads[k].numpy()) < unresolved
            tol = np.where(free, 2 * lr * (1 + wd * np.abs(r)) + tol, tol)
        assert (np.abs(g - r) <= tol).all(), (k, float(np.abs(g - r).max()))


def walk(got, ref, tol, name=''):
    """``close`` over nested dicts and lists of gga_tpu's layout."""
    if isinstance(ref, dict):
        for k in ref:
            walk(got[k], ref[k], tol, f'{name}{k}.')
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), name
        for i, (g, r) in enumerate(zip(got, ref)):
            walk(g, r, tol, f'{name}{i}.')
    else:
        ref = ref.numpy() if torch.is_tensor(ref) else np.asarray(ref)
        if ref.size:
            close(got, ref, tol, name[:-1])
        assert tuple(got.shape) == ref.shape, name


def _cfgs():
    cfg = jdet.GroupFree3DNetConfig.tiny()
    cfg = dataclasses.replace(cfg, head=dataclasses.replace(cfg.head,
                                                            dropout=0.0))
    tcfg = tdet.GroupFree3DNetConfig.tiny()
    tcfg = dataclasses.replace(tcfg, head=dataclasses.replace(tcfg.head,
                                                              dropout=0.0))
    return cfg, tcfg


@pytest.fixture(scope='module')
def setup():
    cfg, tcfg = _cfgs()
    model = jdet.GroupFree3DNet(cfg)
    inputs = scene()
    shapes = jax.eval_shape(lambda p, v: model.init(
        jax.random.PRNGKey(0), p, v, train=False), *inputs[:2])
    rng = np.random.RandomState(1)
    variables = {c: fill(shapes[c], rng) for c in ('params', 'batch_stats')}
    return cfg, model, variables, inputs, tcfg


def _decode_input(preds):
    """gga_tpu's eval predictions with every second candidate's centre
    0.05 m from the one before it, so that they suppress one another."""
    st = dict(preds['stages'][-1])
    st['center'] = st['center'].at[:, 1::2].set(st['center'][:, ::2] + 0.05)
    return dict(preds, stages=preds['stages'][:-1] + [st])


@pytest.fixture(scope='module')
def train_pass(setup):
    """gga_tpu's eval forward, its sampling, targets, decode, train-mode
    loss, gradient and one optax step, in one jit; the port's
    ``groupfree3d_train_step`` from the same weights."""
    cfg, model, variables, inputs, tcfg = setup
    tx = optax_step(OPTIMIZER, SPE)

    def step(params, stats, pts, pv, gt, gl, gv):
        def loss_fn(p):
            preds, upd = model.apply({'params': p, 'batch_stats': stats},
                                     pts, pv, train=True,
                                     mutable=['batch_stats'])
            total, logs = jhead.groupfree3d_loss(cfg.head, preds, gt, gl, gv)
            return total, (logs, preds, upd['batch_stats'])

        (_, (logs, preds, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        logs['grad_norm'] = optax.global_norm(grads)
        evaluated = model.apply({'params': params, 'batch_stats': stats},
                                pts, pv, train=False)
        targets = jax.vmap(lambda *a: jhead.groupfree3d_targets_single(
            cfg.head, *a))(gt, gl, gv, preds['seed_xyz'],
                           preds['seed_valid'], preds['cand_idx'])
        decoded = jhead.decode_groupfree3d(cfg.head,
                                           _decode_input(evaluated))
        return (logs, preds, grads, optax.apply_updates(params, updates),
                new_stats, evaluated, targets, decoded,
                fps_chain(pts, pv, cfg.num_points))

    (jlogs, jpreds, jgrads, jparams, jstats, jeval, jtargets, jdecoded,
     jfps) = jax.tree_util.tree_map(np.asarray, jax.jit(step)(
         variables['params'], variables['batch_stats'], *inputs))
    trainer = apis.init_groupfree3d_trainer(
        tcfg, SPE, convert.from_jax_variables(variables, tcfg),
        device='cpu')
    batch = dict(zip(('points', 'points_valid', 'gt_boxes', 'gt_labels',
                      'gt_valid'), inputs))
    logs, preds, grads = step_pass(
        trainer, lambda: apis.groupfree3d_train_step(trainer, batch))
    return dict(jlogs=jlogs, jpreds=jpreds, jeval=jeval, jtargets=jtargets,
                jdecoded=jdecoded, jfps=jfps, logs=logs, preds=preds,
                indices=trainer.model.sampled_indices(preds), grads=grads,
                ref_grads=convert.from_jax_variables({'params': jgrads},
                                                     tcfg),
                state=trainer.model.state_dict(),
                ref_state=convert.from_jax_variables(
                    {'params': jparams, 'batch_stats': jstats}, tcfg))


def test_conversion_loads_strictly(setup):
    _, _, variables, _, tcfg = setup
    sd = convert.from_jax_variables(variables, tcfg)
    model = tdet.GroupFree3DNet(tcfg)
    assert set(model.state_dict()) == set(sd)
    n_flax = sum(v.size for c in variables.values()
                 for v in jax.tree_util.tree_leaves(c))
    assert sum(v.numel() for v in sd.values()) == n_flax
    model.load_state_dict(sd)
    # the stacked attention: torch's rows [q; k; v], each kernel [C, h, d]
    # transposed, the out kernel [h, d, C] to [C, h * d]
    a = variables['params']['GroupFree3DHead_0']['decoder1']['cross_attn']
    key = 'bbox_head.decoder_layers.1.attentions.1.attn.'
    C = tcfg.head.in_channels
    w = sd[key + 'in_proj_weight'].numpy()
    for i, name in enumerate(('query', 'key', 'value')):
        np.testing.assert_array_equal(
            w[i * C:(i + 1) * C], a[name]['kernel'].reshape(C, C).T)
        np.testing.assert_array_equal(
            sd[key + 'in_proj_bias'].numpy()[i * C:(i + 1) * C],
            a[name]['bias'].reshape(-1))
    np.testing.assert_array_equal(sd[key + 'out_proj.weight'].numpy(),
                                  a['out']['kernel'].reshape(C, C).T)


def test_eval_forward_matches_gga_tpu(setup, train_pass):
    _, _, variables, inputs, tcfg = setup
    bundle = apis.init_groupfree3d_detector(
        tcfg, convert.from_jax_variables(variables, tcfg), device='cpu')
    with torch.no_grad():
        got = bundle.model(t(inputs[0]), t(inputs[1]))
    ref = train_pass['jeval']
    assert set(got) == set(ref)
    walk(got, ref, 1e-5)
    for g, r in zip(bundle.model.sampled_indices(got)['backbone'],
                    train_pass['jfps']):
        np.testing.assert_array_equal(g.numpy(), r)


def test_train_forward_matches_gga_tpu(train_pass):
    ref, got = train_pass['jpreds'], train_pass['preds']
    walk(got, ref, 1e-5)
    for g, r in zip(train_pass['indices']['backbone'], train_pass['jfps']):
        np.testing.assert_array_equal(g.numpy(), r)
    np.testing.assert_array_equal(train_pass['indices']['kps'].numpy(),
                                  ref['cand_idx'])


def test_sampled_indices_are_given_back(setup):
    """The picks passed back give the same forward; other picks another."""
    _, _, variables, inputs, tcfg = setup
    model = tdet.GroupFree3DNet(tcfg)
    model.load_state_dict(convert.from_jax_variables(variables, tcfg))
    model.eval()
    with torch.no_grad():
        first = model(t(inputs[0]), t(inputs[1]))
        idx = model.sampled_indices(first)
        again = model(t(inputs[0]), t(inputs[1]), sample_idx=idx)
        walk(again, {k: v for k, v in first.items()}, 0.0)
        flipped = dict(idx, kps=torch.flip(idx['kps'], [-1]))
        other = model(t(inputs[0]), t(inputs[1]), sample_idx=flipped)
    assert torch.equal(other['cand_idx'], flipped['kps'])
    assert not torch.equal(other['stages'][-1]['center'],
                           first['stages'][-1]['center'])


def test_targets_match_gga_tpu(setup, train_pass):
    _, _, _, inputs, tcfg = setup
    jp, ref = train_pass['jpreds'], train_pass['jtargets']
    got = thead.groupfree3d_targets(
        tcfg.head, *map(t, inputs[2:]), t(jp['seed_xyz']),
        t(jp['seed_valid']), t(jp['cand_idx']))
    assert set(got) == set(ref)
    for k in ref:
        close(got[k], ref[k], 1e-5, k)
    assert 0 < int(ref['objectness_targets'].sum())
    assert 0 < int(ref['sampling_targets'].sum())


@pytest.fixture(scope='module')
def loss_pair(setup, train_pass):
    _, _, _, inputs, tcfg = setup
    jp = train_pass['jpreds']
    # the train step's logs are gga_tpu's loss of these predictions
    ref = {k: v for k, v in train_pass['jlogs'].items() if k != 'grad_norm'}
    preds = jax.tree_util.tree_map(t, jp)
    _, got = thead.groupfree3d_loss(tcfg.head, preds, *map(t, inputs[2:]))
    return ref, got


@pytest.mark.parametrize('term', ('sampling_objectness_loss', 'proposal.loss',
                                  's0.loss', 's1.loss', 'loss'))
def test_loss_terms_match_gga_tpu(loss_pair, term):
    ref, got = loss_pair
    assert set(ref) | {'num_pos'} == set(got)
    assert float(got['num_pos']) > 0
    np.testing.assert_allclose(float(got[term]), float(ref[term]), rtol=1e-4,
                               err_msg=term)


def test_decode_matches_gga_tpu(setup, train_pass):
    _, _, _, _, tcfg = setup
    jeval = jax.tree_util.tree_map(np.array, train_pass['jeval'])
    st = jeval['stages'][-1]
    st['center'][:, 1::2] = st['center'][:, ::2] + 0.05
    ref = train_pass['jdecoded']
    got = thead.decode_groupfree3d(tcfg.head, jax.tree_util.tree_map(t, jeval))
    assert set(got) == set(ref)
    for k in ('labels', 'valid'):
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    for k in ('boxes', 'scores'):
        close(got[k], ref[k], 1e-5, k)
    assert 0 < int(ref['valid'].sum()) < ref['valid'].size


def test_train_step_logs_match_gga_tpu(train_pass):
    ref, got = train_pass['jlogs'], train_pass['logs']
    for k in tuple(ref):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)


def test_train_step_gradients_match_gga_tpu(train_pass):
    check_grads(train_pass['ref_grads'], train_pass['grads'])


def test_train_step_update_matches_gga_tpu(train_pass):
    update_within(train_pass['ref_state'], train_pass['state'],
                  train_pass['ref_grads'], OPTIMIZER['lr'],
                  OPTIMIZER['weight_decay'])


def test_dropout_draws_from_the_trainers_generator(setup):
    """At the config's dropout 0.1 the keep masks drop about a tenth of
    the entries; they come from the given generator (the same seed, the
    same masks), and the step draws them from the trainer's: a step given
    the masks of a generator seeded as the trainer's logs what the step
    that draws them logs."""
    _, _, variables, inputs, tcfg = setup
    tcfg = dataclasses.replace(tcfg, head=dataclasses.replace(tcfg.head,
                                                              dropout=0.1))
    draws = [thead.groupfree3d_draws(tcfg, B, torch.Generator().manual_seed(s),
                                     'cpu') for s in (3, 3, 4)]
    flat = [torch.cat([m.flatten() for d in dr for m in d.values()])
            for dr in draws]
    assert len(draws[0]) == tcfg.head.num_decoder_layers
    assert {k: tuple(v.shape) for k, v in draws[0][0].items()} == dict(
        self=(16, 16), cross=(16, 64), ffn=(B, 16, 32))
    assert torch.equal(flat[0], flat[1]) and not torch.equal(flat[0],
                                                             flat[2])
    assert abs(1 - float(flat[0].float().mean()) - 0.1) < 0.03
    assert thead.groupfree3d_draws(
        dataclasses.replace(tcfg, head=dataclasses.replace(
            tcfg.head, dropout=0.0)), B, torch.Generator(), 'cpu') is None

    sd = convert.from_jax_variables(variables, tcfg)
    batch = dict(zip(('points', 'points_valid', 'gt_boxes', 'gt_labels',
                      'gt_valid'), inputs))
    logs = []
    for keep in (None, thead.groupfree3d_draws(
            tcfg, B, torch.Generator().manual_seed(7), 'cpu'), 'none'):
        trainer = apis.init_groupfree3d_trainer(tcfg, SPE, sd, device='cpu',
                                                seed=7)
        if keep == 'none':
            keep = [dict(self=torch.ones(16, 16, dtype=torch.bool),
                         cross=torch.ones(16, 64, dtype=torch.bool),
                         ffn=torch.ones(B, 16, 32, dtype=torch.bool))] * 2
        logs.append(float(apis.groupfree3d_train_step(trainer, batch,
                                                      keep=keep)['loss']))
    assert logs[0] == logs[1] != logs[2]
    with pytest.raises(ValueError, match='keep masks'):
        tdet.GroupFree3DNet(tcfg).train()(t(inputs[0]), t(inputs[1]))
