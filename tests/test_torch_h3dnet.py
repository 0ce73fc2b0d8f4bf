"""The port's H3DNet against gga_tpu's, ``H3DNetConfig.tiny()`` (two
towers, the three primitive heads, the matching refinement), f32, CPU, on
VoteNet's test scene (B = 2 x 1024 points with the height channel, two
clusters) with eight boxes on a grid over it (``grid_objects``).

gga_tpu's variables (shapes from ``jax.eval_shape`` of its init, values
drawn with numpy) reach the port through ``convert.from_jax_variables``,
whose ``h3dnet_rules`` is ``torch2flax.h3dnet_rules`` on every key that
table maps, and equals ``export_h3dnet`` there. Both packages then run:

- the eval-mode and the train-mode forward: each tower's farthest point
  sampling exactly, every output (RPN, primitives, refined stage,
  matching scores) at 1e-5 of its largest entry in eval mode, 1e-4 in
  train mode (batch statistics);
- each primitive mode's targets against gga_tpu's vmapped
  ``_primitive_targets_single``: masks and classes exactly, offsets and
  sizes at 1e-5;
- every loss term at rtol 1e-4;
- ``decode_h3dnet`` on gga_tpu's eval output, every second refined
  centre next to the one before it and a slot for every proposal: boxes
  and scores at 1e-5, labels and valid exactly, some proposals
  suppressed;
- one ``h3dnet_train_step`` against ``value_and_grad`` of gga_tpu's loss
  with the 3x schedule's ``optax.chain(clip_by_global_norm(10),
  adamw(piecewise lr 0.008, weight_decay=0.01))``: the logs at rtol
  1e-4, each gradient at 1e-4 of the model's largest gradient entry, the
  weights after the step as ``test_torch_groupfree3d.py`` holds them.
"""
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from gga_tpu.models.detectors import h3dnet as jdet
from gga_tpu.models.roi_heads import h3d_head as jh3d
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models.detectors import h3dnet as tdet
from gga_tpu_torch.models.roi_heads import h3d_head as th3d
from tests.test_torch_groupfree3d import (check_grads, fps_chain, optax_step,
                                          step_pass, update_within, walk)
from tests.test_torch_ssd3d import close, fill, t
from tests.test_torch_votenet import B, scene
from tools.model_converters import torch2flax

torch.set_num_threads(1)

OPTIMIZER = apis.VOTENET_OPTIMIZER
SPE = 10
MODES = ('z', 'xy', 'line')


@pytest.fixture(scope='module')
def setup():
    cfg = jdet.H3DNetConfig.tiny()
    model = jdet.H3DNet(cfg)
    inputs = (*scene(), *grid_objects(cfg.rpn.max_objs))
    shapes = jax.eval_shape(lambda p, v: model.init(
        jax.random.PRNGKey(0), p, v, train=False), *inputs[:2])
    rng = np.random.RandomState(1)
    variables = {c: fill(shapes[c], rng) for c in ('params', 'batch_stats')}
    return cfg, model, variables, inputs, tdet.H3DNetConfig.tiny()


def grid_objects(M=8):
    """(gt boxes [B, M, 7] bottom-centre, labels, valid): M 1.4 x 1.4 x 1 m
    boxes on the floor of VoteNet's scene, on a 4 x 2 grid over it, so
    that the tiny model's proposals meet positives."""
    gt = np.zeros((B, M, 7), np.float32)
    xs = (-2.25, -0.75, 0.75, 2.25)
    for i in range(M):
        gt[:, i] = [xs[i % 4], -1.5 if i < 4 else 1.5, -1.2, 1.4, 1.4, 1.0,
                    0.0]
    labels = np.tile(np.arange(M) % 4, (B, 1)).astype(np.int32)
    return gt, labels, np.ones((B, M), bool)


def _decode_cfg(cfg):
    """A slot for every proposal."""
    return dataclasses.replace(cfg, rpn=dataclasses.replace(
        cfg.rpn, max_out=cfg.rpn.agg_num_point))


@pytest.fixture(scope='module')
def train_pass(setup):
    """gga_tpu's eval forward, sampling, primitive targets, decode,
    train-mode loss, gradient and one optax step, in one jit; the port's
    ``h3dnet_train_step`` from the same weights."""
    cfg, model, variables, inputs, tcfg = setup
    tx = optax_step(OPTIMIZER, SPE)

    def step(params, stats, pts, pv, gt, gl, gv):
        def loss_fn(p):
            out, upd = model.apply({'params': p, 'batch_stats': stats},
                                   pts, pv, train=True,
                                   mutable=['batch_stats'])
            total, logs = jdet.h3dnet_loss(cfg, out, gt, gl, gv)
            return total, (logs, out, upd['batch_stats'])

        (_, (logs, out, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        logs['grad_norm'] = optax.global_norm(grads)
        evaluated = model.apply({'params': params, 'batch_stats': stats},
                                pts, pv, train=False)
        targets = {pc.mode: jax.vmap(
            lambda p, v, b, l, g, pc=pc: jh3d._primitive_targets_single(
                pc, p, v, b, l, g))(out['fp_xyz'], out['fp_valid'], gt, gl,
                                    gv) for pc in cfg.primitives}
        ref = dict(evaluated['refined'])
        ref['center'] = ref['center'].at[:, 1::2].set(
            ref['center'][:, ::2] + 0.05)
        decoded = jdet.decode_h3dnet(_decode_cfg(cfg),
                                     dict(evaluated, refined=ref))
        return (logs, out, grads, optax.apply_updates(params, updates),
                new_stats, evaluated, targets, decoded,
                fps_chain(pts[..., :3], pv, cfg.backbone.num_points))

    (jlogs, jout, jgrads, jparams, jstats, jeval, jtargets, jdecoded,
     jfps) = jax.tree_util.tree_map(np.asarray, jax.jit(step)(
         variables['params'], variables['batch_stats'], *inputs))
    trainer = apis.init_h3dnet_trainer(
        tcfg, SPE, convert.from_jax_variables(variables, tcfg), device='cpu')
    batch = dict(zip(('points', 'points_valid', 'gt_boxes', 'gt_labels',
                      'gt_valid'), inputs))
    logs, out, grads = step_pass(
        trainer, lambda: apis.h3dnet_train_step(trainer, batch))
    return dict(jlogs=jlogs, jout=jout, jeval=jeval, jtargets=jtargets,
                jdecoded=jdecoded, jfps=jfps, logs=logs, out=out,
                indices=trainer.model.sampled_indices(), grads=grads,
                ref_grads=convert.from_jax_variables({'params': jgrads},
                                                     tcfg),
                state=trainer.model.state_dict(),
                ref_state=convert.from_jax_variables(
                    {'params': jparams, 'batch_stats': jstats}, tcfg))


def test_conversion_equals_torch2flax_on_its_keys(setup):
    """Every rule of ``torch2flax.h3dnet_rules`` is one of the port's, and
    the port's tensors equal ``export_h3dnet``'s on every key it exports;
    the rest are the refinement's, under the port's own keys; the module
    loads them strictly and holds every flax tensor."""
    cfg, _, variables, _, tcfg = setup
    ours = {(k, c, f) for k, c, f, _ in convert.h3dnet_rules(tcfg)}
    theirs = {(k, c, f) for k, c, f, _ in torch2flax.h3dnet_rules(cfg)}
    assert theirs <= ours
    sd = convert.from_jax_variables(variables, tcfg)
    ref = torch2flax.export_h3dnet(variables, cfg)
    assert set(ref) <= set(sd)
    for k, v in ref.items():
        v = np.asarray(v, np.float32)
        assert tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert all(k.startswith(('roi_head.bbox_head.', 'roi_head.refine_'))
               for k in set(sd) - set(ref))
    model = tdet.H3DNet(tcfg)
    assert set(model.state_dict()) == set(sd)
    n_flax = sum(v.size for c in variables.values()
                 for v in jax.tree_util.tree_leaves(c))
    assert sum(v.numel() for v in sd.values()) == n_flax
    model.load_state_dict(sd)


def test_eval_forward_matches_gga_tpu(setup, train_pass):
    _, _, variables, inputs, tcfg = setup
    bundle = apis.init_h3dnet_detector(
        tcfg, convert.from_jax_variables(variables, tcfg), device='cpu')
    with torch.no_grad():
        got = bundle.model(t(inputs[0]), t(inputs[1]))
    ref = train_pass['jeval']
    assert set(got) == set(ref)
    walk(got, ref, 1e-5)
    for tower in bundle.model.sampled_indices()['backbone']:
        for g, r in zip(tower, train_pass['jfps']):
            np.testing.assert_array_equal(g.numpy(), r)


def test_train_forward_matches_gga_tpu(train_pass):
    """At 1e-4 of each output's largest entry: the batch statistics of
    the 16- to 32-row batches of the tiny heads carry the two packages'
    rounding (their summation orders) a little past 1e-5 (1.7e-5 at
    most, in the matching scores)."""
    walk(train_pass['out'], train_pass['jout'], 1e-4)
    towers = train_pass['indices']['backbone']
    assert len(towers) == 2
    for tower in towers:
        for g, r in zip(tower, train_pass['jfps']):
            np.testing.assert_array_equal(g.numpy(), r)


def test_sampled_indices_are_given_back(setup):
    """The picks passed back give the same forward; other picks for the
    RPN's aggregation another."""
    _, _, variables, inputs, tcfg = setup
    model = tdet.H3DNet(tcfg)
    model.load_state_dict(convert.from_jax_variables(variables, tcfg))
    model.eval()
    with torch.no_grad():
        first = model(t(inputs[0]), t(inputs[1]))
        idx = model.sampled_indices()
        again = model(t(inputs[0]), t(inputs[1]), sample_idx=idx)
        walk(again, first, 0.0)
        other = model(t(inputs[0]), t(inputs[1]), sample_idx=dict(
            idx, rpn=torch.flip(idx['rpn'], [-1])))
    assert not torch.equal(other['refined']['center'],
                           first['refined']['center'])


@pytest.mark.parametrize('mode', MODES)
def test_primitive_targets_match_gga_tpu(setup, train_pass, mode):
    _, _, _, inputs, tcfg = setup
    jo = train_pass['jout']
    pc = {p.mode: p for p in tcfg.primitives}[mode]
    got = th3d._primitive_targets(pc, t(jo['fp_xyz']), t(jo['fp_valid']),
                                  *map(t, inputs[2:]))
    ref = train_pass['jtargets'][mode]
    walk(dict(zip(('mask', 'offset', 'sem', 'size'), got)),
         dict(zip(('mask', 'offset', 'sem', 'size'), ref)), 1e-5, f'{mode}.')
    assert int(ref[0].sum()) > 0


@pytest.fixture(scope='module')
def loss_pair(setup, train_pass):
    _, _, _, inputs, tcfg = setup
    jo = train_pass['jout']
    # the train step's logs are gga_tpu's loss of this output
    ref = {k: v for k, v in train_pass['jlogs'].items() if k != 'grad_norm'}
    _, got = tdet.h3dnet_loss(tcfg, jax.tree_util.tree_map(t, jo),
                              *map(t, inputs[2:]))
    return ref, got


def test_loss_terms_match_gga_tpu(loss_pair):
    ref, got = loss_pair
    assert set(got) == set(ref)
    assert len(ref) == 29
    assert float(got['refined.num_pos']) > 0
    for term in ref:
        np.testing.assert_allclose(float(got[term]), float(ref[term]),
                                   rtol=1e-4, err_msg=term)


def test_decode_matches_gga_tpu(setup, train_pass):
    _, _, _, _, tcfg = setup
    jeval = jax.tree_util.tree_map(np.array, train_pass['jeval'])
    ref_c = jeval['refined']['center']
    ref_c[:, 1::2] = ref_c[:, ::2] + 0.05
    ref = train_pass['jdecoded']
    got = tdet.decode_h3dnet(_decode_cfg(tcfg),
                             jax.tree_util.tree_map(t, jeval))
    assert set(got) == set(ref)
    for k in ('labels', 'valid'):
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    for k in ('boxes', 'scores'):
        close(got[k], ref[k], 1e-5, k)
    assert 0 < int(ref['valid'].sum()) < ref['valid'].size


def test_train_step_logs_match_gga_tpu(train_pass):
    ref, got = train_pass['jlogs'], train_pass['logs']
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)


def test_train_step_gradients_match_gga_tpu(train_pass):
    check_grads(train_pass['ref_grads'], train_pass['grads'])


def test_train_step_update_matches_gga_tpu(train_pass):
    update_within(train_pass['ref_state'], train_pass['state'],
                  train_pass['ref_grads'], OPTIMIZER['lr'],
                  OPTIMIZER['weight_decay'])
