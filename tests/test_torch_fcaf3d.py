"""The port's FCAF3D detector against gga_tpu's, tiny config, f32, CPU.

gga_tpu's ``FCAF3DDetector`` variables (shapes from its init, values drawn
with numpy) reach the port through ``convert.from_jax_variables``. Both
packages then run the same two clouds (``FCAF3DModelConfig.tiny()``,
B = 2 x 512 points, two clusters with a box each):

- the voxelization exactly; the backbone's four levels (coordinates and
  sites exactly, features at rtol 1e-4 + atol 1e-4) and the head's
  outputs at every level (sites exactly, points at 1e-6, center / bbox /
  cls at rtol 1e-4 + atol 1e-4) in train mode, where every norm takes
  the batch's statistics; the BN statistics' updates at 1e-4;
- each loss term at rtol 1e-4, each parameter's gradient at cosine
  >= 0.9999 (f32 sums through 20 sparse convs in another order);
- the FCAF3D optimizer against ``optax.chain(clip_by_global_norm(10),
  adamw(piecewise_constant_schedule, weight_decay=1e-4))`` over three
  steps at rtol 1e-5, with the clip on and off and a decay boundary
  passed, and its schedule against optax's within 2 f32 ulps of the lr;
- the conversion: every variable of gga_tpu's tree lands in exactly one
  tensor of the port's state_dict, which loads strictly, and comes back
  unchanged.

The eval-mode forward and the decode are held against gga_tpu's in
``tests/test_torch_indoor.py``, which imports this file's helpers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gga_tpu.models.backbones.mink_resnet import MinkResNet as JMinkResNet
from gga_tpu.models.dense_heads import fcaf3d_head as jfh
from gga_tpu.models.detectors import fcaf3d as jdet
from gga_tpu.ops import scatter as jscatter
from gga_tpu.ops import voxelize as jvox
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models.dense_heads import fcaf3d_head as tfh
from gga_tpu_torch.models.detectors import fcaf3d as tdet
from gga_tpu_torch.train import optim as topt

torch.set_num_threads(1)

B, P = 2, 512
TERMS = ('center_loss', 'bbox_loss', 'cls_loss', 'loss', 'num_pos')


def _fill(tree, rng, path=()):
    """Numpy values for a tree of shapes: sparse kernels uniform,
    variance-keeping; the head's 1x1 convs normal(0, 0.1) so that scores
    spread; BN and instance-norm scales, running variances and the
    per-level scales near 1; small biases and means."""
    if hasattr(tree, 'items'):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name in ('w_center', 'w_reg', 'w_cls'):
        v = rng.randn(*shape) * 0.1
    elif len(shape) == 3:
        bound = np.sqrt(3.0 / (shape[0] * shape[1]))
        v = rng.uniform(-bound, bound, shape)
    elif name in ('scale', 'var') or name.startswith('scale'):
        v = rng.uniform(0.8, 1.2, shape)
    elif name == 'b_cls':
        v = np.full(shape, -2.0)
    else:                                   # bias, mean
        v = rng.uniform(-0.1, 0.1, shape)
    return np.asarray(v, np.float32)


def fill_variables(shapes, seed=0):
    """gga_tpu's {'params', 'batch_stats'} of the given shapes, drawn."""
    return _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                 np.random.RandomState(seed))


def clouds(seed=0):
    rng = np.random.RandomState(seed)
    bg = np.stack([rng.uniform(-4, 4, (B, P - 200)),
                   rng.uniform(-4, 4, (B, P - 200)),
                   rng.uniform(-2, 2, (B, P - 200))], -1)
    c1 = np.array([1.0, 1.0, 0.0]) + rng.randn(B, 100, 3) * 0.3
    c2 = np.array([-2.0, -2.0, 0.0]) + rng.randn(B, 100, 3) * 0.3
    pts = np.concatenate([bg, c1, c2], 1).astype(np.float32)
    colors = rng.rand(B, P, 3).astype(np.float32)
    return pts, colors, np.ones((B, P), bool)


def objects(cfg):
    M = cfg.head.max_objs
    gt = np.zeros((B, M, 7), np.float32)
    gt[:, 0] = [1.0, 1.0, 0.0, 2.0, 1.5, 1.0, 0.3]
    gt[:, 1] = [-2.0, -2.0, 0.0, 1.0, 1.0, 2.0, -0.5]
    labels = np.full((B, M), -1, np.int32)
    labels[:, :2] = [0, 2]
    valid = np.zeros((B, M), bool)
    valid[:, :2] = True
    return gt, labels, valid


@pytest.fixture(scope='module')
def setup():
    """gga_tpu's model and variables: drawn values with the BN running
    statistics zero (a train-mode pass takes the batch's statistics), and
    the drawn ones."""
    cfg = jdet.FCAF3DModelConfig.tiny()
    model = jdet.FCAF3DDetector(cfg)
    inputs = clouds()
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), *inputs, train=False))
    drawn = fill_variables(shapes)
    variables = dict(drawn, batch_stats=jax.tree_util.tree_map(
        np.zeros_like, drawn['batch_stats']))
    return (cfg, model, variables, inputs, tdet.FCAF3DModelConfig.tiny(),
            drawn)


@pytest.fixture(scope='module')
def train_pass(setup):
    """One train-mode forward, loss and gradient in both packages, from
    the same weights, clouds and objects; gga_tpu's backbone outputs
    captured from the same pass."""
    cfg, model, variables, inputs, tcfg, _ = setup
    objs = objects(cfg)

    def loss_fn(params):
        outs, state = model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            *inputs, train=True, mutable=['batch_stats', 'intermediates'],
            capture_intermediates=lambda mdl, _: isinstance(mdl,
                                                            JMinkResNet))
        total, logs = jfh.loss(cfg.head, outs, *objs)
        bb = state['intermediates']['MinkResNet_0']['__call__'][0]
        return total, (logs, outs, bb, state['batch_stats'])

    (_, (jlogs, jouts, jbb, jstats)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables['params'])

    trainer = apis.init_fcaf3d_trainer(
        tcfg, 1, convert.from_jax_variables(variables, tcfg), device='cpu')
    model_t = trainer.model.train()
    feats, coords, valid = model_t.voxelize(*map(torch.from_numpy, inputs))
    captured = []
    real = model_t.backbone.forward

    def keep(*a, **k):
        captured.append(real(*a, **k))
        return captured[-1]

    model_t.backbone.forward = keep
    outs = model_t(*map(torch.from_numpy, inputs))
    del model_t.backbone.forward
    total, logs = tfh.loss(tcfg.head, outs,
                           *(torch.from_numpy(o) for o in objs))
    total.backward()
    grads = {k: p.grad for k, p in model_t.named_parameters()}
    ref_grads = convert.from_jax_variables(
        {'params': jax.tree_util.tree_map(np.asarray, jgrads)}, tcfg)
    ref_stats = convert.from_jax_variables(
        {'batch_stats': jax.tree_util.tree_map(np.asarray, jstats)}, tcfg)
    stats = {k: b for k, b in model_t.state_dict().items()
             if k.endswith(('running_mean', 'running_var'))}
    return dict(jlogs=jlogs, logs=logs, jouts=jouts, outs=outs, jbb=jbb,
                bb=captured[0], grads=grads, ref_grads=ref_grads,
                stats=stats, ref_stats=ref_stats,
                vox=(feats, coords, valid))


def test_voxelization_equals_gga_tpu(setup, train_pass):
    cfg, inputs = setup[0], setup[3]
    vs, rng = (cfg.voxel_size,) * 3, tuple(cfg.pc_range)
    grid = tdet.FCAF3DModelConfig.tiny().grid_zyx

    def vox(p, col, v):        # gga_tpu's FCAF3DDetector.__call__ vox
        out = jvox.hard_voxelize(p, v, voxel_size=vs, pc_range=rng,
                                 max_points=1, max_voxels=cfg.max_voxels)
        pc, ok = jvox.dynamic_voxelize(p, v, voxel_size=vs, pc_range=rng)
        ids = jscatter.assign_point_voxel_ids(
            pc, out['coords'], ok, out['coords'][:, 0] >= 0, grid)
        mean_col, _ = jscatter.dynamic_scatter_mean(col, ids, ok,
                                                    cfg.max_voxels)
        return (mean_col, out['coords'],
                jnp.arange(cfg.max_voxels) < out['num_voxels'])

    ref = jax.jit(jax.vmap(vox))(*inputs)
    for got, r in zip(train_pass['vox'], ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(r))


def test_backbone_matches_gga_tpu(train_pass):
    assert len(train_pass['bb']) == len(train_pass['jbb']) == 4
    for lvl, (got, ref) in enumerate(zip(train_pass['bb'],
                                         train_pass['jbb'])):
        assert got[3] == tuple(ref[3]), lvl
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        np.testing.assert_allclose(got[0].detach().numpy(),
                                   np.asarray(ref[0]), rtol=1e-4, atol=1e-4,
                                   err_msg=str(lvl))


def test_head_outputs_match_gga_tpu(train_pass):
    for lvl, (got, ref) in enumerate(zip(train_pass['outs'],
                                         train_pass['jouts'])):
        assert set(got) == set(ref)
        np.testing.assert_array_equal(got['valid'].numpy(),
                                      np.asarray(ref['valid']))
        assert bool(got['valid'].any()), lvl
        v = got['valid'].numpy()
        np.testing.assert_allclose(got['points'].numpy()[v],
                                   np.asarray(ref['points'])[v], rtol=1e-6,
                                   atol=1e-6)
        for key in ('center', 'bbox', 'cls'):
            np.testing.assert_allclose(got[key].detach().numpy(),
                                       np.asarray(ref[key]), rtol=1e-4,
                                       atol=1e-4, err_msg=f'{lvl} {key}')


def test_bn_statistics_updates_match_gga_tpu(train_pass):
    ref, stats = train_pass['ref_stats'], train_pass['stats']
    assert set(ref) == set(stats) and len(ref) > 40
    for key, r in ref.items():
        np.testing.assert_allclose(stats[key].numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=key)


@pytest.mark.parametrize('term', TERMS)
def test_loss_terms_match_gga_tpu(train_pass, term):
    assert float(train_pass['jlogs']['num_pos']) > 0
    np.testing.assert_allclose(float(train_pass['logs'][term].detach()),
                               float(train_pass['jlogs'][term]), rtol=1e-4)


def test_gradients_match_gga_tpu(train_pass):
    ref, grads = train_pass['ref_grads'], train_pass['grads']
    assert set(ref) == set(grads)
    low = {}
    for key, g in grads.items():
        a, r = g.double().flatten(), ref[key].double().flatten()
        if r.norm() == 0:
            assert a.norm() == 0, key
            continue
        cos = float(a @ r / (a.norm() * r.norm()))
        if cos < 0.9999:
            low[key] = cos
    assert not low, low


def test_schedule_matches_optax():
    bounds = {16: 0.1, 22: 0.1}
    ref = optax.piecewise_constant_schedule(1e-3, bounds)
    out = topt.piecewise_constant_schedule(1e-3, bounds)
    for step in (0, 1, 15, 16, 17, 21, 22, 23, 100):
        want = float(ref(jnp.int32(step)))
        assert abs(out(step) - want) <= 2 * np.spacing(np.float32(want)), (
            step, out(step), want)


@pytest.mark.parametrize('grad_scale', [1.0, 50.0])
def test_fcaf3d_optimizer_matches_optax(grad_scale):
    """grad_scale 50 puts the global norm above the clip of 10; the lr
    passes a decay boundary at the third step (steps_per_epoch 1,
    lr_steps (2, 8))."""
    rng = np.random.RandomState(0)
    shapes = {'a': (4, 3), 'b': (5,), 'c': (2, 3, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * grad_scale).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    sched = optax.piecewise_constant_schedule(0.01, {2: 0.1, 8: 0.1})
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     optax.adamw(sched, weight_decay=1e-4))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    o = topt.build_fcaf3d_optimizer(tp.values(), steps_per_epoch=1, lr=0.01,
                                    weight_decay=1e-4, grad_clip=10.0,
                                    lr_steps=(2, 8), lr_gamma=0.1)
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        updates, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = o.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)),
                                   rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    assert o.count == 3


def to_jax_variables(state_dict, cfg):
    """The port's state_dict -> gga_tpu's variable trees (every FCAF3D
    rule copies as it is)."""
    out = {'params': {}, 'batch_stats': {}}
    for tk, coll, fp, tr in convert.fcaf3d_rules(cfg):
        assert tr == 'copy'
        node = out[coll]
        *scopes, leaf = fp.split('/')
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = state_dict[tk].numpy().copy()
    return out


def test_conversion_round_trip(setup):
    tcfg, variables = setup[4], setup[5]
    sd = convert.from_jax_variables(variables, tcfg)
    det = tdet.FCAF3DDetector(tcfg)
    det.load_state_dict(sd)                   # strict: every key, once
    rules = convert.fcaf3d_rules(tcfg)
    assert len({r[2] for r in rules}) == len(rules) == len(sd)
    back = to_jax_variables(det.state_dict(), tcfg)
    flat = jax.tree_util.tree_leaves_with_path(variables)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf, err_msg=str(path))
