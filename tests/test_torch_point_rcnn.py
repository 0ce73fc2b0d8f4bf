"""The port's PointRCNN against gga_tpu's, ``PointRCNNConfig.tiny()``,
f32, CPU, on the scene of ``tests/test_models/test_point_rcnn.py`` (B = 2
x 512 points of a KITTI-like wedge, 40 of them inside each of four
car-sized boxes).

gga_tpu's variables (``test_torch_ssd3d.jax_variables``: the conversion
rules' paths and shapes, values drawn with numpy) reach the port through
``convert.from_jax_variables``.
The train-mode cases give both packages gga_tpu's draw of the RoI sampler
(``jax.random.uniform`` of each scene's key) and the same proposals: the
GT boxes jittered twice each, four boxes off every object and two empty
slots a scene (``rpn_proposals`` of both packages replaced in train mode
for the test), so that the RoI stage meets positives, hard and easy
negatives. Both then
run:

- the train-mode forward: every output at 1e-4 of its largest entry
  (masks, labels and sampled slots exactly);
- the eval-mode forward, the proposals its own: the same;
- ``rpn_targets`` against gga_tpu's vmapped ``rpn_targets_single`` and
  ``build_rcnn_targets`` on gga_tpu's samples: masks exactly, the rest at
  1e-5; ``rpn_proposals`` on gga_tpu's RPN scores with zero box
  residuals, so that neighbouring boxes overlap, train and test
  thresholds: boxes and scores at 1e-5, labels and valid exactly, some
  suppressed;
- every term of ``point_rcnn_loss`` at rtol 1e-4;
- ``decode_point_rcnn`` on gga_tpu's eval output: boxes and scores at
  1e-5, labels and valid exactly;
- one ``point_rcnn_train_step`` against ``value_and_grad`` of gga_tpu's
  loss with its ``build_optimizer`` at the PointRCNN config's lr and betas
  (cyclic AdamW, clip 10): the logs at rtol 1e-4, each gradient at 1e-4
  of the model's largest gradient entry, the updated weights and BN
  statistics at 1e-4 (entries whose gradient is within that tolerance of
  0 within AdamW's two first steps' reach).

gga_tpu's functions are jitted once per case, the inputs passed as
arguments: closed over, they would be constants that XLA folds at
compile time in another summation order, and three-NN's squared
distance of a point to itself (all cancellation at KITTI's ranges) would
no longer be gga_tpu's run-time value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gga_tpu.models.dense_heads import point_rpn_head as jrpn
from gga_tpu.models.detectors import point_rcnn as jdet
from gga_tpu.models.roi_heads import build_rcnn_targets as jbuild_targets
from gga_tpu.train.optim import build_optimizer as jbuild_optimizer
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models.dense_heads import point_rpn_head as trpn
from gga_tpu_torch.models.detectors import point_rcnn as tdet
from gga_tpu_torch.models.roi_heads.part_aggregation import \
    build_rcnn_targets
from tests.test_torch_ssd3d import close, jax_variables, t

torch.set_num_threads(1)

B, P, G = 2, 512, 4
TOTAL_STEPS = 100
# proposal slots of the proposals' case: the tiny RPN's nms_pre
PROPOSE = 64
OPTIMIZER = dict(lr=0.001, betas=(0.95, 0.85), weight_decay=0.01,
                 grad_clip=10.0)
TERMS = ('rpn_bbox_loss', 'rpn_semantic_loss', 'loss_rcnn_cls',
         'loss_rcnn_bbox', 'loss_rcnn_corner', 'loss_rcnn', 'loss')


def scene(seed=1):
    """gga_tpu's test scene: (points, valid, gt boxes, labels, gt valid)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(2, 60, (B, P, 1))
    y = rng.uniform(-0.5, 0.5, (B, P, 1)) * (x * 0.8 + 5)
    z = rng.uniform(-2.0, 0.5, (B, P, 1))
    pts = np.concatenate([x, y, z, rng.rand(B, P, 1)], -1).astype(np.float32)
    gt = np.zeros((B, G, 7), np.float32)
    gt[..., 0] = rng.uniform(10, 50, (B, G))
    gt[..., 1] = rng.uniform(-10, 10, (B, G))
    gt[..., 2] = -1.8
    gt[..., 3:6] = [3.9, 1.6, 1.56]
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (B, G))
    for b in range(B):
        for g in range(G):
            pts[b, g * 40:(g + 1) * 40, :3] = (
                gt[b, g, :3] + rng.uniform(-0.5, 0.5, (40, 3))
                * gt[b, g, 3:6] * 0.45 + [0, 0, gt[b, g, 5] / 2])
    return (pts, np.ones((B, P), bool), gt, np.zeros((B, G), np.int32),
            np.ones((B, G), bool))


def given_proposals(gt, n, seed=3):
    """[B, n] proposals: each GT box jittered twice (positives and hard
    negatives), boxes off every object, the last two slots invalid."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, n, 7), np.float32)
    jit = np.repeat(gt, 2, 1)
    k = jit.shape[1]
    jit[..., :3] += rng.uniform(-0.6, 0.6, jit[..., :3].shape)
    jit[..., 6] += rng.uniform(-0.3, 0.3, jit[..., 6].shape)
    boxes[:, :k] = jit
    boxes[:, k:, 0] = rng.uniform(5, 55, (B, n - k))
    boxes[:, k:, 1] = rng.uniform(-20, 20, (B, n - k))
    boxes[:, k:, 2] = -1.8
    boxes[:, k:, 3:6] = [3.9, 1.6, 1.56]
    boxes[:, k:, 6] = rng.uniform(-np.pi, np.pi, (B, n - k))
    valid = np.ones((B, n), bool)
    valid[:, -2:] = False
    return dict(boxes=boxes, scores=rng.uniform(0.1, 1, (B, n)).astype(
        np.float32) * valid, labels=rng.randint(0, 3, (B, n)), valid=valid)


@pytest.fixture(scope='module')
def setup():
    cfg = jdet.PointRCNNConfig.tiny()
    model = jdet.PointRCNNDetector(cfg)
    inputs = scene()
    key = jax.random.PRNGKey(0)
    tcfg = tdet.PointRCNNConfig.tiny()
    variables = jax_variables(tcfg, tdet.PointRCNNDetector(tcfg),
                              np.random.RandomState(2))
    props = given_proposals(inputs[2], cfg.rpn.num_proposals)
    # gga_tpu's draw: jax.random.uniform of each scene's key
    u = np.stack([np.asarray(jax.random.uniform(k, (cfg.rpn.num_proposals,)))
                  for k in jax.random.split(key, B)])
    return cfg, model, variables, inputs, props, key, u, tcfg


@pytest.fixture(scope='module')
def train_pass(setup):
    """gga_tpu's train-mode loss, gradient and one optax step, and the
    port's ``point_rcnn_train_step`` from the same weights, draw and
    proposals, its train-mode output captured."""
    cfg, model, variables, inputs, props, key, u, tcfg = setup
    mp = pytest.MonkeyPatch()
    for mod, conv in ((jdet, jnp.asarray), (tdet, t)):
        real = mod.rpn_proposals
        mp.setattr(mod, 'rpn_proposals',
                   lambda *a, real=real, conv=conv: {
                       k: conv(v) for k, v in props.items()} if a[-1]
                   else real(*a))
    tx = jbuild_optimizer(TOTAL_STEPS, **OPTIMIZER)

    def step(params, stats, pts, pv, gt, gl, gv):
        def loss_fn(p):
            out, upd = model.apply(
                {'params': p, 'batch_stats': stats}, pts, pv, rng=key,
                gt_boxes=gt, gt_labels=gl, gt_valid=gv, train=True,
                mutable=['batch_stats'])
            total, logs = jdet.point_rcnn_loss(cfg, out, gt, gl, gv)
            return total, (logs, out, upd['batch_stats'])

        (_, (logs, out, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        logs['grad_norm'] = optax.global_norm(grads)
        evaluated = model.apply({'params': params, 'batch_stats': stats},
                                pts, pv, train=False)
        # the proposals' and the decode's cases, in the same compile
        bbox = jnp.zeros_like(out['rpn']['bbox']).at[..., 6].set(1.0)
        props_cfg = dataclasses.replace(cfg.rpn, num_proposals=PROPOSE)
        proposed = [jrpn.rpn_proposals(props_cfg, bbox, out['rpn']['cls'],
                                       out['fp_xyz'], out['fp_valid'], train)
                    for train in (True, False)]
        decoded = jdet.decode_point_rcnn(_decode_cfg(cfg), _decode_input(
            evaluated))
        return (logs, out, grads, optax.apply_updates(params, updates),
                new_stats, evaluated, proposed, decoded)

    try:
        (jlogs, jout, jgrads, jparams, jstats, jeval, jprops,
         jdecoded) = jax.tree_util.tree_map(
            np.asarray, jax.jit(step)(variables['params'],
                                      variables['batch_stats'], *inputs))
        trainer = apis.init_point_rcnn_trainer(
            tcfg, TOTAL_STEPS, convert.from_jax_variables(variables, tcfg),
            device='cpu', optimizer=OPTIMIZER)
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
        batch = dict(points=inputs[0], points_valid=inputs[1],
                     gt_boxes=inputs[2], gt_labels=inputs[3],
                     gt_valid=inputs[4])
        logs = apis.point_rcnn_train_step(trainer, batch, sample_u=t(u))
        for h in hooks:
            h.remove()
        del trainer.model.forward
    finally:
        mp.undo()
    return dict(jlogs=jlogs, jout=jout, jeval=jeval, jprops=jprops,
                jdecoded=jdecoded, logs=logs, out=captured, grads=grads,
                ref_grads=convert.from_jax_variables({'params': jgrads},
                                                     tcfg),
                state=trainer.model.state_dict(),
                ref_state=convert.from_jax_variables(
                    {'params': jparams, 'batch_stats': jstats}, tcfg))


def _flat(d, prefix=''):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f'{prefix}{k}.'))
        else:
            out[f'{prefix}{k}'] = v
    return out


def test_conversion_loads_strictly(setup):
    variables, tcfg = setup[2], setup[-1]
    sd = convert.from_jax_variables(variables, tcfg)
    model = tdet.PointRCNNDetector(tcfg)
    assert set(model.state_dict()) == set(sd)
    n_flax = sum(v.size for c in variables.values()
                 for v in jax.tree_util.tree_leaves(c))
    assert sum(v.numel() for v in sd.values()) == n_flax
    model.load_state_dict(sd)


def test_train_forward_matches_gga_tpu(train_pass):
    ref, got = _flat(train_pass['jout']), _flat(train_pass['out'])
    assert set(ref) <= set(got)
    for k in ref:
        close(got[k], ref[k], 1e-4, k)
    samples = train_pass['jout']['samples']
    assert 0 < int(samples['pos_mask'].sum()) < int(samples['roi_valid'].sum())


@pytest.fixture(scope='module')
def eval_pass(setup, train_pass):
    """gga_tpu's eval-mode forward (its own proposals; jitted with the
    train step) and the port's."""
    variables, inputs, tcfg = setup[2], setup[3], setup[-1]
    bundle = apis.init_point_rcnn_detector(
        tcfg, convert.from_jax_variables(variables, tcfg), device='cpu')
    with torch.no_grad():
        got = bundle.model(t(inputs[0]), t(inputs[1]))
    return train_pass['jeval'], got


def test_eval_forward_matches_gga_tpu(eval_pass):
    ref, got = map(_flat, eval_pass)
    for k in ref:
        close(got[k], ref[k], 1e-4, k)
    assert int(ref['props.valid'].sum()) > 0


def test_rpn_targets_match_gga_tpu(setup, train_pass):
    cfg, tcfg, inputs = setup[0], setup[-1], setup[3]
    jo = train_pass['jout']
    args = (jo['fp_xyz'], jo['fp_valid'], *inputs[2:])
    ref = jax.jit(jax.vmap(lambda *a: jrpn.rpn_targets_single(cfg.rpn, *a)))(
        *args)
    got = trpn.rpn_targets(tcfg.rpn, *map(t, args))
    assert set(got) == set(ref)
    for k in ref:
        close(got[k], ref[k], 1e-5, k)
    assert int(np.asarray(ref['positive']).sum()) > 0


def test_rcnn_targets_match_gga_tpu(setup, train_pass):
    cfg, tcfg = setup[0], setup[-1]
    samples = train_pass['jout']['samples']
    ref = jax.jit(lambda s: jbuild_targets(cfg.bbox, s))(samples)
    got = build_rcnn_targets(tcfg.bbox, {k: t(v) for k, v in samples.items()})
    assert set(got) == set(ref)
    for k in ref:
        close(got[k], ref[k], 1e-5, k)
    assert int(np.asarray(ref['reg_mask']).sum()) > 0


@pytest.fixture(scope='module')
def proposal_pair(setup, train_pass):
    """``rpn_proposals`` of both packages at the train and the test
    threshold (gga_tpu's jitted with the train step), on gga_tpu's RPN
    scores with no box residuals (cos 1, sin 0): axis-aligned boxes of the
    mean sizes at their points, so that the clusters' boxes overlap; a
    slot for every top point, so that the suppressed ones show."""
    tcfg = setup[-1]
    jo = train_pass['jout']
    bbox = np.zeros_like(jo['rpn']['bbox'])
    bbox[..., 6] = 1.0
    args = (bbox, jo['rpn']['cls'], jo['fp_xyz'], jo['fp_valid'])
    trpn_cfg = dataclasses.replace(tcfg.rpn, num_proposals=PROPOSE)
    got = [trpn.rpn_proposals(trpn_cfg, *map(t, args), train)
           for train in (True, False)]
    return train_pass['jprops'], got, PROPOSE


@pytest.mark.parametrize('train', [True, False])
def test_rpn_proposals_match_gga_tpu(proposal_pair, train):
    refs, gots, n = proposal_pair
    ref, got = refs[1 - train], gots[1 - train]
    assert set(got) == set(ref)
    for k in ('labels', 'valid'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    for k in ('boxes', 'scores'):
        close(got[k], ref[k], 1e-5, k)
    kept = np.asarray(ref['valid']).sum(-1)
    assert (kept > 0).all() and (kept < n).any()


@pytest.fixture(scope='module')
def loss_pair(setup, train_pass):
    cfg, tcfg, inputs = setup[0], setup[-1], setup[3]
    jo = train_pass['jout']
    ref = jax.jit(lambda o, *gt: jdet.point_rcnn_loss(cfg, o, *gt)[1])(
        jo, *inputs[2:])

    def tree(d):
        return {k: tree(v) if isinstance(v, dict) else t(v)
                for k, v in d.items()}

    _, got = tdet.point_rcnn_loss(tcfg, tree(jo), *map(t, inputs[2:]))
    return ref, got


@pytest.mark.parametrize('term', TERMS)
def test_loss_terms_match_gga_tpu(loss_pair, term):
    ref, got = loss_pair
    assert float(got['num_pos']) > 0
    np.testing.assert_allclose(float(got[term]), float(ref[term]), rtol=1e-4,
                               err_msg=term)


def _decode_cfg(cfg):
    """Every valid RoI decoded: no score threshold."""
    return dataclasses.replace(cfg, bbox=dataclasses.replace(
        cfg.bbox, test_score_thr=0.0))


def _decode_input(out):
    """The eval output with small refinements: the RoIs' own boxes, which
    the RPN's NMS at 0.85 left overlapping, so that the 0.1 NMS of the
    decode suppresses."""
    return dict(out, rcnn=dict(out['rcnn'], reg=out['rcnn']['reg'] * 0.05))


def test_decode_matches_gga_tpu(setup, train_pass):
    tcfg = setup[-1]
    ref = train_pass['jdecoded']

    def tree(d):
        return {k: tree(v) if isinstance(v, dict) else t(v)
                for k, v in d.items()}

    jo = _decode_input(train_pass["jeval"])
    got = tdet.decode_point_rcnn(_decode_cfg(tcfg), tree(jo))
    assert set(got) == set(ref)
    for k in ('labels', 'valid'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    for k in ('boxes', 'scores'):
        close(got[k], ref[k], 1e-5, k)
    n = np.asarray(ref['valid']).sum(-1)
    assert (n > 0).all() and (n < np.asarray(jo['props']['valid']).sum(-1)
                              ).any()


def test_train_step_logs_match_gga_tpu(train_pass):
    ref, got = train_pass['jlogs'], train_pass['logs']
    for k in TERMS + ('grad_norm',):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)


def _grad_scale(grads):
    return max(float(g.abs().max()) for g in grads.values())


def test_train_step_gradients_match_gga_tpu(train_pass):
    """Each gradient at 1e-4 of the model's largest gradient entry: the
    loss is one scalar, and a few of its sums nearly cancel (the RCNN's
    cls bias, within 4e-4 of its own size between the packages)."""
    ref, got = train_pass['ref_grads'], train_pass['grads']
    assert set(got) == set(ref)
    tol = 1e-4 * _grad_scale(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=0,
                                   atol=tol, err_msg=k)


def test_train_step_update_matches_gga_tpu(train_pass):
    """The weights and BN statistics after the step at 1e-4 of each
    tensor's largest entry; where gga_tpu's gradient is within the
    gradient test's tolerance of 0, AdamW's first step (lr times
    g / (|g| + 1e-8)) is set by rounding, and the two weights are only
    held within the two steps' reach, 2 lr (1 + weight decay |w|)."""
    ref, state = train_pass['ref_state'], train_pass['state']
    grads = train_pass['ref_grads']
    assert set(ref) == set(state)
    unresolved = 1e-4 * _grad_scale(grads)
    lr, wd = OPTIMIZER['lr'], OPTIMIZER['weight_decay']
    for k, r in ref.items():
        r, g = r.numpy(), state[k].numpy()
        d = np.abs(g - r)
        tol = np.full(r.shape, 1e-4 * max(float(np.abs(r).max()), 1e-30))
        if k in grads:
            free = np.abs(grads[k].numpy()) < unresolved
            tol = np.where(free, 2 * lr * (1 + wd * np.abs(r)) + tol, tol)
        assert (d <= tol).all(), (k, float(d.max()))
