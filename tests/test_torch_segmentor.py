"""The port's PointNet++ segmentor (``EncoderDecoder3D``, SSG and MSG)
against gga_tpu's, tiny configs, f32, CPU, on ``seg_scene``: B = 2 rooms
of 512 points, the second with 40 padded points, labels by position and a
few at the ignore index.

gga_tpu's variables (paths and shapes from ``convert.rules_of``, values
drawn with numpy) reach the port through ``convert.from_jax_variables``.
One jitted gga_tpu pass a config (``reference_pass``) gives the eval
forward, each level's farthest point sampling, and one train step: the
train-mode forward with a dropout rng (its output captured, whose non-zero
entries are the keep mask the port is given), ``segmentation_loss`` with
class weights and the ignore index, the gradients and one step of
``build_optimizer``'s optax chain (the cyclic AdamW every config trains
with). The port then holds:

- the eval forward at 1e-5 of its largest entry, every FPS level exactly;
- the train step: the train-mode logits at 1e-4, the losses at rtol 1e-5,
  each gradient at 1e-4 of the largest, the weights and BN statistics
  after the step as ``test_torch_point_rcnn.py`` holds them;
- ``inference_segmentor`` against gga_tpu's on one padded cloud, labels
  equal wherever the top-two logit margin exceeds 1e-4.

``seg_scene``, ``reference_pass``, ``port_step`` and ``JaxSeg`` serve the
DGCNN and PAConv files.
"""
import dataclasses

import flax.linen as fnn
import jax
import numpy as np
import optax
import pytest
import torch

from gga_tpu import apis as japis
from gga_tpu.models.segmentors import encoder_decoder as jenc
from gga_tpu.train import optim as joptim
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models.segmentors import base as tbase
from gga_tpu_torch.models.segmentors import encoder_decoder as tenc
from tests.test_torch_groupfree3d import (check_grads, fps_chain, step_pass,
                                          update_within)
from tests.test_torch_ssd3d import close, fill, t

torch.set_num_threads(1)

B, P, NUM_CLASSES, IGNORE = 2, 512, 6, 6
TOTAL_STEPS = 100
OPTIMIZER = dict(lr=0.001, weight_decay=0.01, grad_clip=10.0,
                 lr_policy='cosine', min_lr_ratio=1e-3)


def seg_scene(channels=6, seed=0, num_classes=NUM_CLASSES, ignore=IGNORE):
    """(points [B, P, channels], valid, labels, class weights): a 3 x 3 x
    1.5 m room of uniform points with colours (and, at 9 channels, the xyz
    over the room's per-axis maximum, as mmdet3d's S3DIS pipeline), the
    second room's last 40 points padding, labels by position with every
    tenth point at ``ignore``."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform([0, 0, 0], [3, 3, 1.5], (B, P, 3))
    parts = [xyz, rng.uniform(0, 1, (B, P, 3))]
    if channels == 9:
        parts.append(xyz / xyz.max(1, keepdims=True))
    pts = np.concatenate(parts, -1).astype(np.float32)
    valid = np.ones((B, P), bool)
    valid[1, -40:] = False
    labels = ((xyz[..., 0] // 0.6).astype(np.int64)
              + 2 * (xyz[..., 2] > 0.9)) % num_classes
    labels[:, ::10] = ignore
    weights = rng.uniform(0.5, 2.0, num_classes).astype(np.float32)
    return pts, valid, labels, weights


def jax_variables(tcfg, model, rng):
    """gga_tpu's variables of the segmentor ``tcfg`` describes, paths and
    shapes read off the port's ``model`` through ``convert.rules_of``
    (a path gga_tpu lacks or misses fails its forward), values by
    ``fill``."""
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


@dataclasses.dataclass
class JaxSeg:
    """A gga_tpu segmentor with its variables and the port's config."""
    model: object
    variables: dict
    tcfg: object
    extra_loss: object = None          # params -> an added loss term
    capture: object = None             # eval intermediates to capture


def reference_pass(ref: JaxSeg, inputs, num_points, key=0):
    """gga_tpu's eval forward (with ``ref.capture``'s intermediates), FPS
    chain over ``num_points`` (None: none), and one train step (forward
    with the dropout rng ``key``, loss, gradients, the optax update), in
    one jit. Returns a dict of numpy trees."""
    tx = joptim.build_optimizer(TOTAL_STEPS, lr=OPTIMIZER['lr'],
                                weight_decay=OPTIMIZER['weight_decay'],
                                grad_clip=OPTIMIZER['grad_clip'])
    model = ref.model

    def fn(params, stats, pts, pv, lab, w, rng):
        evaluated, inter = model.apply(
            {'params': params, 'batch_stats': stats}, pts, pv, train=False,
            capture_intermediates=ref.capture or False,
            mutable=['intermediates'])

        def loss_fn(p):
            logits, upd = model.apply(
                {'params': p, 'batch_stats': stats}, pts, pv, train=True,
                rngs={'dropout': rng},
                mutable=['batch_stats', 'intermediates'],
                capture_intermediates=lambda m, n: isinstance(
                    m, fnn.Dropout) or bool(ref.capture and ref.capture(m, n)))
            ce = jenc.segmentation_loss(logits, lab, pv, w, IGNORE)
            logs = {'loss_sem_seg': ce}
            total = ce
            if ref.extra_loss is not None:
                logs['loss_regularize'] = ref.extra_loss(p)
                total = total + logs['loss_regularize']
            logs['loss'] = total
            return total, (logs, logits, upd['batch_stats'],
                           upd['intermediates'])

        (_, (logs, logits, new_stats, train_inter)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        logs['grad_norm'] = optax.global_norm(grads)
        fps = (fps_chain(pts[..., :3], pv, num_points)
               if num_points is not None else [])
        return dict(eval=evaluated, inter=inter.get('intermediates', {}),
                    train_inter=train_inter, fps=fps, logs=logs,
                    logits=logits, dropped=dropout_output(train_inter),
                    grads=grads, params=optax.apply_updates(params, updates),
                    stats=new_stats)

    out = jax.jit(fn)(ref.variables['params'], ref.variables['batch_stats'],
                      *inputs, jax.random.PRNGKey(key))
    return jax.tree_util.tree_map(np.asarray, out)


def dropout_output(tree):
    """The one captured ``nn.Dropout`` output of a flax intermediates
    tree."""
    for k, v in tree.items():
        if k.startswith('Dropout'):
            return v['__call__'][0]
        if isinstance(v, dict):
            out = dropout_output(v)
            if out is not None:
                return out
    return None


def port_step(ref: JaxSeg, res, inputs, picks=None):
    """The port's ``segmentor_train_step`` from the same weights, given
    gga_tpu's dropout keep mask (and ``picks`` where given). Adds logs, logits, grads, state and their
    references to ``res``."""
    tcfg = ref.tcfg
    trainer = apis.init_segmentor_trainer(
        tcfg, TOTAL_STEPS, convert.from_jax_variables(ref.variables, tcfg),
        device='cpu', optimizer=OPTIMIZER)
    pts, pv, lab, w = inputs
    batch = dict(points=pts, points_valid=pv, seg_labels=lab)
    keep = t(res['dropped'] != 0)
    logs, logits, grads = step_pass(trainer, lambda: apis.segmentor_train_step(
        trainer, batch, w, IGNORE, keep=keep, picks=picks))
    res.update(port_logs=logs, port_logits=logits, port_grads=grads,
               port_picks=trainer.model.last_picks,
               state=trainer.model.state_dict(),
               ref_grads=convert.from_jax_variables({'params': res['grads']},
                                                    tcfg),
               ref_state=convert.from_jax_variables(
                   {'params': res['params'], 'batch_stats': res['stats']},
                   tcfg))
    return res


def msg_tiny():
    """The tiny config with the two-branch MSG encoder on 9 channels."""
    return dict(msg=True, in_channels=9,
                msg_radii=((0.2, 0.4), (0.4, 0.8), (0.8, 1.6), (1.6, 3.2)),
                msg_num_samples=((8, 16), (8, 16), (8, 8), (4, 8)),
                msg_sa_channels=(((8,), (8, 8)), ((8,), (16,)),
                                 ((16,), (8, 16)), ((16,), (16,))))


CONFIGS = dict(ssg={}, msg=msg_tiny())


@pytest.fixture(scope='module', params=sorted(CONFIGS))
def seg(request):
    kw = CONFIGS[request.param]
    jcfg = dataclasses.replace(jenc.EncoderDecoder3DConfig.tiny(), **kw)
    tcfg = dataclasses.replace(tenc.EncoderDecoder3DConfig.tiny(), **kw)
    ref = JaxSeg(jenc.EncoderDecoder3D(jcfg),
                 jax_variables(tcfg, tenc.EncoderDecoder3D(tcfg),
                               np.random.RandomState(1)), tcfg)
    inputs = seg_scene(tcfg.in_channels)
    res = port_step(ref, reference_pass(ref, inputs, tcfg.num_points),
                    inputs)
    return request.param, ref, inputs, res


def test_conversion_loads_strictly(seg):
    _, ref, _, _ = seg
    sd = convert.from_jax_variables(ref.variables, ref.tcfg)
    model = tenc.EncoderDecoder3D(ref.tcfg)
    assert set(model.state_dict()) == set(sd)
    n_flax = sum(v.size for c in ref.variables.values()
                 for v in jax.tree_util.tree_leaves(c))
    assert sum(v.numel() for v in sd.values()) == n_flax
    model.load_state_dict(sd)
    assert any(k.startswith('decode_head.FP_modules.3.mlps.layer1')
               for k in sd)


def test_eval_forward_matches_gga_tpu(seg):
    name, ref, inputs, res = seg
    bundle = apis.init_segmentor(
        ref.tcfg, convert.from_jax_variables(ref.variables, ref.tcfg),
        device='cpu')
    with torch.no_grad():
        got = bundle.model(t(inputs[0]), t(inputs[1]))
    close(got, res['eval'], 1e-5, name)
    assert not got[1, -40:].any()              # padding's logits are 0
    assert len(bundle.model.last_picks) == len(ref.tcfg.num_points)
    for g, r in zip(bundle.model.last_picks, res['fps']):
        np.testing.assert_array_equal(g.numpy(), r)


def test_train_forward_matches_gga_tpu(seg):
    name, _, _, res = seg
    # half the entries dropped, and many of the rest zero after the ReLU
    assert 0.1 < (res['dropped'] != 0).mean() < 0.5
    close(res['port_logits'], res['logits'], 1e-4, name)
    for g, r in zip(res['port_picks'], res['fps']):
        np.testing.assert_array_equal(g.numpy(), r)


def test_train_step_losses_match_gga_tpu(seg):
    _, _, _, res = seg
    ref, got = res['logs'], res['port_logs']
    assert set(got) == set(ref)
    for k in ('loss_sem_seg', 'loss'):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(got['grad_norm']),
                               float(ref['grad_norm']), rtol=1e-4)


def test_train_step_gradients_match_gga_tpu(seg):
    check_grads(seg[3]['ref_grads'], seg[3]['port_grads'])


def test_train_step_update_matches_gga_tpu(seg):
    res = seg[3]
    lr = float(joptim.cyclic_cos_schedule(OPTIMIZER['lr'],
                                          total_steps=TOTAL_STEPS)(0))
    update_within(res['ref_state'], res['state'], res['ref_grads'], lr,
                  OPTIMIZER['weight_decay'])


def test_picks_are_given_back(seg):
    """Given its own picks, a forward repeats itself; other picks change
    it."""
    _, ref, inputs, _ = seg
    bundle = apis.init_segmentor(
        ref.tcfg, convert.from_jax_variables(ref.variables, ref.tcfg),
        device='cpu')
    m = bundle.model
    with torch.no_grad():
        first = m(t(inputs[0]), t(inputs[1]))
        picks = m.last_picks
        assert torch.equal(m(t(inputs[0]), t(inputs[1]), picks=picks), first)
        other = [torch.flip(p, [-1]) for p in picks]
        assert not torch.equal(m(t(inputs[0]), t(inputs[1]), picks=other),
                               first)
        assert all(a is b for a, b in zip(m.last_picks, other))


def test_inference_segmentor_matches_gga_tpu():
    """One cloud of 300 points padded to 384 through both packages'
    ``inference_segmentor`` (gga_tpu's jits its own forward), SSG."""
    tcfg = tenc.EncoderDecoder3DConfig.tiny()
    ref = JaxSeg(jenc.EncoderDecoder3D(jenc.EncoderDecoder3DConfig.tiny()),
                 jax_variables(tcfg, tenc.EncoderDecoder3D(tcfg),
                               np.random.RandomState(1)), tcfg)
    cloud = seg_scene()[0][0, :300]
    want = japis.inference_segmentor(ref.model, ref.variables, cloud,
                                     max_points=384)
    bundle = apis.init_segmentor(
        ref.tcfg, convert.from_jax_variables(ref.variables, ref.tcfg),
        device='cpu')
    got = apis.inference_segmentor(bundle, cloud, max_points=384)
    assert got.shape == want.shape == (300,) and got.dtype == np.int64
    pts = np.zeros((1, 384, cloud.shape[1]), np.float32)
    pts[0, :300] = cloud
    with torch.no_grad():
        logits = bundle.model(t(pts), t(np.arange(384) < 300)[None])[0, :300]
    top = torch.topk(logits, 2, -1).values
    clear = (top[:, 0] - top[:, 1] > 1e-4).numpy()
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])


def test_width_mismatch_raises(seg):
    _, ref, inputs, _ = seg
    model = tenc.EncoderDecoder3D(ref.tcfg).eval()
    other = 6 if ref.tcfg.in_channels == 9 else 9
    pts = np.zeros((1, 64, other), np.float32)
    with pytest.raises(ValueError, match=f'{other} channels.*in_channels is '
                       f'{ref.tcfg.in_channels}'):
        model(t(pts), torch.ones(1, 64, dtype=torch.bool))


@pytest.mark.parametrize('weighted', (False, True))
@pytest.mark.parametrize('ignore', (None, IGNORE))
def test_segmentation_loss_matches_gga_tpu(weighted, ignore):
    rng = np.random.RandomState(3)
    logits = (rng.randn(B, 64, NUM_CLASSES) * 3).astype(np.float32)
    labels = rng.randint(0, NUM_CLASSES + 1, (B, 64))
    valid = rng.rand(B, 64) > 0.2
    w = rng.uniform(0.5, 2, NUM_CLASSES).astype(np.float32) if weighted \
        else None
    want = float(jenc.segmentation_loss(logits, labels, valid, w, ignore))
    got = float(tenc.segmentation_loss(t(logits), t(labels), t(valid),
                                       None if w is None else t(w), ignore))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # no kept point: a denominator of 1, a loss of 0
    none = np.zeros_like(valid)
    assert float(tenc.segmentation_loss(t(logits), t(labels), t(none))) == 0


def test_dropout_draws_from_the_generator():
    """The keep mask [B, P, head_channels] keeps about half the entries
    at the configs' 0.5; one seed, one mask; None at 0; a train-mode
    forward without it is refused."""
    cfg = tenc.EncoderDecoder3DConfig.tiny()
    draws = [tbase.segmentor_draws(cfg, B, 100, torch.Generator().manual_seed(s),
                                   'cpu') for s in (3, 3, 4)]
    assert tuple(draws[0].shape) == (B, 100, cfg.head_channels)
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert abs(float(draws[0].float().mean()) - 0.5) < 0.05
    assert tbase.segmentor_draws(dataclasses.replace(cfg, dropout_ratio=0.0),
                                 B, 100, torch.Generator(), 'cpu') is None
    model = tenc.EncoderDecoder3D(cfg).train()
    pts, pv, _, _ = seg_scene()
    with pytest.raises(ValueError, match='keep mask'):
        model(t(pts), t(pv))
