"""The port's SSN (``SSNDetector``, ``shape_aware_head``) against
gga_tpu's, f32, CPU.

A tiny SSN (64 x 64 pillars of 0.5 m, three classes in two task groups:
two small classes at the fused map's 32 x 32, one large class on a
strided group at 16 x 16) with the SECOND and the RegNet-400MF backbone,
gga_tpu's variables through the port's converter (``ssn_rules``):

- ``shape_aware_anchors``: each class's anchors at its group's size equal
  gga_tpu's exactly;
- one train-mode pass with the SECOND backbone: the groups' maps within
  1e-4 of their largest value, ``shape_aware_loss``'s terms at 1e-4 relative, every parameter's
  gradient at cosine >= 0.9999, the BN statistics' updates at 1e-4.
  (RegNet's train-mode chain is held block by block in
  ``test_torch_regnet.py``: chained through its 22 blocks on this tiny
  canvas, gga_tpu's train-mode maps part from a float64 evaluation of the
  same weights by 4-7e-4 of max, the port's by 2-4e-5, so the two f32
  chains are compared in eval mode);
- ``shape_aware_loss`` alone on gga_tpu's maps: its value at 1e-5
  relative and its gradient in every map within 1e-5 of the largest,
  with a GT on an anchor (forced match) and padded slots;
- an eval-mode forward: the maps within 1e-4 of their largest value; ``decode_shape_aware`` on
  gga_tpu's maps: boxes within 1e-5, scores, labels and valid mask
  equal;
- ``apis.ssn_train_step`` and ``infer_ssn`` run with finite results.

One jit a backbone holds every JAX reference.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from gga_tpu.models.dense_heads import shape_aware_head as jsah
from gga_tpu.models.detectors import ssn as jssn
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models.dense_heads import shape_aware_head as tsah
from gga_tpu_torch.models.detectors import ssn as tssn
from chip_smoke import calibrate_bn

from .test_torch_regnet import TINY, cloud
from .test_torch_supervised import _fill, cosine

torch.set_num_threads(1)

HEAD = dict(num_classes=3, anchor_z=(-1.0, -1.0, -0.9),
            anchor_sizes=((0.7, 0.7, 1.8), (1.7, 0.6, 1.3),
                          (4.6, 1.9, 1.7)),
            class_to_task=(0, 0, 1), bev_range=(-16, -16, 16, 16),
            pos_iou_thr=(0.5, 0.5, 0.6), neg_iou_thr=(0.35, 0.35, 0.45),
            min_pos_iou=(0.35, 0.35, 0.45), dir_offset=-0.7854,
            nms_pre=32, max_num=16)
TASKS = (((2, (16, 16), (1, 1))), (1, (16, 16, 16), (2, 1, 1)))
BACKBONES = ('second', 'regnetx_400mf')
TERMS = ('loss_cls', 'loss_bbox', 'loss_dir', 'loss', 'num_pos')
# a pedestrian, a cyclist and a car a scene, scene 0's on anchors (the
# 1 m cells' centres k + 0.5, the 2 m cells' odd coordinates), scene 1's
# moved off them; padded slots
BOXES = np.zeros((2, 5, 7), np.float32)
BOXES[:, 0] = [-5.5, 6.5, -1.8, 0.7, 0.7, 1.8, 0.0]
BOXES[:, 1] = [7.5, -3.5, -1.8, 1.7, 0.6, 1.3, 1.5707963]
BOXES[:, 2] = [5.0, 3.0, -1.8, 4.6, 1.9, 1.7, 0.0]
BOXES[1, :3, :2] += 0.3
LABELS = np.array([[0, 1, 2, 0, 0]] * 2)
VALID = np.array([[True, True, True, False, False]] * 2)


def configs(backbone):
    jhead = jsah.ShapeAwareConfig(
        tasks=tuple(jsah.ShapeTask(*t) for t in TASKS), **HEAD)
    thead = tsah.ShapeAwareConfig(
        tasks=tuple(tsah.ShapeTask(*t) for t in TASKS), **HEAD)
    return (jssn.SSNConfig(backbone=backbone, head=jhead, **TINY),
            tssn.SSNConfig(backbone=backbone, head=thead, **TINY))


def decode_maps(head, sizes=((32, 32), (16, 16)), B=2):
    """Maps of the head's groups for the decode: cls logits rounded to
    quarters (many scores tie), small deltas, direction logits."""
    rng = np.random.RandomState(11)
    R = len(head.rotations)
    return [dict(cls=np.round(rng.normal(-4, 1, (B, h, w, R * t.num_class))
                              * 4).astype(np.float32) / 4,
                 reg=rng.normal(0, 0.2, (B, h, w, R * t.num_class * 7))
                 .astype(np.float32),
                 dir=rng.normal(0, 1, (B, h, w, R * t.num_class * 2))
                 .astype(np.float32))
            for (h, w), t in zip(sizes, head.tasks)]


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=2)
def ssn_pass(backbone):
    """gga_tpu's references (one jit) and the port's passes on the same
    weights; the train pass, the loss on the eval maps and the decode
    (which no backbone reaches) with the SECOND backbone only."""
    train = backbone == 'second'
    jcfg, tcfg = configs(backbone)
    pts, pvalid = cloud(8, boxes=BOXES[0, :3])
    model = jssn.SSNDetector(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), pts[:1, :, :4], pvalid[:1], train=False))
    variables = _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                      np.random.RandomState(9))
    head = jcfg.head

    def loss_of(outs):
        anchors = jsah.shape_aware_anchors(
            head, [o['cls'].shape[1:3] for o in outs])
        return jsah.shape_aware_loss(head, outs, anchors, BOXES, LABELS,
                                     VALID)

    dmaps = decode_maps(head)

    @jax.jit
    def run(v, p, m, dmaps):
        def f(params):
            outs, mut = model.apply({'params': params,
                                     'batch_stats': v['batch_stats']},
                                    p, m, train=True,
                                    mutable=['batch_stats'])
            total, logs = loss_of(outs)
            return total, (logs, outs, mut)
        out = {}
        if train:
            (_, (out['logs'], out['outs'], mut)), out['grads'] = \
                jax.value_and_grad(f, has_aux=True)(v['params'])
            out['stats'] = mut['batch_stats']
        evals = model.apply(v, p, m, train=False)
        anchors = jsah.shape_aware_anchors(
            head, [o['cls'].shape[1:3] for o in evals])
        if train:
            # the loss alone on the eval maps, its gradient in the maps
            (_, out['map_logs']), out['map_grads'] = jax.value_and_grad(
                loss_of, has_aux=True)(evals)
            out['decode'] = jsah.decode_shape_aware(head, dmaps, anchors)
        return dict(out, evals=evals, anchors=anchors)

    ref = tree_np(run(variables, pts[..., :4], pvalid, dmaps))
    sd = convert.from_jax_variables(variables, tcfg)
    batch = dict(points=torch.from_numpy(pts),
                 points_valid=torch.from_numpy(pvalid),
                 gt_boxes=torch.from_numpy(BOXES),
                 gt_labels=torch.from_numpy(LABELS),
                 gt_valid=torch.from_numpy(VALID))
    eval_outs = apis.init_ssn_detector(tcfg, sd, device='cpu').model(
        batch['points'], batch['points_valid'])
    anchors = tsah.shape_aware_anchors(tcfg.head, tsah.feat_sizes(eval_outs))
    r = dict(ref=ref, tcfg=tcfg, sd=sd, batch=batch, anchors=anchors,
             eval_outs=eval_outs, dmaps=dmaps)
    if train:
        det = apis.init_ssn_trainer(tcfg, 10, sd, device='cpu').model
        outs = det(batch['points'], batch['points_valid'])
        total, r['logs'] = tsah.shape_aware_loss(
            tcfg.head, outs, anchors, batch['gt_boxes'],
            batch['gt_labels'], batch['gt_valid'])
        total.backward()
        r.update(outs=outs,
                 grads={k: p.grad for k, p in det.named_parameters()},
                 stats={k: v for k, v in det.state_dict().items()
                        if k.endswith(('running_mean', 'running_var'))},
                 ref_grads=convert.from_jax_variables(
                     {'params': ref['grads']}, tcfg),
                 ref_stats=convert.from_jax_variables(
                     {'batch_stats': ref['stats']}, tcfg))
    return r


def _maps_close(got, ref, tol):
    """Every group's maps within ``tol`` of their largest |value| (the
    drawn statistics leave RegNet's eval-mode logits in the thousands)."""
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        for key in ('cls', 'reg', 'dir'):
            err = np.abs(g[key].detach().numpy() - r[key]).max()
            assert err <= tol * np.abs(r[key]).max(), (key, err)


@pytest.mark.parametrize('backbone', BACKBONES)
def test_anchors_equal_gga_tpu(backbone):
    r = ssn_pass(backbone)
    assert tsah.feat_sizes(r['eval_outs']) == ((32, 32), (16, 16))
    assert len(r['anchors']) == len(r['ref']['anchors']) == 3
    for a, b in zip(r['anchors'], r['ref']['anchors']):
        np.testing.assert_array_equal(a.numpy(), b)


def test_train_pass_matches_gga_tpu():
    r = ssn_pass('second')
    _maps_close(r['outs'], r['ref']['outs'], 1e-4)
    assert float(r['ref']['logs']['loss']) > 0
    for term in TERMS[:-1]:
        np.testing.assert_allclose(float(r['logs'][term].detach()),
                                   float(r['ref']['logs'][term]),
                                   rtol=1e-4, err_msg=term)
    # num_pos (gga_tpu's loss does not log it): scene 0's three GTs on
    # anchors at least
    assert float(r['logs']['num_pos']) >= 3


def test_gradients_and_statistics_match_gga_tpu():
    r = ssn_pass('second')
    grads, ref = r['grads'], r['ref_grads']
    assert set(grads) == set(ref)
    assert any(k.startswith('bbox_head.heads.1.shared_conv.0') for k in grads)
    worst = min((cosine(grads[k], ref[k]), k) for k in grads)
    assert worst[0] >= 0.9999, worst
    assert set(r['stats']) == set(r['ref_stats'])
    for key, v in r['ref_stats'].items():
        np.testing.assert_allclose(r['stats'][key].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_shape_aware_loss_on_the_same_maps_matches_gga_tpu():
    r = ssn_pass('second')
    maps = [{k: torch.from_numpy(np.array(v)).requires_grad_()
             for k, v in o.items()} for o in r['ref']['evals']]
    total, logs = tsah.shape_aware_loss(
        r['tcfg'].head, maps, r['anchors'], r['batch']['gt_boxes'],
        r['batch']['gt_labels'], r['batch']['gt_valid'])
    total.backward()
    for term in TERMS[:-1]:
        np.testing.assert_allclose(float(logs[term].detach()),
                                   float(r['ref']['map_logs'][term]),
                                   rtol=1e-5, err_msg=term)
    for m, g in zip(maps, r['ref']['map_grads']):
        for key in ('cls', 'reg', 'dir'):
            ref = g[key]
            assert np.abs(m[key].grad.numpy() - ref).max() \
                <= 1e-5 * np.abs(ref).max(), key


@pytest.mark.parametrize('backbone', BACKBONES)
def test_eval_forward_matches_gga_tpu(backbone):
    r = ssn_pass(backbone)
    _maps_close(r['eval_outs'], r['ref']['evals'], 1e-4)


def test_decode_matches_gga_tpu():
    r = ssn_pass('second')
    maps = [{k: torch.from_numpy(v) for k, v in o.items()}
            for o in r['dmaps']]
    out = tsah.decode_shape_aware(r['tcfg'].head, maps, r['anchors'])
    ref = r['ref']['decode']
    np.testing.assert_array_equal(out['valid'].numpy(), ref['valid'])
    assert ref['valid'].sum() > 0
    np.testing.assert_array_equal(out['labels'].numpy(), ref['labels'])
    np.testing.assert_array_equal(out['scores'].numpy(), ref['scores'])
    np.testing.assert_allclose(out['boxes'].numpy(), ref['boxes'],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('backbone', BACKBONES)
def test_ssn_train_step_and_inference_run(backbone):
    """Seeded weights: one step, then inference with the running
    statistics of a train batch (``chip_smoke.calibrate_bn``; the seeded
    RegNet's eval-mode logits reach 1e4 on identity statistics, and the
    decode's ``exp`` overflows)."""
    r = ssn_pass(backbone)
    trainer = apis.init_ssn_trainer(r['tcfg'], 10, device='cpu', seed=1)
    logs = apis.ssn_train_step(trainer, r['batch'])
    assert set(logs) == set(TERMS) | {'grad_norm'}
    assert all(torch.isfinite(v) for v in logs.values())
    bundle = apis.init_ssn_detector(r['tcfg'], trainer.model.state_dict(),
                                    device='cpu')
    calibrate_bn(torch, bundle.model, r['batch'])
    out = apis.infer_ssn(bundle, r['batch']['points'],
                         r['batch']['points_valid'])
    assert out['boxes'].shape == (2, HEAD['max_num'], 7)
    assert torch.isfinite(out['boxes']).all()
