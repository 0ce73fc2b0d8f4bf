"""The port's FreeAnchor (``FreeAnchorPointPillarsConfig``,
``free_anchor3d_head.free_anchor_loss``) against gga_tpu's, f32, CPU.

- ``top_k_first`` gives ``jax.lax.top_k``'s indices on rows full of ties
  (the lower index first among equal values).
- ``free_anchor_loss``'s value, its logs and its gradient in the three
  maps against ``jax.value_and_grad`` of gga_tpu's, at 1e-5 relative: two
  scenes with padded GT slots, one GT centred between four anchors (its
  bag's IoUs tie), GTs of every class and one class without a GT.
- A tiny FreeAnchor PointPillars with the FPN neck (SECOND, 64 x 64
  pillars), gga_tpu's variables through the port's converter: one
  train-mode pass and the FreeAnchor loss against gga_tpu's (maps at
  1e-4, the loss terms at 1e-4 relative, every parameter's gradient at
  cosine >= 0.9999, the BN statistics' updates at 1e-4), then one
  ``apis.anchor_train_step`` with finite logs.

gga_tpu's references are jitted once each.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gga_tpu.models.dense_heads import anchor3d_head as jah
from gga_tpu.models.dense_heads import free_anchor3d_head as jfa
from gga_tpu.models.detectors import voxelnet as jvn
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models.dense_heads import anchor3d_head as tah
from gga_tpu_torch.models.dense_heads import free_anchor3d_head as tfa
from gga_tpu_torch.models.detectors import voxelnet as tvn
from gga_tpu_torch.train import loop

from .test_torch_regnet import HEAD, cloud, pillar_configs
from .test_torch_supervised import _fill, cosine

torch.set_num_threads(1)

FA = dict(pre_anchor_topk=8, bbox_thr=0.5)
CFG = dict(num_classes=3, feat_channels=8, pre_anchor_topk=8, bbox_thr=0.5,
           anchor_ranges=((-8, -8, -1.8, 8, 8, -1.8),) * 3,
           anchor_sizes=((4.6, 1.9, 1.7), (0.7, 0.7, 1.8), (1.7, 0.6, 1.3)),
           pos_iou_thr=(0.6,) * 3, neg_iou_thr=(0.3,) * 3,
           min_pos_iou=(0.3,) * 3, dir_offset=-0.7854)
H = W = 16                        # 1 m cells, anchor centres at k + 0.5
# two scenes of G = 5 slots: scene 0's car centred between four anchor
# centres (0, 0); scene 1 with two GTs and no pedestrian; padded slots
GT = np.zeros((2, 5, 7), np.float32)
GT[0, :3] = [[0.0, 0.0, -1.8, 4.6, 1.9, 1.7, 0.0],
             [3.3, -2.6, -1.8, 0.7, 0.7, 1.8, 0.4],
             [-4.1, 5.2, -1.8, 1.7, 0.6, 1.3, 2.9]]
GT[1, :2] = [[2.7, 3.4, -1.8, 4.3, 1.8, 1.6, -2.2],
             [-5.0, -4.5, -1.8, 1.8, 0.6, 1.2, 1.3]]
LABELS = np.array([[0, 1, 2, 0, 0], [0, 2, 0, 0, 0]])
VALID = np.array([[True, True, True, False, False],
                  [True, True, False, False, False]])


def maps(cfg, B, seed):
    C, R = cfg.num_classes, len(cfg.rotations)
    rng = np.random.RandomState(seed)
    return dict(
        cls=(rng.randn(B, H, W, C * R * C) - 2.0).astype(np.float32),
        reg=(rng.randn(B, H, W, C * R * 7) * 0.1).astype(np.float32),
        dir=rng.randn(B, H, W, C * R * 2).astype(np.float32))


@pytest.mark.parametrize('n', [10, 1000, 5000])
def test_top_k_first_matches_jax_top_k(n):
    rng = np.random.RandomState(n)
    x = rng.randint(0, 5, (7, n)).astype(np.float32) / 4   # many ties
    x[3] = 0.0                                          # all tied
    k = min(n, 25)
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
    got = tfa.top_k_first(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[3], np.arange(k))


@pytest.fixture(scope='module')
def loss_pass():
    """gga_tpu's and the port's loss, logs and gradients on the maps."""
    jcfg = jfa.FreeAnchor3DConfig(**CFG)
    tcfg = tfa.FreeAnchor3DConfig(**CFG)
    preds = maps(jcfg, 2, 0)
    anchors = jah.make_anchors(jcfg, (H, W))

    @jax.jit
    def ref(p):
        def f(p):
            return jfa.free_anchor_loss(jcfg, p, anchors, GT, LABELS, VALID)
        (total, logs), grads = jax.value_and_grad(f, has_aux=True)(p)
        # the bag of scene 0's centred car
        iou = jah._bev_iou(jah._nearest_bev(GT[0, :1]),
                           jah._nearest_bev(anchors.reshape(-1, 7)))
        return total, logs, grads, iou, jax.lax.top_k(iou, 8)[1]

    total, logs, grads, iou, bag = jax.tree_util.tree_map(np.asarray,
                                                          ref(preds))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    tanchors = tah.make_anchors(tcfg, (H, W))
    out, out_logs = tfa.free_anchor_loss(
        tcfg, tp, tanchors, torch.from_numpy(GT), torch.from_numpy(LABELS),
        torch.from_numpy(VALID))
    out.backward()
    return dict(total=total, logs=logs, grads=grads, iou=iou, bag=bag,
                out=out, out_logs=out_logs, tp=tp, anchors=tanchors)


def test_free_anchor_loss_matches_gga_tpu(loss_pass):
    r = loss_pass
    np.testing.assert_allclose(float(r['out'].detach()), float(r['total']),
                               rtol=1e-5)
    for key in ('positive_bag_loss', 'negative_bag_loss', 'loss'):
        np.testing.assert_allclose(float(r['out_logs'][key]),
                                   float(r['logs'][key]), rtol=1e-5,
                                   err_msg=key)
    assert float(r['out_logs']['num_pos']) == VALID.sum()


@pytest.mark.parametrize('key', ['cls', 'reg', 'dir'])
def test_free_anchor_gradient_matches_gga_tpu(loss_pass, key):
    got = loss_pass['tp'][key].grad.numpy()
    ref = loss_pass['grads'][key]
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), key


def test_bag_of_a_centred_gt_ties_and_is_picked_in_top_k_order(loss_pass):
    """The car at (0, 0) meets the four anchors around it at one IoU (each
    rotation), so its bag is decided by the order of ties; the port's
    picks are gga_tpu's."""
    iou, bag = loss_pass['iou'][0], loss_pass['bag'][0]
    assert len(np.unique(iou[bag])) < len(bag)          # the bag ties
    got = tfa.top_k_first(
        tah._bev_iou(tah._nearest_bev(torch.from_numpy(GT[0, :1])),
                     tah._nearest_bev(loss_pass['anchors'].reshape(-1, 7))),
        8)[0].numpy()
    np.testing.assert_array_equal(got, bag)


def test_class_max_equals_the_product_max():
    """``class_max`` (a per-class ``index_reduce_('amax')``) equals
    gga_tpu's max over G of obj_box_prob x one-hot(label) x valid, bit for
    bit, padded slots, a class without a GT and out-of-range labels
    included."""
    rng = np.random.RandomState(7)
    G, A, C = 9, 300, 4
    obj = rng.uniform(-0.5, 1.5, (G, A)).clip(0, 1).astype(np.float32)
    labels = np.array([0, 2, 2, 0, 3, 5, -1, 2, 0])
    valid = np.array([1, 1, 1, 1, 1, 1, 1, 0, 0], bool)
    obj[~valid] = 0.0
    ref = np.asarray((jnp.asarray(obj)[:, :, None]
                      * (jax.nn.one_hot(labels, C) * valid[:, None])[
                          :, None, :]).max(0))
    got = tfa.class_max(torch.from_numpy(obj), torch.from_numpy(labels),
                        torch.from_numpy(valid), C)
    np.testing.assert_array_equal(got.T.numpy(), ref)
    assert (ref[:, 1] == 0).all()                       # no GT of class 1


@pytest.fixture(scope='module')
def detector_pass():
    """A tiny FreeAnchor PointPillars (SECOND + FPN): gga_tpu's train-mode
    pass, loss and gradients (one jit) and the port's on the same
    weights."""
    jcfg, tcfg = pillar_configs(
        jvn.FreeAnchorPointPillarsConfig, tvn.FreeAnchorPointPillarsConfig,
        jfa.FreeAnchor3DConfig(**HEAD, **FA),
        tfa.FreeAnchor3DConfig(**HEAD, **FA), neck='fpn')
    boxes = np.zeros((2, 4, 7), np.float32)
    boxes[:, 0] = [4.0, 2.0, -1.8, 4.6, 1.9, 1.7, 0.3]
    boxes[:, 1] = [-6.0, -5.0, -1.8, 0.7, 0.7, 1.8, 0.0]
    labels = np.array([[0, 1, 0, 0]] * 2)
    valid = np.array([[True, True, False, False]] * 2)
    pts, pvalid = cloud(5, boxes=boxes[0, :2])
    model = jvn.PointPillars(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), pts[:1, :, :4], pvalid[:1], train=False))
    variables = _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                      np.random.RandomState(6))

    @jax.jit
    def step(params, stats, p, m):
        def f(params):
            preds, mut = model.apply({'params': params, 'batch_stats': stats},
                                     p, m, train=True,
                                     mutable=['batch_stats'])
            anchors = jah.make_anchors(jcfg.head, preds['cls'].shape[1:3])
            total, logs = jfa.free_anchor_loss(jcfg.head, preds, anchors,
                                               boxes, labels, valid)
            return total, (logs, preds, mut)
        return jax.value_and_grad(f, has_aux=True)(params)

    (_, (jlogs, jpreds, mut)), jgrads = jax.tree_util.tree_map(
        np.asarray, step(variables['params'], variables['batch_stats'],
                         pts[..., :4], pvalid))
    sd = convert.from_jax_variables(variables, tcfg)
    trainer = apis.init_anchor_trainer(tcfg, 10, sd, device='cpu')
    det = trainer.model.train()
    batch = dict(points=torch.from_numpy(pts),
                 points_valid=torch.from_numpy(pvalid),
                 gt_boxes=torch.from_numpy(boxes),
                 gt_labels=torch.from_numpy(labels),
                 gt_valid=torch.from_numpy(valid))
    preds = det(batch['points'], batch['points_valid'])
    total, logs = loop.anchor_terms(tcfg.head, preds, batch)
    total.backward()
    ref_grads = convert.from_jax_variables({'params': jgrads}, tcfg)
    return dict(
        jlogs=jlogs, jpreds=jpreds, logs=logs, preds=preds,
        grads={k: p.grad for k, p in det.named_parameters()},
        ref_grads=ref_grads,
        stats={k: v for k, v in det.state_dict().items()
               if k.endswith(('running_mean', 'running_var'))},
        ref_stats=convert.from_jax_variables(
            {'batch_stats': mut['batch_stats']}, tcfg),
        trainer=trainer, sd=sd, batch=batch, tcfg=tcfg)


def test_free_anchor_detector_matches_gga_tpu(detector_pass):
    r = detector_pass
    for key in ('cls', 'reg', 'dir'):
        np.testing.assert_allclose(r['preds'][key].detach().numpy(),
                                   r['jpreds'][key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    for key in ('positive_bag_loss', 'negative_bag_loss', 'loss'):
        np.testing.assert_allclose(float(r['logs'][key]),
                                   float(r['jlogs'][key]), rtol=1e-4,
                                   err_msg=key)
    grads, ref = r['grads'], r['ref_grads']
    assert set(grads) == set(ref) and any('neck.fpn_convs' in k
                                          for k in grads)
    worst = min((cosine(grads[k], ref[k]), k) for k in grads)
    assert worst[0] >= 0.9999, worst
    assert set(r['stats']) == set(r['ref_stats'])
    for key, v in r['ref_stats'].items():
        np.testing.assert_allclose(r['stats'][key].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_free_anchor_train_step_and_inference_run(detector_pass):
    r = detector_pass
    trainer = apis.init_anchor_trainer(r['tcfg'], 10, r['sd'], device='cpu')
    logs = apis.anchor_train_step(trainer, r['batch'])
    assert set(logs) == {'positive_bag_loss', 'negative_bag_loss', 'loss',
                         'num_pos', 'grad_norm'}
    assert all(torch.isfinite(v) for v in logs.values())
    assert trainer.step == 1
    bundle = apis.init_anchor_detector(r['tcfg'], trainer.model.state_dict(),
                                       device='cpu')
    out = apis.infer_anchor(bundle, r['batch']['points'],
                            r['batch']['points_valid'])
    assert out['boxes'].shape == (2, 2 * HEAD['max_num'], 7)
    assert torch.isfinite(out['boxes']).all()
