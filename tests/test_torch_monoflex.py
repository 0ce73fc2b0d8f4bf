"""The port's MonoFlex against gga_tpu's, f32, CPU, one torch thread.

``MonoFlexModelConfig.tiny()``'s variables (shapes from ``jax.eval_shape``
of gga_tpu's init, values drawn with numpy, the edge fusions' batch-norm
statistics included) reach the port through ``convert.from_jax_variables``;
both packages take ``test_torch_smoke.mono_batch``'s images and objects (B =
2 at 64 x 128, a scene's first car centred off the image, a padding slot).
The DLA backbone and neck are held module by module in
``test_torch_smoke.py``; here:

- ``multibin_loss`` on drawn rows at 1e-6 relative;
- the head given gga_tpu's neck output, eval mode (the edge fusions' batch
  norms at their statistics) and train mode (the outputs, and the
  statistics' updates), at 1e-5 of max; the whole forward at 2e-4, for the
  reason ``test_torch_smoke.py`` gives;
- the targets against ``monoflex_targets`` as configured (the off-image
  centre filtered out) and with ``filter_outside_objs`` off, so the
  truncated objects take the border-line centre and the ellipse
  gaussians: masks, cells and visibilities exactly, the floats at 1e-5 of
  max, the heatmaps at 1e-6;
- the 9 loss terms on gga_tpu's train-mode head outputs at 1e-5
  relative; the decode on its eval-mode outputs: labels, cells and
  ``valid`` exactly, scores at 1e-6, boxes at 1e-4 of max;
- ``apis.inference_mono_3d_detector`` on one image against gga_tpu's
  contract (its decode's boxes where ``valid``): labels exactly, scores at
  1e-4, boxes at 1e-3 of max;
- one ``apis.monoflex_train_step`` (train mode, the config's clip at 35):
  the loss terms at 5e-4 relative to gga_tpu's f32 ones, the unclipped
  gradient norm at 2e-2 and each clipped gradient within 3e-2 of the
  largest entry of gga_tpu's float64 one, clipped alike (at random
  weights the keypoint depths divide by near-zero pixel heights, and
  gga_tpu's own f32 gradient norm sits 1.0e-2 from its float64 one), the
  clipped norm 35; and the port's loss and gradients in float64 against
  gga_tpu's under x64 at 1e-6 relative and 1e-4 of each gradient's
  largest entry (``test_torch_smoke.grads_close``; both packages run the
  neck's upsamplers in f32, whose rounding the network magnifies);
- the conversion round trip.

gga_tpu's references of the tiny model come from one jitted function (and
its float64 gradients from one more), compiled at XLA's backend
optimization level 0 (``test_torch_smoke.run_jitted``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from gga_tpu.models import losses as jlosses
from gga_tpu.models.dense_heads import monoflex_head as jmh
from gga_tpu.models.detectors import monoflex as jmonoflex
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models import losses as tlosses
from gga_tpu_torch.models.dense_heads import monoflex_head as tmh
from gga_tpu_torch.models.detectors import monoflex as tmonoflex
from gga_tpu_torch.train import loop

from .test_torch_mvxnet import close, nchw, t
from .test_torch_smoke import (bottom_boxes, f64_reference, grads_close,
                               init_variables, mono_batch, round_trip,
                               run_jitted)

torch.set_num_threads(1)

TERMS = ('loss_cls', 'loss_bbox', 'loss_keypoints', 'loss_dir', 'loss_dims',
         'loss_offsets2d', 'loss_direct_depth', 'loss_keypoints_depth',
         'loss_combined_depth', 'loss')
TARGET_KEYS = ('heatmap', 'base_int', 'offsets2d', 'bboxes2d', 'keypoints',
               'keypoints_vis', 'kdep_valid', 'ori', 'dims', 'depth', 'valid',
               'trunc')


def loss_args(batch):
    return (bottom_boxes(batch), batch['gt_labels'], batch['gt_bboxes'],
            batch['centers2d'], batch['depths'], batch['obj_valid'],
            batch['cam2img'])


@pytest.fixture(scope='module')
def ref():
    cfg = jmonoflex.MonoFlexModelConfig.tiny()
    model = jmonoflex.MonoFlexDetector(cfg)
    batch = mono_batch()
    img = batch['image']
    img_shape = img.shape[1:3]
    variables = init_variables(model, img)
    args = loss_args(batch)
    unfiltered = dataclasses.replace(cfg.head, filter_outside_objs=False)

    def reference(v, x):
        preds, st = model.apply(v, x, train=False,
                                capture_intermediates=True)
        train_preds, stats = model.apply(v, x, train=True,
                                         mutable=['batch_stats'])
        total, terms = model.loss(train_preds, *args, img_shape)
        fs = preds['heatmap'].shape[1:3]
        targets = [jmh.monoflex_targets(c, *args[:6], args[6], img_shape, fs)
                   for c in (cfg.head, unfiltered)]
        dets = model.decode(preds, batch['cam2img'])
        neck = st['intermediates']['DLANeck_0']['__call__'][0]
        return preds, train_preds, stats, neck, terms, targets, dets

    out = jax.device_get(run_jitted(reference, variables, img))
    keys = ('preds', 'train_preds', 'stats', 'neck', 'terms', 'targets',
            'dets')
    tcfg = tmonoflex.MonoFlexModelConfig.tiny()
    return dict(zip(keys, out), cfg=cfg, tcfg=tcfg, model=model,
                variables=variables, batch=batch,
                sd=convert.from_jax_variables(variables, tcfg),
                f64=f64_reference(model.apply, model.loss, variables, img,
                                  args, (img_shape,)))


def port_model(ref):
    return apis.init_monoflex_detector(ref['tcfg'], ref['sd'],
                                       device='cpu').model


def test_config_fields_equal_gga_tpu():
    for jc, tc in ((jmonoflex.MonoFlexModelConfig.tiny(),
                    tmonoflex.MonoFlexModelConfig.tiny()),
                   (jmonoflex.MonoFlexModelConfig(),
                    tmonoflex.MonoFlexModelConfig())):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    np.testing.assert_array_equal(tmh.edge_indices(5, 7),
                                  jmh.edge_indices(5, 7))


def test_multibin_loss_matches_gga_tpu():
    rng = np.random.RandomState(0)
    pred = rng.randn(40, 16).astype(np.float32)
    gt = np.concatenate([rng.rand(40, 4) < 0.4,
                         rng.uniform(-1, 1, (40, 4))], 1).astype(np.float32)
    gt[:5, :4] = 0                               # rows with no bin flagged
    want = jax.jit(jlosses.multibin_loss)(pred, gt)
    close(tlosses.multibin_loss(t(pred), t(gt)), want, 1e-6)


@pytest.mark.parametrize('train', [False, True])
def test_head_matches_given_gga_tpu_neck(ref, train):
    det = port_model(ref)
    head = det.bbox_head.train(train)
    with torch.no_grad():
        out = head(nchw(ref['neck']))
    want = ref['train_preds' if train else 'preds']
    for key in ('heatmap', 'reg'):
        close(out[key], want[key], 1e-5, err=key)
    if train:
        stats = ref['stats']['batch_stats']['MonoFlexHead_0']
        for tn, fn in (('edge_fuse_cls', 'edge_fuse_cls'),
                       ('edge_fuse_reg', 'edge_fuse_offsets2d')):
            bn = getattr(head, tn).edge_convs[0].bn
            close(bn.running_mean, stats[fn]['bn']['mean'], 1e-5)
            close(bn.running_var, stats[fn]['bn']['var'], 1e-5)


def test_whole_forward_matches_gga_tpu(ref):
    with torch.no_grad():
        out = port_model(ref)(nchw(ref['batch']['image']))
    for key in ('heatmap', 'reg'):
        close(out[key], ref['preds'][key], 2e-4, err=key)


@pytest.mark.parametrize('filtered', [True, False])
def test_targets_match_gga_tpu(ref, filtered):
    want = ref['targets'][0 if filtered else 1]
    head = ref['tcfg'].head if filtered else dataclasses.replace(
        ref['tcfg'].head, filter_outside_objs=False)
    b = ref['batch']
    got = tmh.build_targets(head, *(t(a) for a in loss_args(b)[:6]),
                            t(b['cam2img']), b['image'].shape[1:3],
                            want['heatmap'].shape[1:3])
    for key in TARGET_KEYS:
        tol = 1e-6 if key == 'heatmap' else 1e-5
        close(got[key], want[key], tol, err=key)
    assert (got['heatmap'] == 1.0).sum() == (want['heatmap'] == 1.0).sum()
    # each scene's first car is off the image: filtered out, or truncated
    assert not got['valid'][:, -1].any()
    if filtered:
        assert not got['valid'][:, 0].any() and not got['trunc'].any()
    else:
        assert got['trunc'][:, 0].all() and got['trunc'].sum() == 2
        assert (got['base_int'][:, 0, 0] == 0).all()   # on the left border


def test_loss_matches_on_gga_tpu_preds(ref):
    preds = {k: t(v) for k, v in ref['train_preds'].items()}
    b = ref['batch']
    total, terms = tmh.loss(ref['tcfg'].head, preds,
                            *(t(a) for a in loss_args(b)),
                            b['image'].shape[1:3])
    for key in TERMS:
        np.testing.assert_allclose(float(terms[key]), float(ref['terms'][key]),
                                   rtol=1e-5, err_msg=key)
    assert float(terms['num_pos']) == 4 and float(total) == float(
        terms['loss'])


def test_decode_matches_on_gga_tpu_preds(ref):
    preds = {k: t(v) for k, v in ref['preds'].items()}
    got = tmh.decode(ref['tcfg'].head, preds, t(ref['batch']['cam2img']))
    want = ref['dets']
    close(got['labels'], want['labels'])
    close(got['valid'], want['valid'])
    close(got['scores'], want['scores'], 1e-6)
    close(got['boxes'], want['boxes'], 1e-4)
    assert want['valid'].sum() > 0


def test_inference_mono_3d_detector_matches_gga_tpu(ref):
    """gga_tpu's contract on the batch's first image: its decode's boxes
    where ``valid`` (eval mode: an image's outputs do not depend on the
    rest of its batch)."""
    img, k = ref['batch']['image'][0], ref['batch']['cam2img'][0]
    bundle = apis.init_monoflex_detector(ref['tcfg'], ref['sd'],
                                         device='cpu')
    got = apis.inference_mono_3d_detector(bundle, img, k)
    keep = ref['dets']['valid'][0]
    assert keep.sum() > 0
    close(got['labels_3d'], ref['dets']['labels'][0][keep])
    close(got['scores_3d'], ref['dets']['scores'][0][keep], 1e-4)
    close(got['boxes_3d'], ref['dets']['boxes'][0][keep], 1e-3)


def test_train_step_loss_and_gradients(ref):
    """One f32 step. At seeded random weights the keypoint depths divide
    by near-zero pixel heights and the f32 step is ill-conditioned:
    gga_tpu's own f32 gradient norm sits 1.0e-2 from its float64 one. So
    the loss terms are held at 5e-4 relative to gga_tpu's f32 ones, the
    unclipped gradient norm at 2e-2 and each clipped gradient within 3e-2
    of the largest entry of gga_tpu's float64 one, clipped alike; the
    exact check is ``test_gradients_match_gga_tpu_in_float64``."""
    trainer = apis.init_monoflex_trainer(
        ref['tcfg'], 10, dict(lr=1e-4, grad_clip=35.0, lr_policy='step',
                              lr_steps=(50,), lr_gamma=0.1),
        ref['sd'], device='cpu')
    logs = apis.monoflex_train_step(trainer, ref['batch'])
    for key in TERMS:
        np.testing.assert_allclose(float(logs[key]), float(ref['terms'][key]),
                                   rtol=5e-4, err_msg=key)
    grads64 = ref['f64'][1]
    norm64 = np.sqrt(sum((np.asarray(g) ** 2).sum()
                         for g in jax.tree_util.tree_leaves(grads64)))
    norm = float(logs['grad_norm'])
    np.testing.assert_allclose(norm, norm64, rtol=2e-2)
    clip = 35.0 / norm
    assert clip < 1.0                   # the random weights' step is clipped
    grads_close(trainer.model, jax.tree_util.tree_map(
        lambda g: g * clip, grads64), convert.rules_of(ref['tcfg']), 3e-2)
    clipped = np.sqrt(sum(float((p.grad.double() ** 2).sum())
                          for p in trainer.model.parameters()
                          if p.grad is not None))
    np.testing.assert_allclose(clipped, 35.0, rtol=1e-5)
    assert trainer.step == 1


def test_gradients_match_gga_tpu_in_float64(ref):
    det = port_model(ref).double().train()
    b = ref['batch']
    batch = {k: t(v).double() if v.dtype == np.float32 else t(v)
             for k, v in b.items()}
    batch.update(img=nchw(b['image']).double(),
                 gt_boxes_cam=t(bottom_boxes(b)).double(),
                 gt_labels=t(b['gt_labels']).long())
    total, terms = loop.monoflex_loss(det, batch)
    total.backward()
    for key in TERMS:
        np.testing.assert_allclose(float(terms[key].detach()),
                                   float(ref['f64'][0][key]), rtol=1e-6,
                                   err_msg=key)
    grads_close(det, ref['f64'][1], convert.rules_of(ref['tcfg']), 1e-4)


def test_conversion_round_trip(ref):
    round_trip(ref['tcfg'], ref['variables'], port_model(ref))
