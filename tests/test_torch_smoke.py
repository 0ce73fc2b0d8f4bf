"""The port's SMOKE against gga_tpu's, f32, CPU, one torch thread.

gga_tpu's ``SMOKEDetector`` variables (shapes from ``jax.eval_shape`` of
its init, values drawn with numpy) reach the port through
``convert.from_jax_variables``; both packages then take the same images
and objects (B = 2 at 64 x 128; four objects a scene, one of them padding,
one off the map):

- flax's ``nn.GroupNorm`` (``_Norm``: 16 groups at 16 channels, 32 at
  512; epsilon 1e-6, the fast variance) against ``layers.GroupNorm`` at
  1e-5 of max, and gga_tpu's depthwise upsampler (scale 2 and 4, a drawn,
  asymmetric kernel) against ``DepthwiseUp`` with the converted kernel at
  1e-6 (the kernel unflipped gives another map);
- ``SMOKEModelConfig.tiny_dla()``: DLANet level by level, the neck and the
  head, each given gga_tpu's input, at 1e-5 of max. The whole forward is
  held at 2e-4: at these widths (a channel a group on 2 x 4 maps) the
  network is ill-conditioned, and each package's f32 forward sits 3-6e-5
  of max from the same forward in float64 (gga_tpu's under x64), so f32
  rounding alone parts the two by about that much;
- ``SMOKEModelConfig.tiny()`` (the ResNet + ``_UpFuse`` variant, eval
  mode): the whole forward at 1e-5;
- the heatmap targets against gga_tpu's (its ``render_heatmap`` a class)
  at 1e-6, the centre cells and the in-map mask exactly; the loss terms on
  gga_tpu's head outputs at 1e-5 relative; the decode on them: labels and
  cells exactly, scores at 1e-6, boxes at 1e-5 of max;
- ``apis.inference_mono_3d_detector`` on one image against gga_tpu's (its
  test's ``trans_mat`` wrapper): the same kept set, boxes at 1e-4;
- one ``apis.smoke_train_step`` from the converted weights on a
  ``KittiMonoDataset``-format batch (no clip: the config's 0.0): the loss
  terms at 1e-4 relative to gga_tpu's f32 ones, each gradient within 1e-3
  of the largest entry of gga_tpu's float64 one (gga_tpu's own f32
  gradients part from that by up to 7.7e-3 at these widths), None on the
  two-level tree's discarded ``project`` (zero in gga_tpu); and the port's
  loss and gradients in float64 against gga_tpu's under ``jax.enable_x64``:
  the loss terms at 1e-6 relative (both run the neck's upsamplers in
  f32), each gradient within 1e-5 of its largest entry (``grads_close``:
  a gradient that vanishes in exact arithmetic is held against the
  model's largest entry);
- the conversion round trip, and ``corners_3d`` / ``project_to_image`` at
  the camera origin (0.5, 1, 0.5), about +y.

gga_tpu's references of the tiny DLA model come from one jitted function
and its float64 gradients from one more (``f64_reference``), each
compiled once at XLA's backend optimization level 0 (``run_jitted``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from gga_tpu.apis import inference_mono_3d_detector as j_inference_mono
from gga_tpu.core import geometry as jgeo
from gga_tpu.models.backbones import dla as jdla
from gga_tpu.models.dense_heads import smoke_head as jsh
from gga_tpu.models.detectors import smoke as jsmoke
from gga_tpu.models.necks import dla_neck as jneck
from gga_tpu_torch import apis, convert
from gga_tpu_torch.core import geometry as tgeo
from gga_tpu_torch.models import layers
from gga_tpu_torch.models.backbones.dla import group_norm, norm_groups
from gga_tpu_torch.models.dense_heads import smoke_head as tsh
from gga_tpu_torch.models.detectors import smoke as tsmoke
from gga_tpu_torch.models.necks import dla_neck as tneck
from gga_tpu_torch.train import loop

from .test_torch_mvxnet import close, nchw, t
from .test_torch_supervised import _fill, _from_torch_layout

torch.set_num_threads(1)

B, M, H, W = 2, 4, 64, 128
SMOKE_TERMS = ('loss_heatmap', 'loss_bbox', 'loss')


def cam2img(f=60.0, cx=64.0, cy=32.0):
    k = np.eye(4, dtype=np.float32)
    k[0, 0] = k[1, 1] = f
    k[0, 2], k[1, 2] = cx, cy
    return k


def mono_batch(seed=0, b=B, m=M, h=H, w=W):
    """A ``KittiMonoDataset``-format batch: normalized-like images, and per
    scene m - 1 cars at 10-35 m (the first placed so its centre projects
    off the image's left edge: a truncated object, off the stride-4 map)
    and one padding slot (label -1, invalid). ``gt_cam3d`` gravity-centred
    (x, y, z, l, h, w, yaw), camera y down; the 2D boxes around the
    projected centres."""
    rng = np.random.RandomState(seed)
    k = cam2img(cx=w / 2, cy=h / 2)
    n = m - 1
    boxes = np.zeros((b, m, 7), np.float32)
    boxes[:, :n, 0] = rng.uniform(-4, 4, (b, n))
    boxes[:, :n, 2] = rng.uniform(10, 35, (b, n))
    boxes[:, 0, 0] = -(w / 2 + 4) * boxes[:, 0, 2] / k[0, 0]  # u ~ -4
    boxes[:, :n, 3:6] = [3.9, 1.5, 1.6]
    boxes[:, :n, 1] = 1.2 - boxes[:, :n, 4] / 2                # gravity y
    boxes[:, :n, 6] = rng.uniform(-np.pi, np.pi, (b, n))
    u = k[0, 0] * boxes[..., 0] / np.maximum(boxes[..., 2], 1e-3) + k[0, 2]
    v = k[1, 1] * boxes[..., 1] / np.maximum(boxes[..., 2], 1e-3) + k[1, 2]
    c2d = np.stack([u, v], -1).astype(np.float32)
    wpix = k[0, 0] * boxes[..., 3] / np.maximum(boxes[..., 2], 1e-3)
    hpix = k[1, 1] * boxes[..., 4] / np.maximum(boxes[..., 2], 1e-3)
    bb = np.stack([u - wpix / 2 + 3, v - hpix / 2, u + wpix / 2 + 3,
                   v + hpix / 2], -1).astype(np.float32)
    labels = np.full((b, m), -1, np.int32)
    labels[:, :n] = rng.randint(0, 3, (b, n))
    valid = labels >= 0
    for a in (boxes, c2d, bb):
        a[~valid] = 0
    img = (rng.randn(b, h, w, 3) * 40).astype(np.float32)
    return dict(image=img, cam2img=np.tile(k, (b, 1, 1)), gt_bboxes=bb,
                gt_labels=labels, gt_cam3d=boxes, centers2d=c2d,
                depths=np.where(valid, boxes[..., 2], 0).astype(np.float32),
                obj_valid=valid)


def bottom_boxes(batch):
    """The batch's boxes at their bottom centres (y + h / 2)."""
    g = batch['gt_cam3d'].copy()
    g[..., 1] += g[..., 4] / 2
    return g


def trans_mats(b=B):
    return np.tile(np.diag([0.25, 0.25, 1.0]).astype(np.float32), (b, 1, 1))


def init_variables(model, img, seed=1):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), img,
                                               train=False))
    return _fill({c: shapes[c] for c in shapes}, np.random.RandomState(seed))


def nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def grads_close(model, ref_grads, rules, tol):
    """Each parameter's gradient within ``tol`` of its largest entry of
    gga_tpu's (a flax-path tree, through the rules). A gradient that
    vanishes in exact arithmetic (a conv's bias ahead of a one-channel
    group norm: gga_tpu's largest entry below 1e-9 of the model's) is
    rounding noise in both, and is held below ``tol`` / 100 of the model's
    largest entry instead. A None gradient counts as zeros."""
    flat = {'/'.join(p.key for p in path): np.asarray(v) for path, v in
            jax.tree_util.tree_leaves_with_path(ref_grads)}
    top = max(float(np.abs(v).max()) for v in flat.values())
    params = dict(model.named_parameters())
    checked = 0
    for tk, coll, fp, tr in rules:
        if coll != 'params':
            continue
        p = params[tk]
        g = np.zeros(p.shape) if p.grad is None else p.grad.numpy()
        ref = np.ascontiguousarray(convert._to_torch_layout(tr, flat[fp]))
        scale = float(np.abs(ref).max())
        bound = tol / 100 * top if scale < 1e-9 * top else tol * scale
        assert np.abs(g - ref).max() <= bound, (tk, np.abs(g - ref).max(),
                                                scale, top)
        checked += 1
    assert checked == len(params)


def round_trip(cfg, variables, det):
    """Every flax tensor has one rule and comes back unchanged."""
    rules = convert.rules_of(cfg)
    flat = jax.tree_util.tree_leaves_with_path(variables)
    assert len({r[2] for r in rules}) == len(rules) == len(flat)
    sd = det.state_dict()
    assert set(sd) == {r[0] for r in rules}
    for tk, coll, fp, tr in rules:
        node = variables[coll]
        for k in fp.split('/'):
            node = node[k]
        x = sd[tk].numpy()
        back = (x.transpose(2, 3, 1, 0)[::-1, ::-1]
                if tr == 'depthwise_deconv2d' else
                x.transpose(2, 1, 0) if tr == 'conv1d'
                else _from_torch_layout(tr, x))
        np.testing.assert_array_equal(back, node)


# --- GroupNorm and the depthwise upsampler ---------------------------------

@pytest.mark.parametrize('channels', [16, 512])
def test_group_norm_matches_flax(channels):
    rng = np.random.RandomState(channels)
    x = (rng.randn(2, 6, 10, channels) * 3 + 2).astype(np.float32)
    mod = jdla._Norm()
    v = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), x, False))
    v = _fill(v, rng)
    ref = jax.jit(lambda v, x: mod.apply(v, x, False))(v, x)
    assert norm_groups(channels) == (16 if channels == 16 else 32)
    gn = group_norm(channels)
    gn.load_state_dict(convert.convert_with_rules(v, [
        ('weight', 'params', 'GroupNorm_0/scale', 'copy'),
        ('bias', 'params', 'GroupNorm_0/bias', 'copy')]))
    assert isinstance(gn, layers.GroupNorm) and gn.eps == 1e-6
    with torch.no_grad():
        close(nhwc(gn(nchw(x))), ref, 1e-5)


@pytest.mark.parametrize('scale', [2, 4])
def test_depthwise_upsampler_matches_gga_tpu(scale):
    rng = np.random.RandomState(scale)
    x = rng.randn(2, 3, 5, 6).astype(np.float32)
    mod = jneck._DepthwiseUp(scale)
    kernel = rng.randn(2 * scale, 2 * scale, 1, 6).astype(np.float32)
    ref = jax.jit(lambda k, x: mod.apply({'params': {'kernel': k}}, x))(
        kernel, x)
    up = tneck.DepthwiseUp(6, scale)
    with torch.no_grad():
        up.weight.copy_(t(convert._to_torch_layout('depthwise_deconv2d',
                                                   kernel)))
        got = nhwc(up(nchw(x)))
        up.weight.copy_(t(kernel.transpose(3, 2, 0, 1)))
        unflipped = nhwc(up(nchw(x)))
    assert got.shape == (2, 3 * scale, 5 * scale, 6)
    close(got, ref, 1e-6)
    assert np.abs(unflipped - ref).max() > 1e-2 * np.abs(ref).max()
    # a fresh upsampler is the bilinear kernel in both layouts
    np.testing.assert_allclose(
        tneck.DepthwiseUp(6, scale).weight.detach().numpy()[0, 0],
        jneck._bilinear_kernel(2 * scale, 1)[..., 0, 0], rtol=0, atol=0)


# --- the tiny DLA model: one jitted reference --------------------------------

@pytest.fixture(scope='module')
def dla_ref():
    cfg = jsmoke.SMOKEModelConfig.tiny_dla()
    model = jsmoke.SMOKEDetector(cfg)
    batch = mono_batch()
    img = batch['image']
    variables = init_variables(model, img)
    boxes = bottom_boxes(batch)
    tm = trans_mats()

    def reference(v, x):
        preds, st = model.apply(v, x, train=False,
                                capture_intermediates=True)
        losses = model.loss(preds, boxes, batch['gt_labels'],
                            batch['centers2d'], batch['obj_valid'],
                            batch['cam2img'], tm)
        targets = jsh.smoke_build_targets(
            cfg.head, boxes, batch['gt_labels'], batch['centers2d'],
            batch['obj_valid'], preds['heatmap'].shape[1:3], tm)
        dets = model.decode(preds, batch['cam2img'], tm)
        return preds, st['intermediates'], losses, targets, dets

    preds, inter, losses, targets, dets = jax.device_get(
        run_jitted(reference, variables, img))
    sd = convert.from_jax_variables(variables, tsmoke.SMOKEModelConfig
                                    .tiny_dla())
    return dict(cfg=cfg, model=model, variables=variables, batch=batch,
                preds=preds, inter=inter, losses=losses, targets=targets, dets=dets, sd=sd,
                f64=f64_reference(model.apply, model.loss, variables, img,
                                  loss_args(batch) + (trans_mats(),)))


def run_jitted(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's backend optimization level
    0: half the compile time of these references, which run once."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={'xla_backend_optimization_level': 0})(*args)


def f64_reference(apply, loss, variables, image, args, static=()):
    """gga_tpu's loss and gradients in float64 (under ``jax.enable_x64``,
    train mode) on ``image`` and the loss's array ``args`` after the
    predictions, their floats in float64, then ``static``: (loss terms,
    gradients) as numpy."""
    def as64(x):
        x = np.asarray(x)
        return x.astype(np.float64) if x.dtype == np.float32 else x

    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(as64, variables)

        def loss_fn(params, x, *a):
            preds = apply({**v64, 'params': params}, x, train=True,
                          mutable=['batch_stats'])[0]
            out = loss(preds, *a, *static)
            return (out[0], out[1]) if isinstance(out, tuple) else (
                out['loss'], out)

        (_, terms), grads = run_jitted(
            jax.value_and_grad(loss_fn, has_aux=True), v64['params'],
            as64(image), *map(as64, args))
        return jax.device_get((terms, grads))


def loss_args(batch):
    """SMOKE's loss arguments after the predictions (trans_mat apart)."""
    return (bottom_boxes(batch), batch['gt_labels'], batch['centers2d'],
            batch['obj_valid'], batch['cam2img'])


def port_model(ref, cfg=None):
    cfg = cfg or tsmoke.SMOKEModelConfig.tiny_dla()
    return apis.init_smoke_detector(cfg, ref['sd'], device='cpu').model


@pytest.mark.parametrize('name', ['tiny_dla', 'tiny', None])
def test_config_fields_equal_gga_tpu(name):
    jc, tc = ((getattr(c, name)() if name else c()) for c in (
        jsmoke.SMOKEModelConfig, tsmoke.SMOKEModelConfig))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tsh.CAM_ORIGIN == jsh.CAM_ORIGIN


def test_dla_levels_match_given_gga_tpu_inputs(dla_ref):
    """Each DLANet level from gga_tpu's previous level, at 1e-5."""
    d = dla_ref['inter']['DLANet_0']
    refs = [d['base_layer']['__call__'][0], d['level0_conv0']['__call__'][0],
            d['level1_conv0']['__call__'][0]] + [
        d[f'level{i}']['__call__'][0] for i in range(2, 6)]
    bb = port_model(dla_ref).backbone
    mods = [bb.base_layer, bb.level0, bb.level1] + [
        getattr(bb, f'level{i}') for i in range(2, 6)]
    prev = dla_ref['batch']['image']
    with torch.no_grad():
        for i, (m, r) in enumerate(zip(mods, refs)):
            close(nhwc(m(nchw(prev))), r, 1e-5, err=f'module {i}')
            prev = r
        levels = bb(nchw(dla_ref['batch']['image']))
    assert [lv.shape[1] for lv in levels] == [4, 8, 8, 16, 16, 16]
    assert [lv.shape[2] for lv in levels] == [64, 32, 16, 8, 4, 2]


def test_neck_and_head_match_given_gga_tpu_inputs(dla_ref):
    inter = dla_ref['inter']
    det = port_model(dla_ref)
    levels = [nchw(lv) for lv in inter['DLANet_0']['__call__'][0]]
    neck_ref = inter['DLANeck_0']['__call__'][0]
    with torch.no_grad():
        neck = det.neck(levels)
        close(nhwc(neck), neck_ref, 1e-5)
        out = det.bbox_head(nchw(neck_ref))
    for key in ('heatmap', 'reg'):
        close(out[key], dla_ref['preds'][key], 1e-5, err=key)


def test_whole_forward_matches_gga_tpu(dla_ref):
    det = port_model(dla_ref)
    with torch.no_grad():
        out = det(nchw(dla_ref['batch']['image']))
    for key in ('heatmap', 'reg'):
        close(out[key], dla_ref['preds'][key], 2e-4, err=key)


def test_targets_match_render_heatmap(dla_ref):
    ref_hm, ref_cti, ref_inb = dla_ref['targets']
    b = dla_ref['batch']
    hm, cti, inb = tsh.build_targets(
        dla_ref['cfg'].head, t(bottom_boxes(b)), t(b['gt_labels']),
        t(b['centers2d']), t(b['obj_valid']), ref_hm.shape[1:3],
        t(trans_mats()))
    close(cti, ref_cti)
    close(inb, ref_inb)
    close(hm, ref_hm, 1e-6)
    assert (hm == 1.0).sum() == (ref_hm == 1.0).sum() > 0
    # the batch holds an object off the map and a padding slot
    assert not inb[:, 0].any() and not inb[:, -1].any() and inb.sum() >= 3


def test_loss_matches_on_gga_tpu_preds(dla_ref):
    b = dla_ref['batch']
    preds = {k: t(v) for k, v in dla_ref['preds'].items()}
    got = tsh.loss(dla_ref['cfg'].head, preds, t(bottom_boxes(b)),
                   t(b['gt_labels']), t(b['centers2d']), t(b['obj_valid']),
                   t(b['cam2img']), t(trans_mats()))
    for key in SMOKE_TERMS:
        np.testing.assert_allclose(float(got[key]),
                                   float(dla_ref['losses'][key]),
                                   rtol=1e-5, err_msg=key)
    assert float(got['num_pos']) == float(dla_ref['targets'][2].sum())


def test_decode_matches_on_gga_tpu_preds(dla_ref):
    b = dla_ref['batch']
    preds = {k: t(v) for k, v in dla_ref['preds'].items()}
    got = tsh.decode(dla_ref['cfg'].head, preds, t(b['cam2img']),
                     t(trans_mats()))
    ref = dla_ref['dets']
    close(got['labels'], ref['labels'])
    close(got['scores'], ref['scores'], 1e-6)
    close(got['boxes'], ref['boxes'], 1e-5)


def test_inference_mono_3d_detector_matches_gga_tpu(dla_ref):
    """gga_tpu's contract, with its test's ``trans_mat`` wrapper."""
    import types
    model = dla_ref['model']
    img, k = dla_ref['batch']['image'][0], dla_ref['batch']['cam2img'][0]
    wrapped = types.SimpleNamespace(
        apply=model.apply, decode=lambda preds, kk: model.decode(
            preds, kk, trans_mats(1)))
    ref = j_inference_mono(wrapped, dla_ref['cfg'], dla_ref['variables'],
                           img, k)
    bundle = apis.init_smoke_detector(tsmoke.SMOKEModelConfig.tiny_dla(),
                                      dla_ref['sd'], device='cpu')
    got = apis.inference_mono_3d_detector(bundle, img, k)
    assert len(ref['scores_3d']) > 0
    close(got['labels_3d'], ref['labels_3d'])
    close(got['scores_3d'], ref['scores_3d'], 1e-4)
    close(got['boxes_3d'], ref['boxes_3d'], 1e-4)


def test_train_step_loss_and_gradients(dla_ref):
    """One f32 step: the loss terms at 1e-4 of gga_tpu's f32 ones, each
    gradient within 1e-3 of the largest entry of gga_tpu's float64 one
    (gga_tpu's own f32 gradients part from it by up to 7.7e-3 at these
    widths; see ``test_gradients_match_gga_tpu_in_float64``)."""
    cfg = tsmoke.SMOKEModelConfig.tiny_dla()
    trainer = apis.init_smoke_trainer(
        cfg, 10, dict(lr=2.5e-4, grad_clip=0.0, lr_policy='step',
                      lr_steps=(50,), lr_gamma=0.1),
        dla_ref['sd'], device='cpu')
    assert trainer.optimizer.grad_clip is None
    logs = apis.smoke_train_step(trainer, dla_ref['batch'])
    for key in SMOKE_TERMS:
        np.testing.assert_allclose(float(logs[key]),
                                   float(dla_ref['losses'][key]),
                                   rtol=1e-4, err_msg=key)
    grads_close(trainer.model, dla_ref['f64'][1], convert.rules_of(cfg),
                1e-3)
    # the discarded projection of the two-level tree takes no gradient
    dead = [n for n, p in trainer.model.named_parameters() if p.grad is None]
    assert dead == ['backbone.level3.project.0.weight',
                    'backbone.level3.project.1.weight',
                    'backbone.level3.project.1.bias']
    assert int(logs['num_pos']) == int(dla_ref['targets'][2].sum()) == 4
    assert trainer.step == 1


def test_gradients_match_gga_tpu_in_float64(dla_ref):
    """The loss and every gradient of the port in float64 against
    gga_tpu's under x64, the loss at 1e-6 relative, each gradient within
    1e-5 of its largest entry (both packages run the neck's upsamplers in
    f32)."""
    cfg = tsmoke.SMOKEModelConfig.tiny_dla()
    det = port_model(dla_ref).double().train()
    b = dla_ref['batch']
    batch = {k: t(v).double() if v.dtype == np.float32 else t(v)
             for k, v in b.items()}
    batch.update(img=nchw(b['image']).double(),
                 gt_boxes_cam=t(bottom_boxes(b)).double(),
                 gt_labels=t(b['gt_labels']).long(),
                 trans_mat=t(trans_mats()).double())
    total, terms = loop.smoke_loss(det, batch)
    total.backward()
    terms = {k: v.detach() for k, v in terms.items()}
    for key in SMOKE_TERMS:
        np.testing.assert_allclose(float(terms[key]),
                                   float(dla_ref['f64'][0][key]), rtol=1e-6,
                                   err_msg=key)
    grads_close(det, dla_ref['f64'][1], convert.rules_of(cfg), 1e-5)


def test_conversion_round_trip(dla_ref):
    round_trip(tsmoke.SMOKEModelConfig.tiny_dla(), dla_ref['variables'],
               port_model(dla_ref))


def test_resnet_variant_matches_gga_tpu():
    cfg = jsmoke.SMOKEModelConfig.tiny()
    model = jsmoke.SMOKEDetector(cfg)
    img = mono_batch()['image']
    variables = init_variables(model, img)
    ref = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables,
                                                                img)
    tcfg = tsmoke.SMOKEModelConfig.tiny()
    bundle = apis.init_smoke_detector(
        tcfg, convert.from_jax_variables(variables, tcfg), device='cpu')
    with torch.no_grad():
        out = bundle.model(nchw(img))
    for key in ('heatmap', 'reg'):
        close(out[key], ref[key], 1e-5, err=key)
    round_trip(tcfg, variables, bundle.model)


def test_camera_corners_and_projection_match_gga_tpu():
    rng = np.random.RandomState(3)
    loc = rng.uniform(-5, 5, (6, 3)).astype(np.float32)
    loc[:, 2] += 20
    dims = rng.uniform(0.5, 4, (6, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, 6).astype(np.float32)
    ref = jax.jit(lambda a, b, c, k: jgeo.project_to_image(
        jgeo.corners_3d(a, b, c, origin=jsh.CAM_ORIGIN, axis=1).reshape(
            -1, 3), k) + (jgeo.corners_3d(a, b, c, origin=jsh.CAM_ORIGIN,
                                          axis=1),))(
        loc, dims, yaw, cam2img())
    corners = tgeo.corners_3d(t(loc), t(dims), t(yaw), origin=tsh.CAM_ORIGIN,
                              axis=1)
    pix, depth = tgeo.project_to_image(corners.reshape(-1, 3), t(cam2img()))
    close(corners, ref[2], 1e-6)
    close(pix, ref[0], 1e-6)
    close(depth, ref[1], 1e-6)
