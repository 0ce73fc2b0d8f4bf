"""The port's stage-4 PGD detector against gga_tpu's, tiny config, f32, CPU.

gga_tpu's ``PGDDetector`` variables (shapes from its init, values drawn
with numpy, BN statistics included) reach the port through
``convert.from_jax_variables``. Both packages then run the same images
(``PGDModelConfig.tiny()``, B = 2 at 96 x 320, and a forward at 100 x 330,
an odd size where the stride-2 'SAME' convs pad (1, 1) and the FPN's
nearest upsampling is not an exact 2x):

- the forward of every level and ``fuse_lambda`` at rtol 1e-4 + atol 1e-4;
- ``build_targets``: labels, positives and the assigned object exact, the
  floats within 1e-5;
- each loss term at rtol 1e-4, each parameter's gradient at cosine
  >= 0.9999;
- ``decode`` on gga_tpu's head outputs, and ``apis.infer_mono`` on the
  images: the same kept set, boxes within 1e-3 (``jax.lax.top_k`` and
  ``torch.topk`` may order ties differently, so the kept detections are
  compared as sets);
- the warmup + step schedule against optax's within 2 float32 ulps of its
  peak (optax computes in float32, the port in float64), and
  three optimizer steps against
  ``optax.chain(clip_by_global_norm(35), add_decayed_weights(1e-4),
  sgd(sched, 0.9))`` at rtol 1e-5;
- ``mono_detections_to_kitti_annos`` equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gga_tpu.eval import submission as jsub
from gga_tpu.models.dense_heads import pgd_head as jph
from gga_tpu.models.detectors import pgd as jpgd
from gga_tpu_torch import apis, convert
from gga_tpu_torch.eval import submission as tsub
from gga_tpu_torch.models.dense_heads import pgd_head as tph
from gga_tpu_torch.models.detectors import pgd as tpgd
from gga_tpu_torch.train import optim as topt

torch.set_num_threads(1)

H, W, B, M = 96, 320, 2, 8
TERMS = ('loss_cls', 'loss_offset', 'loss_size', 'loss_rotsin', 'loss_dir',
         'loss_depth', 'loss_kpts', 'loss_bbox2d', 'loss_consistency',
         'loss_centerness', 'loss', 'num_pos')


def _fill(tree, rng, path=()):
    """Numpy values for a tree of shapes: conv kernels uniform, He-scaled
    in the backbone (each followed by a BN) and variance-keeping in the
    FPN and the head (none is), so the outputs stay O(1); small biases;
    BN scales / statistics and the head's scales near 1."""
    if hasattr(tree, 'items'):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == 'kernel':
        gain = 6.0 if path[0] == 'ResNet_0' else 3.0
        bound = np.sqrt(gain / np.prod(shape[:-1]))
        v = rng.uniform(-bound, bound, shape)
    elif name in ('scale', 'var') or name.startswith('scales_lvl'):
        v = rng.uniform(0.8, 1.2, shape)
    elif name == 'fuse_lambda':
        v = np.asarray(0.3)
    else:                                   # bias, mean
        v = rng.uniform(-0.1, 0.1, shape)
    return np.asarray(v, np.float32)


def _fsz(h=H, w=W):
    return [(h // s, w // s) for s in (4, 8, 16, 32)]


def _objects(seed=1):
    """B images of M object slots (6 live, one of them invalid): 2D boxes
    around their projected centres, camera boxes, depths, intrinsics."""
    rng = np.random.RandomState(seed)
    cam2img = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    cam2img[:, 0, 0] = cam2img[:, 1, 1] = 200.0
    cam2img[:, 0, 2], cam2img[:, 1, 2] = W / 2, H / 2
    boxes = np.zeros((B, M, 4), np.float32)
    labels = np.full((B, M), -1, np.int32)
    cam3d = np.zeros((B, M, 7), np.float32)
    centers = np.zeros((B, M, 2), np.float32)
    depths = np.zeros((B, M), np.float32)
    valid = np.zeros((B, M), bool)
    for b in range(B):
        for m in range(6):
            z = rng.uniform(6, 40)
            c = [rng.uniform(20, W - 20), rng.uniform(15, H - 15)]
            half = rng.uniform(4, 60, 2)
            boxes[b, m] = [c[0] - half[0], c[1] - half[1], c[0] + half[0],
                           c[1] + half[1]]
            labels[b, m] = rng.randint(3)
            x = (c[0] - W / 2) * z / 200.0
            y = (c[1] - H / 2) * z / 200.0
            cam3d[b, m] = [x, y, z, *rng.uniform(0.5, 4, 3),
                           rng.uniform(-np.pi, np.pi)]
            centers[b, m] = c
            depths[b, m] = z
            valid[b, m] = m != 5
    return dict(gt_bboxes=boxes, gt_labels=labels, gt_cam3d=cam3d,
                centers2d=centers, depths=depths, obj_valid=valid,
                cam2img=cam2img)


def _jax_targets(cfg, objs, fsz):
    pts = jph.level_points(cfg.head, fsz)
    points = jnp.concatenate(pts)
    strides = jnp.concatenate([jnp.full((p.shape[0],), s, jnp.float32)
                               for p, s in zip(pts, cfg.head.strides)])
    ranges = jnp.concatenate([
        jnp.broadcast_to(jnp.asarray(r, jnp.float32), (p.shape[0], 2))
        for p, r in zip(pts, cfg.head.regress_ranges)])
    keys = ('gt_bboxes', 'gt_labels', 'gt_cam3d', 'centers2d', 'depths',
            'obj_valid')
    return jax.jit(jax.vmap(lambda *a: jph.build_targets(
        cfg.head, points, strides, ranges, *a)))(*(objs[k] for k in keys))


@pytest.fixture(scope='module')
def setup():
    """gga_tpu's variables: drawn weights, and BN running statistics those
    of a train-mode pass over the images (so the eval-mode forward, the
    inference path, keeps its activations O(1), as a trained model's)."""
    cfg = jpgd.PGDModelConfig.tiny()
    model = jpgd.PGDDetector(cfg)
    rng = np.random.RandomState(0)
    imgs = rng.randn(B, H, W, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), imgs, train=False))
    variables = _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                      np.random.RandomState(0))
    zeros = jax.tree_util.tree_map(np.zeros_like, variables['batch_stats'])
    # flax's update from zero statistics is 0.01 x the batch's
    _, upd = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=['batch_stats']))(
            dict(variables, batch_stats=zeros), imgs)
    variables['batch_stats'] = jax.tree_util.tree_map(
        lambda u: np.asarray(u) / np.float32(0.01), upd['batch_stats'])
    tcfg = tpgd.PGDModelConfig.tiny()
    bundle = apis.init_pgd_detector(
        tcfg, convert.from_jax_variables(variables, tcfg), device='cpu')
    return cfg, model, variables, imgs, bundle


_EVAL_FORWARD = {}


def _jax_forward(model, variables, imgs):
    """gga_tpu's eval-mode forward, jitted once a model (the jit's cache
    then serves every call at a seen image size)."""
    if id(model) not in _EVAL_FORWARD:
        _EVAL_FORWARD[id(model)] = jax.jit(
            lambda v, x: model.apply(v, x, train=False))
    return _EVAL_FORWARD[id(model)](variables, imgs)


def _port_forward(bundle, imgs):
    with torch.no_grad():
        return bundle.model.eval()(torch.from_numpy(imgs).permute(0, 3, 1, 2))


@pytest.mark.parametrize('hw', [(H, W), (100, 330)], ids=['96x320',
                                                           '100x330'])
def test_forward_matches_gga_tpu(setup, hw):
    cfg, model, variables, _, bundle = setup
    imgs = np.random.RandomState(hw[0]).randn(B, *hw, 3).astype(np.float32)
    jpreds, jfuse = _jax_forward(model, variables, imgs)
    preds, fuse = _port_forward(bundle, imgs)
    mean, std = cfg.head.base_depths[0]
    assert len(preds) == len(jpreds) == 4
    for lvl, (p, jp) in enumerate(zip(preds, jpreds)):
        assert set(p) == set(jp)
        for key, ref in jp.items():
            ref, out = np.asarray(ref, np.float64), p[key].double().numpy()
            assert out.shape == ref.shape, (lvl, key)
            if key == 'bbox_pred':
                # the direct depth before the coder's mean + x * std (std
                # 16.32 multiplies the f32 noise of the layers below it)
                ref[..., 2] = (ref[..., 2] - mean) / std
                out[..., 2] = (out[..., 2] - mean) / std
            np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4,
                                       err_msg=f'{lvl} {key}')
    np.testing.assert_allclose(float(fuse.detach()), float(jfuse), rtol=1e-6)


def test_build_targets_match_gga_tpu(setup):
    cfg = setup[0]
    objs = _objects()
    ref = _jax_targets(cfg, objs, _fsz())
    points, strides, ranges = tph.flat_points(cfg.head, _fsz())
    out = tph.build_targets(
        tpgd.PGDModelConfig.tiny().head, points, strides, ranges,
        *(torch.from_numpy(objs[k]) for k in (
            'gt_bboxes', 'gt_labels', 'gt_cam3d', 'centers2d', 'depths',
            'obj_valid')))
    pos = np.asarray(ref['pos_mask'])
    assert 20 < pos.sum() < pos.size / 4
    for key in ('labels_3d', 'pos_mask', 'amin'):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    for key in ('bbox_targets_3d', 'centerness'):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.fixture(scope='module')
def train_step(setup):
    """The loss terms and parameter gradients of one train-mode forward in
    both packages, from the same weights, images and objects."""
    cfg, model, variables, imgs, bundle = setup
    objs = _objects()
    targets = _jax_targets(cfg, objs, _fsz())

    def loss_fn(params):
        (preds, fuse), _ = model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            imgs, train=True, mutable=['batch_stats'])
        return jph.loss(cfg.head, preds, fuse, targets, objs['cam2img'],
                        _fsz())

    (_, jlogs), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables['params'])

    tcfg = tpgd.PGDModelConfig.tiny()
    trainer = apis.init_pgd_trainer(
        tcfg, 1, convert.from_jax_variables(variables, tcfg), device='cpu')
    trainer.model.train()
    b = {k: torch.as_tensor(v) for k, v in objs.items()}
    points, strides, ranges = tph.flat_points(tcfg.head, _fsz())
    tt = tph.build_targets(tcfg.head, points, strides, ranges,
                           b['gt_bboxes'], b['gt_labels'], b['gt_cam3d'],
                           b['centers2d'], b['depths'], b['obj_valid'])
    preds, fuse = trainer.model(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    total, logs = tph.loss(tcfg.head, preds, fuse, tt, b['cam2img'], _fsz())
    total.backward()
    logs = {k: v.detach() for k, v in logs.items()}
    grads = {k: p.grad for k, p in trainer.model.named_parameters()}
    ref_grads = convert.from_jax_variables(
        {'params': jax.tree_util.tree_map(np.asarray, jgrads)}, tcfg)
    return jlogs, logs, ref_grads, grads


@pytest.mark.parametrize('term', TERMS)
def test_loss_terms_match_gga_tpu(train_step, term):
    jlogs, logs = train_step[:2]
    assert float(jlogs['num_pos']) > 0
    np.testing.assert_allclose(float(logs[term]), float(jlogs[term]),
                               rtol=1e-4)


def test_gradients_match_gga_tpu(train_step):
    ref, grads = train_step[2:]
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


@pytest.fixture(scope='module')
def jax_decoded(setup):
    """gga_tpu's forward and decode on the images: (preds, fuse, decoded)."""
    cfg, model, variables, imgs, _ = setup
    preds, fuse = _jax_forward(model, variables, imgs)
    ref = jax.jit(lambda p, f, c: jph.decode(cfg.head, p, f, c, _fsz()))(
        preds, fuse, _objects()['cam2img'])
    return preds, fuse, {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize('path', ['decode', 'infer_mono'])
def test_decode_matches_gga_tpu(setup, jax_decoded, path):
    """``decode`` on gga_tpu's head outputs, and ``apis.infer_mono`` (the
    port's own eval-mode forward, then decode) on the images, against
    gga_tpu's forward and decode."""
    cfg, _, _, imgs, bundle = setup
    objs = _objects()
    preds, fuse, ref = jax_decoded
    if path == 'decode':
        out = tph.decode(tpgd.PGDModelConfig.tiny().head,
                         [{k: torch.from_numpy(np.array(v))
                           for k, v in p.items()} for p in preds],
                         torch.tensor(float(fuse)),
                         torch.from_numpy(objs['cam2img']), _fsz())
    else:
        out = apis.infer_mono(bundle, imgs, objs['cam2img'])
    assert out['boxes'].shape == ref['boxes'].shape
    n_kept = 0
    for b in range(B):
        for c in range(cfg.head.num_classes):
            def kept(d, bb=b, cc=c):
                sel = d['valid'][bb] & (d['labels'][bb] == cc)
                order = np.argsort(-d['scores'][bb][sel], kind='stable')
                return {k: d[k][bb][sel][order]
                        for k in ('scores', 'boxes', 'bboxes2d')}
            r = kept(ref)
            o = kept({k: v.numpy() for k, v in out.items()})
            assert len(o['scores']) == len(r['scores']), (b, c)
            n_kept += len(r['scores'])
            for k in r:
                np.testing.assert_allclose(o[k], r[k], rtol=1e-3, atol=1e-3,
                                           err_msg=f'{b} {c} {k}')
    assert n_kept > 4


def _optax_schedule(lr, steps_per_epoch, warmup, ratio, lr_steps, gamma):
    """tools/train_pgd.py:89-97."""
    bounds = [steps_per_epoch * s for s in lr_steps]
    return optax.join_schedules([
        optax.linear_schedule(lr * ratio, lr, warmup),
        optax.piecewise_constant_schedule(
            lr, {max(b - warmup, 1): gamma for b in bounds})], [warmup])


@pytest.mark.parametrize('steps_per_epoch,warmup', [(1, 500), (20, 500),
                                                    (100, 30)])
def test_step_schedule_matches_optax(steps_per_epoch, warmup):
    args = (1e-3, steps_per_epoch, warmup, 1 / 3, (32, 44), 0.1)
    ref, out = _optax_schedule(*args), topt.step_schedule(*args)
    # the steps where the decays start
    bounds = [warmup + max(steps_per_epoch * e - warmup, 1) for e in (32, 44)]
    steps = {0, 1, 2, warmup - 1, warmup, warmup + 1, warmup + 2,
             steps_per_epoch * 48}
    steps |= {s + d for s in bounds for d in (-1, 0, 1)}
    for step in sorted(s for s in steps if s >= 0):
        want = float(ref(jnp.int32(step)))
        assert abs(out(step) - want) <= 2 * np.spacing(np.float32(1e-3)), (
            step, out(step), want)


@pytest.mark.parametrize('grad_scale', [1.0, 300.0])
def test_pgd_optimizer_matches_optax(grad_scale):
    """grad_scale 300 puts the global norm above the clip of 35; the lr
    passes a decay boundary at the third step."""
    rng = np.random.RandomState(0)
    shapes = {'a': (4, 3), 'b': (5,), 'c': (2, 3, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * grad_scale).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    opt = dict(lr=0.01, warmup_iters=2, warmup_ratio=1 / 3, lr_steps=(3,),
               lr_gamma=0.1)
    tx = optax.chain(optax.clip_by_global_norm(35.0),
                     optax.add_decayed_weights(1e-4),
                     optax.sgd(_optax_schedule(0.01, 1, 2, 1 / 3, (3,),
                                               0.1), momentum=0.9))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    o = topt.build_pgd_optimizer(tp.values(), steps_per_epoch=1, **opt)
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


def test_mono_annos_match_gga_tpu():
    rng = np.random.RandomState(3)
    infos, dets = [], []
    for i, n in enumerate((4, 0, 2)):
        P2 = np.eye(4)
        P2[:3, :4] = [[721.5, 0, 609.6, 44.9], [0, 721.5, 172.9, 0.2],
                      [0, 0, 1, 0.003]]
        infos.append(dict(image=dict(image_idx=i, image_shape=(375, 1242)),
                          calib=dict(P2=P2)))
        boxes = np.concatenate([rng.uniform(-10, 10, (n, 1)),
                                rng.uniform(0, 2, (n, 1)),
                                rng.uniform(5, 50, (n, 1)),
                                rng.uniform(0.5, 4, (n, 3)),
                                rng.uniform(-3, 3, (n, 1))], 1)
        det = dict(boxes_cam=boxes.astype(np.float32),
                   scores=rng.rand(n).astype(np.float32),
                   labels=rng.randint(0, 3, n).astype(np.int32))
        if i != 2:      # the last one projects its 3D boxes
            det['bboxes2d'] = rng.uniform(-50, 1300, (n, 4)).astype(
                np.float32)
        dets.append(det)
    classes = ('Pedestrian', 'Cyclist', 'Car')
    ref = jsub.mono_detections_to_kitti_annos(
        [{k: v.copy() for k, v in d.items()} for d in dets], infos, classes)
    out = tsub.mono_detections_to_kitti_annos(dets, infos, classes)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert set(o) == set(r)
        for k in r:
            assert o[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(o[k], r[k], err_msg=k)
