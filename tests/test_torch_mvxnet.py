"""The port's MVXNet against gga_tpu's, f32, CPU.

- ``dynamic_scatter_max``: maxima, counts and the gradient exactly
  (``jax.grad`` of ``.at[].max`` gives each of n tied maxima ``g * (1 /
  n)``), on post-ReLU features whose voxels tie at 0 in most channels,
  on duplicated points, with empty voxels, invalid points and points of
  no voxel.
- ``bilinear_sample`` and ``point_sample`` at 1e-6 of the largest entry,
  with points behind the camera, at depth 1e-3, on the clip edges (x =
  W - 1, y = H - 1, 0) and just outside them.
- ``PointFusion`` and ``DynamicVFE`` alone, in train mode (their outputs
  and BN statistics' updates) and eval mode, at 1e-5.
- ``MVXNetConfig.tiny()``, gga_tpu's variables (shapes from its init,
  values drawn with numpy) reaching the port through
  ``convert.from_jax_variables``: the eval forward's head maps at 1e-5
  and its decode; one train-mode pass (gga_tpu's anchor step body on the
  images and projections, jitted once): the loss terms at rtol 1e-4
  (``num_pos`` exactly), each parameter's gradient within 1e-4 of the
  largest gradient entry and at cosine >= 0.9999, the BN statistics'
  updates at 1e-4; the sparse-conv
  wrappers' calls (the shipped config: ``gather_gemm_conv`` 12 a forward
  and 20 a step, ``gather_gemm_dw`` 12 and ``gather_rows`` 4 a step); the
  conversion round trip; ``inference_multi_modality_detector`` against
  gga_tpu's (its pad, forward at B = 1 and decode are the batch's first
  scene's).
"""
import jax
import numpy as np
import pytest
import torch

from gga_tpu.models import voxel_encoders as jve
from gga_tpu.models.dense_heads import anchor3d_head as jah
from gga_tpu.models.detectors import mvxnet as jm
from gga_tpu.models.fusion_layers import point_fusion as jpf
from gga_tpu.ops import scatter as jscatter
from gga_tpu_torch import apis, convert
from gga_tpu_torch.kernels import gather_rows as tgr
from gga_tpu_torch.kernels import sparse_conv as tsc
from gga_tpu_torch.models.detectors import mvxnet as tm
from gga_tpu_torch.models.fusion_layers import point_fusion as tpf
from gga_tpu_torch.models.voxel_encoders import DynamicVFE
from gga_tpu_torch.ops import scatter as tscatter
from gga_tpu_torch.train import loop

from .test_torch_dynamic_voxelnet import anchor_batch
from .test_torch_supervised import _fill, to_jax_variables

torch.set_num_threads(1)

TERMS = ('loss_cls', 'loss_bbox', 'loss_dir', 'loss', 'num_pos')
IMG_HW = (64, 96)


def close(got, ref, tol=0.0, err=''):
    """Bool and integer arrays exactly, floats within ``tol`` of the
    largest reference entry."""
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (err, got.shape, ref.shape)
    if ref.dtype == bool or ref.dtype.kind in 'iu':
        np.testing.assert_array_equal(got, ref, err_msg=err)
    else:
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=tol * max(float(np.abs(ref).max()), 1e-30),
            err_msg=err)


def lidar2img(B):
    """A KITTI-like projection onto a 64 x 96 image: lidar x is the depth,
    u = (48 x - 50 y) / x, v = (32 x - 50 z) / x."""
    m = np.zeros((B, 4, 4), np.float32)
    m[:, 0, 1] = -50
    m[:, 0, 0] = 48
    m[:, 1, 2] = -50
    m[:, 1, 0] = 32
    m[:, 2, 0] = 1
    m[:, 3, 3] = 1
    return m


def t(x):
    return torch.from_numpy(np.array(x))


def nchw(img):
    return t(img).permute(0, 3, 1, 2).contiguous()


# --- dynamic_scatter_max ------------------------------------------------

def scatter_case(kind, seed=0):
    """(features [B, P, C], ids [B, P], valid [B, P], V)."""
    rng = np.random.RandomState(seed)
    B, P, C, V = 2, 300, 8, 40
    ids = rng.randint(0, V, (B, P))
    ids[:, :20] = V                         # points of no voxel
    ids[ids == 7] = 8                       # voxel 7 empty
    valid = rng.rand(B, P) > 0.1
    if kind == 'relu_ties':
        # post-ReLU: most voxels tie at 0 in most channels
        f = np.maximum(rng.randn(B, P, C) - 1.0, 0.0)
    else:
        # duplicated points: each voxel's max shared by 1-3 points
        f = np.round(rng.randn(B, P, C), 1)
    return f.astype(np.float32), ids.astype(np.int32), valid, V


@pytest.mark.parametrize('kind', ['relu_ties', 'duplicates'])
def test_dynamic_scatter_max_matches_gga_tpu(kind):
    f, ids, valid, V = scatter_case(kind)
    g = np.random.RandomState(1).randn(f.shape[0], V, f.shape[2]).astype(
        np.float32)

    def jfun(f):
        out, cnt = jax.vmap(lambda a, b, c: jscatter.dynamic_scatter_max(
            a, b, c, V))(f, ids, valid)
        return (out * g).sum(), (out, cnt)

    (_, (jout, jcnt)), jgrad = jax.jit(jax.value_and_grad(
        jfun, has_aux=True))(f)
    tf = t(f).requires_grad_()
    out, cnt = tscatter.dynamic_scatter_max(tf, t(ids), t(valid), V)
    (out * t(g)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(tf.grad.numpy(), np.asarray(jgrad))
    # the case holds what it means to: ties, empty voxels
    assert (cnt[:, 7] == 0).all() and (out[:, 7] == 0).all()
    hit = f == np.take_along_axis(
        out.detach().numpy(), np.minimum(ids, V - 1)[..., None], 1)
    live = valid & (ids < V)
    rows = np.broadcast_to((np.arange(2)[:, None] * V + ids)[..., None],
                           f.shape)[hit & live[..., None]]
    assert np.bincount(rows).max() >= 3        # a maximum tied 3 ways


# --- bilinear_sample / point_sample --------------------------------------

def test_bilinear_sample_matches_gga_tpu_at_the_edges():
    rng = np.random.RandomState(0)
    H, W, C = 7, 11, 5
    feat = rng.randn(2, H, W, C).astype(np.float32)
    edges = np.array([[0, 0], [W - 1, H - 1], [W - 1, 0], [0, H - 1],
                      [W - 1, 3.5], [4.25, H - 1], [-1e-4, 2], [W - 1 + 1e-3,
                                                                 2],
                      [3, -0.5], [3, H - 0.5], [5.5, 3.25], [1e6, -1e6]],
                     np.float32)
    uv = np.concatenate([np.broadcast_to(edges, (2,) + edges.shape),
                         rng.uniform(-2, [W + 1, H + 1], (2, 40, 2))],
                        1).astype(np.float32)
    valid = rng.rand(2, uv.shape[1]) > 0.2
    valid[:, :len(edges)] = True
    ref = jax.jit(jax.vmap(jpf.bilinear_sample))(feat, uv, valid)
    got = tpf.bilinear_sample(nchw(feat), t(uv), t(valid))
    close(got, ref, 1e-6)
    assert (got[:, 6:10].abs().sum(-1) == 0).all()     # just outside: 0
    assert (got[:, :6].abs().sum(-1) > 0).all()        # on the edges


def test_point_sample_matches_gga_tpu_behind_the_camera():
    rng = np.random.RandomState(1)
    Hf, Wf, C = 16, 24, 6
    feat = rng.randn(2, Hf, Wf, C).astype(np.float32)
    pts = np.concatenate([rng.uniform(-5, 40, (2, 60, 1)),
                          rng.uniform(-20, 20, (2, 60, 1)),
                          rng.uniform(-3, 1, (2, 60, 1))], -1)
    pts[:, 0] = [-4.0, 1.0, 0.5]           # behind the camera
    pts[:, 1] = [1e-3, 0.0, 0.0]           # at the depth floor
    pts[:, 2] = [1.001e-3, 0.0, 0.0]       # just in front of it
    pts[:, 3] = [10.0, 9.5, 6.25]          # (u, v) = (0.5, 0.75): a corner
    pts = pts.astype(np.float32)
    valid = rng.rand(2, 60) > 0.1
    valid[:, :4] = True
    l2i = lidar2img(2)
    ref = jax.jit(lambda f, p, m, v: jax.vmap(
        jpf.point_sample, in_axes=(0, 0, 0, None, 0))(f, p, m, IMG_HW, v))(
        feat, pts, l2i, valid)
    got = tpf.point_sample(nchw(feat), t(pts), t(l2i), IMG_HW, t(valid))
    close(got, ref, 1e-6)
    assert (got[:, :2].abs().sum(-1) == 0).all()
    assert (got[:, 3].abs().sum(-1) > 0).all()


# --- the model -------------------------------------------------------------

@pytest.fixture(scope='module')
def setup():
    """The tiny config, a 2-scene batch (a pedestrian, a cyclist and a car
    on anchor centres over ground and clutter, images drawn with numpy),
    gga_tpu's variables and every gga_tpu reference, from two jitted
    functions (the eval forward + decode, the train step's loss and
    gradients)."""
    jcfg, tcfg = jm.MVXNetConfig.tiny(), tm.MVXNetConfig.tiny()
    batch = anchor_batch(tcfg.head, (32, 28), ((6, 4), (12, 6), (18, 9)))
    B = batch['points'].shape[0]
    rng = np.random.RandomState(2)
    batch['img'] = rng.rand(B, *IMG_HW, 3).astype(np.float32)
    batch['lidar2img'] = lidar2img(B)
    model = jm.MVXNet(jcfg)
    args = (batch['points'], batch['points_valid'], batch['img'],
            batch['lidar2img'])
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args,
                                               train=False))
    variables = _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                      np.random.RandomState(1))

    @jax.jit
    def evaluate(v, points, valid, img, l2i):
        preds = model.apply(v, points, valid, img, l2i, train=False)
        anchors = jah.make_anchors(jcfg.head, preds['cls'].shape[1:3])
        return preds, jah.decode(jcfg.head, preds, anchors)

    def loss_fn(params, batch_stats, b):
        preds, mut = model.apply(
            {'params': params, 'batch_stats': batch_stats}, b['points'],
            b['points_valid'], b['img'], b['lidar2img'], train=True,
            mutable=['batch_stats', 'diagnostics'])
        anchors = jah.make_anchors(jcfg.head, preds['cls'].shape[1:3])
        targets = jax.vmap(lambda gb, gl, gv: jah.assign_targets(
            jcfg.head, anchors, gb, gl, gv))(b['gt_boxes'], b['gt_labels'],
                                             b['gt_valid'])
        total, logs = jah.loss(jcfg.head, preds, anchors, targets)
        return total, (logs, mut)

    jb = {k: v for k, v in batch.items()}
    (_, (jlogs, mut)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables['params'],
                                variables['batch_stats'], jb)
    jpreds, jdec = evaluate(variables, *args)
    sd = convert.from_jax_variables(variables, tcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, batch=batch, model=model,
                variables=variables, sd=sd, jpreds=jpreds, jdec=jdec,
                jlogs=jlogs, mut=mut, jgrads=jgrads)


def port_detector(setup, train=False):
    det = apis.init_mvxnet_detector(setup['tcfg'], setup['sd'],
                                    device='cpu').model
    return det.train() if train else det.eval()


def port_args(batch):
    return (t(batch['points']), t(batch['points_valid']), nchw(batch['img']),
            t(batch['lidar2img']))


def _sub_variables(variables, scope):
    return {c: variables[c][scope] for c in ('params', 'batch_stats')}


def _sub_state(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize('train', [False, True])
def test_dynamic_vfe_matches_gga_tpu(setup, train):
    """The VFE alone, no fusion (its last layer's maxima scattered), on
    the detector's voxels and slots."""
    jcfg, batch = setup['jcfg'], setup['batch']
    points, valid = t(batch['points']), t(batch['points_valid'])
    coords, ids, pok, vvalid = tm.mvxnet_voxels(setup['tcfg'], points, valid)
    jmod = jve.DynamicVFE(feat_channels=jcfg.vfe_channels,
                          voxel_size=jcfg.voxel_size,
                          point_cloud_range=jcfg.point_cloud_range,
                          max_voxels=jcfg.max_voxels)
    ins = [np.asarray(x) for x in (points, ids, pok, coords, vvalid)]
    ref, mut = jax.jit(lambda v, *a: jmod.apply(
        v, *a, train, mutable=['batch_stats']))(
        _sub_variables(setup['variables'], 'vfe'), *ins)
    vfe = DynamicVFE(feat_channels=jcfg.vfe_channels,
                     voxel_size=jcfg.voxel_size,
                     point_cloud_range=jcfg.point_cloud_range,
                     max_voxels=jcfg.max_voxels)
    vfe.load_state_dict({k: v for k, v in _sub_state(
        setup['sd'], 'pts_voxel_encoder.').items()
        if not k.startswith('fusion_layer.')})
    vfe.train(train)
    with torch.no_grad():
        got = vfe(points, ids, pok, coords, vvalid)
    close(got, ref, 1e-5)
    for i in range(len(jcfg.vfe_channels)):
        for a, b in (('running_mean', 'mean'), ('running_var', 'var')):
            close(vfe.state_dict()[f'vfe_layers.{i}.1.{a}'],
                  mut['batch_stats'][f'vfe_bn{i}'][b], 1e-5)


@pytest.mark.parametrize('train', [False, True])
def test_point_fusion_matches_gga_tpu(setup, train):
    """PointFusion alone on three levels of drawn NCHW maps and drawn
    point features."""
    jcfg, batch = setup['jcfg'], setup['batch']
    rng = np.random.RandomState(3)
    B, P = batch['points_valid'].shape
    L, C = len(jcfg.img_levels), jcfg.img_fpn_channels
    feats = [rng.randn(B, 16 // 2 ** i, 24 // 2 ** i, C).astype(np.float32)
             for i in range(L)]
    pts_feats = np.maximum(rng.randn(B, P, jcfg.vfe_channels[-1]), 0).astype(
        np.float32)
    valid = batch['points_valid'] & (rng.rand(B, P) > 0.2)
    jmod = jpf.PointFusion(img_channels=(C,) * L,
                           pts_channels=jcfg.vfe_channels[-1],
                           mid_channels=jcfg.fusion_mid_channels,
                           out_channels=jcfg.fusion_out_channels,
                           img_levels=tuple(range(L)))
    ref, mut = jax.jit(lambda v, *a: jmod.apply(
        v, *a, IMG_HW, train, mutable=['batch_stats']))(
        _sub_variables(setup['variables'], 'fusion'), feats,
        batch['points'][..., :3], pts_feats, valid, batch['lidar2img'])
    fusion = tpf.PointFusion(img_channels=(C,) * L,
                             pts_channels=jcfg.vfe_channels[-1],
                             mid_channels=jcfg.fusion_mid_channels,
                             out_channels=jcfg.fusion_out_channels,
                             img_levels=tuple(range(L)))
    fusion.load_state_dict(_sub_state(setup['sd'],
                                      'pts_voxel_encoder.fusion_layer.'))
    fusion.train(train)
    with torch.no_grad():
        got = fusion([nchw(f) for f in feats], t(batch['points'][..., :3]),
                     t(pts_feats), t(valid), t(batch['lidar2img']), IMG_HW)
    close(got, ref, 1e-5)
    assert float(got.abs().max()) > 0
    sd = fusion.state_dict()
    for t_, f_ in (('img_transform.1', 'img_bn'),
                   ('pts_transform.1', 'pts_bn'),
                   ('lateral_convs.0.bn', 'lateral0')):
        stats = mut['batch_stats'][f_]
        stats = stats.get('BatchNorm2d_0', {}).get('BatchNorm_0', stats)
        close(sd[f'{t_}.running_mean'], stats['mean'], 1e-5)
        close(sd[f'{t_}.running_var'], stats['var'], 1e-5)


def test_mvxnet_eval_forward_and_decode_match_gga_tpu(setup):
    det = port_detector(setup)
    with torch.no_grad():
        preds = det(*port_args(setup['batch']))
    for key in ('cls', 'reg', 'dir'):
        close(preds[key], setup['jpreds'][key], 1e-5, key)
    out = apis.infer_mvxnet(apis.DetectorBundle(det, setup['tcfg'],
                                                torch.device('cpu')),
                            setup['batch']['points'],
                            setup['batch']['points_valid'],
                            setup['batch']['img'],
                            setup['batch']['lidar2img'])
    ref = setup['jdec']
    close(out['valid'], ref['valid'])
    v = np.asarray(ref['valid'])
    assert v.sum() > 0
    close(out['labels'][t(v)], np.asarray(ref['labels'])[v])
    close(out['scores'][t(v)], np.asarray(ref['scores'])[v], 1e-5)
    close(out['boxes'][t(v)], np.asarray(ref['boxes'])[v], 1e-5)


@pytest.fixture(scope='module')
def train_pass(setup):
    """One train-mode pass of the port (``loop.mvxnet_loss``) from gga_tpu's
    variables, with every sparse-conv wrapper call counted."""
    det = port_detector(setup, train=True)
    b = {k: t(v) for k, v in setup['batch'].items()}
    b['img'] = nchw(setup['batch']['img'])
    calls = dict.fromkeys(('conv', 'dw', 'rows'), 0)
    real = tsc.gather_gemm_conv, tsc.gather_gemm_dw, tgr.gather_rows

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    tsc.gather_gemm_conv = counted('conv', real[0])
    tsc.gather_gemm_dw = counted('dw', real[1])
    tgr.gather_rows = counted('rows', real[2])
    try:
        total, logs = loop.mvxnet_loss(det, b)
        forward_calls = dict(calls)
        total.backward()
    finally:
        tsc.gather_gemm_conv, tsc.gather_gemm_dw, tgr.gather_rows = real
    return dict(det=det, logs=logs, forward_calls=forward_calls,
                step_calls=calls)


@pytest.mark.parametrize('term', TERMS)
def test_mvxnet_loss_terms_match_gga_tpu(setup, train_pass, term):
    assert float(setup['jlogs']['num_pos']) >= 3
    np.testing.assert_allclose(float(train_pass['logs'][term].detach()),
                               float(setup['jlogs'][term]), rtol=1e-4)


def test_mvxnet_gradients_and_bn_updates_match_gga_tpu(setup, train_pass):
    det, tcfg = train_pass['det'], setup['tcfg']
    ref = convert.from_jax_variables(
        {'params': jax.tree_util.tree_map(np.asarray, setup['jgrads'])},
        tcfg)
    shadow = tm.MVXNet(tcfg)
    missing, unexpected = shadow.load_state_dict(ref, strict=False)
    assert not unexpected
    ref = dict(shadow.named_parameters())
    # the tiny FPN's 4th output conv feeds none of its 3 levels: no
    # gradient reaches it, and gga_tpu's is zero
    unused = {k for k, p in det.named_parameters() if p.grad is None}
    assert unused == {'img_neck.fpn_convs.3.conv.weight',
                      'img_neck.fpn_convs.3.conv.bias'}
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in det.named_parameters()}
    assert set(grads) == set(ref)
    # every entry within 1e-4 of the largest gradient entry; each tensor
    # at cosine >= 0.9999 but the fusion's two linear biases, whose
    # gradients a batch norm right after them makes 0 up to rounding
    largest = max(float(r.abs().max()) for r in ref.values())
    for k, g in grads.items():
        r = ref[k].detach()
        assert float((g - r).abs().max()) <= 1e-4 * largest, k
        if k not in unused and not k.endswith('_transform.0.bias'):
            assert float(torch.nn.functional.cosine_similarity(
                g.flatten().double(), r.flatten().double(), dim=0)) \
                >= 0.9999, k
    stats = convert.from_jax_variables(
        {'batch_stats': jax.tree_util.tree_map(
            np.asarray, setup['mut']['batch_stats'])}, tcfg)
    sd = det.state_dict()
    assert len(stats) >= 40
    for k, r in stats.items():
        close(sd[k], r.numpy(), 1e-4, k)


def kernel_calls(cfg):
    """(forward, step) calls of each sparse-conv wrapper: every SubM conv
    (conv_input, stage 0's, the rest of each later stage's) and the 4
    strided convs (the 3 opening stages 1-3, conv_out) in the forward;
    a step adds every SubM conv's input gradient (conv_input's too: the
    VFE below it carries weights) and each conv's weight gradient, and
    the strided convs' input gradients gather rows."""
    subm = 1 + sum(len(b) - (i > 0)
                   for i, b in enumerate(cfg.encoder_channels))
    fwd = subm + 4
    return (dict(conv=fwd, dw=0, rows=0),
            dict(conv=fwd + subm, dw=fwd, rows=4))


def test_mvxnet_step_launch_counts(setup, train_pass):
    assert kernel_calls(tm.MVXNetConfig()) == (
        dict(conv=12, dw=0, rows=0), dict(conv=20, dw=12, rows=4))
    fwd, step = kernel_calls(setup['tcfg'])
    assert train_pass['forward_calls'] == fwd
    assert train_pass['step_calls'] == step


def test_conversion_round_trip(setup):
    tcfg, variables = setup['tcfg'], setup['variables']
    sd = setup['sd']
    det = apis.init_mvxnet_detector(tcfg, sd, device='cpu').model  # strict
    rules = convert.rules_of(tcfg)
    assert len({r[2] for r in rules}) == len(rules) == len(sd)
    back = to_jax_variables(det.state_dict(), tcfg)
    flat = jax.tree_util.tree_leaves_with_path(variables)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def test_inference_multi_modality_detector_matches_gga_tpu(setup):
    """gga_tpu's ``inference_multi_modality_detector`` pads the sample's
    points to ``max_points``, runs the eval forward at B = 1 and decodes:
    at ``max_points`` = P its input is the batch's first scene, whose
    decode the jitted reference holds already."""
    b = setup['batch']
    assert b['points_valid'][0].all()
    bundle = apis.init_mvxnet_detector(setup['tcfg'], setup['sd'],
                                       device='cpu')
    got = apis.inference_multi_modality_detector(
        bundle, b['points'][0], b['img'][0], b['lidar2img'][0],
        max_points=b['points'].shape[1])
    ref = {k: np.asarray(v)[0] for k, v in setup['jdec'].items()}
    v = ref['valid']
    assert v.sum() > 0
    close(got['labels_3d'], ref['labels'][v])
    close(got['scores_3d'], ref['scores'][v], 1e-5)
    close(got['boxes_3d'], ref['boxes'][v], 1e-5)


def test_mvxnet_images_reach_the_fused_points(setup):
    """Zeroing the image moves the fused VFE's output (gga_tpu's own
    check, at the fusion layer)."""
    det = port_detector(setup)
    args = list(port_args(setup['batch']))
    seen = []
    vfe = det.pts_voxel_encoder
    hook = vfe.register_forward_hook(lambda m, a, out: seen.append(out))
    with torch.no_grad():
        det(*args)
        args[2] = torch.zeros_like(args[2])
        det(*args)
    hook.remove()
    assert float((seen[0] - seen[1]).abs().max()) > 1e-4
