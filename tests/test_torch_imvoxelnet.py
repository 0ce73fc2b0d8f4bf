"""The port's ImVoxelNet (KITTI and indoor) against gga_tpu's, f32, CPU.

- The transposed 3-D conv: flax's ``nn.ConvTranspose`` (kernel 2, stride
  2) and torch's ``ConvTranspose3d`` with the converted weight (permuted
  and flipped on its three spatial axes) within 1e-6 of the largest
  entry; the weight unflipped gives another volume.
- ``OutdoorImVoxelNeck`` and ``IndoorImVoxelNeck`` alone on drawn volumes,
  train mode (outputs and BN statistics' updates) and eval mode, at 1e-5.
- ``ImVoxelNetConfig.tiny()`` (KITTI), gga_tpu's variables (shapes from
  its init, values drawn with numpy) reaching the port through
  ``convert.from_jax_variables``: the eval forward's head maps at 1e-5,
  the anchor loss terms of a train-mode pass at rtol 1e-4 (``num_pos``
  exactly), the conversion round trip.
- ``ImVoxelNetIndoorConfig.tiny()``: the eval forward's levels at 1e-5
  and the projection validity exactly; the head's targets of a
  train-mode pass (exactly, the centerness and box targets at 1e-5);
  the 4 loss terms at rtol 1e-4 (``num_pos`` exactly); each parameter's
  gradient within 1e-4 of the largest gradient entry and at cosine >=
  0.9999; the BN statistics' updates at 1e-4; decode on head logits
  rounded to 5 values (equal scores everywhere, which the port's
  stable sort must order as ``jax.lax.top_k`` does) and as they are (the
  kept boxes and labels exactly, scores at 1e-5, boxes at 1e-4); the
  conversion round trip.

Each detector's references come from one jitted function.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gga_tpu.models.dense_heads import anchor3d_head as jah
from gga_tpu.models.dense_heads import fcaf3d_head as jfc
from gga_tpu.models.dense_heads import imvoxel_head as jih
from gga_tpu.models.detectors import imvoxelnet as jm
from gga_tpu.models.necks import imvoxel_neck as jneck
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models.dense_heads import anchor3d_head as tah
from gga_tpu_torch.models.dense_heads import fcaf3d_head as tfc
from gga_tpu_torch.models.dense_heads import imvoxel_head as tih
from gga_tpu_torch.models.detectors import imvoxelnet as tm
from gga_tpu_torch.models.necks import imvoxel_neck as tneck
from gga_tpu_torch.train import loop

from .test_torch_mvxnet import close, lidar2img, nchw, t
from .test_torch_supervised import _fill, _from_torch_layout

torch.set_num_threads(1)

ANCHOR_TERMS = ('loss_cls', 'loss_bbox', 'loss_dir', 'loss', 'num_pos')
INDOOR_TERMS = ('cls_loss', 'center_loss', 'bbox_loss', 'loss', 'num_pos')


def depth2img(B):
    """A SUN RGB-D-like projection of depth coords (x right, y forward, z
    up) onto a 96 x 128 image: u = (60 x + 64 y) / y, v = (48 y - 60 z) /
    y."""
    m = np.zeros((B, 4, 4), np.float32)
    m[:, 0] = [60, 64, 0, 0]
    m[:, 1] = [0, 48, -60, 0]
    m[:, 2] = [0, 1, 0, 0]
    m[:, 3] = [0, 0, 0, 1]
    return m


def to_jax_variables(state_dict, cfg):
    """The port's state_dict -> gga_tpu's variable trees (the 3-D kernels
    back to ``[kx, ky, kz, I, O]``, the transposed one unflipped)."""
    out = {'params': {}, 'batch_stats': {}}
    for tk, coll, fp, tr in convert.rules_of(cfg):
        x = state_dict[tk].numpy()
        if tr == 'conv3d':
            x = x.transpose(2, 3, 4, 1, 0)
        elif tr == 'deconv3d':
            x = x.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1]
        else:
            x = _from_torch_layout(tr, x)
        node = out[coll]
        *scopes, leaf = fp.split('/')
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = np.ascontiguousarray(x)
    return out


def round_trip(cfg, variables):
    sd = convert.from_jax_variables(variables, cfg)
    det = apis.init_imvoxelnet_detector(cfg, sd, device='cpu').model
    rules = convert.rules_of(cfg)
    assert len({r[2] for r in rules}) == len(rules) == len(sd)
    back = to_jax_variables(det.state_dict(), cfg)
    flat = jax.tree_util.tree_leaves_with_path(variables)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def init_variables(model, *args):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args,
                                               train=False))
    return _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                 np.random.RandomState(1))


def ncdhw(x):
    return t(x).permute(0, 4, 1, 2, 3).contiguous()


def ndhwc(x):
    return x.detach().permute(0, 2, 3, 4, 1).numpy()


# --- the transposed conv --------------------------------------------------

def test_transposed_conv_conversion_flips_the_kernel():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 4, 5, 6).astype(np.float32)
    mod = fnn.ConvTranspose(5, (2, 2, 2), strides=(2, 2, 2), use_bias=False)
    v = mod.init(jax.random.PRNGKey(0), x)
    kernel = rng.randn(*v['params']['kernel'].shape).astype(np.float32)
    ref = np.asarray(mod.apply({'params': {'kernel': kernel}}, x))
    deconv = torch.nn.ConvTranspose3d(6, 5, 2, 2, bias=False)
    with torch.no_grad():
        deconv.weight.copy_(t(convert._to_torch_layout('deconv3d', kernel)))
        got = ndhwc(deconv(ncdhw(x)))
        deconv.weight.copy_(t(kernel.transpose(3, 4, 0, 1, 2)))
        unflipped = ndhwc(deconv(ncdhw(x)))
    assert got.shape == ref.shape == (2, 6, 8, 10, 5)
    close(got, ref, 1e-6)
    assert np.abs(unflipped - ref).max() > 1e-2 * np.abs(ref).max()


# --- the necks ------------------------------------------------------------

def _neck_state(variables, cfg, scope):
    """The port's ``neck_3d.*`` tensors from gga_tpu's neck ``scope``."""
    sd = convert.from_jax_variables(variables, cfg)
    return {k[len('neck_3d.'):]: v for k, v in sd.items()
            if k.startswith('neck_3d.')}


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('kind', ['outdoor', 'indoor'])
def test_neck_matches_gga_tpu(kind, train):
    rng = np.random.RandomState(4)
    if kind == 'outdoor':
        cfg = tm.ImVoxelNetConfig.tiny()
        jmod, scope = jneck.OutdoorImVoxelNeck(cfg.neck3d_out), \
            'OutdoorImVoxelNeck_0'
        x = rng.randn(2, 12, 10, 12, 8).astype(np.float32)
        mod = tneck.OutdoorImVoxelNeck(8, cfg.neck3d_out)
    else:
        cfg = tm.ImVoxelNetIndoorConfig.tiny()
        jmod, scope = jneck.IndoorImVoxelNeck(cfg.neck3d_channels,
                                              tuple(cfg.neck3d_blocks)), \
            'IndoorImVoxelNeck_0'
        x = rng.randn(2, 8, 8, 4, 16).astype(np.float32)
        mod = tneck.IndoorImVoxelNeck(16, cfg.neck3d_channels,
                                      tuple(cfg.neck3d_blocks))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x,
                                              train=False))
    var = _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                np.random.RandomState(2))
    ref, mut = jax.jit(lambda v, x_: jmod.apply(
        v, x_, train=train, mutable=['batch_stats']))(var, x)
    full = {c: {scope: var[c]} for c in var}
    state = {k: v for k, v in _neck_state(full, cfg, scope).items()}
    mod.load_state_dict(state)
    mod.train(train)
    with torch.no_grad():
        got = mod(ncdhw(x))
    if kind == 'outdoor':
        close(got.permute(0, 2, 3, 1), ref, 1e-5)
    else:
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            close(ndhwc(g), r, 1e-5)
    stats = convert.from_jax_variables(
        {'batch_stats': {scope: mut['batch_stats']}}, cfg)
    sd = mod.state_dict()
    n_bn = sum(isinstance(m, tneck.BatchNorm2d) for m in mod.modules())
    assert len(stats) == 2 * n_bn
    for k, r in stats.items():
        close(sd[k[len('neck_3d.'):]], r.numpy(), 1e-5, k)


# --- ImVoxelNet (KITTI) ---------------------------------------------------

@pytest.fixture(scope='module')
def kitti():
    jcfg, tcfg = jm.ImVoxelNetConfig.tiny(), tm.ImVoxelNetConfig.tiny()
    B = 2
    rng = np.random.RandomState(0)
    img = rng.rand(B, 64, 96, 3).astype(np.float32)
    l2i = lidar2img(B)
    ny, nx = tcfg.n_voxels[1], tcfg.n_voxels[0]
    anchors = tah.make_anchors(tcfg.head, (ny, nx)).numpy().reshape(
        ny, nx, 2, 7)
    gt = np.zeros((B, 8, 7), np.float32)
    for b in range(B):
        for k, (h, w) in enumerate(((18, 10 + b), (22, 14))):
            gt[b, k] = anchors[h, w, k % 2]
    labels = np.where(gt[..., 3] > 0, 0, -1)
    batch = dict(img=img, lidar2img=l2i, gt_boxes=gt, gt_labels=labels,
                 gt_valid=labels >= 0)
    model = jm.ImVoxelNet(jcfg)
    variables = init_variables(model, img, l2i)

    @jax.jit
    def reference(v, b):
        preds = model.apply(v, b['img'], b['lidar2img'], train=False)
        tpreds, mut = model.apply(v, b['img'], b['lidar2img'], train=True,
                                  mutable=['batch_stats'])
        anc = jah.make_anchors(jcfg.head, tpreds['cls'].shape[1:3])
        targets = jax.vmap(lambda gb, gl, gv: jah.assign_targets(
            jcfg.head, anc, gb, gl, gv))(b['gt_boxes'], b['gt_labels'],
                                         b['gt_valid'])
        return preds, jah.loss(jcfg.head, tpreds, anc, targets)[1], mut

    preds, logs, mut = reference(variables, batch)
    return dict(tcfg=tcfg, batch=batch, variables=variables, preds=preds,
                logs=logs, mut=mut,
                sd=convert.from_jax_variables(variables, tcfg))


def test_kitti_forward_matches_gga_tpu(kitti):
    det = apis.init_imvoxelnet_detector(kitti['tcfg'], kitti['sd'],
                                        device='cpu').model
    with torch.no_grad():
        preds = det(nchw(kitti['batch']['img']),
                    t(kitti['batch']['lidar2img']))
    for key in ('cls', 'reg', 'dir'):
        close(preds[key], kitti['preds'][key], 1e-5, key)


@pytest.mark.parametrize('term', ANCHOR_TERMS)
def test_kitti_anchor_loss_matches_gga_tpu(kitti, term):
    det = apis.init_imvoxelnet_detector(kitti['tcfg'], kitti['sd'],
                                        device='cpu').model.train()
    b = {k: t(v) for k, v in kitti['batch'].items()}
    b['img'] = nchw(kitti['batch']['img'])
    with torch.no_grad():
        _, logs = loop.imvoxelnet_loss(det, b)
    assert float(kitti['logs']['num_pos']) > 0
    np.testing.assert_allclose(float(logs[term]), float(kitti['logs'][term]),
                               rtol=1e-4)


def test_kitti_conversion_round_trip(kitti):
    round_trip(kitti['tcfg'], kitti['variables'])


# --- ImVoxelNetIndoor -------------------------------------------------------

def quantized(preds, xp=torch):
    """Head levels whose logits are rounded to 5 values (their eighths,
    clipped to +-2): the scores tie in large groups."""
    def q(x):
        return xp.clip(xp.round(x / 8), -2, 2)
    return [dict(p, cls=q(p['cls']), center=q(p['center'])) for p in preds]


@pytest.fixture(scope='module')
def indoor():
    jcfg = jm.ImVoxelNetIndoorConfig.tiny()
    tcfg = tm.ImVoxelNetIndoorConfig.tiny()
    B = 2
    rng = np.random.RandomState(0)
    img = rng.rand(B, 96, 128, 3).astype(np.float32)
    d2i = depth2img(B)
    gt = np.zeros((B, 4, 7), np.float32)
    gt[:, 0] = [0.5, 2.0, -1.0, 0.8, 0.9, 0.8, 0.3]
    gt[1, 1] = [-0.6, 3.5, -0.5, 1.2, 0.6, 1.0, -0.7]
    labels = np.full((B, 4), -1, np.int64)
    labels[:, 0] = 1
    labels[1, 1] = 3
    batch = dict(img=img, lidar2img=d2i, gt_boxes=gt, gt_labels=labels,
                 gt_valid=labels >= 0)
    model = jm.ImVoxelNetIndoor(jcfg)
    variables = init_variables(model, img, d2i)
    head = jcfg.head

    def loss_fn(params, batch_stats, b):
        (preds, valids), mut = model.apply(
            {'params': params, 'batch_stats': batch_stats}, b['img'],
            b['lidar2img'], train=True, mutable=['batch_stats'])
        total, logs = jih.loss(head, preds, valids, b['gt_boxes'],
                               b['gt_labels'], b['gt_valid'])
        return total, (logs, preds, valids, mut)

    @jax.jit
    def reference(v, b):
        preds, valids = model.apply(v, b['img'], b['lidar2img'],
                                    train=False)
        (_, (logs, tpreds, tvalids, mut)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(v['params'], v['batch_stats'], b)
        shapes = [p['center'].shape[1:4] for p in tpreds]
        pts = jih.level_points(head, shapes)
        points = jnp.concatenate(pts)
        level_ids = jnp.concatenate([jnp.full((p.shape[0],), i, jnp.int32)
                                     for i, p in enumerate(pts)])
        flat_valid = jih._flatten_valid(tvalids)
        targets = jax.vmap(lambda va, gb, gl, ov: jfc.get_targets(
            jih._assign_cfg(head), points, va, level_ids, gb, gl, ov))(
            flat_valid, b['gt_boxes'], b['gt_labels'], b['gt_valid'])
        # one decode of the scenes as they are and of their quantized
        # copies, stacked on the batch axis (one trace and compile)
        both = jih.decode(head, [
            {k: jnp.concatenate([p[k], q[k]]) for k in p}
            for p, q in zip(preds, quantized(preds, jnp))],
            [jnp.concatenate([v, v]) for v in valids])
        n = b['img'].shape[0]
        return dict(preds=preds, valids=valids, logs=logs, mut=mut,
                    grads=grads, targets=targets, tvalids=tvalids,
                    decode={k: v[:n] for k, v in both.items()},
                    decode_ties={k: v[n:] for k, v in both.items()})

    ref = reference(variables, batch)
    return dict(tcfg=tcfg, batch=batch, variables=variables, ref=ref,
                sd=convert.from_jax_variables(variables, tcfg))


def port_indoor(indoor, train=False):
    det = apis.init_imvoxelnet_detector(indoor['tcfg'], indoor['sd'],
                                        device='cpu').model
    return det.train() if train else det.eval()


def port_batch(indoor):
    b = {k: t(v) for k, v in indoor['batch'].items()}
    b['img'] = nchw(indoor['batch']['img'])
    return b


@pytest.fixture(scope='module')
def indoor_train(indoor):
    det = port_indoor(indoor, train=True)
    b = port_batch(indoor)
    preds, valids = det(b['img'], b['lidar2img'])
    total, logs = tih.loss(indoor['tcfg'].head, preds, valids,
                           b['gt_boxes'], b['gt_labels'], b['gt_valid'])
    total.backward()
    return dict(det=det, valids=valids, logs=logs)


def test_indoor_forward_and_valids_match_gga_tpu(indoor):
    det = port_indoor(indoor)
    b = port_batch(indoor)
    with torch.no_grad():
        preds, valids = det(b['img'], b['lidar2img'])
    ref = indoor['ref']
    assert len(preds) == len(valids) == 3
    for lvl in range(3):
        close(valids[lvl], ref['valids'][lvl])
        for key in ('center', 'bbox', 'cls'):
            close(preds[lvl][key], ref['preds'][lvl][key], 1e-5,
                  f'{lvl} {key}')
    assert 0.3 < float(valids[0].float().mean()) < 0.95


def test_indoor_targets_match_gga_tpu(indoor, indoor_train):
    cfg = indoor['tcfg'].head
    b = port_batch(indoor)
    valids = indoor_train['valids']
    shapes = [tuple(v.shape[1:]) for v in valids]
    pts = tih.level_points(cfg, shapes)
    level_ids = torch.cat([torch.full((p.shape[0],), i)
                           for i, p in enumerate(pts)])
    valid = tih._flatten_valid(valids)
    got = tfc.get_targets(tih._assign_cfg(cfg),
                          torch.cat(pts).expand(2, -1, -1), valid, level_ids,
                          b['gt_boxes'], b['gt_labels'], b['gt_valid'])
    center_t, bbox_t, cls_t, pos = indoor['ref']['targets']
    close(cls_t, got[2].numpy())
    close(got[3], pos)
    assert int(pos.sum()) > 0
    close(got[0], center_t, 1e-5)
    close(got[1], bbox_t, 1e-5)


@pytest.mark.parametrize('term', INDOOR_TERMS)
def test_indoor_loss_terms_match_gga_tpu(indoor, indoor_train, term):
    assert float(indoor['ref']['logs']['num_pos']) > 0
    np.testing.assert_allclose(float(indoor_train['logs'][term].detach()),
                               float(indoor['ref']['logs'][term]), rtol=1e-4)


def test_indoor_gradients_and_bn_updates_match_gga_tpu(indoor, indoor_train):
    det, tcfg = indoor_train['det'], indoor['tcfg']
    ref = convert.from_jax_variables(
        {'params': jax.tree_util.tree_map(np.asarray,
                                          indoor['ref']['grads'])}, tcfg)
    grads = {k: p.grad for k, p in det.named_parameters()}
    # the FPN's levels 1-3 feed nothing: the lift samples level 0
    unused = {k for k, g in grads.items() if g is None}
    assert unused and all(k.startswith('neck.') for k in unused)
    assert set(grads) == set(ref)
    largest = max(float(r.abs().max()) for r in ref.values())
    for k, g in grads.items():
        r = ref[k]
        if g is None:
            assert float(r.abs().max()) == 0.0, k
            continue
        assert float((g - r).abs().max()) <= 1e-4 * largest, k
        if float(r.abs().max()) == 0.0:
            # a level no positive lands on: its scale takes no gradient
            continue
        assert float(torch.nn.functional.cosine_similarity(
            g.flatten().double(), r.flatten().double(), dim=0)) >= 0.9999, k
    stats = convert.from_jax_variables(
        {'batch_stats': jax.tree_util.tree_map(
            np.asarray, indoor['ref']['mut']['batch_stats'])}, tcfg)
    sd = det.state_dict()
    assert len(stats) >= 40
    for k, r in stats.items():
        close(sd[k], r.numpy(), 1e-4, k)


@pytest.mark.parametrize('ties', [False, True])
def test_indoor_decode_matches_gga_tpu(indoor, ties):
    det = port_indoor(indoor)
    b = port_batch(indoor)
    with torch.no_grad():
        preds, valids = det(b['img'], b['lidar2img'])
    cfg = indoor['tcfg'].head
    if ties:
        preds = quantized(preds)
        scores = (torch.sigmoid(tih._flatten(preds, 'cls', cfg.n_classes))
                  * torch.sigmoid(tih._flatten(preds, 'center', 1))
                  * tih._flatten_valid(valids)[..., None].float())
        # equal scores in large groups, beyond the top nms_pre
        assert len(torch.unique(scores[0, :, 0])) < scores.shape[1] / 20
    out = tih.decode(cfg, preds, valids)
    ref = indoor['ref']['decode_ties' if ties else 'decode']
    close(out['valid'], ref['valid'])
    v = np.asarray(ref['valid'])
    assert v.sum() > 0
    close(out['labels'][t(v)], np.asarray(ref['labels'])[v])
    close(out['scores'][t(v)], np.asarray(ref['scores'])[v], 1e-5)
    # the boxes turn by the raw yaw logit, tens of radians at these drawn
    # weights, which scales its last-bit differences up
    close(out['boxes'][t(v)], np.asarray(ref['boxes'])[v], 1e-4)


def test_decode_top_k_keeps_lower_indices_first():
    """The stable sort's top k of scores with exact ties equals
    ``jax.lax.top_k``'s, index for index."""
    rng = np.random.RandomState(5)
    s = rng.randint(0, 4, (2, 300)).astype(np.float32) / 4
    k = 40
    _, ref = jax.lax.top_k(s, k)
    _, idx = torch.sort(t(s), dim=-1, descending=True, stable=True)
    np.testing.assert_array_equal(idx[:, :k].numpy(), np.asarray(ref))


def test_indoor_conversion_round_trip(indoor):
    round_trip(indoor['tcfg'], indoor['variables'])


def test_infer_imvoxelnet_decodes_both_detectors(kitti, indoor):
    for data, n in ((kitti, 1), (indoor, indoor['tcfg'].head.n_classes)):
        bundle = apis.init_imvoxelnet_detector(data['tcfg'], data['sd'],
                                               device='cpu')
        out = apis.infer_imvoxelnet(bundle, data['batch']['img'],
                                    data['batch']['lidar2img'])
        assert out['boxes'].shape[-1] == 7 and out['boxes'].shape[0] == 2
        assert torch.isfinite(out['boxes']).all()
        assert set(out['labels'][out['valid']].tolist()) <= set(range(n))
