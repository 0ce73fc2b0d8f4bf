"""The port's PartA2 against gga_tpu's, tiny config, f32, CPU.

gga_tpu's variables (shapes from its init, values drawn with numpy, BN
statistics included) reach the port through
``convert.from_jax_variables``. On the same two scenes (ground, clutter
and points on a car, a pedestrian and a cyclist):

- ``SparseUNet`` alone (gga_tpu's module, the tiny config's widths), in
  train mode: the BEV map and the voxel features within rtol 1e-4 + atol
  1e-4, and the gradient of a random projection of both with respect to
  every parameter at cosine >= 0.9999 and within 1e-4 of its largest
  entry (every sparse conv's weight gradient is a gather-GEMM summed in
  another order);
- the detector in eval mode: the test proposals (labels and validity
  exactly, boxes and scores within 1e-4), the RCNN outputs within 1e-4,
  and
  ``decode_parta2``: the same kept boxes, labels exactly, boxes and scores
  within 1e-4;
- the conversion round trip exactly: every tensor of gga_tpu's tree has
  one rule, and the port's state_dict maps back to the same bits.

The train mode is held in ``tests/test_torch_parta2_train.py``. The entry
points run on the CPU when asked, and raise without a card otherwise.
gga_tpu's forwards are jitted once each.
"""
import jax
import numpy as np
import pytest
import torch

from gga_tpu.models import middle_encoders as jme
from gga_tpu.models.detectors import parta2 as jp2
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models import middle_encoders as tme
from gga_tpu_torch.models.detectors import parta2 as tp2
from gga_tpu_torch.ops.voxelize import hard_voxelize

from .test_data.fixtures import make_scene
from .test_torch_detector import _fill

torch.set_num_threads(1)

B, P, M = 2, 4000, 4
# a car, a pedestrian and a cyclist a scene; the fourth slot is padding
BOXES = np.array([[14.0, 3.0, -1.7, 3.9, 1.6, 1.55, 0.3],
                  [21.0, -4.0, -1.7, 0.8, 0.6, 1.75, -0.2],
                  [26.0, 7.0, -1.7, 1.76, 0.6, 1.73, 1.0]], np.float32)
LABELS = np.array([2, 0, 1])


def scenes(seed=0):
    """(batch dict of numpy arrays, B scenes of P points and M GT slots)."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((B, P, 4), np.float32)
    gt = np.zeros((B, M, 7), np.float32)
    labels = np.zeros((B, M), np.int64)
    gvalid = np.zeros((B, M), bool)
    for b in range(B):
        boxes = BOXES.copy()
        boxes[:, 1] += 2.0 * b
        cloud = make_scene(rng, boxes, ['Car', 'Pedestrian', 'Cyclist'],
                           n_ground=2700, n_clutter=400, pts_per_box=300)
        rng.shuffle(cloud)
        pts[b] = cloud[:P, :4]
        gt[b, :3], labels[b, :3], gvalid[b, :3] = boxes, LABELS, True
    return dict(points=pts, points_valid=np.ones((B, P), bool),
                gt_boxes=gt, gt_labels=labels, gt_valid=gvalid)


def jax_variables(model, batch, seed=0):
    """gga_tpu's variables with numpy values, the RPN's box deltas zero:
    its proposals are then anchors exactly (with the yaw of the direction
    map), where the drawn deltas would scale anchors by up to e^5 through
    ``exp`` and carry the maps' rounding (1e-5) into the RoIs, whose
    voxels' cells (``floor`` at the cell faces) would then differ between
    the packages."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), batch['points'], batch['points_valid'],
        train=False))
    v = _fill({c: shapes[c] for c in ('params', 'batch_stats')},
              np.random.RandomState(seed))
    reg = v['params']['Anchor3DHead_0']['conv_reg']
    reg['kernel'][:] = 0.0
    reg['bias'][:] = 0.0
    return v


def sampler_draw(rng, n_props):
    """gga_tpu's per-scene uniform draw of ``assign_and_sample``."""
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n_props,)))(
        jax.random.split(rng, B)))


def from_torch_layout(tr, x):
    """Inverse of ``convert._to_torch_layout``."""
    if tr.startswith('sparse3d'):
        _, i_ch, o_ch = tr.split(':')
        return x.transpose(1, 2, 3, 4, 0).reshape(-1, int(i_ch), int(o_ch))
    if tr == 'conv2d':
        return x.transpose(2, 3, 1, 0)
    if tr == 'deconv2d':
        return x.transpose(2, 3, 0, 1)[::-1, ::-1]
    if tr == 'conv3d':
        return x.transpose(2, 3, 4, 1, 0)
    if tr == 'linear':
        return x.T
    return x


def to_jax_tree(rules, tensors):
    """Port-layout tensors (by state_dict key) -> gga_tpu's trees."""
    out = {'params': {}, 'batch_stats': {}}
    for tk, coll, fp, tr in rules:
        node = out[coll]
        *scopes, leaf = fp.split('/')
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = np.array(from_torch_layout(
            tr, tensors[tk].detach().numpy()), order='C')
    return out


def cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


# --- SparseUNet alone ------------------------------------------------------
@pytest.fixture(scope='module')
def unet():
    c = jp2.PartA2Config.tiny()
    kw = dict(sparse_shape=tuple(c.sparse_shape),
              base_channels=c.unet_channels[0][0],
              output_channels=c.unet_out_channels,
              encoder_channels=tuple(c.unet_channels),
              decoder_channels=tuple(c.unet_decoder_channels),
              stage_budgets=tuple(c.unet_budgets),
              out_budget=c.unet_out_budget)
    batch = scenes(1)
    vox = hard_voxelize(torch.from_numpy(batch['points']),
                        torch.from_numpy(batch['points_valid']),
                        voxel_size=c.voxel_size, pc_range=c.point_cloud_range,
                        max_points=c.max_points_per_voxel,
                        max_voxels=c.max_voxels)
    feats = (vox['voxels'].sum(-2) / vox['num_points'].clamp(min=1)[..., None]
             ).numpy()
    coords = vox['coords'].numpy()
    valid = (np.arange(c.max_voxels)[None]
             < vox['num_voxels'].numpy()[:, None])
    jmod = jme.SparseUNet(in_channels=4, **kw)
    jin = tuple(map(jax.numpy.asarray, (feats, coords, valid)))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jin,
                                              False))
    variables = _fill(dict(shapes), np.random.RandomState(2))
    rng = np.random.RandomState(3)
    bev_shape = jax.eval_shape(lambda: jmod.apply(variables, *jin,
                                                  False))[0].shape
    proj_bev = rng.randn(*bev_shape).astype(np.float32)
    proj_seg = rng.randn(B, c.max_voxels, 4).astype(np.float32)

    def objective(params):
        (bev, seg), upd = jmod.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            *jin, True, mutable=['batch_stats'])
        return (bev * proj_bev).sum() + (seg * proj_seg).sum(), (bev, seg,
                                                                 upd)

    (_, (bev, seg, upd)), grads = jax.jit(jax.value_and_grad(
        objective, has_aux=True))(variables['params'])
    rules = [(tk[len('m.'):], coll, fp[len('SparseUNet_0/'):], tr)
             for tk, coll, fp, tr in convert._sparse_unet_rules(c, 'm')]
    flat = {}
    for tk, coll, fp, tr in rules:
        node = variables[coll]
        for s in fp.split('/'):
            node = node[s]
        flat[tk] = torch.from_numpy(np.ascontiguousarray(
            convert._to_torch_layout(tr, node)))
    tmod = tme.SparseUNet(in_channels=4, **kw)
    tmod.load_state_dict(flat)
    tmod.train()
    tbev, tseg = tmod(torch.from_numpy(feats), torch.from_numpy(coords),
                      torch.from_numpy(valid))
    ((tbev * torch.from_numpy(proj_bev).permute(0, 3, 1, 2)).sum()
     + (tseg * torch.from_numpy(proj_seg)).sum()).backward()
    tgrads = to_jax_tree([r for r in rules if r[1] == 'params'],
                         state_grads(tmod))
    return dict(bev=np.asarray(bev), seg=np.asarray(seg), grads=grads,
                tbev=tbev.detach().permute(0, 2, 3, 1).numpy(),
                tseg=tseg.detach().numpy(), tgrads=tgrads['params'],
                stats=upd['batch_stats'], rules=rules, tmod=tmod,
                valid=valid)


def state_grads(module):
    """The parameters' gradients by state_dict key, the sparse kernels'
    in the state_dict's spconv layout."""
    out = {}
    for name, p in module.named_parameters():
        g = p.grad
        if p.dim() == 3:                            # a sparse kernel
            owner = module.get_submodule(name.rsplit('.', 1)[0])
            g = g.reshape(*owner.kernel_size, owner.in_channels,
                          owner.out_channels).permute(4, 0, 1, 2, 3)
        out[name] = g
    return out


def test_unet_outputs_match_gga_tpu(unet):
    np.testing.assert_allclose(unet['tbev'], unet['bev'], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(unet['tseg'], unet['seg'], rtol=1e-4,
                               atol=1e-4)
    seg = unet['seg'][unet['valid']]
    assert np.abs(seg).max() > 0.1 and (seg == 0).mean() < 0.9
    assert (unet['tseg'][~unet['valid']] == 0).all()


def test_unet_gradients_match_gga_tpu(unet):
    leaves = jax.tree_util.tree_leaves_with_path(unet['grads'])
    assert len(leaves) == 25 * 2 + 18 + 7      # BNs, SubMs, raw kernels
    for path, g in leaves:
        node = unet['tgrads']
        for p in path:
            node = node[p.key]
        g = np.asarray(g)
        name = '/'.join(p.key for p in path)
        assert cosine(node, g) >= 0.9999, name
        np.testing.assert_allclose(node, g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max(), err_msg=name)


def test_unet_bn_statistics_match_gga_tpu(unet):
    stats = to_jax_tree(unet['rules'],
                        unet['tmod'].state_dict())['batch_stats']
    for path, v in jax.tree_util.tree_leaves_with_path(unet['stats']):
        node = stats
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(v), rtol=1e-4, atol=1e-4)


# --- the detector ----------------------------------------------------------
@pytest.fixture(scope='module')
def detector():
    jcfg, tcfg = jp2.PartA2Config.tiny(), tp2.PartA2Config.tiny()
    batch = scenes()
    model = jp2.PartA2Detector(jcfg)
    variables = jax_variables(model, batch)

    @jax.jit
    def eval_fwd(v):
        out = model.apply(v, batch['points'], batch['points_valid'],
                          train=False)
        return out, jp2.decode_parta2(jcfg, out)

    jeval, jdec = eval_fwd(variables)
    sd = convert.from_jax_variables(variables, tcfg)
    net = apis.init_parta2_detector(tcfg, sd, device='cpu').model
    with torch.no_grad():
        teval = net(torch.from_numpy(batch['points']),
                    torch.from_numpy(batch['points_valid']))
        tdec = tp2.decode_parta2(tcfg, teval)
    return dict(jcfg=jcfg, tcfg=tcfg, variables=variables, sd=sd,
                jeval=jeval, jdec=jdec, teval=teval, tdec=tdec)


def close(out, ref, msg, tol=1e-4):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol, err_msg=msg)


def test_eval_forward_and_decode_match_gga_tpu(detector):
    ref, out = detector['jeval'], detector['teval']
    for k in ('roi_valid', 'roi_labels'):
        np.testing.assert_array_equal(out['samples'][k].numpy(),
                                      np.asarray(ref['samples'][k]),
                                      err_msg=k)
    for k in ('rois', 'roi_scores'):
        close(out['samples'][k], ref['samples'][k], f'samples.{k}')
    for k in ('cls', 'reg'):
        close(out['rcnn'][k], ref['rcnn'][k], f'rcnn.{k}')
    ref, out = detector['jdec'], detector['tdec']
    for k in ('labels', 'valid'):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    for k in ('boxes', 'scores'):
        close(out[k], ref[k], k)
    assert out['valid'].sum() > 0


def test_decode_suppresses_as_gga_tpu():
    """decode_parta2 on RoIs in overlapping clusters, scores tie-free:
    the same kept boxes in the same order."""
    jcfg, tcfg = jp2.PartA2Config.tiny(), tp2.PartA2Config.tiny()
    rng = np.random.RandomState(4)
    R = 24
    centres = rng.uniform(5, 60, (B, 4, 2))[:, rng.randint(0, 4, R)]
    rois = np.concatenate([
        centres + rng.normal(0, 0.4, (B, R, 2)), np.full((B, R, 1), -1.7),
        np.broadcast_to([3.9, 1.6, 1.56], (B, R, 3)),
        rng.uniform(-0.3, 0.3, (B, R, 1))], -1).astype(np.float32)
    out = dict(samples=dict(rois=rois, roi_valid=rng.rand(B, R) < 0.9,
                            roi_labels=rng.randint(0, 3, (B, R)).astype(
                                np.int32)),
               rcnn=dict(cls=rng.randn(B, R, 1).astype(np.float32),
                         reg=(rng.randn(B, R, 7) * 0.1).astype(np.float32)))
    ref = jax.jit(lambda o: jp2.decode_parta2(jcfg, o))(out)
    got = tp2.decode_parta2(tcfg, jax.tree_util.tree_map(torch.from_numpy,
                                                         out))
    for k in ('labels', 'valid'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    for k in ('boxes', 'scores'):
        close(got[k], ref[k], k, 1e-5)
    assert 4 <= got['valid'].sum() < B * R / 2


def test_conversion_round_trip(detector):
    tcfg, variables, sd = detector['tcfg'], detector['variables'], detector[
        'sd']
    rules = convert.rules_of(tcfg)
    assert len({r[2] for r in rules}) == len(rules) == len(sd)
    model = tp2.PartA2Detector(tcfg)
    model.load_state_dict(sd)                       # strict: every key, once
    back = to_jax_tree(rules, model.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(variables)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf, err_msg=str(path))


def test_infer_entry_point_runs_on_cpu():
    tcfg = tp2.PartA2Config.tiny()
    batch = scenes(2)
    bundle = apis.init_parta2_detector(tcfg, device='cpu', seed=1)
    out = apis.infer_parta2(bundle, batch['points'], batch['points_valid'])
    assert out['boxes'].shape == (B, tcfg.test_proposals, 7)
    assert torch.isfinite(out['boxes']).all()
    assert out['labels'].dtype == torch.int32


@pytest.mark.parametrize('entry', ['init_parta2_detector',
                                   'init_parta2_trainer'])
def test_cuda_entry_points_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    tcfg = tp2.PartA2Config.tiny()
    args = (tcfg,) if entry == 'init_parta2_detector' else (tcfg, 10)
    with pytest.raises(RuntimeError, match='CUDA'):
        getattr(apis, entry)(*args)
