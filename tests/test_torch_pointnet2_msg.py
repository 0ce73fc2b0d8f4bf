"""The port's multi-scale PointNet++ pieces against gga_tpu's, f32, CPU:

- ``ops/points.py squared_norm`` equals XLA's CPU reduction of
  ``jnp.sum(x ** 2, -1)`` bit for bit at every width (an FMA chain up to
  32 entries; above, XLA's windows of 32 over the zero-padded row, the
  padding split before and after), and ``furthest_point_sample`` over
  [xyz, features] picks gga_tpu's indices at 3DSSD's full widths: D = 67
  (level 1, 512 of 4 096 seeds) and D = 131 (level 2, 256 of the first
  512);
- ``sample_points_multi_mode``: D-FPS, F-FPS, FS and mixed modes, with
  and without sample ranges, at the tiny configs' D = 3 + 16, index for
  index, one scene with invalid points;
- ``PointSAModuleMSG`` in train mode (batch statistics), its relative xyz
  not normalised, sampled and with 'spec' centres (``target_xyz``): every
  output within 1e-5 of its largest entry;
- the PointXYZWHLR coder: the round trip and both directions against
  gga_tpu's within 1e-6;
- ``roipoint_pool3d``: each RoI's points (a feature holds each point's
  index, so the indices compare exactly), the RoI-frame coordinates
  within 1e-6, the empty flags exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gga_tpu.core import coders as jcoders
from gga_tpu.models.backbones import pointnet2 as jp2
from gga_tpu.ops import points as jpoints
from gga_tpu.ops.roipoint_pool import roipoint_pool3d as jpool
from gga_tpu_torch.core import coders as tcoders
from gga_tpu_torch.models.backbones import pointnet2 as tp2
from gga_tpu_torch.ops import points as tpoints
from gga_tpu_torch.ops.roipoint_pool import roipoint_pool3d as tpool
from tests.test_torch_ssd3d import close, fill, t

torch.set_num_threads(1)

MEAN_SIZES = ((3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73))


def cloud(B, N, D, seed):
    """KITTI-range xyz and D - 3 features of assorted scales."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform([0, -40, -3], [70, 40, 1], (B, N, 3))
    feats = rng.randn(B, N, D - 3) * rng.uniform(0.1, 5, D - 3)
    return np.concatenate([xyz, feats], -1).astype(np.float32)


def test_squared_norm_is_xla_sum_at_every_width():
    rng = np.random.RandomState(0)
    f = jax.jit(lambda x: jnp.sum(x ** 2, -1))
    for D in (1, 3, 19, 32, 33, 64, 67, 131, 1100):
        x = (rng.randn(512, D) * rng.uniform(0.1, 30, D)).astype(np.float32)
        np.testing.assert_array_equal(tpoints.squared_norm(t(x)).numpy(),
                                      np.asarray(f(x)), err_msg=f'D={D}')


@pytest.mark.parametrize('D, N, S', [(67, 4096, 512), (131, 512, 256)],
                         ids=['level1', 'level2'])
def test_feature_fps_equals_gga_tpu_at_full_width(D, N, S):
    x = cloud(2, N, D, seed=D)
    valid = np.ones((2, N), bool)
    valid[1, N - N // 8:] = False
    ref = jax.jit(jax.vmap(lambda p, v: jpoints.furthest_point_sample(
        p, v, S)))(x, valid)
    got = tpoints.furthest_point_sample(t(x), t(valid), S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


MODES = {
    'dfps': (('D-FPS',), (-1,), (24,)),
    'ffps': (('F-FPS',), (-1,), (24,)),
    'fs': (('FS',), (-1,), (16,)),
    'ffps+dfps': (('F-FPS', 'D-FPS'), (64, -1), (16, 16)),
    'dfps+fs': (('D-FPS', 'FS'), (100, -1), (8, 12)),
}


@pytest.fixture(scope='module')
def sampled():
    """gga_tpu's picks of every MODES case, in one jit."""
    x = cloud(2, 160, 19, seed=5)
    valid = np.ones((2, 160), bool)
    valid[0, 150:] = False

    def one(m):
        return jax.vmap(lambda p, f, v: jp2.sample_points_multi_mode(
            p, f, v, m[2], m[0], m[1]))

    def all_modes(x, valid):
        return {name: one(m)(x[..., :3], x[..., 3:], valid)
                for name, m in MODES.items()}

    return x, valid, jax.jit(all_modes)(x, valid)


@pytest.mark.parametrize('mode', sorted(MODES))
def test_sample_points_multi_mode_equals_gga_tpu(sampled, mode):
    x, valid, refs = sampled
    mods, ranges, npts = MODES[mode]
    got = tp2.sample_points_multi_mode(t(x[..., :3]), t(x[..., 3:]),
                                       t(valid), npts, mods, ranges)
    np.testing.assert_array_equal(got.numpy(), np.asarray(refs[mode]))


def _msg_state_dict(variables, n_branches):
    """gga_tpu's PointSAModuleMSG variables -> the port module's keys."""
    sd = {}
    for j in range(n_branches):
        mlp = variables['params'][f'mlp{j}']
        stats = variables['batch_stats'][f'mlp{j}']
        for k in range(sum(n.startswith('fc') for n in mlp)):
            p = f'mlps.{j}.layer{k}'
            sd[f'{p}.conv.weight'] = t(mlp[f'fc{k}']['kernel'].T[..., None,
                                                                None])
            sd[f'{p}.bn.weight'] = t(mlp[f'bn{k}']['scale'])
            sd[f'{p}.bn.bias'] = t(mlp[f'bn{k}']['bias'])
            sd[f'{p}.bn.running_mean'] = t(stats[f'bn{k}']['mean'])
            sd[f'{p}.bn.running_var'] = t(stats[f'bn{k}']['var'])
    return sd


@pytest.mark.parametrize('spec', [False, True], ids=['sampled', 'spec'])
def test_msg_module_matches_gga_tpu(spec):
    B, N, C = 2, 300, 8
    x = cloud(B, N, 3 + C, seed=7)
    x[..., :3] *= 0.1                     # balls of 0.8-2.4 m hold points
    valid = np.ones((B, N), bool)
    valid[1, 250:] = False
    radii, samples, mlps = (0.8, 1.6, 2.4), (8, 16, 8), ((8, 16), (8,),
                                                          (16, 16))
    jmod = jp2.PointSAModuleMSG((32,), radii, samples, mlps,
                                fps_mods=('F-FPS',))
    target = (x[:, :20, :3] + 0.3, valid[:, :20]) if spec else (None, None)
    args = (x[..., :3], x[..., 3:], valid)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args,
                                              True, *target))
    variables = {c: fill(shapes[c], np.random.RandomState(3))
                 for c in ('params', 'batch_stats')}
    ref, upd = jax.jit(lambda v, a, tg: jmod.apply(
        v, *a, True, *tg, mutable=['batch_stats']))(variables, args, target)
    tmod = tp2.PointSAModuleMSG(32, radii, samples, C, mlps,
                                fps_mods=('F-FPS',)).train()
    tmod.load_state_dict(_msg_state_dict(variables, len(mlps)))
    got = tmod(t(x[..., :3]), t(x[..., 3:]), t(valid),
               *(None if a is None else t(a) for a in target))
    for r, g, name in zip(ref, got, ('xyz', 'features', 'valid')):
        close(g, r, 1e-5, name)
    assert float(np.abs(np.asarray(ref[1])).max()) > 0
    # the batch statistics the step leaves
    new = _msg_state_dict({'params': variables['params'],
                           'batch_stats': upd['batch_stats']}, len(mlps))
    for k, v in tmod.state_dict().items():
        close(v, new[k].numpy(), 1e-5, k)


def test_point_xyzwhlr_coder_matches_gga_tpu():
    rng = np.random.RandomState(0)
    gt = rng.uniform(0.5, 5, (64, 7)).astype(np.float32)
    gt[:, 6] = rng.uniform(-np.pi, np.pi, 64)
    pts = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    lab = rng.randint(0, 3, 64)
    enc = np.array(jax.jit(lambda *a: jcoders.point_xyzwhlr_encode(
        *a, MEAN_SIZES))(gt, pts, lab))
    got = tcoders.point_xyzwhlr_encode(t(gt), t(pts), t(lab), MEAN_SIZES)
    close(got, enc, 1e-6, 'encode')
    dec = np.asarray(jax.jit(lambda *a: jcoders.point_xyzwhlr_decode(
        *a, MEAN_SIZES))(enc, pts, lab))
    back = tcoders.point_xyzwhlr_decode(t(enc), t(pts), t(lab), MEAN_SIZES)
    close(back, dec, 1e-6, 'decode')
    # the round trip; the guarded atan2 of a zero (cos, sin) gives yaw 0
    close(back, gt, 1e-6, 'round trip')
    enc[:4, 6:] = 0.0
    assert (tcoders.point_xyzwhlr_decode(t(enc), t(pts), t(lab), MEAN_SIZES)[
        :4, 6] == 0).all()


def test_roipoint_pool3d_matches_gga_tpu():
    rng = np.random.RandomState(1)
    B, N, R, S = 2, 600, 12, 40
    xyz = rng.uniform([0, -10, -2], [30, 10, 1], (B, N, 3)).astype(
        np.float32)
    valid = rng.rand(B, N) > 0.1
    rois = np.zeros((B, R, 7), np.float32)
    rois[..., :2] = rng.uniform([2, -8], [28, 8], (B, R, 2))
    rois[..., 2] = -2.0
    rois[..., 3:6] = rng.uniform([1, 1, 1], [8, 5, 3], (B, R, 3))
    rois[..., 6] = rng.uniform(-np.pi, np.pi, (B, R))
    rois[:, -1, :2] = [100.0, 100.0]      # an empty RoI
    # the features: each point's index, then a random channel
    feats = np.concatenate([np.broadcast_to(np.arange(N, dtype=np.float32),
                                            (B, N))[..., None],
                            rng.randn(B, N, 1).astype(np.float32)], -1)
    ref_pooled, ref_empty = jax.jit(jax.vmap(
        lambda x, f, v, r: jpool(x, f, v, r, num_sampled=S)))(
            xyz, feats, valid, rois)
    pooled, empty = tpool(t(xyz), t(feats), t(valid), t(rois), S)
    np.testing.assert_array_equal(empty.numpy(), np.asarray(ref_empty))
    np.testing.assert_array_equal(pooled[..., 3:].numpy(),
                                  np.asarray(ref_pooled)[..., 3:])
    close(pooled[..., :3], ref_pooled[..., :3], 1e-6, 'RoI frame')
    ref_empty = np.asarray(ref_empty)
    assert ref_empty[:, -1].all() and not ref_empty[:, :-1].all()
    # some RoIs hold fewer points than S: their points repeat cyclically
    counts = np.array([[len(set(r[:, 3].tolist())) for r in b]
                       for b in np.asarray(ref_pooled)])
    assert ((counts > 1) & (counts < S)).any()
