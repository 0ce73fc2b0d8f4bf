"""The port's PointNet++ point ops, aligned 3D NMS and set abstraction /
feature propagation layers against gga_tpu's, on seeded numpy inputs,
CPU:

- ``furthest_point_sample`` indices exactly, on clouds far from the
  origin, with invalid points, a scene with fewer valid points than
  samples and a scene with none;
- ``ball_query`` indices and counts and the ``query_and_group`` mask
  exactly (the grouped features at 1e-6), with invalid supports and
  queries that hit nothing;
- ``aligned_3d_nms``'s keep mask exactly on tie-free scores, with
  overlapping boxes of one class and of two, and invalid entries;
- ``PointSAModule`` (sampling its centres, or given them) and
  ``PointFPModule`` in train mode (batch statistics) at 1e-5 of the
  largest entry, and their BN statistics' updates at 1e-5.

gga_tpu's functions are jitted once per case (vmapped over the batch).
"""
import jax
import numpy as np
import pytest
import torch

from gga_tpu.core import nms as jnms
from gga_tpu.models.backbones import pointnet2 as jpn2
from gga_tpu.ops import points as jpoints
from gga_tpu_torch.core import nms as tnms
from gga_tpu_torch.models.backbones import pointnet2 as tpn2
from gga_tpu_torch.ops import points as tpoints

torch.set_num_threads(1)


def _cloud(kind, seed=0, B=3, P=1500):
    """Points [B, P, 3] of a room-sized scene offset from the origin (so
    the expanded distances lose digits), and their valid mask."""
    rng = np.random.RandomState(seed)
    pts = (rng.uniform([-4, -3, -1], [4, 3, 2], (B, P, 3))
           + [6.0, -2.0, 0.5]).astype(np.float32)
    valid = np.ones((B, P), bool)
    if kind == 'invalid':
        valid = rng.rand(B, P) < 0.7
        valid[1, :] = False
        valid[1, 500:520] = True          # 20 valid points, 64 samples
        valid[-1, :] = False              # none valid
    return pts, valid


@pytest.mark.parametrize('kind', ['all', 'invalid'])
@pytest.mark.parametrize('num', [64, 512])
def test_furthest_point_sample_equals_gga_tpu(kind, num):
    pts, valid = _cloud(kind)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda p, v: jpoints.furthest_point_sample(p, v, num)))(pts, valid))
    got = tpoints.furthest_point_sample(torch.from_numpy(pts),
                                        torch.from_numpy(valid), num)
    np.testing.assert_array_equal(got.numpy(), ref)
    if kind == 'invalid':
        # the scene of 20 valid points repeats them; the empty one
        # starts at 0
        assert set(ref[1]) <= set(np.flatnonzero(valid[1]))
        assert ref[-1, 0] == 0


@pytest.mark.parametrize('kind', ['all', 'invalid'])
@pytest.mark.parametrize('radius,num', [(0.2, 64), (0.4, 32), (1.2, 16)])
def test_ball_query_and_grouping_equal_gga_tpu(kind, radius, num,
                                               monkeypatch):
    pts, valid = _cloud(kind, seed=1)
    rng = np.random.RandomState(2)
    # a dense cluster, so that balls fill
    pts[:, :500] = pts[:, :1] + rng.uniform(-0.15, 0.15, (3, 500, 3))
    centers = pts[:, ::7][:, :200].copy()
    centers[:, :20] += 40.0                   # queries that hit nothing
    feats = rng.randn(*pts.shape[:2], 5).astype(np.float32)
    ref_i, ref_c = map(np.asarray, jax.jit(jax.vmap(
        lambda q, p, v: jpoints.ball_query(q, p, radius, num,
                                           s_valid=v)))(centers, pts, valid))
    ref_g, ref_m = map(np.asarray, jax.jit(jax.vmap(
        lambda p, f, q, v: jpoints.query_and_group(
            p, f, q, radius, num, p_valid=v)))(pts, feats, centers, valid))
    # two scenes a pass, so the batch is cut into passes
    monkeypatch.setattr(tpoints, 'BALL_QUERY_ELEMENTS', 2 * 200 * 1500)
    t = [torch.from_numpy(a) for a in (pts, feats, centers, valid)]
    idx, cnt = tpoints.ball_query(t[2], t[0], radius, num, s_valid=t[3])
    grouped, mask = tpoints.query_and_group(t[0], t[1], t[2], radius, num,
                                            p_valid=t[3])
    np.testing.assert_array_equal(idx.numpy(), ref_i)
    np.testing.assert_array_equal(cnt.numpy(), ref_c)
    np.testing.assert_array_equal(mask.numpy(), ref_m)
    np.testing.assert_allclose(grouped.numpy(), ref_g, rtol=1e-6, atol=1e-6)
    assert (ref_c[:, :20] == 0).all() and (ref_i[:, :20] == 0).all()
    assert (ref_c[:1] == num).any() and ((ref_c[:1] > 0)
                                         & (ref_c[:1] < num)).any()


def test_aligned_3d_nms_equals_gga_tpu():
    rng = np.random.RandomState(3)
    B, N = 3, 120
    lo = rng.uniform(-3, 3, (B, N, 3))
    # clusters of overlapping boxes around a few centres
    lo[:, ::2] = lo[:, 1::2] + rng.uniform(-0.3, 0.3, (B, N // 2, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.3, 1.5, (B, N, 3))],
                           -1).astype(np.float32)
    scores = rng.permutation(B * N).reshape(B, N).astype(np.float32) / (
        B * N)
    classes = rng.randint(0, 2, (B, N))
    valid = rng.rand(B, N) < 0.9
    ref = np.asarray(jax.jit(jax.vmap(
        lambda b, s, c, v: jnms.aligned_3d_nms(b, s, c, 0.25, valid=v)))(
            boxes, scores, classes, valid))
    got = tnms.aligned_3d_nms(torch.from_numpy(boxes),
                              torch.from_numpy(scores),
                              torch.from_numpy(classes), 0.25,
                              valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < valid.sum()


def _fill(tree, rng):
    if hasattr(tree, 'items'):
        return {k: _fill(v, rng) for k, v in tree.items()}
    return np.asarray(rng.uniform(-0.5, 0.5, tree.shape) + (
        1.0 if len(tree.shape) == 1 else 0.0), np.float32)


def _load_mlp(module, params, stats):
    """gga_tpu SharedMLP trees (fc{k}, bn{k}) -> the port's SharedMLP."""
    sd = {}
    for k, name in enumerate(module.names):
        w = torch.from_numpy(np.asarray(params[f'fc{k}']['kernel']).T.copy())
        layer = getattr(module, name)
        sd[f'{name}.conv.weight'] = w.reshape(layer.conv.weight.shape)
        sd[f'{name}.bn.weight'] = torch.from_numpy(params[f'bn{k}']['scale'])
        sd[f'{name}.bn.bias'] = torch.from_numpy(params[f'bn{k}']['bias'])
        sd[f'{name}.bn.running_mean'] = torch.from_numpy(
            stats[f'bn{k}']['mean'])
        sd[f'{name}.bn.running_var'] = torch.from_numpy(stats[f'bn{k}']['var'])
    module.load_state_dict(sd)


def _stats(module):
    return {k: v.numpy() for k, v in module.state_dict().items()
            if k.endswith(('running_mean', 'running_var'))}


def _flat_stats(tree):
    out = {}
    for k in sorted(tree, key=lambda s: int(s[2:])):
        i = int(k[2:])
        out[f'layer{i}.bn.running_mean'] = np.asarray(tree[k]['mean'])
        out[f'layer{i}.bn.running_var'] = np.asarray(tree[k]['var'])
    return out


def _close(got, ref, err=''):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()),
                               err_msg=err)


@pytest.mark.parametrize('features', [0, 6])
def test_point_sa_module_matches_gga_tpu(features):
    pts, valid = _cloud('invalid', seed=4, B=3, P=1200)
    rng = np.random.RandomState(5)
    feats = (rng.randn(3, 1200, features).astype(np.float32)
             if features else None)
    jm = jpn2.PointSAModule(128, 0.6, 16, (16, 24))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), pts, feats,
                                            valid, False))
    var = {c: _fill(shapes[c], rng) for c in ('params', 'batch_stats')}
    (rx, rf, rv), upd = jax.jit(lambda v, p, f, m: jm.apply(
        v, p, f, m, True, mutable=['batch_stats']))(var, pts, feats, valid)
    tm = tpn2.PointSAModule(128, 0.6, 16, features, (16, 24))
    _load_mlp(tm.mlps[0], var['params']['SharedMLP_0'],
              var['batch_stats']['SharedMLP_0'])
    x, f, v = tm.train()(torch.from_numpy(pts),
                         None if feats is None else torch.from_numpy(feats),
                         torch.from_numpy(valid))
    np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    _close(f.detach().numpy(), np.asarray(rf))
    ref_stats = _flat_stats(upd['batch_stats']['SharedMLP_0'])
    for k, s in _stats(tm.mlps[0]).items():
        _close(s, ref_stats[k], k)


@pytest.mark.parametrize('features', [0, 6])
def test_point_sa_module_given_centres_matches_gga_tpu(features):
    """``target_xyz`` / ``target_valid`` (H3DNet's matchers): the given
    centres grouped as they are, some invalid and some parked 1e4 m away
    (no member), as gga_tpu's ``pointnet2.py:44-56``; no indices kept."""
    pts, valid = _cloud('invalid', seed=8, B=3, P=1200)
    rng = np.random.RandomState(9)
    feats = (rng.randn(3, 1200, features).astype(np.float32)
             if features else None)
    centres = pts[:, rng.randint(0, 1200, 96)] + rng.normal(
        0, 0.2, (3, 96, 3)).astype(np.float32)
    centres[:, ::7] = 1e4
    cvalid = rng.rand(3, 96) < 0.8
    jm = jpn2.PointSAModule(96, 0.5, 8, (16, 24))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), pts, feats,
                                            valid, False))
    var = {c: _fill(shapes[c], rng) for c in ('params', 'batch_stats')}
    (rx, rf, rv), upd = jax.jit(lambda v, p, f, m, c, cv: jm.apply(
        v, p, f, m, True, target_xyz=c, target_valid=cv,
        mutable=['batch_stats']))(var, pts, feats, valid, centres, cvalid)
    tm = tpn2.PointSAModule(96, 0.5, 8, features, (16, 24))
    _load_mlp(tm.mlps[0], var['params']['SharedMLP_0'],
              var['batch_stats']['SharedMLP_0'])
    x, f, v = tm.train()(torch.from_numpy(pts),
                         None if feats is None else torch.from_numpy(feats),
                         torch.from_numpy(valid),
                         target_xyz=torch.from_numpy(centres),
                         target_valid=torch.from_numpy(cvalid))
    assert tm.last_idx is None
    np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    _close(f.detach().numpy(), np.asarray(rf))
    assert not np.asarray(rf)[:, ::7].any() and np.asarray(rf).any()
    ref_stats = _flat_stats(upd['batch_stats']['SharedMLP_0'])
    for k, s in _stats(tm.mlps[0]).items():
        _close(s, ref_stats[k], k)


def test_point_fp_module_matches_gga_tpu():
    rng = np.random.RandomState(6)
    tgt, tv = _cloud('all', seed=7, B=2, P=600)
    src, sv = tgt[:, :150], rng.rand(2, 150) < 0.8
    tv = rng.rand(2, 600) < 0.9
    tf = rng.randn(2, 600, 8).astype(np.float32)
    sf = rng.randn(2, 150, 12).astype(np.float32)
    jm = jpn2.PointFPModule((16, 16))
    args = (tgt, tf, src, sf, sv, tv)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args,
                                            False))
    var = {c: _fill(shapes[c], rng) for c in ('params', 'batch_stats')}
    ref, upd = jax.jit(lambda v, *a: jm.apply(
        v, *a, True, mutable=['batch_stats']))(var, *args)
    tm = tpn2.PointFPModule(20, (16, 16))
    _load_mlp(tm.mlps, var['params']['SharedMLP_0'],
              var['batch_stats']['SharedMLP_0'])
    got = tm.train()(*map(torch.from_numpy, args))
    _close(got.detach().numpy(), np.asarray(ref))
    ref_stats = _flat_stats(upd['batch_stats']['SharedMLP_0'])
    for k, s in _stats(tm.mlps).items():
        _close(s, ref_stats[k], k)
