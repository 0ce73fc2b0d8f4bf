"""The port's FCAF3D sparse ops against gga_tpu's, on the CPU.

The same batched coordinate sets (each scene sorted by linear id, padding
last) and features, drawn with numpy, go through gga_tpu's per-scene
functions (``jax.vmap`` under ``jax.jit``) and the port's batched ones:

- the rulebook of a strided conv (``downsample_rulebook_batched``: output
  sites, forward and dense backward maps), the strided query map of
  MinkResNet's 1x1 identity with ``flatten_nmap(n_in=)``, the output
  sites of ``downsample_coords``, exactly, with and without the budget
  cutting sites;
- the rulebook conv forward and both gradients against ``jax.grad``
  within 1e-5 of max|gga_tpu| (f32 sums of up to 27 x 384 products in
  another order; an entry that nearly cancels keeps the sum's error, not
  its own), and no input gradient where the input needs none;
- ``sparse_max_pool``, ``sparse_add``, ``lookup_features`` and
  ``topk_prune`` (with distinct scores and with ties) exactly; the
  generative transpose conv's sites exactly and its features at 1e-6
  (one f32 product summed in another order);
- ``dynamic_scatter_mean``, ``assign_point_voxel_ids``,
  ``dynamic_voxelize`` and ``hard_voxelize`` at one point a voxel
  exactly (the port adds each voxel's points in point order, as
  gga_tpu's scatter does on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gga_tpu.models import layers as jlayers
from gga_tpu.ops import scatter as jscatter
from gga_tpu.ops import sparse as jsp
from gga_tpu.ops import voxelize as jvox
from gga_tpu_torch.kernels import sparse_conv
from gga_tpu_torch.models.layers import flatten_nmap
from gga_tpu_torch.ops import scatter as tscatter
from gga_tpu_torch.ops import sparse as tsp
from gga_tpu_torch.ops import voxelize as tvox

torch.set_num_threads(1)

GRID = (16, 40, 48)
B, N, C = 2, 384, 6


def _scenes(seed=0, grid=GRID, n=N, fill=(0.6, 0.8)):
    """[B, n, 3] int32 coords, each scene's active sites clustered,
    distinct and sorted by linear id, padding rows (-1) last; valid."""
    rng = np.random.RandomState(seed)
    nz, ny, nx = grid
    coords = np.full((B, n, 3), -1, np.int32)
    valid = np.zeros((B, n), bool)
    for b in range(B):
        k = int(n * rng.uniform(*fill))
        centres = rng.uniform([0, 0, 0], grid, (4, 3))
        pts = centres[rng.randint(0, 4, 4 * k)] + rng.randn(4 * k, 3) * [
            2, 5, 5]
        pts = np.clip(np.round(pts), 0, np.asarray(grid) - 1).astype(int)
        lin = np.unique(pts[:, 0] * ny * nx + pts[:, 1] * nx + pts[:, 2])
        lin = np.sort(rng.choice(lin, min(k, len(lin)), replace=False))
        coords[b, :len(lin)] = np.stack(
            [lin // (ny * nx), (lin // nx) % ny, lin % nx], -1)
        valid[b, :len(lin)] = True
    return coords, valid


def _feats(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize('budget', [1024, 200], ids=['fits', 'cut'])
def test_rulebook_maps_equal_gga_tpu(budget):
    coords, valid = _scenes(1)
    ref = jax.jit(lambda c, v: jsp.downsample_rulebook_batched(
        c, v, GRID, (3, 3, 3), (2, 2, 2), (1, 1, 1), budget),
        )(coords, valid)
    out = tsp.downsample_rulebook_batched(_t(coords), _t(valid), GRID, 3, 2,
                                          1, budget)
    assert out[2] == tuple(ref[2])
    if budget == 200:          # the budget cuts sites, farthest first
        assert bool(ref[1].all())
    for i in (0, 1, 3, 4):
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(ref[i]),
                                      err_msg=str(i))


def test_strided_identity_map_equals_gga_tpu():
    """MinkResNet's 1x1 s2 identity: the input row at 2 * site, a map of
    M sites into N input rows, flattened with ``n_in``."""
    coords, valid = _scenes(2)
    oc, ov, og, *_ = tsp.downsample_rulebook_batched(
        _t(coords), _t(valid), GRID, 3, 2, 1, 256)
    feats = _feats(3, (B, N, C))

    def resolve(f, c, v, qc, qv):
        st = jsp.SparseTensor(f, c, v, GRID)
        return jsp._neighbor_pos_hit(st, qc, qv, (1, 1, 1), (2, 2, 2),
                                     (0, 0, 0))

    pos, hit = jax.jit(jax.vmap(resolve))(feats, coords, valid, oc.numpy(),
                                          ov.numpy())
    p_f, h_f = jlayers.flatten_nmap(pos, hit, n_in=N)
    ref = np.where(np.asarray(h_f), np.asarray(p_f), -1)
    out = flatten_nmap(tsp.neighbor_map(_t(coords), _t(valid), GRID, oc, ov,
                                        1, 2, 0), n_in=N)
    assert (ref >= 0).sum() > 20
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize('budget', [1024, 150], ids=['fits', 'cut'])
def test_downsample_coords_equal_gga_tpu(budget):
    coords, valid = _scenes(4)
    feats = _feats(5, (B, N, C))
    ref = jax.jit(jax.vmap(lambda f, c, v: jsp.downsample_coords(
        jsp.SparseTensor(f, c, v, GRID), (2, 2, 2), (2, 2, 2), (0, 0, 0),
        budget)[:2]))(feats, coords, valid)
    out = tsp.downsample_coords(tsp.SparseTensor(_t(feats), _t(coords),
                                                 _t(valid), GRID),
                                2, 2, 0, budget)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize('c,d', [(3, 8), (8, 16)])
def test_rulebook_conv_and_grads_match_jax_grad(c, d):
    coords, valid = _scenes(6)
    M = 512
    oc, ov, og, fwd, bwd = jsp.downsample_rulebook_batched(
        coords, valid, GRID, (3, 3, 3), (2, 2, 2), (1, 1, 1), M)
    f = _feats(7, (B * N, c)) * valid.reshape(-1, 1)
    w = _feats(8, (27, c, d)) * 0.3
    g = _feats(9, (B * M, d))
    ovf = np.asarray(ov).reshape(-1)

    def loss(f_, w_):
        out = jsp.rulebook_conv(f_, w_, fwd, bwd, ovf)
        return (out * g).sum(), out

    (_, jout), (jdf, jdw) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(f, w)
    tf = _t(f).requires_grad_()
    tw = _t(w).requires_grad_()
    out = tsp.RulebookConvFunction.apply(tf, tw, _t(np.asarray(fwd)),
                                         _t(np.asarray(bwd)), _t(ovf))
    (out * _t(g)).sum().backward()
    for got, ref in ((out.detach(), jout), (tf.grad, jdf), (tw.grad, jdw)):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 1
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_rulebook_conv_skips_the_input_gradient(monkeypatch):
    """conv1's input (the voxel colours) needs no gradient: the backward
    runs the weight gradient only."""
    coords, valid = _scenes(10)
    _, ov, _, fwd, bwd = tsp.downsample_rulebook_batched(
        _t(coords), _t(valid), GRID, 3, 2, 1, 256)
    calls = []
    real = sparse_conv.gather_gemm_conv
    monkeypatch.setattr(sparse_conv, 'gather_gemm_conv',
                        lambda *a: calls.append(1) or real(*a))
    w = torch.randn(27, 3, 8, requires_grad=True)
    f = _t(_feats(11, (B * N, 3)))
    out = tsp.RulebookConvFunction.apply(f, w, fwd, bwd, ov.reshape(-1))
    out.sum().backward()
    assert len(calls) == 1 and w.grad is not None
    f.requires_grad_()
    tsp.RulebookConvFunction.apply(f, w, fwd, bwd,
                                   ov.reshape(-1)).sum().backward()
    assert len(calls) == 3 and f.grad is not None


def test_max_pool_equals_gga_tpu():
    coords, valid = _scenes(12)
    feats = _feats(13, (B, N, C)) * valid[..., None]
    ref = jax.jit(jax.vmap(lambda f, c, v: jsp.sparse_max_pool(
        jsp.SparseTensor(f, c, v, GRID), out_budget=300)))(feats, coords,
                                                           valid)
    out = tsp.sparse_max_pool(tsp.SparseTensor(_t(feats), _t(coords),
                                               _t(valid), GRID),
                              out_budget=300)
    assert out.grid == ref.grid
    for a, r in ((out.features, ref.features), (out.coords, ref.coords),
                 (out.valid, ref.valid)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


@pytest.mark.parametrize('budget', [None, 2000, 4096],
                         ids=['8N', 'cut', 'padded'])
def test_transpose_conv_matches_gga_tpu(budget):
    grid = (8, 20, 24)
    coords, valid = _scenes(14, grid, n=320)
    feats = _feats(15, (B, 320, 5)) * valid[..., None]
    w = _feats(16, (8, 5, 7))
    ref = jax.jit(jax.vmap(lambda f, c, v: jsp.generative_transpose_conv(
        jsp.SparseTensor(f, c, v, grid), w, out_budget=budget)))(
            feats, coords, valid)
    out = tsp.generative_transpose_conv(
        tsp.SparseTensor(_t(feats), _t(coords), _t(valid), grid), _t(w),
        out_budget=budget)
    assert out.grid == ref.grid
    np.testing.assert_array_equal(out.coords.numpy(), np.asarray(ref.coords))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(out.features.numpy(),
                               np.asarray(ref.features), rtol=1e-6,
                               atol=1e-6)


def _add_and_prune_inputs():
    """Two coordinate sets on one grid that share sites, and a score per
    site of their union."""
    grid = (8, 20, 24)
    a_c, a_v = _scenes(17, grid, n=200)
    b_c, b_v = _scenes(18, grid, n=200)
    b_c[:, :60], b_v[:, :60] = a_c[:, 40:100], a_v[:, 40:100]  # shared
    nz, ny, nx = grid
    for b in range(B):       # keep each scene sorted
        lin = np.where(b_v[b], b_c[b, :, 0] * ny * nx + b_c[b, :, 1] * nx
                       + b_c[b, :, 2], 1 << 30)
        lin = np.unique(lin)
        lin = lin[lin < (1 << 30)]
        b_c[b] = -1
        b_v[b] = False
        b_c[b, :len(lin)] = np.stack(
            [lin // (ny * nx), (lin // nx) % ny, lin % nx], -1)
        b_v[b, :len(lin)] = True
    a_f = _feats(19, (B, 200, 4)) * a_v[..., None]
    b_f = _feats(20, (B, 200, 4)) * b_v[..., None]
    return grid, (a_f, a_c, a_v), (b_f, b_c, b_v)


def test_sparse_add_lookup_and_prune_equal_gga_tpu():
    grid, a, b = _add_and_prune_inputs()
    budget = 200

    def jadd(af, ac, av, bf, bc, bv):
        return jsp.sparse_add(jsp.SparseTensor(af, ac, av, grid),
                              jsp.SparseTensor(bf, bc, bv, grid), budget)

    ref = jax.jit(jax.vmap(jadd))(*a, *b)
    out = tsp.sparse_add(tsp.SparseTensor(*map(_t, a), grid),
                         tsp.SparseTensor(*map(_t, b), grid), budget)
    assert bool(np.asarray(ref.valid).all(-1).any())   # a cut scene
    for x, r in ((out.features, ref.features), (out.coords, ref.coords),
                 (out.valid, ref.valid)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(r))

    # parent lookups on the coarser grid, as the head's prune scores
    half = tuple(d // 2 for d in grid)
    parents = np.floor_divide(np.asarray(ref.coords), 2)
    pf, pc, pv = (np.asarray(x) for x in (ref.features, ref.coords,
                                          ref.valid))
    coarse = tsp.downsample_coords(tsp.SparseTensor(*map(_t, (pf, pc, pv)),
                                                    grid), 2, 2, 0, 256)
    cf = _feats(21, (B, 256, 1)) * coarse[1].numpy()[..., None]
    jl = jax.jit(jax.vmap(lambda f, c, v, q, qv: jsp.lookup_features(
        jsp.SparseTensor(f, c, v, half), q, qv)))(
            cf, coarse[0].numpy(), coarse[1].numpy(), parents, pv)
    tl = tsp.lookup_features(tsp.SparseTensor(_t(cf), coarse[0], coarse[1],
                                              half), _t(parents), _t(pv))
    assert (np.asarray(jl) != 0).sum() > 100
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize('ties', [False, True], ids=['distinct', 'ties'])
def test_topk_prune_equals_gga_tpu(ties):
    grid, a, _ = _add_and_prune_inputs()
    f, c, v = a
    rng = np.random.RandomState(22)
    if ties:      # the 8 children of a parent share its score
        par = c // 2
        s = np.sin(par[..., 0] * 7.1 + par[..., 1] * 3.3 + par[..., 2] * 1.7)
    else:
        s = rng.permutation(B * 200).reshape(B, 200) / 7.0
    s = s.astype(np.float32)
    ref = jax.jit(jax.vmap(lambda f_, c_, v_, s_: jsp.topk_prune(
        jsp.SparseTensor(f_, c_, v_, grid), s_, 64)))(f, c, v, s)
    out = tsp.topk_prune(tsp.SparseTensor(_t(f), _t(c), _t(v), grid), _t(s),
                         64)
    for x, r in ((out.features, ref.features), (out.coords, ref.coords),
                 (out.valid, ref.valid)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(r))


VS, PC_RANGE = (0.08, 0.08, 0.08), (-5.12, -5.12, -2.56, 5.12, 5.12, 2.56)


def _clouds(seed=23, P=700):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-5.5, 5.5, (B, P, 2)),
                          rng.uniform(-2.8, 2.8, (B, P, 1))], -1)
    pts[:, :200] = pts[:, :200] * 0.1          # dense: many points a voxel
    valid = rng.rand(B, P) < 0.9
    return pts.astype(np.float32), valid, rng.rand(B, P, 3).astype(
        np.float32)


def test_voxelize_and_scatter_mean_equal_gga_tpu():
    """The FCAF3D detector's voxelization: one voxel per cell, the mean
    colour of its points."""
    pts, valid, cols = _clouds()
    V = 512
    grid = (64, 128, 128)

    def jvoxel(p, v, col):
        out = jvox.hard_voxelize(p, v, voxel_size=VS, pc_range=PC_RANGE,
                                 max_points=1, max_voxels=V)
        pc, ok = jvox.dynamic_voxelize(p, v, voxel_size=VS,
                                       pc_range=PC_RANGE)
        ids = jscatter.assign_point_voxel_ids(pc, out['coords'], ok,
                                              out['coords'][:, 0] >= 0,
                                              grid)
        mean, cnt = jscatter.dynamic_scatter_mean(col, ids, ok, V)
        return out, pc, ok, ids, mean, cnt

    jout, jpc, jok, jids, jmean, jcnt = jax.jit(jax.vmap(jvoxel))(
        pts, valid, cols)
    tp, tv, tc = _t(pts), _t(valid), _t(cols)
    out = tvox.hard_voxelize(tp, tv, voxel_size=VS, pc_range=PC_RANGE,
                             max_points=1, max_voxels=V)
    pc, ok = tvox.dynamic_voxelize(tp, tv, voxel_size=VS, pc_range=PC_RANGE)
    ids = tscatter.assign_point_voxel_ids(pc, out['coords'], ok,
                                          out['coords'][..., 0] >= 0, grid)
    mean, cnt = tscatter.dynamic_scatter_mean(tc, ids, ok, V)
    assert int(jout['num_voxels'].min()) == V        # the budget cuts
    for k in jout:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jpc))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert int(cnt.max()) > 1
    np.testing.assert_array_equal(mean.numpy(), np.asarray(jmean))
