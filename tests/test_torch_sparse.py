"""gga_tpu_torch sparse maps and sparse conv against gga_tpu.

Same inputs, made with numpy, go through gga_tpu's functions and the
port's. Maps must agree exactly (hit pattern, and the row where hit).
The conv's plain version must agree with gga_tpu's einsum path, its
Pallas ``_window_conv`` (interpret mode on the CPU) and the strided
rulebook conv at rtol/atol 1e-5: both sum in f32, only the order of the
sum differs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gga_tpu.models import layers as jl
from gga_tpu.ops import sparse as jsp
from gga_tpu_torch.kernels import sparse_conv
from gga_tpu_torch.models import layers as tl
from gga_tpu_torch.ops import sparse as tsp
from gga_tpu_torch.ops.voxelize import hard_voxelize

torch.set_num_threads(1)

GRID = (41, 256, 224)
VS = (0.32, 0.3125, 0.1)
PCR = (0., -40., -3., 71.68, 40., 1.)


def _active_sets(B=2, P=1500, V=1024, seed=0):
    """Sorted (z, y, x) active sets of clustered clouds, some saturating
    the budget: coords [B, V, 3] int32, valid [B, V] bool (numpy)."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([
        rng.uniform(10, 20, (B, P, 1)), rng.uniform(-5, 5, (B, P, 1)),
        rng.uniform(-2.5, -0.5, (B, P, 1)), rng.rand(B, P, 1)],
        -1).astype(np.float32)
    out = hard_voxelize(torch.from_numpy(pts), torch.ones(B, P, dtype=bool),
                        voxel_size=VS, pc_range=PCR, max_voxels=V)
    coords = out['coords'].numpy()
    valid = np.arange(V)[None] < out['num_voxels'].numpy()[:, None]
    return coords, valid


_jax_rulebook = jax.jit(jsp.downsample_rulebook_compact,
                        static_argnums=(2, 3, 4, 5, 6))


@functools.lru_cache(maxsize=None)
def _jax_nmap_fn(grid):
    def one(c, v):
        st = jsp.SparseTensor(jnp.zeros((c.shape[0], 1)), c, v, grid)
        return jsp.build_neighbor_map(st)
    return jax.jit(jax.vmap(one))


def _jax_nmap(coords, valid, grid=GRID):
    """gga_tpu's neighbor maps of a batch, jitted once a grid."""
    return _jax_nmap_fn(tuple(grid))(jnp.asarray(coords), jnp.asarray(valid))


def _port_nmap(coords, valid, grid=GRID):
    return tsp.build_neighbor_map(torch.from_numpy(coords),
                                  torch.from_numpy(valid), grid)


def test_neighbor_map_matches_gga_tpu():
    coords, valid = _active_sets()
    pos, hit = (np.asarray(a) for a in _jax_nmap(coords, valid))
    nmap = _port_nmap(coords, valid).numpy()
    assert nmap.dtype == np.int32 and nmap.shape == pos.shape
    np.testing.assert_array_equal(nmap >= 0, hit)
    np.testing.assert_array_equal(nmap[hit], pos[hit])
    assert 0.05 < hit.mean() < 0.9          # the scenes have real neighbors


def test_flatten_nmap_matches_gga_tpu():
    coords, valid = _active_sets(B=3, seed=1)
    pos, hit = _jax_nmap(coords, valid)
    jflat, jhit = (np.asarray(a) for a in jl.flatten_nmap(pos, hit))
    flat = tl.flatten_nmap(_port_nmap(coords, valid)).numpy()
    np.testing.assert_array_equal(flat >= 0, jhit)
    np.testing.assert_array_equal(flat[jhit], jflat[jhit])


@pytest.mark.parametrize('ksz,stride,pad,budget', [
    ((3, 3, 3), (2, 2, 2), 1, 1024),
    ((3, 3, 3), (2, 2, 2), 1, 300),          # budget saturates
    ((3, 3, 3), (2, 2, 2), (0, 1, 1), 1024),
    ((3, 1, 1), (2, 1, 1), 0, 1024),
])
def test_strided_rulebook_matches_gga_tpu(ksz, stride, pad, budget):
    coords, valid = _active_sets(seed=2)
    joc, jov, jog, jfwd, _, _ = _jax_rulebook(
        jnp.asarray(coords), jnp.asarray(valid), GRID, ksz, stride, pad,
        budget)
    oc, ov, og, fwd = tsp.downsample_rulebook_compact(
        torch.from_numpy(coords), torch.from_numpy(valid), GRID, ksz,
        stride, pad, budget)
    assert og == jog
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
    np.testing.assert_array_equal(oc.numpy(), np.asarray(joc))
    np.testing.assert_array_equal(fwd.numpy(), np.asarray(jfwd))
    if budget < 1024:
        assert ov.numpy().all()             # the budget really saturated


def _feats(rng, n, c, valid):
    return (rng.randn(n, c).astype(np.float32)
            * valid.reshape(-1, 1)).astype(np.float32)


@pytest.mark.parametrize('c,d', [(4, 16), (16, 16), (16, 32), (32, 8)])
def test_subm_conv_plain_matches_einsum_path(c, d):
    rng = np.random.RandomState(c * 100 + d)
    coords, valid = _active_sets(seed=3)
    pos, hit = _jax_nmap(coords, valid)
    jmap, jhit = jl.flatten_nmap(pos, hit)
    f = _feats(rng, valid.size, c, valid)
    w = (rng.randn(27, c, d) * 0.2).astype(np.float32)
    ref = jsp.subm_conv_with_map(jnp.asarray(f), jnp.asarray(valid).reshape(-1),
                                 jmap, jhit, jnp.asarray(w))
    nmap = tl.flatten_nmap(_port_nmap(coords, valid))
    out = sparse_conv.gather_gemm_conv_plain(torch.from_numpy(f), nmap,
                                             torch.from_numpy(w))
    out = torch.where(torch.from_numpy(valid).reshape(-1, 1), out, 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_subm_conv_plain_matches_pallas_window_conv():
    """gga_tpu's Pallas _window_conv (interpret mode) is the TPU kernel the
    port's CUDA kernel replaces."""
    rng = np.random.RandomState(7)
    coords, valid = _active_sets(seed=4)
    pos, hit = _jax_nmap(coords, valid)
    jmap, jhit = jl.flatten_nmap(pos, hit)
    f = _feats(rng, valid.size, 16, valid)
    w = (rng.randn(27, 16, 16) * 0.2).astype(np.float32)
    ref = jsp.subm_conv_window(jnp.asarray(f), jnp.asarray(valid).reshape(-1),
                               jmap, jhit, jnp.asarray(w))
    nmap = tl.flatten_nmap(_port_nmap(coords, valid))
    out = sparse_conv.gather_gemm_conv_plain(torch.from_numpy(f), nmap,
                                             torch.from_numpy(w))
    out = torch.where(torch.from_numpy(valid).reshape(-1, 1), out, 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('ksz,stride,pad,c,d', [
    ((3, 3, 3), (2, 2, 2), 1, 8, 16),
    ((3, 1, 1), (2, 1, 1), 0, 16, 16),
])
def test_strided_conv_plain_matches_rulebook_conv(ksz, stride, pad, c, d):
    rng = np.random.RandomState(c + d)
    coords, valid = _active_sets(seed=5)
    M = 512
    _, jov, _, jfwd, bwd_d, parity = _jax_rulebook(
        jnp.asarray(coords), jnp.asarray(valid), GRID, ksz, stride, pad, M)
    f = _feats(rng, valid.size, c, valid)
    K = int(np.prod(ksz))
    w = (rng.randn(K, c, d) * 0.2).astype(np.float32)
    ref = jsp.rulebook_conv_compact(jnp.asarray(f), jnp.asarray(w), jfwd,
                                    bwd_d, parity, jov.reshape(-1), ksz,
                                    stride)
    st = tsp.SparseTensor(torch.from_numpy(f).reshape(*valid.shape, c),
                          torch.from_numpy(coords), torch.from_numpy(valid),
                          GRID)
    conv = tl.SparseConv3d(c, d, ksz, stride, pad, M)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        out = conv(st)
    np.testing.assert_allclose(out.features.reshape(-1, d).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('train', [False, True])
def test_masked_batchnorm_matches_gga_tpu(train):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 40, 8).astype(np.float32) * 2 + 1
    valid = rng.rand(2, 40) < 0.7
    v = {'params': {'scale': rng.rand(8).astype(np.float32) + 0.5,
                    'bias': rng.randn(8).astype(np.float32)},
         'batch_stats': {'mean': rng.randn(8).astype(np.float32),
                         'var': rng.rand(8).astype(np.float32) + 0.5}}
    ref, upd = jl.MaskedBatchNorm().apply(v, jnp.asarray(x),
                                          jnp.asarray(valid), train,
                                          mutable=['batch_stats'])
    bn = tl.MaskedBatchNorm(8)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v['params']['scale']))
        bn.bias.copy_(torch.from_numpy(v['params']['bias']))
        bn.running_mean.copy_(torch.from_numpy(v['batch_stats']['mean']))
        bn.running_var.copy_(torch.from_numpy(v['batch_stats']['var']))
    bn.train(train)
    out = bn(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd['batch_stats']['mean']),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd['batch_stats']['var']),
                               rtol=1e-5, atol=1e-6)
