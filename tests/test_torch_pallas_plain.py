"""The plain versions of the port's train-path kernels against gga_tpu's
Pallas kernels (interpret mode on the CPU) and its default XLA paths.

- ``gather_rows_plain`` equals ``gather_rows_pallas`` and its two variants
  (non-negative indices, M a multiple of their 1024-row tile) and
  ``_rb_gather`` (with -1 entries) exactly: they copy values.
- ``gather_rows_t_plain`` equals ``window_gather_t`` exactly.
- ``gather_gemm_dw_plain`` equals ``_window_dw`` (through
  ``_window_dw_apply``) at rtol 1e-5 plus 1e-5 of the largest entry: f32
  sums of the same products in another order.
- the plain heatmap equals ``render_heatmap_pallas`` and
  ``render_heatmap_dyn`` at atol 1e-6 (two exp implementations), with
  exactly the same pixels equal to 1.0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gga_tpu.core import gaussian as jg
from gga_tpu.models import layers as jl
from gga_tpu.ops import sparse as jsp
from gga_tpu.ops.pallas import gather_rows as jgr
from gga_tpu.ops.pallas import heatmap as jhm
from gga_tpu.ops.pallas import window_gather as wg
from gga_tpu_torch.kernels import gather_rows as gr
from gga_tpu_torch.kernels import heatmap, sparse_conv

from .test_torch_sparse import _active_sets, _jax_nmap

torch.set_num_threads(1)


@pytest.mark.parametrize('fn', ['gather_rows_pallas', 'gather_rows_unroll',
                                'gather_rows_vec'])
def test_gather_rows_plain_matches_pallas(fn):
    rng = np.random.RandomState(0)
    src = rng.randn(300, 8).astype(np.float32)
    idx = rng.randint(0, 300, 1024).astype(np.int32)
    ref = getattr(jgr, fn)(jnp.asarray(src), jnp.asarray(idx),
                           interpret=True)
    out = gr.gather_rows_plain(torch.from_numpy(src), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_gather_rows_plain_matches_rb_gather_with_misses():
    rng = np.random.RandomState(1)
    src = rng.randn(200, 16).astype(np.float32)
    idx = rng.randint(-1, 200, (8, 300)).astype(np.int32)
    ref = jsp._rb_gather(jnp.asarray(src), jnp.asarray(idx))     # [8, 300, C]
    out = gr.gather_rows_plain(torch.from_numpy(src),
                               torch.from_numpy(idx.reshape(-1)))
    assert (idx < 0).any()
    np.testing.assert_array_equal(out.numpy().reshape(8, 300, 16),
                                  np.asarray(ref))


def _flat_map(seed):
    """Batch-flat neighbor map of clustered scenes (monotone per offset,
    as window_gather_t requires), with gga_tpu's (pos, hit) form."""
    coords, valid = _active_sets(P=800, V=512, seed=seed)
    jmap, jhit = jl.flatten_nmap(*_jax_nmap(coords, valid))
    nmap = np.where(np.asarray(jhit), np.asarray(jmap), -1).astype(np.int32)
    return np.asarray(jmap), np.asarray(jhit), nmap


def _takes_the_pallas_path(jmap, jhit, c):
    """gga_tpu falls back to an XLA gather when a block's hits overflow
    its window; these maps must not, so that the Pallas kernel runs."""
    pad = (-jmap.shape[1]) % (wg.GROUP * wg.TILE)
    rows = jmap.shape[1] + (-jmap.shape[1]) % (2 * wg._wg_for(c) * (128 // c))
    *_, ovf = wg.window_prep(jnp.pad(jmap, ((0, 0), (0, pad))),
                             jnp.pad(jhit, ((0, 0), (0, pad))), rows, c)
    return not bool(ovf)


# window_gather_t takes the powers of two that divide 128
@pytest.mark.parametrize('c', [8, 16, 32, 64])
def test_gather_rows_t_plain_matches_window_gather_t(c):
    jmap, jhit, nmap = _flat_map(seed=2)
    assert _takes_the_pallas_path(jmap, jhit, c)
    f = np.random.RandomState(3).randn(nmap.shape[1], c).astype(np.float32)
    ref = wg.window_gather_t(jnp.asarray(f), jnp.asarray(jmap),
                             jnp.asarray(jhit), interpret=True)
    out = gr.gather_rows_t_plain(torch.from_numpy(f), torch.from_numpy(nmap))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_gather_gemm_dw_plain_matches_pallas_window_dw():
    jmap, jhit, nmap = _flat_map(seed=4)
    assert _takes_the_pallas_path(jmap, jhit, 8)
    rng = np.random.RandomState(5)
    f = rng.randn(nmap.shape[1], 8).astype(np.float32)
    dout = rng.randn(nmap.shape[1], 16).astype(np.float32)
    ref = np.asarray(jax.jit(jsp._window_dw_apply)(
        jnp.asarray(f), jnp.asarray(jmap), jnp.asarray(jhit),
        jnp.asarray(dout)))
    out = sparse_conv.gather_gemm_dw_plain(
        torch.from_numpy(f), torch.from_numpy(nmap), torch.from_numpy(dout))
    assert out.dtype == torch.float32 and np.abs(ref).max() > 1
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def _objects(seed, M=40, H=48, W=176, kind='random'):
    """One map's objects: 'random' centres inside the map, radii 2-8;
    'radius0' a third of them of radius 0; 'corners' centres on the four
    corners and one past them."""
    rng = np.random.RandomState(seed)
    centers = np.stack([rng.randint(0, W, M), rng.randint(0, H, M)],
                       -1).astype(np.int32)
    radii = rng.randint(2, 9, M).astype(np.int32)
    valid = rng.rand(M) > 0.3
    if kind == 'radius0':
        radii[::3] = 0
    elif kind == 'corners':
        corners = np.array([[0, 0], [W - 1, 0], [0, H - 1], [W - 1, H - 1],
                            [-1, -1], [W, H]], np.int32)
        centers = corners[rng.randint(0, len(corners), M)]
    return centers, radii, valid, (H, W)


# W = 175 (not a multiple of 4), H = 13 (not a multiple of the 8- and
# 16-row tiles), radius 0, centres on the corners
@pytest.mark.parametrize('h,w,kind', [(48, 176, 'random'),
                                      (48, 175, 'random'),
                                      (13, 176, 'random'),
                                      (48, 176, 'radius0'),
                                      (48, 176, 'corners')])
def test_plain_heatmap_matches_pallas_and_dyn(h, w, kind):
    maps = [_objects(s, H=h, W=w, kind=kind) for s in range(3)]
    hw = maps[0][3]
    out = heatmap.render_heatmap_plain(
        *(torch.from_numpy(np.stack([m[i] for m in maps])) for i in range(3)),
        hw).numpy()
    for g, (c, r, v, _) in enumerate(maps):
        args = (jnp.asarray(c), jnp.asarray(r), jnp.asarray(v))
        for ref in (jhm.render_heatmap_pallas(*args, hw, interpret=True),
                    jg.render_heatmap_dyn(*args, hw)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(out[g], ref, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(out[g] == 1.0, ref == 1.0)
        assert (out[g] == 1.0).sum() >= 1
