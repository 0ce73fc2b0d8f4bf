"""The plain versions of the port's train-path kernels against gga_tpu's
Pallas kernels (interpret mode on the CPU) and its default XLA paths.

- ``gather_rows_plain`` equals ``gather_rows_pallas`` and its two variants
  (non-negative indices, M a multiple of their 1024-row tile) and
  ``_rb_gather`` (with -1 entries) exactly: they copy values.
- ``gather_rows_t_plain`` equals ``window_gather_t`` exactly.
- ``gather_gemm_dw_plain`` equals ``_window_dw`` (through
  ``_window_dw_apply``, and called directly in f32 at C = 8, 16, 32) at
  rtol 1e-5 plus 1e-5 of the largest entry: f32 sums of the same products
  in another order.
- ``gather_gemm_conv_plain`` equals ``_window_conv`` in f32 at C = 8, 16,
  32 at rtol 1e-5, atol 1e-5, for the same reason.
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


def _window_operands(jmap, jhit, f, pad_to):
    """(fwide, bb, cols) of gga_tpu's window kernels for features f [R, C]
    on the map padded to a multiple of ``pad_to`` rows, as
    ``_window_conv_apply`` / ``_window_dw_apply`` build them; asserts that
    no block overflows its window (so the Pallas kernel is the path)."""
    c = f.shape[1]
    pack = wg.LANES // c
    qp = (-jmap.shape[1]) % pad_to
    fp = wg._pad_rows(jnp.asarray(f), 2 * wg._wg_for(c) * pack)
    bb, cols, ovf = wg.window_prep(jnp.pad(jmap, ((0, 0), (0, qp))),
                                   jnp.pad(jhit, ((0, 0), (0, qp))),
                                   fp.shape[0], c)
    assert not bool(ovf)
    return fp.reshape(fp.shape[0] // pack, wg.LANES), bb, cols, qp


@pytest.mark.parametrize('c', [8, 16, 32])
def test_f32_conv_plain_matches_pallas_window_conv(c):
    """The f32 gather-GEMM: gga_tpu's TPU kernel _window_conv in f32
    (interpret mode) against the plain version the f32 CUDA kernel is
    held to."""
    jmap, jhit, nmap = _flat_map(seed=6)
    rng = np.random.RandomState(c)
    q, d = nmap.shape[1], 16
    f = rng.randn(q, c).astype(np.float32)
    w = (rng.randn(27, c, d) * 0.2).astype(np.float32)
    fwide, bb, cols, _ = _window_operands(jmap, jhit, f, wg.TILE)
    ref = np.asarray(wg._window_conv(fwide, c, d, bb, cols, jnp.asarray(w),
                                     interpret=True))[:q]
    out = sparse_conv.gather_gemm_conv_plain(
        torch.from_numpy(f), torch.from_numpy(nmap), torch.from_numpy(w))
    assert ref.dtype == np.float32 and out.dtype == torch.float32
    assert np.abs(ref).max() > 1
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('c', [8, 16, 32])
def test_f32_dw_plain_matches_pallas_window_dw(c):
    """The f32 weight gradient: gga_tpu's TPU kernel _window_dw in f32
    (interpret mode) against the plain version."""
    jmap, jhit, nmap = _flat_map(seed=7)
    rng = np.random.RandomState(c + 1)
    q, d = nmap.shape[1], 32
    f = rng.randn(q, c).astype(np.float32)
    dout = rng.randn(q, d).astype(np.float32)
    fwide, bb, cols, qp = _window_operands(jmap, jhit, f,
                                           wg.GROUP * wg.TILE)
    ref = np.asarray(wg._window_dw(fwide, c, d, bb, cols,
                                   jnp.pad(jnp.asarray(dout), ((0, qp),
                                                               (0, 0))),
                                   interpret=True))
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
