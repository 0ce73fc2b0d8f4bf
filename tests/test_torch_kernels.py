"""The kernel wrappers, without JAX.

This file imports only torch and gga_tpu_torch, so it also runs on the
machine with the card, where JAX is absent:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

On the CPU each wrapper takes its plain version; the tests that need a
CUDA kernel carry the ``cuda`` marker and skip there (each decides inside
the test, never at import). On the card each kernel is held against its
plain version, on maps from the port's own builders where it takes maps:

- gather_gemm_conv in bf16 at ``|kernel - plain| <= 1e-2 * max|plain| +
  one bf16 ulp``: both sum in f32, in another order, and round the output
  to bf16 once;
- gather_gemm_dw (f32 output of bf16 inputs) at ``|kernel - plain| <=
  1e-3 * max|plain|``: both sum the same bf16 products in f32, in another
  order, and round nothing else;
- gather_rows and gather_rows_t exactly: they copy bits;
- render_heatmap at ``|kernel - plain| <= 1e-6`` (the two exps may differ
  by an ulp or two), with exactly the same pixels equal to 1.0.
"""
import numpy as np
import pytest
import torch

from gga_tpu_torch.kernels import gather_rows as gr
from gga_tpu_torch.kernels import heatmap, sparse_conv
from gga_tpu_torch.models.layers import flatten_nmap
from gga_tpu_torch.ops import sparse as sp
from gga_tpu_torch.ops.voxelize import hard_voxelize

torch.set_num_threads(1)

GRID = (41, 256, 224)


def _scene_maps(seed=0, B=2, P=3000, V=2048):
    """Neighbor map and strided rulebook of voxelized clustered clouds."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([
        rng.uniform(5, 30, (B, P, 1)), rng.uniform(-8, 8, (B, P, 1)),
        rng.uniform(-2.5, -0.5, (B, P, 1)), rng.rand(B, P, 1)],
        -1).astype(np.float32)
    vox = hard_voxelize(torch.from_numpy(pts), torch.ones(B, P, dtype=bool),
                        voxel_size=(0.32, 0.3125, 0.1),
                        pc_range=(0., -40., -3., 71.68, 40., 1.),
                        max_voxels=V)
    valid = torch.arange(V)[None] < vox['num_voxels'][:, None]
    subm = flatten_nmap(sp.build_neighbor_map(vox['coords'], valid, GRID))
    *_, strided = sp.downsample_rulebook_compact(
        vox['coords'], valid, GRID, (3, 3, 3), (2, 2, 2), 1, 1024)
    return subm, strided, B * V


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _within_bf16_tolerance(out, ref):
    out, ref = out.float(), ref.float()
    _, exp = torch.frexp(ref)
    ulp = torch.ldexp(torch.ones_like(ref), exp - 8)
    tol = 1e-2 * ref.abs().max() + ulp
    return bool(((out - ref).abs() <= tol).all())


def test_cpu_wrapper_takes_plain_path_without_counting():
    rng = np.random.RandomState(0)
    f = torch.from_numpy(rng.randn(50, 8).astype(np.float32))
    nmap = torch.from_numpy(rng.randint(-1, 50, (27, 40)).astype(np.int32))
    w = torch.from_numpy(rng.randn(27, 8, 16).astype(np.float32))
    before = sparse_conv.launches
    out = sparse_conv.gather_gemm_conv(f, nmap, w)
    assert sparse_conv.launches == before
    torch.testing.assert_close(out,
                               sparse_conv.gather_gemm_conv_plain(f, nmap, w))


def test_plain_version_is_a_masked_gather_gemm():
    """The plain version (f32 sums) against a loop in numpy (f64 sums)."""
    rng = np.random.RandomState(1)
    f = rng.randn(30, 5).astype(np.float32)
    nmap = rng.randint(-1, 30, (4, 12)).astype(np.int32)
    w = rng.randn(4, 5, 3).astype(np.float32)
    ref = np.zeros((12, 3))
    for q in range(12):
        for k in range(4):
            if nmap[k, q] >= 0:
                ref[q] += f[nmap[k, q]].astype(np.float64) @ w[k]
    out = sparse_conv.gather_gemm_conv_plain(
        torch.from_numpy(f), torch.from_numpy(nmap), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize('which,c,d', [
    ('subm', 4, 16), ('subm', 16, 16), ('subm', 32, 64), ('subm', 128, 128),
    ('strided', 64, 128), ('subm', 24, 200),
])
def test_cuda_kernel_matches_plain(which, c, d):
    dev = _cuda()
    subm, strided, rows = _scene_maps()
    nmap = (subm if which == 'subm' else strided).to(dev)
    rng = np.random.RandomState(c + d)
    f = torch.from_numpy(rng.randn(rows, c).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.randn(27, c, d).astype(np.float32) * 0.2)
    f, w = f.bfloat16(), w.to(dev).bfloat16()
    before = sparse_conv.launches
    out = sparse_conv.gather_gemm_conv(f, nmap, w)
    ref = sparse_conv.gather_gemm_conv_plain(f, nmap, w)
    torch.cuda.synchronize()
    assert sparse_conv.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert _within_bf16_tolerance(out, ref)


@pytest.mark.cuda
def test_cuda_kernel_all_misses_give_zeros():
    dev = _cuda()
    f = torch.randn(100, 16, device=dev).bfloat16()
    nmap = torch.full((27, 70), -1, dtype=torch.int32, device=dev)
    w = torch.randn(27, 16, 32, device=dev).bfloat16()
    out = sparse_conv.gather_gemm_conv(f, nmap, w)
    torch.cuda.synchronize()
    assert (out == 0).all()


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    dev = _cuda()
    f = torch.randn(100, 16, device=dev)
    nmap = torch.zeros((27, 70), dtype=torch.int32, device=dev)
    w = torch.randn(27, 16, 32, device=dev)
    with pytest.raises(TypeError):
        sparse_conv.gather_gemm_conv(f, nmap, w)            # f32
    with pytest.raises(TypeError):
        sparse_conv.gather_gemm_conv(f.bfloat16(), nmap.long(), w.bfloat16())
    with pytest.raises(ValueError):
        sparse_conv.gather_gemm_conv(f.bfloat16(), nmap[:, ::2],
                                     w.bfloat16())          # not contiguous


def _rows_case(seed, n, c, m, dtype):
    rng = np.random.RandomState(seed)
    src = torch.from_numpy(rng.randn(n, c).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.randint(-1, n, m).astype(np.int32))
    return src, idx


def _heatmap_case(seed, G=6, M=40, H=50, W=44):
    rng = np.random.RandomState(seed)
    centers = torch.from_numpy(np.stack(
        [rng.randint(-3, W + 3, (G, M)), rng.randint(-3, H + 3, (G, M))],
        -1).astype(np.int32))
    radii = torch.from_numpy(rng.randint(0, 9, (G, M)).astype(np.int32))
    valid = torch.from_numpy(rng.rand(G, M) < 0.6)
    return centers, radii, valid, (H, W)


def test_cpu_wrappers_of_the_train_kernels_take_plain_paths_uncounted():
    rng = np.random.RandomState(3)
    f = torch.from_numpy(rng.randn(50, 8).astype(np.float32))
    nmap = torch.from_numpy(rng.randint(-1, 50, (27, 40)).astype(np.int32))
    dout = torch.from_numpy(rng.randn(40, 16).astype(np.float32))
    src, idx = _rows_case(4, 30, 6, 70, torch.float32)
    hm = _heatmap_case(5)
    before = (sparse_conv.dw_launches, gr.launches, gr.t_launches,
              heatmap.launches)
    torch.testing.assert_close(sparse_conv.gather_gemm_dw(f, nmap, dout),
                               sparse_conv.gather_gemm_dw_plain(f, nmap, dout))
    assert torch.equal(gr.gather_rows(src, idx),
                       gr.gather_rows_plain(src, idx))
    assert torch.equal(gr.gather_rows_t(f, nmap),
                       gr.gather_rows_t_plain(f, nmap))
    assert torch.equal(heatmap.render_heatmap(*hm),
                       heatmap.render_heatmap_plain(*hm))
    assert before == (sparse_conv.dw_launches, gr.launches, gr.t_launches,
                      heatmap.launches)


def test_plain_dw_is_a_masked_gathered_product():
    """gather_gemm_dw_plain (f32 sums) against a loop in numpy (f64)."""
    rng = np.random.RandomState(6)
    f = rng.randn(30, 5).astype(np.float32)
    nmap = rng.randint(-1, 30, (4, 12)).astype(np.int32)
    dout = rng.randn(12, 3).astype(np.float32)
    ref = np.zeros((4, 5, 3))
    for k in range(4):
        for q in range(12):
            if nmap[k, q] >= 0:
                ref[k] += np.outer(f[nmap[k, q]], dout[q])
    out = sparse_conv.gather_gemm_dw_plain(
        torch.from_numpy(f), torch.from_numpy(nmap), torch.from_numpy(dout))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_plain_rows_give_zero_rows_for_misses():
    src, idx = _rows_case(7, 20, 3, 50, torch.float32)
    out = gr.gather_rows_plain(src, idx)
    miss = idx < 0
    assert miss.any() and (out[miss] == 0).all()
    assert torch.equal(out[~miss], src[idx[~miss].long()])
    t = gr.gather_rows_t_plain(src, idx.reshape(5, 10))
    assert torch.equal(t, out.reshape(5, 10, 3).transpose(1, 2))


def test_plain_heatmap_is_one_exactly_at_each_valid_centre():
    centers, radii, valid, hw = _heatmap_case(8)
    out = heatmap.render_heatmap_plain(centers, radii, valid, hw)
    H, W = hw
    for g, j in zip(*np.nonzero(valid.numpy())):
        x, y = centers[g, j].tolist()
        if 0 <= x < W and 0 <= y < H:
            assert out[g, y, x] == 1.0
    assert ((out >= 0) & (out <= 1)).all()


@pytest.mark.cuda
@pytest.mark.parametrize('which,c,d', [
    ('subm', 4, 16), ('subm', 16, 16), ('subm', 32, 64), ('subm', 128, 128),
    ('strided', 64, 128), ('subm', 24, 20),
])
def test_cuda_dw_kernel_matches_plain(which, c, d):
    dev = _cuda()
    subm, strided, rows = _scene_maps()
    nmap = (subm if which == 'subm' else strided).to(dev)
    rng = np.random.RandomState(c * 7 + d)
    f = torch.from_numpy(rng.randn(rows, c).astype(np.float32)).to(dev)
    dout = torch.from_numpy(rng.randn(nmap.shape[1], d).astype(np.float32))
    f, dout = f.bfloat16(), dout.to(dev).bfloat16()
    before = sparse_conv.dw_launches
    out = sparse_conv.gather_gemm_dw(f, nmap, dout)
    ref = sparse_conv.gather_gemm_dw_plain(f, nmap, dout)
    torch.cuda.synchronize()
    assert sparse_conv.dw_launches == before + 1
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert ((out - ref).abs() <= 1e-3 * ref.abs().max()).all()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('c', [3, 4, 6, 16, 64, 128])
def test_cuda_gather_rows_match_plain_exactly(dtype, c):
    dev = _cuda()
    src, idx = _rows_case(c, 3000, c, 20000, dtype)
    src, idx = src.to(dev), idx.to(dev)
    before = (gr.launches, gr.t_launches)
    out = gr.gather_rows(src, idx)
    nmap = idx[:19992].reshape(8, -1)
    out_t = gr.gather_rows_t(src, nmap)
    torch.cuda.synchronize()
    assert (gr.launches, gr.t_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(out, gr.gather_rows_plain(src, idx))
    assert torch.equal(out_t, gr.gather_rows_t_plain(src, nmap))


@pytest.mark.cuda
def test_cuda_heatmap_kernel_matches_plain():
    dev = _cuda()
    centers, radii, valid, hw = _heatmap_case(9, G=24, M=500, H=200, W=176)
    centers, radii, valid = centers.to(dev), radii.to(dev), valid.to(dev)
    before = heatmap.launches
    out = heatmap.render_heatmap(centers, radii, valid, hw)
    ref = heatmap.render_heatmap_plain(centers, radii, valid, hw)
    torch.cuda.synchronize()
    assert heatmap.launches == before + 1
    assert (out - ref).abs().max() <= 1e-6
    assert torch.equal(out == 1.0, ref == 1.0) and (ref == 1.0).any()


@pytest.mark.cuda
def test_cuda_train_kernel_wrappers_refuse_what_they_do_not_take():
    dev = _cuda()
    f = torch.randn(100, 16, device=dev)
    nmap = torch.zeros((27, 70), dtype=torch.int32, device=dev)
    dout = torch.randn(70, 32, device=dev)
    with pytest.raises(TypeError):
        sparse_conv.gather_gemm_dw(f, nmap, dout.bfloat16())     # f32
    with pytest.raises(TypeError):
        gr.gather_rows(f.double(), nmap[0])
    with pytest.raises(TypeError):
        gr.gather_rows(f, nmap[0].long())
    with pytest.raises(ValueError):
        gr.gather_rows_t(f, nmap[:, ::2])                         # strided
    c, r, v, hw = (t.to(dev) if torch.is_tensor(t) else t
                   for t in _heatmap_case(1))
    with pytest.raises(TypeError):
        heatmap.render_heatmap(c.long(), r, v, hw)
