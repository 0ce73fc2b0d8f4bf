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
  to bf16 once; in f32 at ``|kernel - plain| <= 1e-5 * max|plain|``:
  products as accurate as f32 ones (3xTF32 on the tensor cores, or FFMA
  at C and D <= 32, in the kernel; f32 with TF32 off for the plain
  einsum) summed in another order;
- gather_gemm_dw (f32 output) of bf16 inputs at ``|kernel - plain| <=
  1e-3 * max|plain|``: both sum the same bf16 products in f32, in another
  order, and round nothing else; of f32 inputs at ``2e-5 * max|plain|``;
  two calls give the same bits;
- gather_rows and gather_rows_t exactly: they copy bits;
- render_heatmap at ``|kernel - plain| <= 1e-6`` (the two exps may differ
  by an ulp or two), with exactly the same pixels equal to 1.0.
"""
import functools

import numpy as np
import pytest
import torch

from gga_tpu_torch.device import resolve_device
from gga_tpu_torch.kernels import gather_rows as gr
from gga_tpu_torch.kernels import heatmap, sparse_conv
from gga_tpu_torch.models.layers import flatten_nmap
from gga_tpu_torch.ops import sparse as sp
from gga_tpu_torch.ops.voxelize import hard_voxelize

torch.set_num_threads(1)

GRID = (41, 256, 224)


def _scene_maps(seed=0, B=2, P=3000, V=2048):
    """Neighbor map and strided rulebook of voxelized clustered clouds."""
    coords, valid = _voxels(seed, B, P, V)
    subm = flatten_nmap(sp.build_neighbor_map(coords, valid, GRID))
    *_, strided = sp.downsample_rulebook_compact(
        coords, valid, GRID, (3, 3, 3), (2, 2, 2), 1, 1024)
    return subm, strided, B * V


@functools.lru_cache(maxsize=1)
def _second_maps():
    """SECOND's maps (``hv_second_secfpn_kitti``: 0.05 m voxels of a
    41 x 1600 x 1408 grid): the input SubM map of one scene of 16 000
    voxels, the stage-3 strided rulebook (padding (0, 1, 1)) and conv_out's
    (3, 1, 1) stride (2, 1, 1) rulebook, the two on the scene voxels of
    ``_scene_maps``; each with the rows it indexes."""
    rng = np.random.RandomState(5)
    pts = np.concatenate([rng.uniform(2, 60, (1, 20000, 1)),
                          rng.uniform(-30, 30, (1, 20000, 1)),
                          rng.uniform(-2.9, 0.9, (1, 20000, 1)),
                          rng.rand(1, 20000, 1)], -1).astype(np.float32)
    V = 16000
    vox = hard_voxelize(torch.from_numpy(pts), torch.ones(1, 20000,
                                                          dtype=bool),
                        voxel_size=(0.05, 0.05, 0.1),
                        pc_range=(0, -40, -3, 70.4, 40, 1), max_voxels=V)
    valid = torch.arange(V)[None] < vox['num_voxels'][:, None]
    assert int(valid.sum()) == V
    subm = flatten_nmap(sp.build_neighbor_map(vox['coords'], valid,
                                              (41, 1600, 1408)))
    coords, valid = _voxels()
    rows = coords.shape[0] * coords.shape[1]
    *_, strided = sp.downsample_rulebook_compact(
        coords, valid, GRID, (3, 3, 3), (2, 2, 2), (0, 1, 1), 1024)
    *_, out = sp.downsample_rulebook_compact(
        coords, valid, GRID, (3, 1, 1), (2, 1, 1), 0, 2048)
    return dict(second_in=(subm, V), strided_z0=(strided, rows),
                conv_out=(out, rows))


@functools.lru_cache(maxsize=1)
def _second_batch_map():
    """The input SubM map of a train batch of the KITTI voxel detectors
    (SECOND, DVSECOND, SASSD, bf16 SECOND: ``data.samples_per_gpu`` = 6
    scenes of 16 000 voxels, 96 000 rows) and its rows."""
    rng = np.random.RandomState(6)
    B, P, V = 6, 20000, 16000
    pts = np.concatenate([rng.uniform(2, 60, (B, P, 1)),
                          rng.uniform(-30, 30, (B, P, 1)),
                          rng.uniform(-2.9, 0.9, (B, P, 1)),
                          rng.rand(B, P, 1)], -1).astype(np.float32)
    vox = hard_voxelize(torch.from_numpy(pts), torch.ones(B, P, dtype=bool),
                        voxel_size=(0.05, 0.05, 0.1),
                        pc_range=(0, -40, -3, 70.4, 40, 1), max_voxels=V)
    valid = torch.arange(V)[None] < vox['num_voxels'][:, None]
    return flatten_nmap(sp.build_neighbor_map(vox['coords'], valid,
                                              (41, 1600, 1408))), B * V


@functools.lru_cache(maxsize=1)
def _small_maps():
    """The accuracy bench's model (``GGAModelConfig.small()``: 0.1 m
    voxels of a 41 x 800 x 704 grid, 8 192 voxels a scene, stage budgets
    8 192 / 8 192 / 6 144) on two of the bench's synthetic scenes (ground,
    clutter and 350 points on each of 3-5 boxes, cropped to the camera's
    view as the bench's reduced clouds are): the input SubM map, the
    stage-0 -> 1 strided rulebook, and conv_out's (3, 1, 1) stride
    (2, 1, 1) rulebook on the sites the three strided convs leave; each
    with the rows it indexes."""
    from gga_tpu_torch.core import np_geometry as ng
    from gga_tpu_torch.data.kitti import synth
    rng = np.random.RandomState(9)
    B, P, V, grid = 2, 8192, 8192, (41, 800, 704)
    pts = np.zeros((B, P, 4), np.float32)
    valid = np.zeros((B, P), bool)
    for b in range(B):
        n = rng.randint(3, 6)
        boxes = np.stack([rng.uniform(8, 50, n), rng.uniform(-12, 12, n),
                          np.full(n, -1.73), rng.uniform(3.4, 4.6, n),
                          rng.uniform(1.5, 1.85, n), rng.uniform(1.4, 1.7, n),
                          rng.uniform(-np.pi, np.pi, n)], 1)
        cloud = ng.remove_outside_points(
            synth.make_scene(rng, boxes, ['Car'] * n, 6000, 400, 350),
            synth.RECT, synth.VELO2CAM, synth.P2, synth.IMG_SHAPE)[:P]
        pts[b, :len(cloud)], valid[b, :len(cloud)] = cloud, True
    vox = hard_voxelize(torch.from_numpy(pts), torch.from_numpy(valid),
                        voxel_size=(0.1, 0.1, 0.1),
                        pc_range=(0, -40, -3, 70.4, 40, 1), max_voxels=V)
    coords = vox['coords']
    vvalid = torch.arange(V)[None] < vox['num_voxels'][:, None]
    subm = flatten_nmap(sp.build_neighbor_map(coords, vvalid, grid))
    st = (coords, vvalid, grid)
    maps = []
    for pad, budget in ((1, 8192), (1, 8192), ((0, 1, 1), 6144)):
        *st, fwd = sp.downsample_rulebook_compact(*st, (3, 3, 3), (2, 2, 2),
                                                  pad, budget)
        maps.append((fwd, B * V))
    *_, out = sp.downsample_rulebook_compact(*st, (3, 1, 1), (2, 1, 1), 0,
                                             6144)
    return dict(small_in=(subm, B * V), small_s1=maps[0],
                small_out=(out, B * 6144))


@functools.lru_cache(maxsize=1)
def _centerpoint_maps():
    """The nuScenes CenterPoint encoder's maps (0.1 x 0.1 x 0.2 m voxels of
    a 41 x 1024 x 1024 grid, 90 000 voxels a scene, stage budgets
    90 000 / 60 000 / 40 000) on a train batch of 4 scenes of 60 000
    points: the input SubM map (360 000 rows) and the stage-3 SubM map
    after the three strided convs (160 000 rows); each with its rows."""
    rng = np.random.RandomState(13)
    B, P, V = 4, 60000, 90000
    r = 51 * np.sqrt(rng.rand(B, P, 1))
    a = rng.uniform(-np.pi, np.pi, (B, P, 1))
    pts = np.concatenate([r * np.cos(a), r * np.sin(a),
                          rng.uniform(-3, 1, (B, P, 1)), rng.rand(B, P, 2)],
                         -1).astype(np.float32)
    vox = hard_voxelize(torch.from_numpy(pts), torch.ones(B, P, dtype=bool),
                        voxel_size=(0.1, 0.1, 0.2),
                        pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                        max_points=10, max_voxels=V)
    coords = vox['coords']
    valid = torch.arange(V)[None] < vox['num_voxels'][:, None]
    grid = (41, 1024, 1024)
    subm = flatten_nmap(sp.build_neighbor_map(coords, valid, grid))
    st = (coords, valid, grid)
    for pad, budget in ((1, 90000), (1, 60000), ((0, 1, 1), 40000)):
        *st, _ = sp.downsample_rulebook_compact(*st, (3, 3, 3), (2, 2, 2),
                                                pad, budget)
    s3 = flatten_nmap(sp.build_neighbor_map(*st))
    return dict(cp_in=(subm, B * V), cp_s3=(s3, B * 40000))


@functools.lru_cache(maxsize=1)
def _parta2_maps():
    """PartA2's SparseUNet maps (0.05 m voxels of a 41 x 1600 x 1408 grid,
    16 000 voxels a scene, strided budgets 16 000 / 14 000 / 12 000 and
    12 000 at conv_out) on a train batch of 2 scenes of 20 000 points: the
    inverse convs' maps, which are the strided rulebooks' backward maps
    read forwards ([27, B*N] rows into the B*M downsampled rows): stage
    2's onto stage 1's set and stage 1's onto the input set; stage 2's
    SubM map (the merge SubM's) and conv_out's (3, 1, 1) map; each with
    the rows it indexes."""
    rng = np.random.RandomState(14)
    B, P, V = 2, 20000, 16000
    pts = np.concatenate([rng.uniform(2, 60, (B, P, 1)),
                          rng.uniform(-30, 30, (B, P, 1)),
                          rng.uniform(-2.9, 0.9, (B, P, 1)),
                          rng.rand(B, P, 1)], -1).astype(np.float32)
    vox = hard_voxelize(torch.from_numpy(pts), torch.ones(B, P, dtype=bool),
                        voxel_size=(0.05, 0.05, 0.1),
                        pc_range=(0, -40, -3, 70.4, 40, 1), max_voxels=V)
    st = (vox['coords'], torch.arange(V)[None] < vox['num_voxels'][:, None],
          (41, 1600, 1408))
    bwd = []
    for pad, budget in ((1, 16000), (1, 14000), ((0, 1, 1), 12000)):
        *st, _, b = sp.downsample_rulebook_batched(*st, 3, 2, pad, budget)
        bwd.append((b, B * budget))
        if budget == 14000:
            s2 = (flatten_nmap(sp.build_neighbor_map(*st)), B * budget)
    *_, out, _ = sp.downsample_rulebook_batched(*st, (3, 1, 1), (2, 1, 1), 0,
                                                12000)
    return dict(pa_inv2=bwd[1], pa_inv1=bwd[0], pa_s2=s2,
                pa_out=(out, B * 12000))


def _strided_bwd_map(M=1024):
    """The dense backward map [27, B*V] of a strided rulebook (MinkResNet's
    strided convs' input gradient; mostly -1) and the rows it indexes,
    B*M."""
    coords, valid = _voxels()
    *_, bwd = sp.downsample_rulebook_batched(coords, valid, GRID, 3, 2, 1, M)
    return bwd, coords.shape[0] * M


def _voxels(seed=0, B=2, P=3000, V=2048):
    """Voxel coords [B, V, 3] and valid [B, V] of clustered clouds."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([
        rng.uniform(5, 30, (B, P, 1)), rng.uniform(-8, 8, (B, P, 1)),
        rng.uniform(-2.5, -0.5, (B, P, 1)), rng.rand(B, P, 1)],
        -1).astype(np.float32)
    vox = hard_voxelize(torch.from_numpy(pts), torch.ones(B, P, dtype=bool),
                        voxel_size=(0.32, 0.3125, 0.1),
                        pc_range=(0., -40., -3., 71.68, 40., 1.),
                        max_voxels=V)
    return vox['coords'], torch.arange(V)[None] < vox['num_voxels'][:, None]


def _cuda():
    """The card (TF32 off, so the plain f32 einsums are f32), or a skip."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return resolve_device('cuda')


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


# (map, C, D, K, Q): the encoder's widths on both sides of the narrow
# path's limit (C and D <= 32 and even: W resident, A gathered into
# registers) and the tile path's (the ring), C = 4, 12, 24 and 3 (rows
# that are not 16-byte multiples: 8-byte, 16-byte and scalar copies),
# C = 160 (two column chunks per offset), D = 20 (narrow path with D not a
# multiple of 8) and 200 (split over the grid), K = 3 on both paths,
# ragged Q, and synthetic maps
_CONV_CASES = [
    ('subm', 4, 16, 27, None), ('subm', 16, 16, 27, None),
    ('subm', 32, 32, 27, 4093), ('subm', 32, 64, 27, None),
    ('subm', 64, 64, 27, 4001), ('subm', 128, 128, 27, None),
    ('strided', 64, 128, 27, 2047), ('subm', 24, 200, 27, None),
    ('subm', 16, 20, 27, 4095), ('subm', 128, 128, 3, 4095),
    ('subm', 160, 48, 27, None), ('subm', 12, 64, 27, 4094),
    ('subm', 3, 40, 27, None), ('dense', 32, 32, 27, None),
    ('dense', 128, 128, 27, 3001), ('single', 16, 16, 27, None),
    ('single', 64, 128, 27, 3999), ('dup', 16, 32, 27, None),
    ('dup', 16, 16, 3, 1001), ('dup', 64, 64, 3, 1001),
    # FCAF3D's MinkResNet34 and head: conv1 (C = 3), widths 256 and 512
    # (four and eight column chunks, D split over blockIdx.y), a strided
    # 64 -> 64 with ragged Q, and the strided input gradients through the
    # dense backward map
    ('strided', 3, 64, 27, None), ('subm', 256, 512, 27, None),
    ('subm', 512, 512, 27, 2047), ('subm', 512, 128, 27, None),
    ('strided', 64, 64, 27, 1999), ('strided_bwd', 128, 64, 27, None),
    ('strided_bwd', 512, 256, 27, 3001),
    # SECOND's encoder (conv_module): the input SubM on 16 000 rows, its
    # strided convs 16 -> 32 and 32 -> 64, stage 3's with padding
    # (0, 1, 1), and conv_out's (3, 1, 1) map
    ('second_in', 4, 16, 27, None), ('strided', 16, 32, 27, None),
    ('strided', 32, 64, 27, 2047), ('strided_z0', 64, 64, 27, None),
    ('conv_out', 64, 128, 3, None),
    # a train batch of the KITTI voxel detectors (6 scenes, 96 000 rows):
    # the input SubM 4 -> 16 and stage 0's 16 -> 16
    ('second_b6', 4, 16, 27, None), ('second_b6', 16, 16, 27, None),
    # the accuracy bench's small model on its synthetic scenes: the input
    # SubM 4 -> 16 and the stage-0 SubM 16 -> 16 on the 41 x 800 x 704
    # grid, the strided 16 -> 32 and conv_out's (3, 64, 64)
    ('small_in', 4, 16, 27, None), ('small_in', 16, 16, 27, None),
    ('small_s1', 16, 32, 27, None), ('small_out', 64, 64, 3, None),
    # a train batch of nuScenes CenterPoint (4 scenes, 360 000 rows): the
    # input SubM 4 -> 16 and stage 0's 16 -> 16, and stage 3's 128 -> 128
    # SubM on its 160 000 rows
    ('cp_in', 4, 16, 27, None), ('cp_in', 16, 16, 27, None),
    ('cp_s3', 128, 128, 27, None),
    # a train batch of PartA2 (2 scenes): the inverse convs' swapped maps
    # (64 -> 32 onto stage 1's set, 32 -> 16 onto the input set), the
    # merge SubM (27, 128, 64) and conv_out's (3, 64, 128)
    ('pa_inv2', 64, 32, 27, None), ('pa_inv1', 32, 16, 27, None),
    ('pa_s2', 128, 64, 27, None), ('pa_out', 64, 128, 3, None),
]


def _case_map(which, k, q):
    """(nmap [k, Q] int32, source rows R): the port's neighbor map,
    strided rulebook or dense strided backward map of a voxelized scene,
    or a synthetic map: 'dense'
    (every offset hits every row), 'single' (one hit per 128-row tile),
    'dup' (each source row hit by dozens of outputs); first k offsets,
    first q rows."""
    if which in ('subm', 'strided'):
        subm, strided, rows = _scene_maps()
        nmap = (subm if which == 'subm' else strided).numpy()
    elif which == 'strided_bwd':
        nmap, rows = _strided_bwd_map()
        nmap = nmap.numpy()
    elif which in ('second_in', 'strided_z0', 'conv_out'):
        nmap, rows = _second_maps()[which]
        nmap = nmap.numpy()
    elif which == 'second_b6':
        nmap, rows = _second_batch_map()
        nmap = nmap.numpy()
    elif which in ('small_in', 'small_s1', 'small_out'):
        nmap, rows = _small_maps()[which]
        nmap = nmap.numpy()
    elif which in ('cp_in', 'cp_s3'):
        nmap, rows = _centerpoint_maps()[which]
        nmap = nmap.numpy()
    elif which.startswith('pa_'):
        nmap, rows = _parta2_maps()[which]
        nmap = nmap.numpy()
    else:
        rng = np.random.RandomState(11)
        rows, n = 3000, 4096
        if which == 'dense':
            nmap = rng.randint(0, rows, (27, n))
        elif which == 'single':
            nmap = np.full((27, n), -1)
            tiles = np.arange(0, n, 128)
            nmap[rng.randint(0, 27, len(tiles)),
                 tiles + rng.randint(0, 128, len(tiles))] = rng.randint(
                     0, rows, len(tiles))
        else:
            dup = (np.arange(n)[None] * 5 + np.arange(27)[:, None]) // 64
            nmap = np.where(rng.rand(27, n) < 0.7, dup % rows, -1)
    return torch.from_numpy(
        np.ascontiguousarray(nmap[:k, :q]).astype(np.int32)), rows


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('which,c,d,k,q', _CONV_CASES)
def test_cuda_kernel_matches_plain(which, c, d, k, q, dtype):
    dev = _cuda()
    nmap, rows = _case_map(which, k, q)
    nmap = nmap.to(dev)
    rng = np.random.RandomState(c + d)
    f = torch.from_numpy(rng.randn(rows, c).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.randn(k, c, d).astype(np.float32) * 0.2)
    f, w = f.to(dtype), w.to(dev, dtype)
    before = sparse_conv.launches
    out = sparse_conv.gather_gemm_conv(f, nmap, w)
    ref = sparse_conv.gather_gemm_conv_plain(f, nmap, w)
    torch.cuda.synchronize()
    assert sparse_conv.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    if dtype == torch.bfloat16:
        assert _within_bf16_tolerance(out, ref)
    else:
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('c,d,q', [(16, 32, 70), (128, 128, 300)])
def test_cuda_kernel_all_misses_give_zeros(c, d, q, dtype):
    dev = _cuda()
    f = torch.randn(100, c, device=dev).to(dtype)
    nmap = torch.full((27, q), -1, dtype=torch.int32, device=dev)
    w = torch.randn(27, c, d, device=dev).to(dtype)
    dout = torch.randn(q, d, device=dev).to(dtype)
    out = sparse_conv.gather_gemm_conv(f, nmap, w)
    dw = sparse_conv.gather_gemm_dw(f, nmap, dout)
    torch.cuda.synchronize()
    assert (out == 0).all() and (dw == 0).all()


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    dev = _cuda()
    f = torch.randn(100, 16, device=dev)
    nmap = torch.zeros((27, 70), dtype=torch.int32, device=dev)
    w = torch.randn(27, 16, 32, device=dev)
    with pytest.raises(TypeError):
        sparse_conv.gather_gemm_conv(f, nmap, w.bfloat16())  # mixed
    with pytest.raises(TypeError):
        sparse_conv.gather_gemm_conv(f.bfloat16(), nmap, w)  # mixed
    with pytest.raises(TypeError):
        sparse_conv.gather_gemm_conv(f.half(), nmap, w.half())
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


def _heatmap_case(seed, G=6, M=40, H=50, W=44, kind='random'):
    """(centers, radii, valid, (H, W)) of G maps of M object slots:
    'random' centres a little past every edge with radii 0-8; 'edges'
    centres on the corners and edges and one past them; 'radius' radii 0
    and larger than a 16-row band and than W; 'overlap' objects stacked
    on a few centres with several radii; 'empty' as 'random' with map 0
    holding no valid object."""
    rng = np.random.RandomState(seed)
    cx = rng.randint(-3, W + 3, (G, M))
    cy = rng.randint(-3, H + 3, (G, M))
    radii = rng.randint(0, 9, (G, M))
    valid = rng.rand(G, M) < 0.6
    if kind == 'edges':
        xs = np.array([0, W - 1, 0, W - 1, W // 2, W // 2, 0, W - 1, -1, W])
        ys = np.array([0, 0, H - 1, H - 1, 0, H - 1, H // 2, H // 2, H, -1])
        pick = rng.randint(0, len(xs), (G, M))
        cx, cy = xs[pick], ys[pick]
        radii = rng.randint(1, 9, (G, M))
    elif kind == 'radius':
        radii = rng.choice([0, 0, 3, 17, W + 5], (G, M))
    elif kind == 'overlap':
        cx = rng.randint(0, W, (G, 3))[:, rng.randint(0, 3, M)]
        cy = rng.randint(0, H, (G, 3))[:, rng.randint(0, 3, M)]
    elif kind == 'empty':
        valid[0] = False
    centers = np.ascontiguousarray(np.stack([cx, cy], -1), np.int32)
    return (torch.from_numpy(centers), torch.from_numpy(radii.astype(np.int32)),
            torch.from_numpy(valid), (H, W))


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


# (map, C, D, K, Q): every width of the encoder (warp tiles and offset
# groups differ at each), C = 4, 3 and 24, C = 160 and D = 200 (two c and
# d slabs), D = 20, K = 3, ragged Q (which also takes the 4-byte index
# copies) and synthetic maps
_DW_CASES = [
    ('subm', 4, 16, 27, None), ('subm', 3, 16, 27, None),
    ('subm', 16, 16, 27, 4093),
    ('subm', 16, 32, 27, None), ('subm', 32, 32, 27, None),
    ('subm', 32, 64, 27, 4001), ('subm', 64, 64, 27, None),
    ('subm', 128, 128, 27, None), ('strided', 64, 128, 27, 2047),
    ('subm', 24, 20, 27, None), ('subm', 128, 128, 3, 4095),
    ('subm', 160, 200, 27, None), ('dense', 32, 32, 27, None),
    ('dense', 128, 128, 27, 3001), ('single', 16, 16, 27, None),
    ('dup', 64, 64, 27, None), ('dup', 16, 16, 3, 1001),
    # FCAF3D's widths, as in _CONV_CASES (the dW split scratch at
    # (27, 512, 512))
    ('strided', 3, 64, 27, None), ('subm', 256, 512, 27, None),
    ('subm', 512, 512, 27, 2047), ('subm', 512, 128, 27, None),
    ('strided', 64, 64, 27, 1999),
    # SECOND's encoder, as in _CONV_CASES
    ('second_in', 4, 16, 27, None), ('strided', 16, 32, 27, None),
    ('strided', 32, 64, 27, None), ('strided_z0', 64, 64, 27, None),
    ('conv_out', 64, 128, 3, None),
    ('second_b6', 4, 16, 27, None), ('second_b6', 16, 16, 27, None),
    # the accuracy bench's small model, as in _CONV_CASES
    ('small_in', 4, 16, 27, None), ('small_in', 16, 16, 27, None),
    ('small_s1', 16, 32, 27, None), ('small_out', 64, 64, 3, None),
    # nuScenes CenterPoint, as in _CONV_CASES
    ('cp_in', 4, 16, 27, None), ('cp_in', 16, 16, 27, None),
    ('cp_s3', 128, 128, 27, None),
    # PartA2, as in _CONV_CASES (the inverse convs' weight gradients
    # gather the downsampled rows through the same swapped maps)
    ('pa_inv2', 64, 32, 27, None), ('pa_inv1', 32, 16, 27, None),
    ('pa_s2', 128, 64, 27, None), ('pa_out', 64, 128, 3, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('which,c,d,k,q', _DW_CASES)
def test_cuda_dw_kernel_matches_plain(which, c, d, k, q, dtype):
    dev = _cuda()
    nmap, rows = _case_map(which, k, q)
    nmap = nmap.to(dev)
    rng = np.random.RandomState(c * 7 + d)
    f = torch.from_numpy(rng.randn(rows, c).astype(np.float32)).to(dev)
    dout = torch.from_numpy(rng.randn(nmap.shape[1], d).astype(np.float32))
    f, dout = f.to(dtype), dout.to(dev, dtype)
    before = sparse_conv.dw_launches
    out = sparse_conv.gather_gemm_dw(f, nmap, dout)
    again = sparse_conv.gather_gemm_dw(f, nmap, dout)
    ref = sparse_conv.gather_gemm_dw_plain(f, nmap, dout)
    torch.cuda.synchronize()
    assert sparse_conv.dw_launches == before + 2
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert torch.equal(out, again)             # a fixed summation order
    rtol = 1e-3 if dtype == torch.bfloat16 else 2e-5
    assert ((out - ref).abs() <= rtol * ref.abs().max()).all()


def _f32_map(kind, k=27, q=1001, rows=3000, seed=21):
    """nmap [k, q] int32: 'sparse' (stage 0 of the encoder: the centre
    offset hits every row, each other offset about one row in fifty),
    'all' (every offset hits every row), 'none' (all misses); Q = 1001 is
    a multiple of neither kernel's row tile."""
    rng = np.random.RandomState(seed)
    nmap = rng.randint(0, rows, (k, q))
    if kind == 'sparse':
        nmap = np.where(rng.rand(k, q) < 0.02, nmap, -1)
        nmap[k // 2] = rng.randint(0, rows, q)
    elif kind == 'none':
        nmap[:] = -1
    return torch.from_numpy(nmap.astype(np.int32))


# the f32 kernels (3xTF32 on the tensor cores; FFMA at C and D <= 32) at
# every width pair of the conv's and dW's tiles, C = 3 and 24 (rows that are not 16-byte or 8-column
# multiples), on stage-0-like, all-hit and all-miss maps; both kernels give
# the same bits on a second call
@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['sparse', 'all', 'none'])
@pytest.mark.parametrize('d', [16, 32, 64, 128])
@pytest.mark.parametrize('c', [3, 16, 24, 32, 64, 128])
def test_cuda_f32_kernels_match_plain_at_every_width(c, d, kind):
    dev = _cuda()
    nmap = _f32_map(kind).to(dev)
    rng = np.random.RandomState(c * 5 + d)
    f = torch.from_numpy(rng.randn(3000, c).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(27, c, d) * 0.2).astype(np.float32)).to(dev)
    dout = torch.from_numpy(rng.randn(nmap.shape[1], d).astype(np.float32))
    dout = dout.to(dev)
    out = sparse_conv.gather_gemm_conv(f, nmap, w)
    again = sparse_conv.gather_gemm_conv(f, nmap, w)
    dw = sparse_conv.gather_gemm_dw(f, nmap, dout)
    dw_again = sparse_conv.gather_gemm_dw(f, nmap, dout)
    ref = sparse_conv.gather_gemm_conv_plain(f, nmap, w)
    dw_ref = sparse_conv.gather_gemm_dw_plain(f, nmap, dout)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(dw, dw_again)
    if kind == 'none':
        assert (out == 0).all() and (dw == 0).all()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert (dw - dw_ref).abs().max() <= 2e-5 * dw_ref.abs().max()


# inf, -inf, FLT_MAX and denormal features (weights small enough that
# FLT_MAX times one stays finite, one weight row an exact TF32 value):
# each f32 kernel is finite exactly where its plain version is, and the
# conv NaN exactly where it is
@pytest.mark.cuda
@pytest.mark.parametrize('c,d', [(16, 16), (32, 64), (128, 128), (3, 32)])
def test_cuda_f32_kernels_keep_the_plain_finiteness(c, d):
    dev = _cuda()
    rng = np.random.RandomState(c + d)
    f = rng.randn(3000, c).astype(np.float32)
    f[5, 0], f[17, c - 1], f[29, c // 2] = np.inf, -np.inf, 1e-41
    f[41, 0] = f[53, c - 1] = np.finfo(np.float32).max
    f[60:80] = 3e-39
    w = (rng.randn(27, c, d) * 2 ** -12).astype(np.float32)
    w[13, 0] = 0.5
    nmap = _f32_map('sparse').to(dev)
    nmap[13, :100] = torch.arange(100, device=dev, dtype=torch.int32)
    f, w = torch.from_numpy(f).to(dev), torch.from_numpy(w).to(dev)
    dout = torch.randn(nmap.shape[1], d, device=dev)
    out = sparse_conv.gather_gemm_conv(f, nmap, w)
    ref = sparse_conv.gather_gemm_conv_plain(f, nmap, w)
    dw = sparse_conv.gather_gemm_dw(f, nmap, dout)
    dw_ref = sparse_conv.gather_gemm_dw_plain(f, nmap, dout)
    torch.cuda.synchronize()
    for o, r in ((out, ref), (dw, dw_ref)):
        assert (~torch.isfinite(r)).any() and torch.isfinite(r).any()
        assert torch.equal(torch.isfinite(o), torch.isfinite(r))
    # inf times the exact 0.5 stays inf in the conv (no inf * 0 = NaN)
    assert torch.equal(torch.isnan(out), torch.isnan(ref))


def _rows_t_map(kind, k, q, rows, seed):
    """nmap [k, q] int32 into ``rows`` source rows: 'random' (a third of
    them -1), 'miss' (all -1), 'last' (half of them the last row), 'dup'
    (each row gathered 37 times in a row)."""
    rng = np.random.RandomState(seed)
    nmap = np.where(rng.rand(k, q) < 1 / 3, -1, rng.randint(0, rows, (k, q)))
    if kind == 'miss':
        nmap[:] = -1
    elif kind == 'last':
        nmap = np.where(rng.rand(k, q) < 0.5, rows - 1, nmap)
    elif kind == 'dup':
        nmap = (np.arange(k * q).reshape(k, q) // 37) % rows
    return torch.from_numpy(nmap.astype(np.int32))


# (K, Q, map): Q = 1, 7, 8, 63 and 2499 (output rows [k, c, :] that start
# at every alignment, and Q cutting the last 8-q store), K = 3 and 27, an
# all-miss map, the last source row, duplicate indices
_ROWS_T_MAPS = [
    (8, 2499, 'random'), (27, 1, 'random'), (27, 7, 'random'),
    (3, 8, 'random'), (27, 63, 'random'), (3, 2499, 'random'),
    (27, 300, 'miss'), (27, 129, 'last'), (3, 1000, 'dup'),
]


# C = 3, 4, 6: rows that are not 16-byte multiples (narrower copies);
# C = 24: 48-byte rows in a tile whose pitch is rounded up to 64; f32
# C = 128: two passes over the 512-byte rows
@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('c', [3, 4, 6, 16, 24, 32, 64, 128])
@pytest.mark.parametrize('k,q,kind', _ROWS_T_MAPS)
def test_cuda_gather_rows_match_plain_exactly(dtype, c, k, q, kind):
    dev = _cuda()
    src, _ = _rows_case(c, 3000, c, 1, dtype)
    nmap = _rows_t_map(kind, k, q, 3000, c + q).to(dev)
    src, idx = src.to(dev), nmap.reshape(-1)
    before = (gr.launches, gr.t_launches)
    out = gr.gather_rows(src, idx)
    out_t = gr.gather_rows_t(src, nmap)
    torch.cuda.synchronize()
    assert (gr.launches, gr.t_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(out, gr.gather_rows_plain(src, idx))
    assert torch.equal(out_t, gr.gather_rows_t_plain(src, nmap))


# (G, M, H, W, objects): the train step's shape; W = 175 and 13 (not a
# multiple of the kernel's 4-pixel stores); H = 199 and 1 (not a multiple
# of its 16-row band); M = 499 and 1 (the tail of its 16-byte reads of
# valid); objects on the edges and corners, of radius 0 and larger than a
# band and than W, overlapping; a map with no valid object; G = 1; M =
# 1500 (more slots than one cull round)
_HEATMAP_CASES = [
    (24, 500, 200, 176, 'random'), (24, 500, 200, 175, 'random'),
    (6, 40, 50, 13, 'random'), (6, 40, 199, 44, 'random'),
    (6, 40, 1, 44, 'random'), (24, 499, 200, 176, 'random'),
    (8, 1, 30, 31, 'random'), (4, 40, 50, 44, 'edges'),
    (4, 40, 50, 44, 'radius'), (4, 40, 61, 47, 'overlap'),
    (3, 40, 50, 44, 'empty'), (1, 40, 50, 44, 'random'),
    (2, 1500, 64, 40, 'random'),
    # nuScenes CenterPoint's step: B x 10 class maps of 128 object slots,
    # 128 x 128 (0.1 m voxel and 0.2 m pillar) and 180 x 180 (0.075 m)
    (40, 128, 128, 128, 'random'), (40, 128, 180, 180, 'random'),
]


@pytest.mark.cuda
@pytest.mark.parametrize('g,m,h,w,kind', _HEATMAP_CASES)
def test_cuda_heatmap_kernel_matches_plain(g, m, h, w, kind):
    dev = _cuda()
    centers, radii, valid, hw = _heatmap_case(9, g, m, h, w, kind)
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
        sparse_conv.gather_gemm_dw(f, nmap, dout.bfloat16())     # mixed
    with pytest.raises(TypeError):
        sparse_conv.gather_gemm_dw(f.half(), nmap, dout.half())
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
