"""Sparse 3D convolution: neighbor maps for submanifold convs, the
rulebooks of strided convs (compact for the GGA encoder, with a dense
backward map for MinkResNet), the three convs as autograd Functions, and
the sparse ops of FCAF3D (max pool, generative transposed conv, union
add, lookup, top-k prune) and SparseUNet's inverse conv (port of
``gga_tpu/ops/sparse.py``, default flags).

Active voxels live in a fixed budget ``N`` per scene, sorted by
linearized (z, y, x) id with invalid rows parked at the end. Maps index
the batch-flat ``[B*N, C]`` feature array, with -1 for a miss, so that one
``kernels.sparse_conv.gather_gemm_conv`` launch covers the whole batch.

The Functions mirror gga_tpu's custom VJPs (``subm_conv_with_map``,
``_rulebook_conv_compact``, ``_rulebook_conv``): they take the f32
weights, cast them to the feature dtype inside, and return the weight
gradient in f32. The FCAF3D ops run per scene in gga_tpu (``jax.vmap``)
and batched here, on ``[B, N, ...]`` tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..kernels import gather_rows as gr
from ..kernels import sparse_conv

_IMAX = 2 ** 31 - 1


@dataclasses.dataclass
class SparseTensor:
    """A batch of sparse voxel sets. ``coords`` are (z, y, x), each scene
    sorted by linear id; rows where ``valid`` is False are padding."""
    features: torch.Tensor               # [B, N, C]
    coords: torch.Tensor                 # [B, N, 3] int32 (z, y, x)
    valid: torch.Tensor                  # [B, N] bool
    grid: Tuple[int, int, int]


def _linearize(coords, valid, grid):
    """(lin [...] int64 with ``big`` for invalid rows, big)."""
    nz, ny, nx = grid
    big = nz * ny * nx
    c = coords.long()
    lin = c[..., 0] * (ny * nx) + c[..., 1] * nx + c[..., 2]
    return torch.where(valid, lin, big), big


def _triple(v):
    """Normalize an int or length-3 sequence to a (z, y, x) tuple."""
    return tuple(int(x) for x in np.broadcast_to(np.asarray(v), (3,)))


def _kernel_offsets(kernel_size):
    """[K, 3] integer offsets, row-major over (z, y, x)."""
    kz, ky, kx = _triple(kernel_size)
    return np.stack(np.meshgrid(np.arange(kz), np.arange(ky), np.arange(kx),
                                indexing='ij'), -1).reshape(-1, 3)


def neighbor_map(coords, valid, grid, query_coords, query_valid,
                 kernel_size, stride, padding):
    """Rows of the inputs at ``query * stride - padding + offset`` for every
    kernel offset (gga_tpu ``_neighbor_pos_hit``, ``sparse.py:256``,
    batched; a miss is -1 where gga_tpu returns a hit mask beside an
    arbitrary row).

    Each target's linear id is looked up in the scene's sorted table with
    ``torch.searchsorted``; a target outside the grid never hits.

    Args:
        coords: [B, N, 3] int (z, y, x), each scene sorted by linear id.
        valid: [B, N] bool.
        query_coords: [B, Q, 3] int; query_valid: [B, Q] bool.
    Returns:
        [B, K, Q] int32: the row within its scene, -1 on a miss.
    """
    dev = coords.device
    offs = torch.as_tensor(_kernel_offsets(kernel_size), device=dev)
    stride_t = torch.tensor(_triple(stride), device=dev)
    pad = torch.tensor(_triple(padding), device=dev)
    B, Q, _ = query_coords.shape
    K = offs.shape[0]
    lin_in, _ = _linearize(coords, valid, grid)                # [B, N]
    tgt = (query_coords.long()[:, None] * stride_t - pad
           + offs[None, :, None])                              # [B, K, Q, 3]
    in_bounds = ((tgt >= 0) & (tgt < torch.tensor(grid, device=dev))).all(-1)
    nz, ny, nx = grid
    lin_t = (tgt[..., 0] * (ny * nx) + tgt[..., 1] * nx
             + tgt[..., 2]).reshape(B, K * Q)
    pos = torch.searchsorted(lin_in, lin_t, right=True) - 1
    pos_c = pos.clamp(min=0)
    hit = (pos >= 0) & (lin_in.gather(1, pos_c) == lin_t)
    hit = hit.reshape(B, K, Q) & in_bounds & query_valid[:, None, :]
    return torch.where(hit, pos_c.reshape(B, K, Q), -1).int()


def build_neighbor_map(coords, valid, grid, kernel_size=(3, 3, 3)):
    """Gather map of a submanifold conv on this active set, shared by
    every SubM conv of a stage (gga_tpu ``build_neighbor_map`` with all
    K offsets resolved directly, its default).

    Args:
        coords: [B, N, 3] int (z, y, x), each scene sorted by linear id.
        valid: [B, N] bool.
    Returns:
        nmap [B, K, N] int32: row of the neighbor within its scene, -1 miss.
    """
    k = _triple(kernel_size)
    return neighbor_map(coords, valid, grid, coords, valid, k, 1,
                        tuple((x - 1) // 2 for x in k))


def _gather_rows(features, nmap):
    """features [B, N, C], nmap [B, K, Q] (-1 miss) -> [B, K, Q, C], zeros
    on a miss."""
    B, K, Q = nmap.shape
    idx = nmap.long().clamp(min=0).reshape(B, K * Q, 1)
    g = features.gather(1, idx.expand(B, K * Q, features.shape[-1]))
    return torch.where(nmap.reshape(B, K * Q, 1) >= 0, g, 0).reshape(
        B, K, Q, -1)


def gather_neighbors(st: SparseTensor, query_coords, query_valid,
                     kernel_size, stride, padding):
    """Input features at ``query * stride - padding + offset`` for every
    kernel offset (gga_tpu ``gather_neighbors``, ``sparse.py:282``).

    Returns:
        [B, K, Q, C], zeros where the neighbor is inactive.
    """
    nmap = neighbor_map(st.coords, st.valid, st.grid, query_coords,
                        query_valid, kernel_size, stride, padding)
    return _gather_rows(st.features, nmap)


def downsample_coords(st: SparseTensor, kernel_size, stride, padding,
                      out_budget):
    """Active output sites of a strided sparse op, deduplicated into a
    static budget (gga_tpu ``downsample_coords``, ``sparse.py:328``): every
    position whose kernel window touches an active input; sites beyond the
    budget are dropped farthest first (``_budget_keep``).

    Returns:
        (out_coords [B, M, 3] int32, -1 padded; out_valid [B, M];
         out_grid), each scene sorted by linear id.
    """
    B = st.coords.shape[0]
    ksz, stride_a, pad_a, out_grid, ds, K = _ds_prep(
        st.grid, kernel_size, stride, padding)
    keys, _, newv, big = _ds_pairs(st.coords, st.valid, ksz, stride_a,
                                   pad_a, out_grid, ds, K)
    newv = newv & _budget_keep(keys, newv, big, out_grid, out_budget)
    slot = torch.cumsum(newv, dim=-1) - 1
    slot = torch.where(newv & (slot < out_budget), slot, out_budget)
    rows = torch.arange(B, device=keys.device)[:, None] * (out_budget + 1)
    out_lin = torch.full((B * (out_budget + 1),), big, dtype=torch.long,
                         device=keys.device)
    out_lin[(rows + slot).reshape(-1)] = torch.where(newv, keys,
                                                     big).reshape(-1)
    out_lin = out_lin.reshape(B, out_budget + 1)[:, :out_budget]
    out_valid = out_lin < big
    _, oy, ox = out_grid
    zyx = torch.stack([out_lin // (oy * ox), (out_lin % (oy * ox)) // ox,
                       out_lin % ox], -1)
    return (torch.where(out_valid[..., None], zyx, -1).int(), out_valid,
            out_grid)


def sparse_max_pool(st: SparseTensor, kernel_size=(2, 2, 2),
                    stride=(2, 2, 2), out_budget=None):
    """Max pooling over sparse neighbourhoods (gga_tpu ``sparse_max_pool``,
    ``sparse.py:428``; MinkowskiMaxPooling): the max over the window's
    active inputs, 0 where none is active."""
    if out_budget is None:
        out_budget = st.features.shape[1]
    oc, ov, og = downsample_coords(st, kernel_size, stride, 0, out_budget)
    nmap = neighbor_map(st.coords, st.valid, st.grid, oc, ov, kernel_size,
                        stride, 0)
    hit = (nmap >= 0)[..., None]                       # [B, K, Q, 1]
    neg = torch.finfo(st.features.dtype).min
    g = torch.where(hit, _gather_rows(st.features, nmap), neg)
    out = torch.where(hit.any(1) & ov[..., None], g.amax(1), 0)
    return SparseTensor(out, oc, ov, og)


def generative_transpose_conv(st: SparseTensor, weights, out_budget=None):
    """Generative transposed conv, kernel 2 stride 2 (gga_tpu
    ``generative_transpose_conv``, ``sparse.py:453``;
    MinkowskiGenerativeConvolutionTranspose): every input site generates
    its 8 children on the doubled grid, ``out[c * 2 + off] = in[c] @
    W[off]``; children of distinct inputs never collide.

    An 8-offset product of every row, left to ``torch.matmul``, as gga_tpu
    leaves it to XLA. The children are sorted by linear id with a stable
    sort (ties among invalid rows keep gga_tpu's order), then cut or
    padded to the budget.

    Args:
        weights: [8, Cin, Cout], offsets row-major over (z, y, x).
    """
    B, N, _ = st.features.shape
    Cout = weights.shape[-1]
    if out_budget is None:
        out_budget = 8 * N
    dev = st.coords.device
    out_grid = tuple(2 * d for d in st.grid)
    offs = torch.as_tensor(_kernel_offsets(2), device=dev, dtype=torch.int32)
    cc = (st.coords[:, None] * 2 + offs[None, :, None]).reshape(B, 8 * N, 3)
    cf = torch.matmul(st.features[:, None], weights[None]).reshape(
        B, 8 * N, Cout)                                # [B, 8, N] -> [B, 8N]
    cv = st.valid[:, None].expand(B, 8, N).reshape(B, 8 * N)
    lin, _ = _linearize(cc, cv, out_grid)
    order = torch.argsort(lin, dim=-1, stable=True)
    cc = cc.gather(1, order[..., None].expand(B, 8 * N, 3))
    cf = cf.gather(1, order[..., None].expand(B, 8 * N, Cout))
    cv = cv.gather(1, order)
    pad = out_budget - 8 * N
    if pad < 0:
        cc, cf, cv = cc[:, :out_budget], cf[:, :out_budget], cv[:, :out_budget]
    elif pad > 0:
        cc = torch.cat([cc, cc.new_full((B, pad, 3), -1)], 1)
        cf = torch.cat([cf, cf.new_zeros(B, pad, Cout)], 1)
        cv = torch.cat([cv, cv.new_zeros(B, pad)], 1)
    return SparseTensor(cf, torch.where(cv[..., None], cc, -1), cv, out_grid)


def sparse_add(a: SparseTensor, b: SparseTensor, out_budget):
    """Union of two sparse tensors on one grid, features summed at shared
    sites (gga_tpu ``sparse_add``, ``sparse.py:498``; MinkowskiEngine's
    ``a + b``): a stable sort by linear id of both row sets, then sites
    beyond the budget are dropped in coordinate order."""
    assert a.grid == b.grid
    coords = torch.cat([a.coords, b.coords], 1)
    feats = torch.cat([a.features, b.features], 1)
    valid = torch.cat([a.valid, b.valid], 1)
    B, L, C = feats.shape
    lin, _ = _linearize(coords, valid, a.grid)
    lin_s, order = torch.sort(lin, dim=-1, stable=True)
    feats_s = feats.gather(1, order[..., None].expand(B, L, C))
    coords_s = coords.gather(1, order[..., None].expand(B, L, 3))
    valid_s = valid.gather(1, order)
    prev = torch.cat([lin_s.new_full((B, 1), -1), lin_s[:, :-1]], 1)
    newv = (lin_s != prev) & valid_s
    slot = torch.cumsum(newv, dim=-1) - 1
    slot = torch.where(valid_s & (slot < out_budget), slot, out_budget)
    rows = (torch.arange(B, device=lin.device)[:, None] * (out_budget + 1)
            + slot).reshape(-1)
    n = B * (out_budget + 1)
    out_f = feats.new_zeros(n, C).index_add(
        0, rows, torch.where(valid_s[..., None], feats_s, 0).reshape(-1, C))
    out_c = coords.new_full((n, 3), -1)
    out_c[rows] = coords_s.reshape(-1, 3)
    out_v = valid.new_zeros(n)
    out_v[rows] = valid_s.reshape(-1)

    def cut(x):
        return x.reshape(B, out_budget + 1, *x.shape[1:])[:, :out_budget]

    return SparseTensor(cut(out_f), cut(out_c), cut(out_v), a.grid)


def lookup_features(st: SparseTensor, query_coords, query_valid):
    """Features at exact coordinates, [B, Q, C], zeros on a miss (gga_tpu
    ``lookup_features``, ``sparse.py:525``)."""
    return gather_neighbors(st, query_coords, query_valid, 1, 1, 0)[:, 0]


def topk_prune(st: SparseTensor, scores, k_budget):
    """Keep the ``k_budget`` highest-scoring active sites, re-sorted by
    coordinate (gga_tpu ``topk_prune``, ``sparse.py:534``).

    ``jax.lax.top_k`` puts the lower index first among equal scores (the
    8 children of one parent share its score); a stable descending sort
    does the same, and the stable sort by coordinate after it keeps the
    order of the invalid rows."""
    B, N, C = st.features.shape
    s = torch.where(st.valid, scores, -torch.inf)
    top, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    k = min(k_budget, N)
    top, idx = top[:, :k], idx[:, :k]
    keep_valid = torch.isfinite(top)
    coords = st.coords.gather(1, idx[..., None].expand(B, k, 3))
    feats = st.features.gather(1, idx[..., None].expand(B, k, C))
    lin, _ = _linearize(coords, keep_valid, st.grid)
    order = torch.argsort(lin, dim=-1, stable=True)
    return SparseTensor(feats.gather(1, order[..., None].expand(B, k, C)),
                        coords.gather(1, order[..., None].expand(B, k, 3)),
                        keep_valid.gather(1, order), st.grid)


def _ds_prep(grid, kernel_size, stride, padding):
    """Host constants of a strided-conv rulebook: kernel triple, stride
    and pad arrays, output grid, feasible candidate offsets [D, 3], K."""
    ksz = _triple(kernel_size)
    stride_a = np.asarray(_triple(stride), np.int64)
    pad_a = np.asarray(_triple(padding), np.int64)
    out_grid = tuple(
        int((d + 2 * p - k) // s + 1)
        for d, p, k, s in zip(grid, pad_a, ksz, stride_a))
    K = int(np.prod(ksz))
    n_cand = [int(-(-k // s)) for k, s in zip(ksz, stride_a)]
    ds = np.stack(np.meshgrid(*[np.arange(c) for c in n_cand],
                              indexing='ij'), -1).reshape(-1, 3)
    return ksz, stride_a, pad_a, out_grid, ds, K


def _ds_pairs(coords, valid, ksz, stride_a, pad_a, out_grid, ds, K):
    """Per-scene (input, output-candidate) pair streams, sorted by output
    linear id: the <= D feasible candidates of each input.

    Returns (keys [B, D*N] sorted out-lin ids, ``big`` where infeasible;
    pay [B, D*N] = input_row * K + offset_id; newv first-pair-of-site
    flags; big). Within one site each offset has at most one pair, so the
    order of a site's pairs does not matter and the sort need not be
    stable."""
    dev = coords.device
    oz, oy, ox = out_grid
    big = oz * oy * ox
    B, N, _ = coords.shape
    stride_t = torch.as_tensor(stride_a, device=dev)
    ksz_t = torch.tensor(ksz, device=dev)
    cp = coords.long() + torch.as_tensor(pad_a, device=dev)   # [B, N, 3]
    base_o = torch.div(cp, stride_t, rounding_mode='floor')
    o = base_o[:, None] - torch.as_tensor(ds, device=dev)[None, :, None]
    off = cp[:, None] - o * stride_t                          # [B, D, N, 3]
    cover = ((off >= 0) & (off < ksz_t)).all(-1)
    in_rng = ((o >= 0) & (o < torch.tensor(out_grid, device=dev))).all(-1)
    ok = cover & in_rng & valid[:, None, :]
    k_id = off[..., 0] * (ksz[1] * ksz[2]) + off[..., 1] * ksz[2] + off[..., 2]
    payload = torch.arange(N, device=dev) * K + k_id
    lin = o[..., 0] * (oy * ox) + o[..., 1] * ox + o[..., 2]
    lin = torch.where(ok, lin, big).reshape(B, -1)
    keys, order = torch.sort(lin, dim=-1)
    pay = payload.reshape(B, -1).gather(1, order)
    prev = torch.cat([keys.new_full((B, 1), -1), keys[:, :-1]], 1)
    newv = (keys != prev) & (keys < big)
    return keys, pay, newv, big


def _budget_keep(keys, newv, big, out_grid, budget):
    """Per-pair keep mask for distance-priority budget truncation
    (gga_tpu ``sparse._budget_keep``, batched over the leading dim).

    Keeps the ``budget`` sites nearest the ego by BEV voxel distance
    d2 = x^2 + (y - oy//2)^2, ties broken by linear id; gga_tpu's two-key
    (d2, lin) sort is one sort of the int64 key ``d2 * 2^31 + lin``.

    Args:
        keys: [B, L] pair out-lin ids, sorted ascending (``big`` invalid).
        newv: [B, L] first-pair-of-site flags.
    Returns:
        keep [B, L] bool.
    """
    _, oy, ox = out_grid
    rem = keys % (oy * ox)
    y = rem // ox
    x = rem % ox
    d2 = torch.where(keys < big, x * x + (y - oy // 2) ** 2, _IMAX)
    prio = d2 * 2 ** 31 + keys
    site = torch.where(newv, prio, _IMAX * 2 ** 31 + _IMAX)
    i = min(budget, keys.shape[-1]) - 1
    thresh = torch.sort(site, dim=-1).values[:, i:i + 1]
    return (keys < big) & (prio <= thresh)


def parity_k_table(kernel_size, stride):
    """Kernel-offset ids per (input parity class, candidate).

    An input at padded coords c reaches its candidate d through offset
    ``(c mod s) + d * s``, so the offset depends only on the input's
    parity class p = c mod s (``prod(stride)`` classes) and on d.

    Returns (k_of [P, D] int32, feasible [P, D] bool); an infeasible
    (p, d) never links and its entry is 0."""
    ksz = _triple(kernel_size)
    s = _triple(stride)
    n_cand = [int(-(-k // st)) for k, st in zip(ksz, s)]
    ds = np.stack(np.meshgrid(*[np.arange(c) for c in n_cand],
                              indexing='ij'), -1).reshape(-1, 3)
    ps = np.stack(np.meshgrid(*[np.arange(c) for c in s],
                              indexing='ij'), -1).reshape(-1, 3)
    off = ps[:, None, :] + ds[None, :, :] * np.asarray(s)    # [P, D, 3]
    feas = (off < np.asarray(ksz)).all(-1)
    k_of = (off[..., 0] * (ksz[1] * ksz[2]) + off[..., 1] * ksz[2]
            + off[..., 2])
    return np.where(feas, k_of, 0).astype(np.int32), feas


def _rulebook_core(coords, valid, grid, kernel_size, stride, padding,
                   out_budget):
    """What both strided-conv builds share: the output sites, the forward
    map, and the pairs that link them.

    Every output position whose kernel window touches an active input is
    an output site; sites beyond ``out_budget`` are dropped farthest
    first. Each (offset, site) pair has exactly one input, so the scatter
    that builds ``fwd_flat`` is collision-free.

    Returns ((out_coords [B, M, 3] int32 (-1 padded), out_valid [B, M],
    out_grid, fwd_flat [K, B*M] int32 rows into the [B*N] inputs), pairs):
    ``pairs`` is (k_arr, i_arr, slot, slot_ok) [B, D*N] per sorted pair
    (its offset, its input row, its output slot, whether it links) and the
    host constants (ksz, stride_a, pad_a, ds, K)."""
    B, N, _ = coords.shape
    M = out_budget
    dev = coords.device
    ksz, stride_a, pad_a, out_grid, ds, K = _ds_prep(
        grid, kernel_size, stride, padding)
    keys, pay, newv, big = _ds_pairs(coords, valid, ksz, stride_a, pad_a,
                                     out_grid, ds, K)
    keep = _budget_keep(keys, newv, big, out_grid, M)
    newv = newv & keep
    slot = torch.cumsum(newv, dim=-1) - 1
    slot_ok = (keys < big) & keep & (slot >= 0) & (slot < M)

    b_ix = torch.arange(B, device=dev)[:, None]
    k_arr = pay % K
    i_arr = pay // K
    fidx = torch.where(slot_ok, k_arr * (B * M) + b_ix * M + slot, K * B * M)
    fwd = torch.full((K * B * M + 1,), -1, dtype=torch.long, device=dev)
    fwd[fidx.reshape(-1)] = (b_ix * N + i_arr).reshape(-1)
    fwd_flat = fwd[:K * B * M].reshape(K, B * M)

    # output coords from each site's first hit offset:
    # c_out = (c_in + pad - off_k) / stride, exact by construction
    hit = fwd_flat >= 0
    out_valid = hit.any(0)
    k_col = torch.arange(K, device=dev)[:, None]
    first_k = torch.where(hit, k_col, K).amin(0).clamp(max=K - 1)
    i_m = fwd_flat.gather(0, first_k[None])[0]
    ci = coords.reshape(B * N, 3).long()[i_m.clamp(min=0)]
    off_m = torch.as_tensor(_kernel_offsets(ksz), device=dev)[first_k]
    oc = torch.div(ci + torch.as_tensor(pad_a, device=dev) - off_m,
                   torch.as_tensor(stride_a, device=dev),
                   rounding_mode='floor')
    out_coords = torch.where(out_valid[:, None], oc, -1).int()
    out = (out_coords.reshape(B, M, 3), out_valid.reshape(B, M), out_grid,
           fwd_flat.int())
    return out, (k_arr, i_arr, slot, slot_ok, ksz, stride_a, pad_a, ds, K)


def downsample_rulebook_compact(coords, valid, grid, kernel_size, stride,
                                padding, out_budget, backward=False):
    """Output sites and maps of a strided sparse conv (gga_tpu's
    ``downsample_rulebook_compact``).

    Each (candidate, input) pair links to at most one site, so the
    scatter that builds ``bwd_d`` is collision-free too.

    Args:
        coords: [B, N, 3] int, each scene sorted by linear id.
        valid: [B, N] bool.
        backward: also build the compact backward maps.
    Returns:
        (out_coords [B, M, 3] int32 (-1 padded), out_valid [B, M],
         out_grid, fwd_flat [K, B*M] int32 rows into the [B*N] inputs),
        and with ``backward`` also (bwd_d [D, B*N] int32: the row in
        [B*M] of input n's candidate d, -1 where that pair does not link;
        parity [B*N] int32: each input's class in ``parity_k_table``).
    """
    out, pairs = _rulebook_core(coords, valid, grid, kernel_size, stride,
                                padding, out_budget)
    if not backward:
        return out
    k_arr, i_arr, slot, slot_ok, ksz, stride_a, pad_a, ds, _ = pairs
    B, N, _ = coords.shape
    M = out_budget
    dev = coords.device
    b_ix = torch.arange(B, device=dev)[:, None]

    # compact backward map by one scatter (gga_tpu's scatter build,
    # sparse.py:1158-1165): a pair's candidate d is its per-dim offset
    # divided by the stride, since off = (c mod s) + d * s
    kz, ky, kx = ksz
    n_cand = [int(-(-k // s)) for k, s in zip(ksz, stride_a)]
    d_arr = ((k_arr // (ky * kx)) // int(stride_a[0]) * (n_cand[1] * n_cand[2])
             + ((k_arr // kx) % ky) // int(stride_a[1]) * n_cand[2]
             + (k_arr % kx) // int(stride_a[2]))
    D = ds.shape[0]
    bidx = torch.where(slot_ok, d_arr * (B * N) + b_ix * N + i_arr,
                       D * B * N)
    bwd = torch.full((D * B * N + 1,), -1, dtype=torch.long, device=dev)
    bwd[bidx.reshape(-1)] = (b_ix * M + slot).reshape(-1)
    bwd_d = bwd[:D * B * N].reshape(D, B * N).int()

    cp = torch.remainder(coords.long() + torch.as_tensor(pad_a, device=dev),
                         torch.as_tensor(stride_a, device=dev))
    parity = (cp[..., 0] * int(stride_a[1] * stride_a[2])
              + cp[..., 1] * int(stride_a[2]) + cp[..., 2])
    return out + (bwd_d, parity.reshape(B * N).int())


def downsample_rulebook_batched(coords, valid, grid, kernel_size, stride,
                                padding, out_budget):
    """Output sites and maps of a strided sparse conv with a DENSE backward
    map (gga_tpu's ``downsample_rulebook_batched``, ``sparse.py:967``, the
    rulebook of MinkResNet's strided convs).

    Returns:
        (out_coords [B, M, 3] int32 (-1 padded), out_valid [B, M],
         out_grid, fwd_flat [K, B*M] int32 rows into the [B*N] inputs,
         bwd_flat [K, B*N] int32: the row in [B*M] that input n feeds
         through offset k, -1 where it feeds none). Each (offset, input)
         pair links to at most one site, so that scatter is
         collision-free as well.
    """
    out, (k_arr, i_arr, slot, slot_ok, *_, K) = _rulebook_core(
        coords, valid, grid, kernel_size, stride, padding, out_budget)
    B, N, _ = coords.shape
    M = out_budget
    dev = coords.device
    b_ix = torch.arange(B, device=dev)[:, None]
    bidx = torch.where(slot_ok, k_arr * (B * N) + b_ix * N + i_arr,
                       K * B * N)
    bwd = torch.full((K * B * N + 1,), -1, dtype=torch.long, device=dev)
    bwd[bidx.reshape(-1)] = (b_ix * M + slot).reshape(-1)
    return out + (bwd[:K * B * N].reshape(K, B * N).int(),)


class SubMConvFunction(torch.autograd.Function):
    """Submanifold conv on a batch-flat neighbor map (gga_tpu
    ``subm_conv_with_map``, ``sparse.py:610-733``).

    forward(features [R, C], valid [R] bool, nmap [K, R], weights
    [K, C, D] f32) -> [R, D] in the feature dtype, zero on invalid rows.

    The input gradient is the same gather-GEMM on the same map with the
    weights flipped over k and transposed: the submanifold relation is
    symmetric (m is at offset k from n iff n is at offset K-1-k from m).
    It is skipped when the features need no gradient (``conv_input``)."""

    @staticmethod
    def forward(ctx, features, valid, nmap, weights):
        out = sparse_conv.gather_gemm_conv(features, nmap,
                                           weights.to(features.dtype))
        ctx.save_for_backward(features, valid, nmap, weights)
        return torch.where(valid[:, None], out, 0)

    @staticmethod
    def backward(ctx, dout):
        features, valid, nmap, weights = ctx.saved_tensors
        dout = torch.where(valid[:, None], dout, 0).to(
            features.dtype).contiguous()
        df = dw = None
        if ctx.needs_input_grad[0]:
            w_t = weights.flip(0).transpose(1, 2).to(features.dtype)
            df = sparse_conv.gather_gemm_conv(dout, nmap, w_t.contiguous())
            df = torch.where(valid[:, None], df, 0)
        if ctx.needs_input_grad[3]:
            dw = sparse_conv.gather_gemm_dw(features, nmap, dout)
        return df, None, None, dw


class StridedConvFunction(torch.autograd.Function):
    """Strided sparse conv on a compact rulebook (gga_tpu
    ``_rulebook_conv_compact``, ``sparse.py:1198-1258``).

    forward(features [B*N, C], weights [K, C, D] f32, fwd_flat [K, B*M],
    bwd_d [D', B*N], parity [B*N], out_valid [B*M], kernel_size, stride)
    -> [B*M, D] in the feature dtype, zero on invalid rows.

    The input gradient gathers dout through the compact map,
    ``df[n] = sum_d dout[bwd_d[d, n]] @ W[k_of[p(n), d]]^T``: one row
    gather, then one product of the gathered [B*N, D'*Cout] rows with
    every parity class's stacked weights [D'*Cout, P*Cin], of which each
    row keeps its own class's columns. That is gga_tpu's per-parity
    einsum and one-hot contraction (``sparse.py:1237-1242``) without a
    per-row weight gather."""

    @staticmethod
    def forward(ctx, features, weights, fwd_flat, bwd_d, parity, out_valid,
                kernel_size, stride):
        out = sparse_conv.gather_gemm_conv(features, fwd_flat,
                                           weights.to(features.dtype))
        ctx.save_for_backward(features, weights, fwd_flat, bwd_d, parity,
                              out_valid)
        ctx.kernel_size, ctx.stride = kernel_size, stride
        return torch.where(out_valid[:, None], out, 0)

    @staticmethod
    def backward(ctx, dout):
        features, weights, fwd_flat, bwd_d, parity, out_valid = \
            ctx.saved_tensors
        dout = torch.where(out_valid[:, None], dout, 0).to(
            features.dtype).contiguous()
        df = dw = None
        if ctx.needs_input_grad[1]:
            dw = sparse_conv.gather_gemm_dw(features, fwd_flat, dout)
        if ctx.needs_input_grad[0]:
            k_of, feas = parity_k_table(ctx.kernel_size, ctx.stride)
            n_par, n_cand = k_of.shape
            _, c_in, c_out = weights.shape
            dev = weights.device
            w_eff = (weights[torch.as_tensor(k_of, device=dev).long()]
                     * torch.as_tensor(feas, device=dev)[..., None, None])
            # [D', Cout, P, Cin]: row (d, o), column (p, c) holds
            # W[k_of[p, d]][c, o]
            w_cat = w_eff.permute(1, 3, 0, 2).reshape(
                n_cand * c_out, n_par * c_in).to(features.dtype)
            rows = features.shape[0]
            g = gr.gather_rows(dout, bwd_d.t().contiguous().reshape(-1))
            tmp = (g.reshape(rows, n_cand * c_out) @ w_cat).reshape(
                rows, n_par, c_in)
            df = tmp.gather(1, parity.long()[:, None, None].expand(
                rows, 1, c_in))[:, 0]
        return df, dw, None, None, None, None, None, None


class RulebookConvFunction(torch.autograd.Function):
    """Strided sparse conv on a rulebook with a dense backward map
    (gga_tpu ``rulebook_conv``, ``sparse.py:1456-1530``; MinkResNet's
    strided convs).

    forward(features [B*N, C], weights [K, C, D] f32, fwd_flat [K, B*M],
    bwd_flat [K, B*N], out_valid [B*M]) -> [B*M, D] in the feature dtype,
    zero on invalid rows.

    Backward: the weight gradient ``gather_gemm_dw(features, fwd_flat,
    dout)``, and the input gradient the same gather-GEMM as the forward
    on the backward map, ``df[n] = sum_k dout[bwd_flat[k, n]] @ W[k]^T``:
    input n feeds its site through offset k, so unlike the submanifold
    conv the weights are not flipped over k. The input gradient is skipped
    when the features need none (MinkResNet's conv1, whose input is the
    voxels' colours)."""

    @staticmethod
    def forward(ctx, features, weights, fwd_flat, bwd_flat, out_valid):
        out = sparse_conv.gather_gemm_conv(features, fwd_flat,
                                           weights.to(features.dtype))
        ctx.save_for_backward(features, weights, fwd_flat, bwd_flat,
                              out_valid)
        return torch.where(out_valid[:, None], out, 0)

    @staticmethod
    def backward(ctx, dout):
        features, weights, fwd_flat, bwd_flat, out_valid = ctx.saved_tensors
        dout = torch.where(out_valid[:, None], dout, 0).to(
            features.dtype).contiguous()
        df = dw = None
        if ctx.needs_input_grad[1]:
            dw = sparse_conv.gather_gemm_dw(features, fwd_flat, dout)
        if ctx.needs_input_grad[0]:
            w_t = weights.transpose(1, 2).to(features.dtype).contiguous()
            df = sparse_conv.gather_gemm_conv(dout, bwd_flat, w_t)
        return df, dw, None, None, None


def sparse_inverse_conv(features, weights, fwd_flat, bwd_flat, in_valid):
    """SparseInverseConv3d (gga_tpu ``sparse_inverse_conv``,
    ``sparse.py:1532``; spconv's indice_key reuse in SparseUNet's decoder):
    the downsampled features deconvolved back onto the PRE-downsample
    active set of the strided conv whose rulebook is given.

    ``out[n] = sum_k features[bwd_flat[k, n]] @ W[k]``: the strided conv's
    ``RulebookConvFunction`` with its two maps in each other's roles. Its
    input gradient is then the gather-GEMM on ``fwd_flat`` with ``W^T``,
    its weight gradient ``gather_gemm_dw(features, bwd_flat, dout)``. A
    pre-downsample row that feeds no site through offset k is -1 in
    ``bwd_flat`` and takes nothing from k (gga_tpu's ``hit`` False).

    Args:
        features: [B*M, C_low] downsampled features.
        weights: [K, C_low, C_out] f32.
        fwd_flat / bwd_flat: ``downsample_rulebook_batched``'s maps of the
            matching strided conv ([K, B*M] and [K, B*N]).
        in_valid: [B*N] validity of the pre-downsample set.
    Returns:
        [B*N, C_out], zero on invalid rows.
    """
    return RulebookConvFunction.apply(features, weights, bwd_flat, fwd_flat,
                                      in_valid)
