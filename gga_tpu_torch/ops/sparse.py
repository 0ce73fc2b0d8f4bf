"""Sparse 3D convolution: neighbor maps for submanifold convs, the
compact rulebook of strided convs, and the two convs as autograd
Functions (port of ``gga_tpu/ops/sparse.py``, default flags).

Active voxels live in a fixed budget ``N`` per scene, sorted by
linearized (z, y, x) id with invalid rows parked at the end. Maps index
the batch-flat ``[B*N, C]`` feature array, with -1 for a miss, so that one
``kernels.sparse_conv.gather_gemm_conv`` launch covers the whole batch.

The Functions mirror gga_tpu's custom VJPs (``subm_conv_with_map``,
``_rulebook_conv_compact``): they take the f32 weights, cast them to the
feature dtype inside, and return the weight gradient in f32.
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


def build_neighbor_map(coords, valid, grid, kernel_size=(3, 3, 3)):
    """Gather map of a submanifold conv on this active set, shared by
    every SubM conv of a stage (gga_tpu ``build_neighbor_map`` with all
    K offsets resolved directly, its default).

    Each query ``coords + offset - pad`` is looked up in the scene's
    sorted linear-id table with ``torch.searchsorted``.

    Args:
        coords: [B, N, 3] int (z, y, x), each scene sorted by linear id.
        valid: [B, N] bool.
    Returns:
        nmap [B, K, N] int32: row of the neighbor within its scene, -1 miss.
    """
    k = _triple(kernel_size)
    pad = torch.tensor([(x - 1) // 2 for x in k], device=coords.device)
    offs = torch.as_tensor(_kernel_offsets(k), device=coords.device)
    B, N, _ = coords.shape
    K = offs.shape[0]
    lin_in, _ = _linearize(coords, valid, grid)                # [B, N]
    tgt = coords.long()[:, None] - pad + offs[None, :, None]   # [B, K, N, 3]
    dims = torch.tensor(grid, device=coords.device)
    in_bounds = ((tgt >= 0) & (tgt < dims)).all(-1)
    nz, ny, nx = grid
    lin_t = (tgt[..., 0] * (ny * nx) + tgt[..., 1] * nx
             + tgt[..., 2]).reshape(B, K * N)
    pos = torch.searchsorted(lin_in, lin_t, right=True) - 1
    pos_c = pos.clamp(min=0)
    hit = (pos >= 0) & (lin_in.gather(1, pos_c) == lin_t)
    hit = hit.reshape(B, K, N) & in_bounds & valid[:, None, :]
    return torch.where(hit, pos_c.reshape(B, K, N), -1).int()


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


def downsample_rulebook_compact(coords, valid, grid, kernel_size, stride,
                                padding, out_budget, backward=False):
    """Output sites and maps of a strided sparse conv (gga_tpu's
    ``downsample_rulebook_compact``).

    Every output position whose kernel window touches an active input is
    an output site; sites beyond ``out_budget`` are dropped farthest
    first. Each (offset, site) pair has exactly one input and each
    (candidate, input) pair at most one site, so the scatters that build
    ``fwd_flat`` and ``bwd_d`` are collision-free.

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
    if not backward:
        return out

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
