"""The f32 sparse-conv kernels' 3xTF32 arithmetic, emulated in torch on
the CPU, against gga_tpu's TPU kernels (``_window_conv``, ``_window_dw``
in f32, interpret mode) and against f64 numpy.

The CUDA kernels (``csrc/gather_tile.cuh``: ``split_tf32``,
``mma_3xtf32``) split each f32 operand into TF32 parts, ``hi`` = x
truncated to TF32 and ``lo = x - hi``, of which the tensor core reads the
TF32 truncation, and take each product as ``lo_a hx_b + hx_a lo_b + hi_a
hi_b`` with f32 sums, where ``hx`` is ``hi`` for a finite operand and 0
for inf or NaN (whose ``lo`` is 0 too). A product of two TF32 values is
exact in f32, so an f32 einsum of the TF32 parts is the tensor cores'
arithmetic up to the order of the sums (the kernels sum at most four
8-deep k-steps on the tensor core and add that to their running sums with
f32 adds). Tolerances are the card gates': conv within 1e-5 and dW within
2e-5 of max|reference|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gga_tpu.ops.pallas import window_gather as wg
from gga_tpu_torch.kernels import sparse_conv

from .test_torch_pallas_plain import _flat_map, _window_operands

torch.set_num_threads(1)

EXP = 0x7f800000
MASK = 0xffffe000  # a TF32 value: the 13 low mantissa bits zero


def _bits(x):
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xffffffff


def _float(b):
    b = torch.where(b >= 2 ** 31, b - 2 ** 32, b)
    return b.to(torch.int32).view(torch.float32)


def _tf32(x):
    """x as the tensor core reads a TF32 operand: truncated."""
    return _float(_bits(x) & MASK)


def split_tf32(x):
    """(hi, lo, hx) as the kernels' split_tf32 makes them, lo as the
    tensor core reads it."""
    hi = _tf32(x)
    finite = hi.abs() < np.inf
    zero = torch.zeros_like(x)
    lo = torch.where(finite, _tf32(torch.where(finite, x - hi, zero)), zero)
    return hi, lo, torch.where(finite, hi, zero)


def _gathered(f, nmap):
    hit = (nmap >= 0)[..., None]
    return torch.where(hit, f[nmap.clamp(min=0).long()], 0)   # [K, Q, C]


def conv_3xtf32(f, nmap, w):
    """gather_gemm_conv as the f32 kernel computes it."""
    gh, gl, gx = split_tf32(_gathered(f, nmap))
    wh, wl, wx = split_tf32(w)
    e = 'kqc,kcd->qd'
    return (torch.einsum(e, gl, wx) + torch.einsum(e, gx, wl)
            + torch.einsum(e, gh, wh))


def dw_3xtf32(f, nmap, dout):
    """gather_gemm_dw as the f32 kernel computes it."""
    gh, gl, gx = split_tf32(_gathered(f, nmap))
    dh, dl, dx = split_tf32(dout)
    e = 'kqc,qd->kcd'
    return (torch.einsum(e, gl, dx) + torch.einsum(e, gx, dl)
            + torch.einsum(e, gh, dh))


def _within(out, ref, rtol):
    ref = np.asarray(ref, np.float64)
    err = np.abs(np.asarray(out, np.float64) - ref).max()
    assert err <= rtol * np.abs(ref).max(), (err, np.abs(ref).max())


def test_split_parts_are_tf32_and_sum_to_x():
    rng = np.random.RandomState(0)
    x = (rng.randn(20000) * np.exp2(rng.randint(-120, 120, 20000))
         ).astype(np.float32)
    x = np.concatenate([x, np.float32([0., -0., 1e-40, -3e-42, 1.5, 3.0])])
    hi, lo, hx = split_tf32(torch.from_numpy(x))
    for part in (hi, lo, hx):
        assert ((_bits(part) & ~MASK & 0xffffffff) == 0).all()
    assert torch.equal(hi, hx)
    err = np.abs(x.astype(np.float64) - hi.double().numpy() - lo.double().numpy())
    # a lo below the normal range keeps TF32's 10 bits of its subnormal
    # pattern: an absolute 2^-136 at most
    assert (err <= np.exp2(-20) * np.abs(x) + np.exp2(-136)).all()
    # a TF32 product is exact in f32: the three terms of x * y lose
    # nothing but the dropped lo * lo and the bits of the two lo below
    # TF32 (each below 2^-20 |xy|), and two roundings
    y = np.float32(rng.randn(x.size))
    yh, yl, yx = split_tf32(torch.from_numpy(y))
    prod = lo * yx + hx * yl + hi * yh
    exact = x.astype(np.float64) * y
    fin = (np.abs(exact) < 1e38) & (np.abs(x) > 1e-30) & (np.abs(y) > 1e-30)
    rel = np.abs(prod.double().numpy() - exact)[fin]
    assert (rel <= 3.5 * np.exp2(-20) * np.abs(exact[fin])).all()
    assert np.median(rel / np.abs(exact[fin])) < np.exp2(-20)


def test_split_keeps_inf_nan_and_flt_max():
    big = np.finfo(np.float32).max
    x = torch.tensor([np.inf, -np.inf, np.nan, big, -big, 1e-45],
                     dtype=torch.float32)
    hi, lo, hx = split_tf32(x)
    assert hi[0] == np.inf and hi[1] == -np.inf and torch.isnan(hi[2])
    assert (lo[:3] == 0).all() and (hx[:3] == 0).all()
    # FLT_MAX would round up to inf: truncated, hi stays finite
    assert torch.isfinite(hi[3:]).all() and torch.isfinite(lo[3:]).all()
    assert abs(float(hi[3].double() + lo[3].double()) - float(big)) <= (
        np.exp2(-22) * float(big))
    # inf times an exact TF32 value (lo = 0) stays inf, as with FFMA
    y = torch.tensor([0.5, -2.0, 0.5, 2 ** -10, -2 ** -10, 3.0])
    yh, yl, yx = split_tf32(y)
    prod = lo * yx + hx * yl + hi * yh
    assert prod[0] == np.inf and prod[1] == np.inf and torch.isnan(prod[2])
    assert torch.isfinite(prod[3:]).all()
    ref = x.double() * y.double()
    assert torch.equal(torch.isfinite(prod), torch.isfinite(ref))


@pytest.mark.parametrize('c,d,k', [(8, 16, 27), (32, 32, 27), (128, 128, 27),
                                   (16, 64, 3)])
def test_conv_3xtf32_matches_window_conv_and_f64(c, d, k):
    jmap, jhit, nmap = _flat_map(seed=6)
    jmap, jhit, nmap = jmap[:k], jhit[:k], nmap[:k]
    rng = np.random.RandomState(c + d)
    q = nmap.shape[1]
    f = rng.randn(q, c).astype(np.float32)
    w = (rng.randn(k, c, d) * 0.2).astype(np.float32)
    fwide, bb, cols, _ = _window_operands(jmap, jhit, f, wg.TILE)
    ref = np.asarray(wg._window_conv(fwide, c, d, bb, cols, jnp.asarray(w),
                                     interpret=True))[:q]
    out = conv_3xtf32(torch.from_numpy(f), torch.from_numpy(nmap),
                      torch.from_numpy(w)).numpy()
    g = np.where((nmap >= 0)[..., None], f[np.maximum(nmap, 0)], 0)
    f64 = np.einsum('kqc,kcd->qd', g.astype(np.float64), w.astype(np.float64))
    assert np.abs(f64).max() > 1
    _within(out, ref, 1e-5)
    _within(out, f64, 1e-5)
    _within(sparse_conv.gather_gemm_conv_plain(
        torch.from_numpy(f), torch.from_numpy(nmap),
        torch.from_numpy(w)).numpy(), f64, 1e-5)


@pytest.mark.parametrize('c,d', [(8, 32), (32, 16), (128, 128)])
def test_dw_3xtf32_matches_window_dw_and_f64(c, d):
    jmap, jhit, nmap = _flat_map(seed=7)
    rng = np.random.RandomState(c + d + 1)
    q = nmap.shape[1]
    f = rng.randn(q, c).astype(np.float32)
    dout = rng.randn(q, d).astype(np.float32)
    fwide, bb, cols, qp = _window_operands(jmap, jhit, f,
                                           wg.GROUP * wg.TILE)
    ref = np.asarray(wg._window_dw(fwide, c, d, bb, cols,
                                   jnp.pad(jnp.asarray(dout), ((0, qp),
                                                               (0, 0))),
                                   interpret=True))
    out = dw_3xtf32(torch.from_numpy(f), torch.from_numpy(nmap),
                    torch.from_numpy(dout)).numpy()
    g = np.where((nmap >= 0)[..., None], f[np.maximum(nmap, 0)], 0)
    f64 = np.einsum('kqc,qd->kcd', g.astype(np.float64),
                    dout.astype(np.float64))
    assert np.abs(f64).max() > 1
    _within(out, ref, 2e-5)
    _within(out, f64, 2e-5)


def test_conv_3xtf32_keeps_the_plain_finiteness():
    """inf, FLT_MAX and denormal inputs: the emulated kernel is finite
    exactly where the plain f32 version is."""
    rng = np.random.RandomState(3)
    f = rng.randn(200, 16).astype(np.float32)
    f[3, 2], f[7, 5], f[11, 0] = np.inf, -np.inf, 1e-41
    f[20, 4] = np.finfo(np.float32).max
    w = (rng.randn(27, 16, 8) * 2 ** -12).astype(np.float32)
    w[13, 2, :4] = 0.5                     # exact TF32: lo = 0
    nmap = rng.randint(-1, 200, (27, 300)).astype(np.int32)
    args = [torch.from_numpy(a) for a in (f, nmap, w)]
    out = conv_3xtf32(*args)
    ref = sparse_conv.gather_gemm_conv_plain(*args)
    assert (~torch.isfinite(ref)).any() and torch.isfinite(ref).any()
    assert torch.equal(torch.isfinite(out), torch.isfinite(ref))
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
