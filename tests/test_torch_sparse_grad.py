"""Sparse conv gradients and the strided conv's backward maps against
gga_tpu, on the CPU.

The compact backward map ``bwd_d`` and the ``parity`` classes must equal
gga_tpu's exactly. The autograd Functions' feature and weight gradients
must equal ``jax.grad`` of gga_tpu's custom VJPs (its default einsum path,
and for the submanifold conv also the Pallas ``_window_conv`` /
``_window_dw`` path in interpret mode) at rtol 1e-5 plus an atol of 1e-5
of the gradient's largest entry: all sum in f32, only the order of the
sums differs, and a weight gradient sums thousands of products, so its
rounding error scales with the products' size, not with an entry that
happens to cancel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gga_tpu.models import layers as jl
from gga_tpu.ops import sparse as jsp
from gga_tpu_torch.models import layers as tl
from gga_tpu_torch.ops import sparse as tsp

from .test_torch_sparse import GRID, _active_sets, _jax_nmap, _jax_rulebook

torch.set_num_threads(1)


@pytest.mark.parametrize('ksz,stride,pad,budget', [
    ((3, 3, 3), (2, 2, 2), 1, 1024),
    ((3, 3, 3), (2, 2, 2), 1, 300),          # budget saturates
    ((3, 1, 1), (2, 1, 1), 0, 1024),
])
def test_backward_maps_match_gga_tpu(ksz, stride, pad, budget):
    coords, valid = _active_sets(seed=2)
    *_, jbwd, jpar = _jax_rulebook(jnp.asarray(coords), jnp.asarray(valid),
                                   GRID, ksz, stride, pad, budget)
    *_, bwd, par = tsp.downsample_rulebook_compact(
        torch.from_numpy(coords), torch.from_numpy(valid), GRID, ksz,
        stride, pad, budget, backward=True)
    assert bwd.dtype == torch.int32 and par.dtype == torch.int32
    np.testing.assert_array_equal(bwd.numpy(), np.asarray(jbwd))
    np.testing.assert_array_equal(par.numpy(), np.asarray(jpar))
    assert (bwd.numpy() >= 0).any() and (bwd.numpy() < 0).any()


@pytest.mark.parametrize('ksz,stride', [((3, 3, 3), (2, 2, 2)),
                                        ((3, 1, 1), (2, 1, 1))])
def test_parity_k_table_matches_gga_tpu(ksz, stride):
    k_of, feas = tsp.parity_k_table(ksz, stride)
    jk, jf = jsp.parity_k_table(ksz, stride)
    np.testing.assert_array_equal(k_of, jk)
    np.testing.assert_array_equal(feas, jf)


def _grads(f, w, ct, run):
    """(dF, dW) of sum(run(f, w) * ct) in the port."""
    f = torch.from_numpy(f).requires_grad_()
    w = torch.from_numpy(w).requires_grad_()
    (run(f, w) * torch.from_numpy(ct)).sum().backward()
    return f.grad.numpy(), w.grad.numpy()


def _close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def _jax_grads(f, w, ct, run):
    return jax.grad(lambda a, b: (run(a, b) * ct).sum(), argnums=(0, 1))(
        jnp.asarray(f), jnp.asarray(w))


def _subm_case(c, d, seed):
    rng = np.random.RandomState(seed)
    coords, valid = _active_sets(P=800, V=512, seed=3)
    jmap, jhit = jl.flatten_nmap(*_jax_nmap(coords, valid))
    nmap = tl.flatten_nmap(tsp.build_neighbor_map(
        torch.from_numpy(coords), torch.from_numpy(valid), GRID))
    f = (rng.randn(valid.size, c) * valid.reshape(-1, 1)).astype(np.float32)
    w = (rng.randn(27, c, d) * 0.2).astype(np.float32)
    ct = rng.randn(valid.size, d).astype(np.float32)
    return valid.reshape(-1), jmap, jhit, nmap, f, w, ct


@pytest.mark.parametrize('jax_fn,c,d', [
    ('subm_conv_with_map', 4, 16), ('subm_conv_with_map', 8, 8),
    ('subm_conv_window', 8, 8)])
def test_subm_conv_grads_match_gga_tpu(jax_fn, c, d):
    """``subm_conv_window`` runs gga_tpu's Pallas _window_conv and
    _window_dw (interpret mode on the CPU, one width: its compile takes
    most of this file's time)."""
    valid, jmap, jhit, nmap, f, w, ct = _subm_case(c, d, seed=c + d)
    jv = jnp.asarray(valid)
    jdf, jdw = _jax_grads(f, w, ct, lambda a, b: getattr(jsp, jax_fn)(
        a, jv, jmap, jhit, b))
    tv = torch.from_numpy(valid)
    df, dw = _grads(f, w, ct, lambda a, b: tsp.SubMConvFunction.apply(
        a, tv, nmap, b))
    assert np.abs(jdw).max() > 0.1 and np.abs(jdf).max() > 0.1
    _close(df, jdf)
    _close(dw, jdw)


@pytest.mark.parametrize('ksz,stride,pad,c,d', [
    ((3, 3, 3), (2, 2, 2), 1, 4, 16),
    ((3, 3, 3), (2, 2, 2), (0, 1, 1), 8, 8),
    ((3, 1, 1), (2, 1, 1), 0, 8, 16),
])
def test_strided_conv_grads_match_gga_tpu(ksz, stride, pad, c, d):
    rng = np.random.RandomState(c * d)
    coords, valid = _active_sets(seed=5)
    M = 512
    _, jov, _, jfwd, jbwd, jpar = _jax_rulebook(
        jnp.asarray(coords), jnp.asarray(valid), GRID, ksz, stride, pad, M)
    _, ov, _, fwd, bwd, par = tsp.downsample_rulebook_compact(
        torch.from_numpy(coords), torch.from_numpy(valid), GRID, ksz, stride,
        pad, M, backward=True)
    K = int(np.prod(ksz))
    f = (rng.randn(valid.size, c) * valid.reshape(-1, 1)).astype(np.float32)
    w = (rng.randn(K, c, d) * 0.2).astype(np.float32)
    ct = rng.randn(jov.size, d).astype(np.float32)
    jdf, jdw = _jax_grads(f, w, ct, lambda a, b: jsp.rulebook_conv_compact(
        a, b, jfwd, jbwd, jpar, jov.reshape(-1), ksz, stride))
    df, dw = _grads(f, w, ct, lambda a, b: tsp.StridedConvFunction.apply(
        a, b, fwd, bwd, par, ov.reshape(-1), ksz, stride))
    assert np.abs(jdw).max() > 0.1 and np.abs(jdf).max() > 0.1
    _close(df, jdf)
    _close(dw, jdw)


def test_weight_grad_is_f32_for_bf16_features():
    """The weights enter the Function in f32 and are cast inside, so dW is
    summed and returned in f32 as gga_tpu's (the same bf16 products)."""
    valid, jmap, jhit, nmap, f, w, ct = _subm_case(8, 16, seed=11)
    fb = torch.from_numpy(f).bfloat16().requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tsp.SubMConvFunction.apply(fb, torch.from_numpy(valid), nmap, wt)
    ctb = torch.from_numpy(ct).bfloat16()
    (out.float() * ctb.float()).sum().backward()
    assert out.dtype == torch.bfloat16 and fb.grad.dtype == torch.bfloat16
    assert wt.grad.dtype == torch.float32
    jv = jnp.asarray(valid)
    _, jdw = jax.grad(lambda a, b: (jsp.subm_conv_with_map(
        a, jv, jmap, jhit, b).astype(jnp.float32)
        * jnp.asarray(ctb.float().numpy())).sum(), argnums=(0, 1))(
            jnp.asarray(f, jnp.bfloat16), jnp.asarray(w))
    assert jdw.dtype == jnp.float32
    _close(wt.grad.numpy(), jdw)
