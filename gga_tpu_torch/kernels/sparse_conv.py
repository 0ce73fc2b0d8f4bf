"""Fused gather-GEMM sparse convolution and its weight gradient: the CUDA
kernels and their plain PyTorch versions.

``gather_gemm_conv(features [R, C], nmap [K, Q], weights [K, C, D])``
computes ``out[q] = sum_k [nmap[k, q] >= 0] * features[nmap[k, q]] @
weights[k]`` with an f32 sum rounded once to the input dtype. It is the
port of ``gga_tpu/ops/pallas/window_gather.py:_window_conv`` and runs the
forward of every sparse conv of the encoder (submanifold convs through
their neighbor map, strided convs through their rulebook map) and the
input gradient of every submanifold conv (same map, weights flipped over
k and transposed).

``gather_gemm_dw(features [R, C], nmap [K, Q], dout [Q, D])`` computes
the weight gradient ``dW[k] = sum_q [nmap[k, q] >= 0] *
features[nmap[k, q]]^T dout[q]`` as f32 ``[K, C, D]``: the port of
``window_gather.py:_window_dw``, used by every sparse conv's backward.

On a CPU tensor each wrapper runs its plain version. On a CUDA tensor it
launches its kernel (``csrc/gather_gemm.cu``, ``csrc/gather_gemm_dw.cu``)
or raises. Both kernels take bf16 or f32 inputs, the two operands of one
dtype: bf16 runs the tensor-core entries (``*_bf16``), f32 the FFMA
entries (``*_f32``), so that f32 means f32 on the card as on the CPU.
"""
from __future__ import annotations

import torch

from . import _build
from ._build import I, P

launches = 0     # gather_gemm_conv launches since the caller set this to 0
dw_launches = 0  # gather_gemm_dw launches since the caller set this to 0

_CONV = 'gather_gemm'
_DW = 'gather_gemm_dw'
_CONV_SIG = {'gga_gather_gemm_conv_bf16': ([P] * 4 + [I] * 5 + [P], I),
             'gga_gather_gemm_conv_f32': ([P] * 4 + [I] * 5 + [P], I),
             'gga_gather_gemm_smem_bytes': ([I], I),
             'gga_gather_gemm_smem_bytes_f32': ([I], I)}
_DW_SIG = {'gga_gather_gemm_dw_bf16': ([P] * 5 + [I] * 6 + [P], I),
           'gga_gather_gemm_dw_f32': ([P] * 5 + [I] * 6 + [P], I),
           'gga_gather_gemm_dw_splits': ([I] * 4, I),
           'gga_gather_gemm_dw_splits_f32': ([I] * 4, I)}
# the C entries' suffix of each dtype the kernels take
_SUFFIX = {torch.bfloat16: 'bf16', torch.float32: 'f32'}


def gather_gemm_conv_plain(features, nmap, weights):
    """Gather + einsum in plain PyTorch: the kernel's reference.

    Misses (``nmap < 0``) contribute zero rows. Products are summed in
    f32 and the result is cast to ``features.dtype``, as
    ``jnp.einsum(..., preferred_element_type=float32).astype`` does in
    gga_tpu (``ops/sparse.py:653-659``)."""
    hit = (nmap >= 0)[..., None]
    g = torch.where(hit, features[nmap.clamp(min=0)], 0)     # [K, Q, C]
    out = torch.einsum('kqc,kcd->qd', g.float(), weights.float())
    return out.to(features.dtype)


def gather_gemm_dw_plain(features, nmap, dout):
    """``dW[k] = where(nmap[k] >= 0, features[nmap[k]], 0)^T @ dout`` in
    f32, as gga_tpu's ``einsum('knc,nd->kcd', ...,
    preferred_element_type=float32)`` (``ops/sparse.py:715-719``)."""
    hit = (nmap >= 0)[..., None]
    g = torch.where(hit, features[nmap.clamp(min=0)], 0)     # [K, Q, C]
    return torch.einsum('kqc,qd->kcd', g.float(), dout.float())


def build():
    """Compile (once per source version) and load the forward kernel."""
    return _build.load(_CONV, _CONV_SIG)


def build_dw():
    """Compile (once per source version) and load the dW kernel."""
    return _build.load(_DW, _DW_SIG)


def _check(what, features, nmap, other, other_name, aligned):
    """Raise on what the kernels do not take; returns the C entries'
    dtype suffix."""
    _build.check_cuda(what, [('features', features), ('nmap', nmap),
                             (other_name, other)], aligned)
    if features.dtype not in _SUFFIX or other.dtype != features.dtype:
        raise TypeError(f'{what}: the CUDA kernel takes bf16 or f32 '
                        f'features and {other_name} of one dtype, got '
                        f'{features.dtype} and {other.dtype}')
    if nmap.dtype != torch.int32:
        raise TypeError(f'{what}: nmap must be int32, got {nmap.dtype}')
    if features.dim() != 2 or nmap.dim() != 2:
        raise ValueError(f'{what}: expected features [R, C] and nmap [K, Q]')
    return _SUFFIX[features.dtype]


def gather_gemm_conv(features, nmap, weights):
    """``out [Q, D] = sum_k where(nmap[k] >= 0, features[nmap[k]], 0) @
    weights[k]``; f32 sum, output in ``features.dtype``.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (bf16 or f32, features and weights of one dtype) or raise; an index
    >= R stops the kernel with an error."""
    global launches
    if features.device.type == 'cpu':
        return gather_gemm_conv_plain(features, nmap, weights)
    dt = _check('gather_gemm_conv', features, nmap, weights, 'weights',
                ('features', 'weights'))
    if weights.dim() != 3:
        raise ValueError('gather_gemm_conv: expected weights [K, C, D]')
    K, C, D = weights.shape
    if nmap.shape[0] != K or features.shape[1] != C:
        raise ValueError(f'gather_gemm_conv: shapes disagree: features '
                         f'{tuple(features.shape)}, nmap {tuple(nmap.shape)}'
                         f', weights {tuple(weights.shape)}')
    lib = build()
    Q = nmap.shape[1]
    smem = (lib.gga_gather_gemm_smem_bytes_f32 if dt == 'f32'
            else lib.gga_gather_gemm_smem_bytes)
    if smem(C) > _build.MAX_SMEM:
        raise ValueError(f'gather_gemm_conv: input width C={C} needs more '
                         'shared memory than a block has')
    out = torch.empty((Q, D), dtype=features.dtype, device=features.device)
    if Q == 0 or D == 0:
        return out
    with torch.cuda.device(features.device):
        err = getattr(lib, f'gga_gather_gemm_conv_{dt}')(
            features.data_ptr(), nmap.data_ptr(), weights.data_ptr(),
            out.data_ptr(), features.shape[0], C, K, Q, D,
            _build.stream_of(features))
    _build.check_launch('gather_gemm_conv', err)
    launches += 1
    return out


def gather_gemm_dw(features, nmap, dout):
    """``dW [K, C, D] f32 = sum_q where(nmap[:, q] >= 0,
    features[nmap[:, q]], 0)^T dout[q]``.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (bf16 or f32 features and dout of one dtype) or raise. The kernel
    splits Q over blocks, writes each split's partial sum to an f32
    scratch and adds the splits in a fixed order, so the result is the
    same from run to run."""
    global dw_launches
    if features.device.type == 'cpu':
        return gather_gemm_dw_plain(features, nmap, dout)
    dt = _check('gather_gemm_dw', features, nmap, dout, 'dout',
                ('features', 'dout'))
    if dout.dim() != 2 or dout.shape[0] != nmap.shape[1]:
        raise ValueError(f'gather_gemm_dw: shapes disagree: nmap '
                         f'{tuple(nmap.shape)}, dout {tuple(dout.shape)}')
    R, C = features.shape
    K, Q = nmap.shape
    D = dout.shape[1]
    lib = build_dw()
    out = torch.empty((K, C, D), dtype=torch.float32, device=features.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(features.device):
        splits = (lib.gga_gather_gemm_dw_splits_f32 if dt == 'f32'
                  else lib.gga_gather_gemm_dw_splits)(K, C, D, Q)
        if splits < 1:
            raise ValueError(f'gather_gemm_dw: (K, C, D) = {(K, C, D)} needs '
                             'more shared memory than a block has')
        scratch = torch.empty((splits, K, C, D), dtype=torch.float32,
                              device=features.device)
        if scratch.numel() >= 2 ** 31:
            raise ValueError('gather_gemm_dw: the split scratch overflows '
                             'the kernel\'s int32 sizes')
        err = getattr(lib, f'gga_gather_gemm_dw_{dt}')(
            features.data_ptr(), nmap.data_ptr(), dout.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), R, C, K, Q, D, splits,
            _build.stream_of(features))
    _build.check_launch('gather_gemm_dw', err)
    dw_launches += 1
    return out
