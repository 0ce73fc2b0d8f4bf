"""Masked row gather, row-major and transposed: the CUDA kernels and their
plain PyTorch versions.

``gather_rows(src [N, C], idx [M] int32) -> [M, C]`` with a zero row where
``idx`` is -1: the contract of gga_tpu's ``_rb_gather``
(``ops/sparse.py:1467-1472``) and the port of the TPU row gathers
``gga_tpu/ops/pallas/gather_rows.py`` (``gather_rows_pallas``,
``gather_rows_unroll``, ``gather_rows_vec``). The strided conv's input
gradient gathers its dout rows through the compact backward map with it.

``gather_rows_t(src [R, C], nmap [K, Q] int32) -> [K, C, Q]`` is the same
gather stored transposed: the function of gga_tpu's ``window_gather_t``
(``ops/pallas/window_gather.py:378``, kernel ``_window_gather_t``), without
its TPU window. gga_tpu runs it only behind ``GGA_WINDOW_GATHER=1``; the
port's main path does not call it.

On a CPU tensor each wrapper runs its plain version. On a CUDA tensor it
launches its kernel (``csrc/gather_rows.cu``) or raises; an index past
the source rows stops the kernel with an error.
"""
from __future__ import annotations

import torch

from . import _build
from ._build import I, P

launches = 0    # gather_rows launches since the caller set this to 0
t_launches = 0  # gather_rows_t launches since the caller set this to 0

_NAME = 'gather_rows'
_SIG = {'gga_gather_rows': ([P] * 3 + [I] * 4 + [P], I),
        'gga_gather_rows_t': ([P] * 3 + [I] * 5 + [P], I)}
_DTYPES = (torch.bfloat16, torch.float32)


def gather_rows_plain(src, idx):
    """``where(idx >= 0, src[idx], 0)``, rows of ``src`` by ``idx``."""
    hit = (idx >= 0)[:, None]
    return torch.where(hit, src[idx.clamp(min=0)], 0).to(src.dtype)


def gather_rows_t_plain(src, nmap):
    """``where(nmap >= 0, src[nmap], 0)`` transposed to [K, C, Q]."""
    K, Q = nmap.shape
    return gather_rows_plain(src, nmap.reshape(-1)).reshape(
        K, Q, -1).transpose(1, 2).contiguous()


def build():
    """Compile (once per source version) and load the kernels."""
    return _build.load(_NAME, _SIG)


def _check(what, src, idx, idx_dims):
    _build.check_cuda(what, [('src', src), ('idx', idx)], ('src',))
    if src.dtype not in _DTYPES:
        raise TypeError(f'{what}: the CUDA kernel takes bf16 or f32 rows, '
                        f'got {src.dtype}')
    if idx.dtype != torch.int32:
        raise TypeError(f'{what}: indices must be int32, got {idx.dtype}')
    if src.dim() != 2 or idx.dim() != idx_dims:
        raise ValueError(f'{what}: expected src [N, C] and a {idx_dims}-d '
                         'index')


def gather_rows(src, idx):
    """[M, C]: ``src[idx[m]]``, or zeros where ``idx[m]`` is -1."""
    global launches
    if src.device.type == 'cpu':
        return gather_rows_plain(src, idx)
    _check('gather_rows', src, idx, 1)
    N, C = src.shape
    M = idx.shape[0]
    out = torch.empty((M, C), dtype=src.dtype, device=src.device)
    if out.numel() >= 2 ** 31:
        raise ValueError('gather_rows: the output overflows the kernel\'s '
                         'int32 sizes')
    if out.numel() == 0:
        return out
    lib = build()
    with torch.cuda.device(src.device):
        err = lib.gga_gather_rows(src.data_ptr(), idx.data_ptr(),
                                  out.data_ptr(), N, M, C, src.element_size(),
                                  _build.stream_of(src))
    _build.check_launch('gather_rows', err)
    launches += 1
    return out


def gather_rows_t(src, nmap):
    """[K, C, Q]: ``out[k, :, q] = src[nmap[k, q]]``, zeros where -1."""
    global t_launches
    if src.device.type == 'cpu':
        return gather_rows_t_plain(src, nmap)
    _check('gather_rows_t', src, nmap, 2)
    R, C = src.shape
    K, Q = nmap.shape
    out = torch.empty((K, C, Q), dtype=src.dtype, device=src.device)
    if out.numel() >= 2 ** 31:
        raise ValueError('gather_rows_t: the output overflows the kernel\'s '
                         'int32 sizes')
    if out.numel() == 0:
        return out
    lib = build()
    with torch.cuda.device(src.device):
        err = lib.gga_gather_rows_t(src.data_ptr(), nmap.data_ptr(),
                                    out.data_ptr(), R, C, K, Q,
                                    src.element_size(), _build.stream_of(src))
    _build.check_launch('gather_rows_t', err)
    t_launches += 1
    return out
