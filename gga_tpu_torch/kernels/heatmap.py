"""Gaussian heatmap targets of a whole train step in one launch: the CUDA
kernel and its plain PyTorch version.

``render_heatmap(centers [G, M, 2] int32, radii [G, M] int32, valid [G, M]
bool, hw) -> [G, H, W] f32`` renders G maps, each the max over its valid
objects of a gaussian window, exactly 1.0 at every centre. It is the port
of ``gga_tpu/ops/pallas/heatmap.py:render_heatmap_pallas``, batched over
maps; ``build_targets`` renders all B * sum(classes) maps of a step with it.

On a CPU tensor the wrapper runs ``render_heatmap_plain``
(``core.gaussian.render_heatmaps``). On a CUDA tensor it launches the
kernel in ``csrc/heatmap.cu`` or raises.
"""
from __future__ import annotations

import torch

from ..core.gaussian import render_heatmaps as render_heatmap_plain
from . import _build
from ._build import I, P

launches = 0  # kernel launches since the caller last set this to 0

_NAME = 'heatmap'
_SIG = {'gga_render_heatmap': ([P] * 4 + [I] * 4 + [P], I),
        'gga_heatmap_smem_bytes': ([I], I)}


def build():
    """Compile (once per source version) and load the kernel."""
    return _build.load(_NAME, _SIG)


def render_heatmap(centers, radii, valid, hw):
    """[G, H, W] f32 gaussian heatmaps (see ``render_heatmap_plain``)."""
    global launches
    if centers.device.type == 'cpu':
        return render_heatmap_plain(centers, radii, valid, hw)
    _build.check_cuda('render_heatmap', [('centers', centers),
                                         ('radii', radii), ('valid', valid)])
    if centers.dtype != torch.int32 or radii.dtype != torch.int32:
        raise TypeError('render_heatmap: centers and radii must be int32, got '
                        f'{centers.dtype} and {radii.dtype}')
    if valid.dtype != torch.bool:
        raise TypeError(f'render_heatmap: valid must be bool, got '
                        f'{valid.dtype}')
    G, M = radii.shape
    if centers.shape != (G, M, 2) or valid.shape != (G, M):
        raise ValueError(f'render_heatmap: expected centers [G, M, 2] and '
                         f'valid [G, M] beside radii [G, M], got '
                         f'{tuple(centers.shape)}, {tuple(valid.shape)}')
    H, W = (int(v) for v in hw)
    lib = build()
    if lib.gga_heatmap_smem_bytes(W) > _build.MAX_SMEM:
        raise ValueError(f'render_heatmap: width W={W} needs more shared '
                         'memory than a block has')
    out = torch.empty((G, H, W), dtype=torch.float32, device=centers.device)
    if out.numel() >= 2 ** 31:
        raise ValueError('render_heatmap: the output overflows the kernel\'s '
                         'int32 sizes')
    if out.numel() == 0:
        return out
    with torch.cuda.device(centers.device):
        err = lib.gga_render_heatmap(
            centers.data_ptr(), radii.data_ptr(), valid.data_ptr(),
            out.data_ptr(), G, M, H, W, _build.stream_of(centers))
    _build.check_launch('render_heatmap', err)
    launches += 1
    return out
