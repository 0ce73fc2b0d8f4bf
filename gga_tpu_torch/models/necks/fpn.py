"""FPN neck, NCHW (the port of ``gga_tpu/models/necks/fpn.py``; mmdet's
FPN as the reference's PGD config sets it: start_level 0, four outputs,
extra levels from the last output after a ReLU).

State_dict keys are mmdet's: ``lateral_convs.{i}.conv`` and
``fpn_convs.{i}.conv``, the extra levels' convs continuing the
``fpn_convs`` index.

The top-down pathway upsamples by nearest neighbour with half-pixel
centres, as ``jax.image.resize(..., 'nearest')`` does. Its source index
is ``floor((i + 0.5) * m / n)`` in f32, which XLA compiles as ``(i +
0.5) * c`` with the constant ``c = m * (1 / n)``, each product and the
reciprocal rounded to f32: ``resize_nearest`` computes it the same way
(it matches ``jax.image.resize`` at every m < 70, m < n <= 2m + 1). Where
the quotient is a whole number that product can fall just below it (42
-> 83 at i = 41 gives 20, not 21), so neither
``F.interpolate(mode='nearest')`` (which differs wherever the ratio is
not an exact 2) nor ``'nearest-exact'`` gives gga_tpu's pixels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import PlainConvModule


def _source_index(m, n, device):
    c = m * (torch.tensor(1.0, device=device) / n)          # f32 rounding
    i = torch.arange(n, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * c).long()


def resize_nearest(x, size):
    """[..., m_h, m_w] -> [..., n_h, n_w] by ``jax.image.resize``'s
    nearest neighbour."""
    for dim, n in zip((-2, -1), size):
        x = x.index_select(dim, _source_index(x.shape[dim], n, x.device))
    return x


class FPN(nn.Module):

    def __init__(self, in_channels, out_channels=256, start_level=0,
                 num_outs=4, relu_before_extra_convs=True):
        super().__init__()
        self.start_level = start_level
        self.num_outs = num_outs
        self.relu_before_extra_convs = relu_before_extra_convs
        ins = in_channels[start_level:]
        self.lateral_convs = nn.ModuleList(
            PlainConvModule(c, out_channels, 1) for c in ins)
        self.fpn_convs = nn.ModuleList(
            PlainConvModule(out_channels, out_channels, 3, padding=1)
            for _ in ins)
        for _ in range(num_outs - len(ins)):
            self.fpn_convs.append(PlainConvModule(
                out_channels, out_channels, 3, stride=2, padding=1))

    def forward(self, feats):
        """feats: tuple of NCHW maps of increasing stride."""
        feats = feats[self.start_level:]
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, feats)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest(
                laterals[i], laterals[i - 1].shape[-2:])
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        for conv in self.fpn_convs[len(laterals):self.num_outs]:
            src = F.relu(outs[-1]) if self.relu_before_extra_convs \
                else outs[-1]
            outs.append(conv(src))
        return tuple(outs[:self.num_outs])
