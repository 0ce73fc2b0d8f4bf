"""SECONDFPN neck (port of ``gga_tpu/models/necks/second_fpn.py``): per
level a deconv (stride > 1) or a k x k conv of stride k = round(1 / stride)
(stride <= 1: a 1x1 conv at stride 1, a 2x2 stride-2 conv at 0.5), then
BN+ReLU; levels concatenated on channels. NCHW."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..layers import BatchNorm2d, Conv2d, ConvTranspose2d


class SECONDFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (128, 128, 256),
                 out_channels: Sequence[int] = (256, 256, 256),
                 upsample_strides: Sequence[int] = (1, 2, 4)):
        super().__init__()
        deblocks = []
        for in_ch, out_ch, stride in zip(in_channels, out_channels,
                                         upsample_strides):
            if stride > 1:
                # torch's deconv kernel is gga_tpu's flax ConvTranspose
                # kernel flipped in space (convert.py applies the flip)
                up = ConvTranspose2d(in_ch, out_ch, stride, stride,
                                     bias=False)
            else:
                # flax's 'SAME' conv of kernel = stride k pads nothing on
                # a map whose size k divides
                k = int(round(1 / stride))
                up = Conv2d(in_ch, out_ch, k, k, bias=False)
            deblocks.append(nn.Sequential(up, BatchNorm2d(out_ch), nn.ReLU()))
        self.deblocks = nn.ModuleList(deblocks)

    def forward(self, feats):
        """feats: tuple of [B, Ci, Hi, Wi] -> [B, sum(out), H0, W0]."""
        ups = [block(x) for block, x in zip(self.deblocks, feats)]
        return torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
