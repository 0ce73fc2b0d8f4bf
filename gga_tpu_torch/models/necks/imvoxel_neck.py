"""3D necks of ImVoxelNet (port of ``gga_tpu/models/necks/imvoxel_neck.py``;
mmdet3d's OutdoorImVoxelNeck and IndoorImVoxelNeck), on NCDHW volumes
[B, C, Nx, Ny, Nz]: gga_tpu's NDHWC [B, Nx, Ny, Nz, C] with the channels
moved first, mmdet3d's own volume order. The convs are dense (cuDNN on
the card, f32 with TF32 off); the norms are ``layers.BatchNorm2d``, whose
statistics span every axis but the channels', as flax's.

State_dict keys are mmdet3d's: a ``ConvModule3d`` is ``conv`` + ``bn``; a
``ResModule3d`` ``conv0`` (ConvModule3d), ``conv1`` (no activation) and,
where it strides, ``downsample`` (a 1x1x1 ConvModule without
activation); the outdoor neck's ``model.{0-5}``; the indoor neck's
``down_layer_{i}.{j}``, ``up_block_{i}.{0,1,3,4}`` and
``out_block_{i}.{0,1}``.

gga_tpu's transposed conv (flax ``nn.ConvTranspose``, kernel 2, stride 2)
correlates with its kernel, where torch's convolves: the conversion
(``convert.py``, ``deconv3d``) flips the kernel on its three spatial axes.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..layers import BatchNorm2d


class ConvModule3d(nn.Module):
    """3x3x3 Conv3d (no bias) + BN + ReLU (``act=False``: no ReLU) with
    explicit paddings."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 stride=(1, 1, 1), padding=(1, 1, 1), act=True):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, kernel_size, stride,
                              padding, bias=False)
        self.bn = BatchNorm2d(out_channels)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class ResModule3d(nn.Module):
    """Two 3x3x3 convs + BN with a residual add; a stride > 1 (or a change
    of width) projects the shortcut by a 1x1x1 conv + BN at the stride,
    which pads nothing (flax's 'SAME' at kernel 1)."""

    def __init__(self, in_channels, channels, stride=1):
        super().__init__()
        self.conv0 = ConvModule3d(in_channels, channels, stride=(stride,) * 3)
        self.conv1 = ConvModule3d(channels, channels, act=False)
        self.downsample = (
            ConvModule3d(in_channels, channels, 1, (stride,) * 3, 0,
                         act=False)
            if stride != 1 or in_channels != channels else None)

    def forward(self, x):
        y = self.conv1(self.conv0(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class UpBlock3d(nn.Sequential):
    """2x upsampling by a kernel-2 stride-2 transposed conv + BN + ReLU,
    then a 3x3x3 conv + BN + ReLU (mmdet3d ``_make_up_block``: children
    0 deconv, 1 norm, 3 conv, 4 norm)."""

    def __init__(self, in_channels, channels):
        super().__init__(
            nn.ConvTranspose3d(in_channels, channels, 2, 2, bias=False),
            BatchNorm2d(channels), nn.ReLU(),
            nn.Conv3d(channels, channels, 3, 1, 1, bias=False),
            BatchNorm2d(channels), nn.ReLU())


class OutBlock3d(nn.Sequential):
    """3x3x3 conv + BN + ReLU (mmdet3d ``_make_block``: children 0 conv,
    1 norm)."""

    def __init__(self, in_channels, channels):
        super().__init__(nn.Conv3d(in_channels, channels, 3, 1, 1,
                                   bias=False),
                         BatchNorm2d(channels), nn.ReLU())


class IndoorImVoxelNeck(nn.Module):
    """Indoor 3D FPN over the lifted volume: a stride-2 residual down path
    (the width doubling at each level), a deconv up path with skip adds,
    one out block a level. Returns the finest level first."""

    def __init__(self, in_channels, out_channels=128, n_blocks=(1, 1, 1)):
        super().__init__()
        self.n_levels = len(n_blocks)
        ch = in_channels
        for i, nb in enumerate(n_blocks):
            blocks = []
            for j in range(nb):
                if j == 0 and i > 0:
                    blocks.append(ResModule3d(ch, 2 * ch, stride=2))
                    ch *= 2
                else:
                    blocks.append(ResModule3d(ch, ch))
            self.add_module(f'down_layer_{i}', nn.Sequential(*blocks))
            if i > 0:
                self.add_module(f'up_block_{i}', UpBlock3d(ch, ch // 2))
            self.add_module(f'out_block_{i}', OutBlock3d(ch, out_channels))

    def forward(self, x):
        """x [B, C, Nx, Ny, Nz] -> [level i: B, out, Nx / 2^i, ...]."""
        downs = []
        for i in range(self.n_levels):
            x = getattr(self, f'down_layer_{i}')(x)
            downs.append(x)
        outs = []
        for i in range(self.n_levels - 1, -1, -1):
            if i < self.n_levels - 1:
                x = downs[i] + getattr(self, f'up_block_{i + 1}')(x)
            outs.append(getattr(self, f'out_block_{i}')(x))
        return outs[::-1]


class OutdoorImVoxelNeck(nn.Module):
    """ResModule + stride-(1, 1, 2) conv pairs compress z; the last conv
    (padding (1, 1, 0)) collapses it. Returns the BEV map NCHW
    [B, out, Ny, Nx], in Anchor3DHead's (y, x) order."""

    def __init__(self, in_channels, out_channels=256):
        super().__init__()
        c = in_channels
        self.model = nn.Sequential(
            ResModule3d(c, c),
            ConvModule3d(c, 2 * c, stride=(1, 1, 2)),
            ResModule3d(2 * c, 2 * c),
            ConvModule3d(2 * c, 4 * c, stride=(1, 1, 2)),
            ResModule3d(4 * c, 4 * c),
            ConvModule3d(4 * c, out_channels, padding=(1, 1, 0)))

    def forward(self, x):
        """x [B, C, Nx, Ny, Nz] -> [B, out, Ny, Nx]."""
        x = self.model(x)
        if x.shape[-1] != 1:
            raise ValueError(f'z not collapsed: {tuple(x.shape)}')
        return x[..., 0].transpose(-1, -2)
