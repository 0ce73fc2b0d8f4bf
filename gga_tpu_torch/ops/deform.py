"""Deformable conv sampling for dense BEV maps (port of
``gga_tpu/ops/deform.py``): mmcv's DeformConv2d (v1) as used by
CenterPoint's DCNSeparateHead, stride 1 and SAME padding. Each kernel
tap's sampling point is shifted by a learned per-pixel (dy, dx) and read
bilinearly; corners outside the map read zero, as mmcv's im2col pads.

The taps' fractional sample points are resolved with four flat row
gathers (one per bilinear corner, every tap in one index vector), then
one contraction over the stacked taps. Plain PyTorch: gga_tpu runs this
as XLA work, not as a TPU kernel.

Maps are NCHW at the boundary, the offsets in mmcv's channel order
(dy0, dx0, dy1, dx1, ...) and the weight in mmcv's ``[Cout, Cin / groups,
k, k]`` layout.
"""
from __future__ import annotations

import torch


def _tap_offsets(kernel_size, device):
    """(dy, dx) [k * k] of the taps, row-major over (ky, kx)."""
    r = (kernel_size - 1) // 2
    t = torch.arange(kernel_size, device=device, dtype=torch.float32) - r
    dy, dx = torch.meshgrid(t, t, indexing='ij')
    return dy.reshape(-1), dx.reshape(-1)


def deform_sample(x, offsets, kernel_size=3):
    """Bilinear samples of each kernel tap at its shifted point.

    Args:
        x: [B, C, H, W] feature map.
        offsets: [B, 2 * k * k, H, W] learned (dy, dx) per tap.
    Returns:
        [B, H, W, k * k, C] samples (zero where a corner falls outside
        the map).
    """
    B, C, H, W = x.shape
    KK = kernel_size * kernel_size
    dev = x.device
    off = offsets.float().reshape(B, KK, 2, H, W).permute(0, 3, 4, 1, 2)
    dy, dx = _tap_offsets(kernel_size, dev)
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :, None]
    py = yy + dy + off[..., 0]                      # [B, H, W, KK]
    px = xx + dx + off[..., 1]
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    fy = py - y0
    fx = px - x0
    xf = x.permute(0, 2, 3, 1).reshape(B * H * W, C)
    b_ix = torch.arange(B, device=dev)[:, None, None, None]

    def corner(yi, xi):
        ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = yi.clamp(0, H - 1).long()
        xc = xi.clamp(0, W - 1).long()
        idx = ((b_ix * H + yc) * W + xc).reshape(-1)
        g = xf.index_select(0, idx).reshape(B, H, W, KK, C)
        return g, ok.to(x.dtype)

    g00, m00 = corner(y0, x0)
    g01, m01 = corner(y0, x0 + 1)
    g10, m10 = corner(y0 + 1, x0)
    g11, m11 = corner(y0 + 1, x0 + 1)
    w00 = ((1 - fy) * (1 - fx)).to(x.dtype) * m00
    w01 = ((1 - fy) * fx).to(x.dtype) * m01
    w10 = (fy * (1 - fx)).to(x.dtype) * m10
    w11 = (fy * fx).to(x.dtype) * m11
    return (g00 * w00[..., None] + g01 * w01[..., None]
            + g10 * w10[..., None] + g11 * w11[..., None])


def deform_conv2d(x, offsets, weight, groups=1):
    """Deformable conv: sample the taps, contract over (tap, channel).

    Args:
        x: [B, C, H, W]; offsets: [B, 2 * k * k, H, W].
        weight: [Cout, C // groups, k, k]; output channel g * (Cout //
            groups) + d reads input channel slice g.
    Returns:
        [B, Cout, H, W].
    """
    B, C, H, W = x.shape
    cout, cg, k, _ = weight.shape
    s = deform_sample(x, offsets, k)                  # [B, H, W, KK, C]
    wg = weight.to(s.dtype).reshape(groups, cout // groups, cg, k * k)
    out = torch.einsum('bhwkgc,gdck->bhwgd',
                       s.reshape(B, H, W, k * k, groups, cg), wg)
    return out.reshape(B, H, W, cout).permute(0, 3, 1, 2)
