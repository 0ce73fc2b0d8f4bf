"""Shared building blocks: batch norms that match gga_tpu's flax ones, the
sparse conv modules and the dense ConvModule (port of
``gga_tpu/models/layers.py``).

Sparse convs run batch-flat: features ``[B*N, C]`` and maps ``[K, B*M]``
whose rows are offset into the flat array, so one
``gather_gemm_conv`` launch covers the whole batch. They go through the
autograd Functions of ``ops/sparse.py``, which receive the f32 weights,
cast them to the input dtype (bf16 on the fast path) inside, and return
the weight gradient in f32. Norms compute in f32.

Sparse conv weights are ``[K, C, D]`` inside the modules; their
state_dict uses spconv2's ``[D, kz, ky, kx, C]`` layout, so a released
mmdet3d checkpoint loads as it is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import sparse as sp
from ..parallel import mesh


def flatten_nmap(nmap, n_in=None):
    """Per-scene neighbor map [B, K, M] -> batch-flat [K, B*M] whose rows
    index the flat [B*n_in, C] features; misses stay -1.

    ``n_in`` is the per-scene row count of the array the map indexes
    into; it defaults to M, the submanifold case where the query and the
    input sets coincide. Pass it wherever they differ (MinkResNet's 1x1
    stride-2 identity queries M output sites in N input rows), or every
    scene b > 0 gathers another scene's rows."""
    B, K, M = nmap.shape
    rows = M if n_in is None else n_in
    offs = (torch.arange(B, device=nmap.device, dtype=nmap.dtype)
            * rows)[:, None, None]
    flat = torch.where(nmap >= 0, nmap + offs, -1)
    return flat.permute(1, 0, 2).reshape(K, B * M).contiguous()


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over active voxels only (eps 1e-3, momentum 0.01):
    padding rows are excluded from the statistics and come out as 0.
    The running variance is unbiased, as in torch and gga_tpu. Under a
    process group the count, the sums and the centred second moment span
    the global batch (``mesh.global_sum``; gga_tpu's GSPMD reductions):
    the global mean first, then the sum of squares about it."""

    def __init__(self, num_features, eps=1e-3, momentum=0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x, valid):
        """x [..., C]; valid [...] bool."""
        xf = x.float()
        if self.training:
            m = valid[..., None].float()
            dims = tuple(range(x.dim() - 1))
            sums = mesh.global_sum(torch.cat([(xf * m).sum(dims),
                                              m.sum()[None]]))
            cnt = sums[-1].clamp(min=1.0)
            mean = sums[:-1] / cnt
            var = mesh.global_sum((((xf - mean) ** 2) * m).sum(dims)) / cnt
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var * cnt / (cnt - 1).clamp(min=1.0),
                                       self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return torch.where(valid[..., None], y, 0.0).to(x.dtype)


class BatchNorm2d(nn.Module):
    """Dense BN on NCHW maps (and NCDHW volumes: the statistics span every
    axis but the channels', as flax's ``nn.BatchNorm`` on a channel-last
    array of any rank) matching flax ``nn.BatchNorm`` (eps 1e-3, momentum
    0.01): f32 arithmetic (or the input's wider dtype, as flax promotes),
    output in the input dtype, and a BIASED running
    variance (torch's own BatchNorm2d keeps it unbiased). Under a process
    group the moments span the global batch, as ``MaskedBatchNorm``'s."""

    def __init__(self, num_features, eps=1e-3, momentum=0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = (0, *range(2, x.dim()))
        tail = (1,) * (x.dim() - 2)
        if self.training:
            if mesh.distributed():
                sums = mesh.global_sum(torch.cat([
                    xf.sum(dims),
                    xf.new_tensor([xf.numel() // xf.shape[1]])]))
                mean = sums[:-1] / sums[-1]
                # the mean detached, as torch.var's backward: the variance's
                # derivative in the mean is zero, and its f32 remainder
                # would only add noise
                var = mesh.global_sum(
                    ((xf - mean.detach().view(-1, *tail)) ** 2)
                    .sum(dims)) / sums[-1]
            else:
                mean = xf.mean(dims)
                var = xf.var(dims, unbiased=False)
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(-1, *tail)) * mul.view(-1, *tail) \
            + self.bias.view(-1, *tail)
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm on NCHW maps matching flax ``nn.GroupNorm``: epsilon 1e-6
    (torch's default is 1e-5) and flax's fast variance, ``max(E[x^2] -
    E[x]^2, 0)`` over each group (torch takes the mean of squared
    deviations); then ``(x - mean) * (rsqrt(var + eps) * weight) + bias``,
    as flax orders it, in f32 or the input's wider dtype (flax promotes to
    at least f32). Parameters ``weight`` and ``bias``, as torch's
    GroupNorm names them."""

    def __init__(self, num_groups, num_channels, eps=1e-6):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f'{num_groups} groups do not divide '
                             f'{num_channels} channels')
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        B, C = x.shape[:2]
        g = xf.reshape(B, self.num_groups, -1)
        mean = g.mean(-1)
        var = torch.clamp((g * g).mean(-1) - mean * mean, min=0.0)
        tail = (1,) * (x.dim() - 2)
        rep = C // self.num_groups
        mean = mean.repeat_interleave(rep, 1).view(B, C, *tail)
        mul = (torch.rsqrt(var + self.eps).repeat_interleave(rep, 1)
               * self.weight).view(B, C, *tail)
        y = (xf - mean) * mul + self.bias.view(-1, *tail)
        return y.to(x.dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in the input dtype (params stay f32)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that computes in the input dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class _SparseConv(nn.Module):
    """Weight holder of a sparse conv: ``weight`` [K, C, D] in the module,
    spconv2 [D, kz, ky, kx, C] in the state_dict."""

    def __init__(self, in_channels, out_channels, kernel_size):
        super().__init__()
        self.kernel_size = sp._triple(kernel_size)
        k = self.kernel_size[0] * self.kernel_size[1] * self.kernel_size[2]
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.weight = nn.Parameter(torch.zeros(k, in_channels, out_channels))

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        w = self.weight if keep_vars else self.weight.detach()
        destination[prefix + 'weight'] = w.reshape(
            *self.kernel_size, self.in_channels,
            self.out_channels).permute(4, 0, 1, 2, 3)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + 'weight'
        if key in state_dict and state_dict[key].dim() == 5:
            state_dict[key] = state_dict[key].permute(1, 2, 3, 4, 0).reshape(
                self.weight.shape)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class SubMConv3d(_SparseConv):
    """Submanifold conv on a precomputed batch-flat neighbor map (gga_tpu
    ``SubMConv3dMapped``, row form)."""

    def __init__(self, in_channels, out_channels, kernel_size=3):
        super().__init__(in_channels, out_channels, kernel_size)

    def forward(self, feats, valid, nmap):
        """feats [B, N, C]; valid [B, N]; nmap [K, B*N] -> [B, N, D]."""
        B, N, C = feats.shape
        out = sp.SubMConvFunction.apply(feats.reshape(B * N, C),
                                        valid.reshape(-1), nmap, self.weight)
        return out.reshape(B, N, self.out_channels)


class SparseConv3d(_SparseConv):
    """Strided sparse conv; its output set is sort-deduplicated into a
    static budget (gga_tpu ``SparseConv3d``, compact-rulebook branch)."""

    def __init__(self, in_channels, out_channels, kernel_size=(3, 3, 3),
                 stride=(2, 2, 2), padding=(1, 1, 1), out_budget=16000):
        super().__init__(in_channels, out_channels, kernel_size)
        self.stride = sp._triple(stride)
        self.padding = sp._triple(padding)
        self.out_budget = out_budget

    def forward(self, st: sp.SparseTensor) -> sp.SparseTensor:
        """The backward maps are built only where autograd records."""
        grad = torch.is_grad_enabled()
        oc, ov, og, fwd_flat, *bwd = sp.downsample_rulebook_compact(
            st.coords, st.valid, st.grid, self.kernel_size, self.stride,
            self.padding, self.out_budget, backward=grad)
        bwd_d, parity = bwd if grad else (None, None)
        B, N, C = st.features.shape
        out = sp.StridedConvFunction.apply(
            st.features.reshape(B * N, C), self.weight, fwd_flat, bwd_d,
            parity, ov.reshape(-1), self.kernel_size, self.stride)
        M = ov.shape[1]
        return sp.SparseTensor(out.reshape(B, M, self.out_channels), oc, ov,
                               og)


class RulebookConv3d(_SparseConv):
    """Strided sparse conv on the rulebook with a dense backward map
    (gga_tpu ``rulebook_conv`` on ``downsample_rulebook_batched``: the
    strided convs of SparseUNet, whose maps its decoder's inverse convs
    reuse). ``forward`` returns the output set and the maps."""

    def __init__(self, in_channels, out_channels, kernel_size=(3, 3, 3),
                 stride=(2, 2, 2), padding=(1, 1, 1), out_budget=16000):
        super().__init__(in_channels, out_channels, kernel_size)
        self.stride = sp._triple(stride)
        self.padding = sp._triple(padding)
        self.out_budget = out_budget

    def forward(self, st: sp.SparseTensor):
        """-> (SparseTensor, (fwd_flat [K, B*M], bwd_flat [K, B*N]))."""
        oc, ov, og, fwd_flat, bwd_flat = sp.downsample_rulebook_batched(
            st.coords, st.valid, st.grid, self.kernel_size, self.stride,
            self.padding, self.out_budget)
        B, N, C = st.features.shape
        out = sp.RulebookConvFunction.apply(
            st.features.reshape(B * N, C), self.weight, fwd_flat, bwd_flat,
            ov.reshape(-1))
        M = ov.shape[1]
        return (sp.SparseTensor(out.reshape(B, M, self.out_channels), oc, ov,
                                og), (fwd_flat, bwd_flat))


class SparseInverseConv3d(_SparseConv):
    """spconv's SparseInverseConv3d on the maps of the strided conv it
    inverts (``ops.sparse.sparse_inverse_conv``): features of the
    downsampled set onto that conv's input set."""

    def forward(self, x, maps, out_valid):
        """x [B, M, C]; maps (fwd_flat, bwd_flat) of the strided conv;
        out_valid [B, N] -> [B, N, D]."""
        B, M, C = x.shape
        out = sp.sparse_inverse_conv(x.reshape(B * M, C), self.weight,
                                     *maps, out_valid.reshape(-1))
        return out.reshape(B, out_valid.shape[1], self.out_channels)


class RulebookConvBlock(nn.Sequential):
    """``RulebookConv3d`` + masked BN + ReLU (children ``0`` conv, ``1``
    norm); ``forward`` also returns the conv's maps."""

    def __init__(self, in_channels, out_channels, kernel_size=(3, 3, 3),
                 stride=(2, 2, 2), padding=(1, 1, 1), out_budget=16000):
        super().__init__(
            RulebookConv3d(in_channels, out_channels, kernel_size, stride,
                           padding, out_budget),
            MaskedBatchNorm(out_channels))

    def forward(self, st: sp.SparseTensor):
        conv, bn = self[0], self[1]
        st, maps = conv(st)
        st.features = F.relu(bn(st.features, st.valid))
        return st, maps


class InverseConvBlock(nn.Sequential):
    """``SparseInverseConv3d`` + masked BN + ReLU (children ``0`` conv,
    ``1`` norm)."""

    def __init__(self, in_channels, out_channels, kernel_size=3):
        super().__init__(SparseInverseConv3d(in_channels, out_channels,
                                             kernel_size),
                         MaskedBatchNorm(out_channels))

    def forward(self, x, maps, out_valid):
        conv, bn = self[0], self[1]
        return F.relu(bn(conv(x, maps, out_valid), out_valid))


class SparseConvBlock(nn.Sequential):
    """Strided sparse conv + masked BN + ReLU (mmdet3d's sparse
    ConvModule; state_dict children ``0`` conv, ``1`` norm)."""

    def __init__(self, in_channels, out_channels, kernel_size=(3, 3, 3),
                 stride=(2, 2, 2), padding=(1, 1, 1), out_budget=16000):
        super().__init__(
            SparseConv3d(in_channels, out_channels, kernel_size, stride,
                         padding, out_budget),
            MaskedBatchNorm(out_channels))

    def forward(self, st: sp.SparseTensor) -> sp.SparseTensor:
        conv, bn = self[0], self[1]
        st = conv(st)
        st.features = F.relu(bn(st.features, st.valid))
        return st


class SubMConvBlock(nn.Sequential):
    """SubM conv + masked BN + ReLU on a shared neighbor map (mmdet3d's
    submanifold ConvModule; state_dict children ``0`` conv, ``1`` norm)."""

    def __init__(self, in_channels, out_channels):
        super().__init__(SubMConv3d(in_channels, out_channels),
                         MaskedBatchNorm(out_channels))

    def forward(self, x, valid, nmap):
        conv, bn = self[0], self[1]
        return F.relu(bn(conv(x, valid, nmap), valid))


class SparseBasicBlock(nn.Module):
    """ResNet BasicBlock on sparse rows: two SubM convs with BN, residual
    add, ReLU after each (the second after the add)."""

    def __init__(self, channels):
        super().__init__()
        self.conv1 = SubMConv3d(channels, channels)
        self.bn1 = MaskedBatchNorm(channels)
        self.conv2 = SubMConv3d(channels, channels)
        self.bn2 = MaskedBatchNorm(channels)

    def forward(self, x, valid, nmap):
        y = F.relu(self.bn1(self.conv1(x, valid, nmap), valid))
        y = self.bn2(self.conv2(y, valid, nmap), valid)
        return F.relu(y + x)


class ConvModule2d(nn.Module):
    """Conv2d + BN + ReLU on NCHW maps (mmcv ConvModule; children ``conv``
    and ``bn``). Padding 1 for a 3x3 conv at stride 1 and 2, as gga_tpu's
    'SAME' and explicit (1, 1) paddings give."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 bias=False):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           padding=kernel_size // 2, bias=bias)
        self.bn = BatchNorm2d(out_channels)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class PlainConvModule(nn.Module):
    """mmcv ConvModule without a norm (child ``conv``, with a bias), then
    a ReLU where ``relu``; the FPN's and the PGD head's convs."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, relu=False):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              padding)
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        return F.relu(x) if self.relu else x


def init_params(module, generator, gain=6.0):
    """Seeded init of every conv weight, uniform in +-sqrt(gain / fan_in),
    conv biases zero. The default, He-uniform, keeps the GGA detector's
    random-weight activations O(1) through its eval-mode BNs (identity
    statistics), so every layer sees live values; torch's default
    (gain 1, flax's ``variance_scaling(1/3)``) shrinks them ~6x per
    layer. The PGD detector takes gain 1, as gga_tpu's: its FPN and head
    have no norm, and He scaling there grows them ~2x per conv until
    exp(size) overflows."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, _SparseConv):
                fan_in = m.weight.shape[0] * m.weight.shape[1]
            elif isinstance(m, nn.ConvTranspose2d):
                fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
            elif isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
            else:
                continue
            bound = (gain / fan_in) ** 0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            if getattr(m, 'bias', None) is not None:
                m.bias.zero_()
