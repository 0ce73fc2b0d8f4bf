"""Middle encoders (port of ``gga_tpu/models/middle_encoders.py``): the
sparse ``SparseEncoder`` on the row engine, in its basicblock (GGA) and
conv_module (SECOND) variants, PartA2's ``SparseUNet``, and PointPillars'
``PointPillarsScatter``."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops import sparse as sp
from ..ops.scatter import pillar_scatter
from .layers import (InverseConvBlock, RulebookConvBlock, SparseBasicBlock,
                     SparseConvBlock, SubMConvBlock, flatten_nmap)


class SparseEncoder(nn.Module):
    """SECOND's sparse encoder: SubM(in->base) + BN + ReLU, four stages,
    then conv_out with kernel (3, 1, 1) stride (2, 1, 1). One neighbor map
    per active set is shared by all SubM convs on it.

    ``block_type='basicblock'`` (gga_kitti_config.py:11-19): stages of
    SparseBasicBlocks, stages 0-2 closed by a stride-2 SparseConv3d whose
    budget is ``stage_budgets[i]``. ``block_type='conv_module'`` (SECOND,
    mmdet3d's ``make_encoder_layers``): every block a SubM conv + BN +
    ReLU, stages 1-3 opened by the stride-2 SparseConv3d (+ BN + ReLU)
    with budget ``stage_budgets[i - 1]``; the encoder paddings of a SubM
    block are not read (a SubM conv pads 1).

    Returns the dense BEV map NCHW [B, C*D, H, W], channels flattened
    channel-major over (C, D) like the reference's ``view(N, C*D, H, W)``;
    with ``return_stages`` (SASSD's encode features, mmdet3d's
    sparse_encoder.py:292-295) a tuple (bev, stages), each encoder layer's
    output as (features [B, N, C], coords [B, N, 3], valid [B, N], grid).
    ``tile_stages``, ``remat_blocks``, ``tile_shape`` and ``tile_budgets``
    are gga_tpu's TPU options: any value but their defaults is refused."""

    def __init__(self, in_channels=4, sparse_shape=(41, 1600, 1408),
                 base_channels=16, output_channels=128,
                 encoder_channels: Sequence[Sequence[int]] = (
                     (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)),
                 encoder_paddings: Sequence = (
                     (0, 0, 1), (0, 0, 1), (0, 0, (0, 1, 1)), (0, 0)),
                 stage_budgets: Sequence[int] = (16000, 16000, 16000),
                 out_budget: int = 16000,
                 block_type: str = 'basicblock',
                 return_stages: bool = False,
                 tile_stages: Tuple[int, ...] = (),
                 remat_blocks: bool = False,
                 tile_shape: Tuple[int, int, int] = (2, 4, 4),
                 tile_budgets: Tuple[int, ...] = (0, 7168, 3072, 1536)):
        super().__init__()
        if (tile_stages or remat_blocks or tuple(tile_shape) != (2, 4, 4)
                or tuple(tile_budgets) != (0, 7168, 3072, 1536)):
            raise NotImplementedError(
                'tile_stages, remat_blocks, tile_shape and tile_budgets are '
                'TPU options of gga_tpu; the port runs the row engine only')
        if block_type not in ('basicblock', 'conv_module'):
            raise ValueError(f'block_type {block_type!r}')
        self.sparse_shape = tuple(sparse_shape)
        self.stage_budgets = tuple(stage_budgets)
        self.out_budget = out_budget
        self.block_type = block_type
        self.return_stages = return_stages
        self.conv_input = SubMConvBlock(in_channels, base_channels)
        layers = {}
        ch = base_channels
        grid = self.sparse_shape
        n_stages = len(encoder_channels)
        basic = block_type == 'basicblock'
        for i, blocks in enumerate(encoder_channels):
            layer = []
            for j, out_ch in enumerate(blocks):
                down = (j == len(blocks) - 1 and i != n_stages - 1 if basic
                        else i != 0 and j == 0)
                if down:
                    pad = encoder_paddings[i][j]
                    layer.append(SparseConvBlock(
                        ch, out_ch, (3, 3, 3), (2, 2, 2), pad,
                        stage_budgets[i if basic else i - 1]))
                    grid = sp._ds_prep(grid, 3, 2, pad)[3]
                elif basic:
                    layer.append(SparseBasicBlock(out_ch))
                else:
                    layer.append(SubMConvBlock(ch, out_ch))
                ch = out_ch
            layers[f'encoder_layer{i + 1}'] = nn.ModuleList(layer)
        self.encoder_layers = nn.ModuleDict(layers)
        self.conv_out = SparseConvBlock(ch, output_channels, (3, 1, 1),
                                        (2, 1, 1), (0, 0, 0), out_budget)
        grid = sp._ds_prep(grid, (3, 1, 1), (2, 1, 1), 0)[3]
        # channels of the dense BEV map: C * nz of conv_out's grid
        self.bev_channels = output_channels * grid[0]

    @staticmethod
    def _subm_map(st):
        return flatten_nmap(sp.build_neighbor_map(st.coords, st.valid,
                                                  st.grid))

    def forward(self, feats, coords, valid, diag=None):
        """feats [B, V, C]; coords [B, V, 3] (z, y, x) sorted; valid [B, V].

        With a dict ``diag``, records the budget occupancy (mean active
        sites per scene over the budget; 1.0 means the budget saturated)
        as gga_tpu sows it: ``occupancy_out`` after conv_out, and in the
        basicblock variant ``occupancy_stage{i}`` after each strided
        conv."""
        st = sp.SparseTensor(feats, coords, valid, self.sparse_shape)
        nmap = self._subm_map(st)
        st.features = self.conv_input(feats, valid, nmap)
        stages = []
        for i, layer in enumerate(self.encoder_layers.values()):
            for block in layer:
                if isinstance(block, SparseConvBlock):
                    st = block(st)
                    if diag is not None and self.block_type == 'basicblock':
                        diag[f'occupancy_stage{i}'] = _occupancy(
                            st.valid, self.stage_budgets[i])
                    nmap = self._subm_map(st)
                else:
                    st.features = block(st.features, st.valid, nmap)
            stages.append((st.features, st.coords, st.valid, st.grid))
        st = self.conv_out(st)
        if diag is not None:
            diag['occupancy_out'] = _occupancy(st.valid, self.out_budget)
        bev = _densify(st)
        return (bev, stages) if self.return_stages else bev


def _occupancy(valid, budget):
    return valid.sum(-1).float().mean() / budget


def _densify(st):
    """Sparse rows -> NCHW [B, C*nz, ny, nx], channel-major over (C, nz)."""
    nz, ny, nx = st.grid
    B, M, C = st.features.shape
    c = st.coords.long()
    lin = torch.where(st.valid, c[..., 0] * (ny * nx) + c[..., 1] * nx
                      + c[..., 2], nz * ny * nx)
    rows = (torch.arange(B, device=lin.device)[:, None] * (nz * ny * nx + 1)
            + lin).reshape(-1)
    dense = st.features.new_zeros(B * (nz * ny * nx + 1), C)
    dense[rows] = torch.where(st.valid[..., None], st.features,
                              0).reshape(-1, C)
    dense = dense.reshape(B, nz * ny * nx + 1, C)[:, :-1]
    return dense.reshape(B, nz, ny, nx, C).permute(0, 4, 1, 2, 3).reshape(
        B, C * nz, ny, nx)


class SparseUNet(nn.Module):
    """PartA2's UNet-shaped sparse middle encoder (gga_tpu ``SparseUNet``,
    ``middle_encoders.py:215-371``; mmdet3d's sparse_unet.py:19).

    Encoder: ``conv_input`` (SubM + BN + ReLU), four stages of SubM
    blocks, stages 2-4 opened by a stride-2 sparse conv on
    ``downsample_rulebook_batched`` (budget ``stage_budgets[i - 1]``)
    whose maps are kept; ``conv_out`` (3, 1, 1) stride (2, 1, 1) on the
    last stage, densified to the BEV map channel-major over (C, D). One
    neighbor map per active set is shared by every SubM conv on it.

    Decoder, from the deepest stage up (``lateral_layer{k}``,
    ``merge_layer{k}``, ``upsample_layer{k}``, k = 4..1): a lateral
    SparseBasicBlock on the stage's encoder output, its concat after the
    rising features, the merge SubM, plus the concat's interleaved
    channel pairs summed (mmdet3d's ``reduce_channel``), then the inverse
    conv of the stage's strided conv onto the set below (k > 1) or a SubM
    (k = 1).

    Returns (bev NCHW [B, C*D, H, W], seg_feats [B, N, C_seg] on the
    input active set)."""

    def __init__(self, in_channels=4, sparse_shape=(41, 1600, 1408),
                 base_channels=16, output_channels=128,
                 encoder_channels: Sequence[Sequence[int]] = (
                     (16,), (32, 32, 32), (64, 64, 64), (64, 64, 64)),
                 encoder_sconv_paddings: Sequence = (1, 1, (0, 1, 1)),
                 decoder_channels: Sequence[Sequence[int]] = (
                     (64, 64, 64), (64, 64, 32), (32, 32, 16),
                     (16, 16, 16)),
                 stage_budgets: Sequence[int] = (16000, 16000, 16000),
                 out_budget: int = 16000):
        super().__init__()
        self.sparse_shape = tuple(sparse_shape)
        self.stage_budgets = tuple(stage_budgets)
        self.out_budget = out_budget
        self.conv_input = SubMConvBlock(in_channels, base_channels)
        layers = {}
        ch = base_channels
        grid = self.sparse_shape
        for i, blocks in enumerate(encoder_channels):
            layer = []
            for j, out_ch in enumerate(blocks):
                if i != 0 and j == 0:
                    pad = encoder_sconv_paddings[i - 1]
                    layer.append(RulebookConvBlock(
                        ch, out_ch, 3, 2, pad, stage_budgets[i - 1]))
                    grid = sp._ds_prep(grid, 3, 2, pad)[3]
                else:
                    layer.append(SubMConvBlock(ch, out_ch))
                ch = out_ch
            layers[f'encoder_layer{i + 1}'] = nn.ModuleList(layer)
        self.encoder_layers = nn.ModuleDict(layers)
        self.conv_out = RulebookConvBlock(ch, output_channels, (3, 1, 1),
                                          (2, 1, 1), 0, out_budget)
        grid = sp._ds_prep(grid, (3, 1, 1), (2, 1, 1), 0)[3]
        self.bev_channels = output_channels * grid[0]
        n = len(decoder_channels)
        for d, dch in enumerate(decoder_channels):
            k = n - d
            setattr(self, f'lateral_layer{k}', SparseBasicBlock(dch[0]))
            setattr(self, f'merge_layer{k}', SubMConvBlock(2 * dch[0],
                                                           dch[1]))
            setattr(self, f'upsample_layer{k}',
                    InverseConvBlock(dch[1], dch[2]) if k != 1
                    else SubMConvBlock(dch[1], dch[2]))
        self.seg_channels = decoder_channels[-1][2]

    def forward(self, feats, coords, valid, diag=None):
        """feats [B, V, C]; coords [B, V, 3] (z, y, x) sorted; valid [B, V].

        With a dict ``diag``, records the budget occupancy (mean active
        sites a scene over the budget): ``occupancy_stage{i}`` after each
        strided conv, ``occupancy_out`` after conv_out."""
        st = sp.SparseTensor(feats, coords, valid, self.sparse_shape)
        nmaps = [SparseEncoder._subm_map(st)]
        st.features = self.conv_input(feats, valid, nmaps[0])
        sets, rulebooks, encoded = [], [None], []
        for i, layer in enumerate(self.encoder_layers.values()):
            for block in layer:
                if isinstance(block, RulebookConvBlock):
                    st, maps = block(st)
                    rulebooks.append(maps)
                    nmaps.append(SparseEncoder._subm_map(st))
                    if diag is not None:
                        diag[f'occupancy_stage{i}'] = _occupancy(
                            st.valid, self.stage_budgets[i - 1])
                else:
                    st.features = block(st.features, st.valid, nmaps[i])
            sets.append(st.valid)
            encoded.append(st.features)
        out, _ = self.conv_out(st)
        if diag is not None:
            diag['occupancy_out'] = _occupancy(out.valid, self.out_budget)
        bev = _densify(out)

        x = encoded[-1]
        for i in reversed(range(len(encoded))):
            k = i + 1
            lat = getattr(self, f'lateral_layer{k}')(encoded[i], sets[i],
                                                     nmaps[i])
            cat = torch.cat([x, lat], -1)                  # [B, N, 2C]
            merge = getattr(self, f'merge_layer{k}')
            merged = merge(cat, sets[i], nmaps[i])
            # reduce_channel: the concat's channels summed in interleaved
            # groups (sparse_unet.py:186)
            reduced = cat.reshape(*cat.shape[:2], merged.shape[-1],
                                  -1).sum(-1)
            x = merged + reduced
            up = getattr(self, f'upsample_layer{k}')
            x = (up(x, rulebooks[i], sets[i - 1]) if i != 0
                 else up(x, sets[0], nmaps[0]))
        return bev, x


class PointPillarsScatter(nn.Module):
    """Pillar features onto the dense BEV canvas (gga_tpu
    ``PointPillarsScatter``, mmdet3d's pillar_scatter.py:10). No
    parameters."""

    def __init__(self, output_shape):
        super().__init__()
        self.output_shape = tuple(output_shape)     # (ny, nx)

    def forward(self, feats, coords, valid):
        """feats [B, V, C]; coords [B, V, 3] (z, y, x); valid [B, V] ->
        NCHW [B, C, ny, nx]."""
        return pillar_scatter(feats, coords, valid, self.output_shape)
