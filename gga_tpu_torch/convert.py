"""gga_tpu (flax) variables -> the port's state_dict.

The port's modules carry mmdet3d's state_dict keys, so this is the
port's own copy of the GGA rule table and layout transforms of
``tools/model_converters/torch2flax.py`` (``gga_rules``,
``_gga_transform``), run from flax to torch, and the same for the stage-4
PGD detector (``pgd_rules``: flax's automatic names of ResNet, FPN and
PGDHead to mmdet3d's keys) and the indoor FCAF3D detector
(``fcaf3d_rules``). A released mmdet3d GGA checkpoint loads into the port
directly, with no conversion.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .models.backbones import mink_resnet
from .models.backbones.resnet import ARCH
from .models.detectors.fcaf3d import FCAF3DModelConfig
from .models.detectors.pgd import PGDModelConfig


def _bn_moves(torch_prefix, flax_prefix):
    return [(f'{torch_prefix}.weight', 'params', f'{flax_prefix}/scale',
             'copy'),
            (f'{torch_prefix}.bias', 'params', f'{flax_prefix}/bias', 'copy'),
            (f'{torch_prefix}.running_mean', 'batch_stats',
             f'{flax_prefix}/mean', 'copy'),
            (f'{torch_prefix}.running_var', 'batch_stats',
             f'{flax_prefix}/var', 'copy')]


def gga_rules(cfg):
    """(torch_key, collection, flax_path, transform) for every tensor of
    the GGA detector (HardSimpleVFE has no parameters)."""
    rules = []

    def bn(torch_prefix, flax_prefix):
        rules.extend(_bn_moves(torch_prefix, flax_prefix))

    # SparseEncoder
    enc = 'SparseEncoder_0'
    me = 'pts_middle_encoder'
    base = cfg.encoder_channels[0][0]
    rules.append((f'{me}.conv_input.0.weight', 'params',
                  f'{enc}/SubMConv3dMapped_0/kernel', f'sparse3d:4:{base}'))
    bn(f'{me}.conv_input.1', f'{enc}/MaskedBatchNorm_0')
    n_bb = n_sc = 0
    ch = base
    for i, blocks in enumerate(cfg.encoder_channels):
        layer = f'{me}.encoder_layers.encoder_layer{i + 1}'
        for j, out_ch in enumerate(blocks):
            if j == len(blocks) - 1 and i != len(cfg.encoder_channels) - 1:
                f = f'{enc}/SparseConvBlock_{n_sc}'
                rules.append((f'{layer}.{j}.0.weight', 'params',
                              f'{f}/SparseConv3d_0/kernel',
                              f'sparse3d:{ch}:{out_ch}'))
                bn(f'{layer}.{j}.1', f'{f}/MaskedBatchNorm_0')
                n_sc += 1
            else:
                f = f'{enc}/SparseBasicBlock_{n_bb}'
                rules.append((f'{layer}.{j}.conv1.weight', 'params',
                              f'{f}/SubMConv3dMapped_0/kernel',
                              f'sparse3d:{ch}:{out_ch}'))
                bn(f'{layer}.{j}.bn1', f'{f}/MaskedBatchNorm_0')
                rules.append((f'{layer}.{j}.conv2.weight', 'params',
                              f'{f}/SubMConv3dMapped_1/kernel',
                              f'sparse3d:{out_ch}:{out_ch}'))
                bn(f'{layer}.{j}.bn2', f'{f}/MaskedBatchNorm_1')
                n_bb += 1
            ch = out_ch
    rules.append((f'{me}.conv_out.0.weight', 'params',
                  f'{enc}/SparseConvBlock_{n_sc}/SparseConv3d_0/kernel',
                  f'sparse3d:{ch}:{cfg.encoder_out_channels}'))
    bn(f'{me}.conv_out.1', f'{enc}/SparseConvBlock_{n_sc}/MaskedBatchNorm_0')

    # SECOND
    cm = 0
    for s, num in enumerate(cfg.backbone_layers):
        for j in range(num + 1):
            t = f'pts_backbone.blocks.{s}.{3 * j}'
            f = f'SECOND_0/ConvModule2d_{cm}'
            rules.append((f'{t}.weight', 'params', f'{f}/Conv_0/kernel',
                          'conv2d'))
            bn(f'pts_backbone.blocks.{s}.{3 * j + 1}',
               f'{f}/BatchNorm2d_0/BatchNorm_0')
            cm += 1

    # SECONDFPN
    n_conv = n_dec = 0
    for i, stride in enumerate(cfg.neck_strides):
        t = f'pts_neck.deblocks.{i}'
        if stride > 1:
            rules.append((f'{t}.0.weight', 'params',
                          f'SECONDFPN_0/ConvTranspose_{n_dec}/kernel',
                          'deconv2d'))
            n_dec += 1
        else:
            rules.append((f'{t}.0.weight', 'params',
                          f'SECONDFPN_0/Conv_{n_conv}/kernel', 'conv2d'))
            n_conv += 1
        bn(f'{t}.1', f'SECONDFPN_0/BatchNorm2d_{i}/BatchNorm_0')

    # CenterHead
    hd = 'CenterHead_0'
    bh = 'pts_bbox_head'
    rules.append((f'{bh}.shared_conv.conv.weight', 'params',
                  f'{hd}/ConvModule2d_0/Conv_0/kernel', 'conv2d'))
    rules.append((f'{bh}.shared_conv.conv.bias', 'params',
                  f'{hd}/ConvModule2d_0/Conv_0/bias', 'copy'))
    bn(f'{bh}.shared_conv.bn', f'{hd}/ConvModule2d_0/BatchNorm2d_0/BatchNorm_0')
    for t in range(len(cfg.tasks)):
        for b_i, name in enumerate(['reg', 'height', 'dim', 'rot', 'heatmap']):
            tb = f'{bh}.task_heads.{t}.{name}'
            fb = f'{hd}/task{t}'
            rules.append((f'{tb}.0.conv.weight', 'params',
                          f'{fb}/ConvModule2d_{b_i}/Conv_0/kernel', 'conv2d'))
            rules.append((f'{tb}.0.conv.bias', 'params',
                          f'{fb}/ConvModule2d_{b_i}/Conv_0/bias', 'copy'))
            bn(f'{tb}.0.bn', f'{fb}/ConvModule2d_{b_i}/BatchNorm2d_0'
                             '/BatchNorm_0')
            rules.append((f'{tb}.1.weight', 'params', f'{fb}/{name}_out/kernel',
                          'conv2d'))
            rules.append((f'{tb}.1.bias', 'params', f'{fb}/{name}_out/bias',
                          'copy'))
    return rules


def pgd_rules(cfg: PGDModelConfig):
    """(torch_key, collection, flax_path, transform) for every tensor of
    gga_tpu's ``PGDDetector`` (``gga_tpu/models/detectors/pgd.py``)."""
    rules = []

    def conv(torch_prefix, flax_prefix, bias=True):
        rules.append((f'{torch_prefix}.weight', 'params',
                      f'{flax_prefix}/kernel', 'conv2d'))
        if bias:
            rules.append((f'{torch_prefix}.bias', 'params',
                          f'{flax_prefix}/bias', 'copy'))

    def bn(torch_prefix, flax_prefix):
        rules.extend(_bn_moves(torch_prefix, f'{flax_prefix}/BatchNorm_0'))

    # ResNet: blocks are numbered across stages; in a block the convs and
    # norms in order, the projection shortcut last
    r = 'ResNet_0'
    conv('backbone.conv1', f'{r}/Conv_0', bias=False)
    bn('backbone.bn1', f'{r}/BatchNorm2d_0')
    stage_blocks, kind = ARCH[cfg.backbone_depth]
    n_convs, expansion = (3, 4) if kind == 'bottleneck' else (2, 1)
    name = 'Bottleneck' if kind == 'bottleneck' else 'BasicBlock'
    k, channels, planes = 0, 64, 64
    for i, n_blocks in enumerate(stage_blocks):
        for j in range(n_blocks):
            t, f = f'backbone.layer{i + 1}.{j}', f'{r}/{name}_{k}'
            for c in range(n_convs):
                conv(f'{t}.conv{c + 1}', f'{f}/Conv_{c}', bias=False)
                bn(f'{t}.bn{c + 1}', f'{f}/BatchNorm2d_{c}')
            if channels != planes * expansion or (i and not j):
                conv(f'{t}.downsample.0', f'{f}/Conv_{n_convs}', bias=False)
                bn(f'{t}.downsample.1', f'{f}/BatchNorm2d_{n_convs}')
            channels = planes * expansion
            k += 1
        planes *= 2

    # FPN: extra levels continue the fpn_convs index
    n_in = len(stage_blocks) - cfg.fpn_start_level
    for i in range(n_in):
        conv(f'neck.lateral_convs.{i}.conv', f'FPN_0/lateral{i}')
        conv(f'neck.fpn_convs.{i}.conv', f'FPN_0/fpn{i}')
    for i in range(n_in, cfg.fpn_num_outs):
        conv(f'neck.fpn_convs.{i}.conv', f'FPN_0/fpn_extra{i}')

    # PGDHead
    h, t, hc = 'PGDHead_0', 'bbox_head', cfg.head
    for i in range(hc.stacked_convs):
        conv(f'{t}.cls_convs.{i}.conv', f'{h}/cls_tower/conv{i}')
        conv(f'{t}.reg_convs.{i}.conv', f'{h}/reg_tower/conv{i}')

    def branch(prev, out, flax_name, channels):
        for j in range(len(channels)):
            conv(f'{t}.{prev}.{j}.conv', f'{h}/{flax_name}/conv{j}')
        conv(f'{t}.{out}', f'{h}/{flax_name}/out')

    branch('conv_cls_prev', 'conv_cls', 'cls', hc.cls_branch)
    for g, channels in enumerate(hc.reg_branch):
        branch(f'conv_reg_prevs.{g}', f'conv_regs.{g}', f'reg{g}', channels)
    branch('conv_dir_cls_prev', 'conv_dir_cls', 'dir', hc.dir_branch)
    branch('conv_depth_cls_prev', 'conv_depth_cls', 'depth_cls',
           hc.depth_branch)
    branch('conv_weight_prevs.0', 'conv_weights.0', 'weight',
           hc.weight_branch[0])
    branch('conv_centerness_prev', 'conv_centerness', 'centerness',
           hc.centerness_branch)
    for lvl in range(len(hc.strides)):
        rules.append((f'{t}.scales.{lvl}', 'params', f'{h}/scales_lvl{lvl}',
                      'copy'))
    rules.append((f'{t}.fuse_lambda', 'params', f'{h}/fuse_lambda', 'copy'))
    return rules


def fcaf3d_rules(cfg: FCAF3DModelConfig):
    """(torch_key, collection, flax_path, transform) for every tensor of
    gga_tpu's ``FCAF3DDetector`` (``gga_tpu/models/detectors/fcaf3d.py``).

    The keys are mmdet3d's MinkResNet / FCAF3DHead names; every tensor
    is copied as it is: the sparse kernels keep gga_tpu's ``[K, C, D]``
    layout and (z, y, x) row-major offset order (MinkowskiEngine orders
    its kernel offsets otherwise), the 1x1 projections ``[1, C, D]``, the
    head's 1x1 convs ``[C, D]``, the instance norm's affine ``[C]``."""
    rules = []

    def copy(torch_key, flax_path):
        rules.append((torch_key, 'params', flax_path, 'copy'))

    def bn(torch_prefix, flax_prefix):
        rules.extend(_bn_moves(torch_prefix, flax_prefix))

    r = 'MinkResNet_0'
    copy('backbone.conv1.kernel', f'{r}/conv1')
    copy('backbone.norm1.weight', f'{r}/MaskedInstanceNorm_0/scale')
    copy('backbone.norm1.bias', f'{r}/MaskedInstanceNorm_0/bias')
    for i, n_blocks in enumerate(mink_resnet.ARCH[cfg.depth]):
        for b in range(n_blocks):
            t, f = f'backbone.layer{i + 1}.{b}', f'{r}/layer{i}_{b}'
            copy(f'{t}.conv1.kernel', f'{f}/w1')
            copy(f'{t}.conv2.kernel', f'{f}/w2')
            bn(f'{t}.norm1.bn', f'{f}/bn1')
            bn(f'{t}.norm2.bn', f'{f}/bn2')
            if b == 0:
                copy(f'{t}.downsample.0.kernel', f'{f}/wd')
                bn(f'{t}.downsample.1.bn', f'{f}/bn_down')

    h, t = 'FCAF3DHead_0', 'head'
    for i in range(len(cfg.head.in_channels)):
        copy(f'{t}.out_block_{i}.0.kernel', f'{h}/out_block{i}/w')
        bn(f'{t}.out_block_{i}.1.bn', f'{h}/out_block{i}/MaskedBatchNorm_0')
        copy(f'{t}.scales.{i}.scale', f'{h}/scale{i}')
        if i:       # up_block_i takes level i to level i - 1
            copy(f'{t}.up_block_{i}.0.kernel', f'{h}/w_up{i - 1}')
            bn(f'{t}.up_block_{i}.1.bn', f'{h}/bn_up{i - 1}')
            copy(f'{t}.up_block_{i}.3.kernel', f'{h}/up_conv{i - 1}/w')
            bn(f'{t}.up_block_{i}.4.bn',
               f'{h}/up_conv{i - 1}/MaskedBatchNorm_0')
    copy(f'{t}.conv_center.kernel', f'{h}/w_center')
    copy(f'{t}.conv_reg.kernel', f'{h}/w_reg')
    copy(f'{t}.conv_cls.kernel', f'{h}/w_cls')
    copy(f'{t}.conv_cls.bias', f'{h}/b_cls')
    return rules


def _to_torch_layout(name, x):
    """One flax tensor -> its mmdet3d state_dict layout."""
    x = np.asarray(x)
    if name.startswith('sparse3d'):
        # flax [K, I, O] -> spconv2 [O, kz, ky, kx, I]
        _, i_ch, o_ch = name.split(':')
        dhw = (3, 1, 1) if x.shape[0] == 3 else (3, 3, 3)
        return x.reshape(*dhw, int(i_ch), int(o_ch)).transpose(4, 0, 1, 2, 3)
    if name == 'conv2d':            # [kh, kw, I, O] -> [O, I, kh, kw]
        return x.transpose(3, 2, 0, 1)
    if name == 'deconv2d':
        # flax ConvTranspose [kh, kw, I, O] -> torch [I, O, kh, kw] with a
        # spatial flip: flax's transposed conv correlates, torch's convolves
        return x[::-1, ::-1].transpose(2, 3, 0, 1)
    return x


def _flatten(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def from_jax_variables(variables_np, cfg):
    """gga_tpu ``{'params', 'batch_stats'}`` trees (nested dicts of numpy
    arrays) of the detector ``cfg`` describes (a ``GGAModelConfig``, a
    ``PGDModelConfig`` or an ``FCAF3DModelConfig``) -> the port's
    ``load_state_dict`` input (f32 tensors)."""
    flat = {c: _flatten(variables_np.get(c, {}))
            for c in ('params', 'batch_stats')}
    if isinstance(cfg, PGDModelConfig):
        rules = pgd_rules(cfg)
    elif isinstance(cfg, FCAF3DModelConfig):
        rules = fcaf3d_rules(cfg)
    else:
        rules = gga_rules(cfg)
    out = {}
    for tk, coll, fp, tr in rules:
        if fp in flat[coll]:
            arr = _to_torch_layout(tr, flat[coll][fp])
            # np.array keeps a 0-d array 0-d (fuse_lambda), as
            # np.ascontiguousarray would not
            out[tk] = torch.from_numpy(np.array(arr, dtype=np.float32,
                                                order='C'))
    return out
