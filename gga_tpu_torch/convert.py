"""gga_tpu (flax) variables -> the port's state_dict.

The port's modules carry mmdet3d's state_dict keys, so this is the
port's own copy of the GGA rule table and layout transforms of
``tools/model_converters/torch2flax.py`` (``gga_rules``,
``_gga_transform``), run from flax to torch, and the same for the stage-4
PGD detector (``pgd_rules``: flax's automatic names of ResNet, FPN and
PGDHead to mmdet3d's keys), the indoor FCAF3D detector
(``fcaf3d_rules``) and the supervised KITTI voxel detectors
(``second_rules`` for SECOND and DVSECOND, ``pointpillars_rules``,
``sassd_rules``, and DynamicVoxelNet's dense half alone, whose voxel
features and scatter have no parameters) and the nuScenes CenterPoint
family (``centerpoint_rules``: voxel and pillar, with and without the DCN
head, to mmdet3d's CenterPoint names); gga_tpu has no converter rules for
these, so theirs stand alone; and PartA2 (``parta2_rules``: SparseUNet,
SECOND + SECONDFPN, the RPN, the semantic head and the part-aggregation
bbox head, whose dense 3-D convs and linears keep torch's layouts). A
released mmdet3d GGA checkpoint loads into the port directly, with no
conversion.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .models.backbones import mink_resnet
from .models.backbones.resnet import ARCH
from .models.detectors.centerpoint import CenterPointConfig, common_heads
from .models.detectors.dynamic_voxelnet import DynamicVoxelNetConfig
from .models.detectors.fcaf3d import FCAF3DModelConfig
from .models.detectors.parta2 import PartA2Config
from .models.detectors.pgd import PGDModelConfig
from .models.detectors.sassd import SASSDConfig
from .models.detectors.voxelnet import PointPillarsConfig, SECONDNetConfig


def _bn_moves(torch_prefix, flax_prefix):
    return [(f'{torch_prefix}.weight', 'params', f'{flax_prefix}/scale',
             'copy'),
            (f'{torch_prefix}.bias', 'params', f'{flax_prefix}/bias', 'copy'),
            (f'{torch_prefix}.running_mean', 'batch_stats',
             f'{flax_prefix}/mean', 'copy'),
            (f'{torch_prefix}.running_var', 'batch_stats',
             f'{flax_prefix}/var', 'copy')]


def _second_fpn_rules(cfg, backbone, neck):
    """SECOND (``backbone``) + SECONDFPN (``neck``) of any of gga_tpu's
    detectors that build them under ``SECOND_0`` / ``SECONDFPN_0``."""
    rules = []
    cm = 0
    for s, num in enumerate(cfg.backbone_layers):
        for j in range(num + 1):
            f = f'SECOND_0/ConvModule2d_{cm}'
            rules.append((f'{backbone}.blocks.{s}.{3 * j}.weight', 'params',
                          f'{f}/Conv_0/kernel', 'conv2d'))
            rules.extend(_bn_moves(f'{backbone}.blocks.{s}.{3 * j + 1}',
                                   f'{f}/BatchNorm2d_0/BatchNorm_0'))
            cm += 1
    n_conv = n_dec = 0
    for i, stride in enumerate(cfg.neck_strides):
        t = f'{neck}.deblocks.{i}'
        if stride > 1:
            rules.append((f'{t}.0.weight', 'params',
                          f'SECONDFPN_0/ConvTranspose_{n_dec}/kernel',
                          'deconv2d'))
            n_dec += 1
        else:
            rules.append((f'{t}.0.weight', 'params',
                          f'SECONDFPN_0/Conv_{n_conv}/kernel', 'conv2d'))
            n_conv += 1
        rules.extend(_bn_moves(f'{t}.1',
                               f'SECONDFPN_0/BatchNorm2d_{i}/BatchNorm_0'))
    return rules


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

    rules.extend(_second_fpn_rules(cfg, 'pts_backbone', 'pts_neck'))

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


def _anchor_head_rules(head):
    """Anchor3DHead's three convs under the port's prefix ``head``. The
    channels keep gga_tpu's order (anchor class, rotation, value); a
    released mmdet3d checkpoint may need them reordered."""
    rules = []
    for t, f in (('conv_cls', 'conv_cls'), ('conv_reg', 'conv_reg'),
                 ('conv_dir_cls', 'conv_dir')):
        rules.append((f'{head}.{t}.weight', 'params',
                      f'Anchor3DHead_0/{f}/kernel', 'conv2d'))
        rules.append((f'{head}.{t}.bias', 'params',
                      f'Anchor3DHead_0/{f}/bias', 'copy'))
    return rules


def _anchor_rules(cfg):
    """SECOND + SECONDFPN + Anchor3DHead under mmdet3d's VoxelNet names."""
    return (_second_fpn_rules(cfg, 'backbone', 'neck')
            + _anchor_head_rules('bbox_head'))


def _conv_module_encoder_rules(cfg, me, base, out_channels):
    """gga_tpu's conv_module SparseEncoder under the port's prefix ``me``:
    it numbers every block ``SparseConvBlock_<n>`` in build order (SubM
    and strided alike, conv_out last); conv_input is 4 -> ``base``."""
    enc = 'SparseEncoder_0'
    rules = [(f'{me}.conv_input.0.weight', 'params',
              f'{enc}/SubMConv3dMapped_0/kernel', f'sparse3d:4:{base}')]
    rules.extend(_bn_moves(f'{me}.conv_input.1', f'{enc}/MaskedBatchNorm_0'))
    n, ch = 0, base
    for i, blocks in enumerate(cfg.encoder_channels):
        for j, out_ch in enumerate(blocks):
            f = f'{enc}/SparseConvBlock_{n}'
            t = f'{me}.encoder_layers.encoder_layer{i + 1}.{j}'
            conv = 'SparseConv3d_0' if i and not j else 'SubMConv3d_0'
            rules.append((f'{t}.0.weight', 'params', f'{f}/{conv}/kernel',
                          f'sparse3d:{ch}:{out_ch}'))
            rules.extend(_bn_moves(f'{t}.1', f'{f}/MaskedBatchNorm_0'))
            n, ch = n + 1, out_ch
    f = f'{enc}/SparseConvBlock_{n}'
    rules.append((f'{me}.conv_out.0.weight', 'params',
                  f'{f}/SparseConv3d_0/kernel',
                  f'sparse3d:{ch}:{out_channels}'))
    rules.extend(_bn_moves(f'{me}.conv_out.1', f'{f}/MaskedBatchNorm_0'))
    return rules


def second_rules(cfg: SECONDNetConfig):
    """(torch_key, collection, flax_path, transform) for every tensor of
    gga_tpu's ``SECONDDetector``: its conv_module SparseEncoder is
    4 -> 16 at conv_input whatever the first stage's width, and 128 wide
    at conv_out, as gga_tpu builds it."""
    return (_conv_module_encoder_rules(cfg, 'middle_encoder', 16, 128)
            + _anchor_rules(cfg))


def centerpoint_rules(cfg: CenterPointConfig):
    """(torch_key, collection, flax_path, transform) for every tensor of
    gga_tpu's ``CenterPointDetector``, to mmdet3d's CenterPoint names:
    the conv_module SparseEncoder (voxel configs) or PillarFeatureNet
    (pillar configs; its scatter has no parameters), SECOND + SECONDFPN,
    and the CenterHead: per task a SeparateHead (flax numbers its
    ConvModules in output order: reg, height, dim, rot, [vel], heatmap),
    or a DCNSeparateHead: the two deformable adapters (their tap-major
    ``[k*k, Cin / groups, Cout]`` kernels to mmcv's ``[Cout, Cin /
    groups, k, k]``, and ``conv_offset``), ``cls_head`` (flax's
    ``ConvModule2d_0`` and ``heatmap_out``) and ``task_head``."""
    rules = []

    def conv_module(t, f):
        rules.append((f'{t}.conv.weight', 'params', f'{f}/Conv_0/kernel',
                      'conv2d'))
        rules.append((f'{t}.conv.bias', 'params', f'{f}/Conv_0/bias', 'copy'))
        rules.extend(_bn_moves(f'{t}.bn', f'{f}/BatchNorm2d_0/BatchNorm_0'))

    def conv(t, f, transform='conv2d'):
        rules.append((f'{t}.weight', 'params', f'{f}/kernel', transform))
        rules.append((f'{t}.bias', 'params', f'{f}/bias', 'copy'))

    def separate_head(t, f, names):
        for b_i, name in enumerate(names):
            conv_module(f'{t}.{name}.0', f'{f}/ConvModule2d_{b_i}')
            conv(f'{t}.{name}.1', f'{f}/{name}_out')

    if cfg.pillar:
        for i in range(len(cfg.pfn_channels)):
            t = f'pts_voxel_encoder.pfn_layers.{i}'
            rules.append((f'{t}.linear.weight', 'params',
                          f'PillarFeatureNet_0/Dense_{i}/kernel', 'linear'))
            rules.extend(_bn_moves(f'{t}.norm',
                                   f'PillarFeatureNet_0/MaskedBatchNorm_{i}'))
    else:
        rules.extend(_conv_module_encoder_rules(
            cfg, 'pts_middle_encoder', cfg.encoder_channels[0][0],
            cfg.encoder_out_channels))
    rules.extend(_second_fpn_rules(cfg, 'pts_backbone', 'pts_neck'))
    hd, bh = 'CenterHead_0', 'pts_bbox_head'
    conv_module(f'{bh}.shared_conv', f'{hd}/ConvModule2d_0')
    box = list(common_heads(cfg))
    for t in range(len(cfg.tasks)):
        tb, fb = f'{bh}.task_heads.{t}', f'{hd}/task{t}'
        if not cfg.dcn_head:
            separate_head(tb, fb, box + ['heatmap'])
            continue
        for adapt in ('feature_adapt_cls', 'feature_adapt_reg'):
            rules.append((f'{tb}.{adapt}.weight', 'params',
                          f'{fb}/{adapt}/kernel', 'deform2d'))
            conv(f'{tb}.{adapt}.conv_offset', f'{fb}/{adapt}/conv_offset')
        conv_module(f'{tb}.cls_head.0', f'{fb}/ConvModule2d_0')
        conv(f'{tb}.cls_head.1', f'{fb}/heatmap_out')
        separate_head(f'{tb}.task_head', f'{fb}/task_head', box)
    return rules


def pointpillars_rules(cfg: PointPillarsConfig):
    """(torch_key, collection, flax_path, transform) for every tensor of
    gga_tpu's ``PointPillars`` (its scatter has no parameters)."""
    rules = []
    for i in range(len(cfg.pfn_channels)):
        t = f'voxel_encoder.pfn_layers.{i}'
        rules.append((f'{t}.linear.weight', 'params',
                      f'PillarFeatureNet_0/Dense_{i}/kernel', 'linear'))
        rules.extend(_bn_moves(f'{t}.norm',
                               f'PillarFeatureNet_0/MaskedBatchNorm_{i}'))
    return rules + _anchor_rules(cfg)


def sassd_rules(cfg: SASSDConfig):
    """gga_tpu's ``SASSD``: SECOND's tensors plus the auxiliary branch's
    linears (no bias; gga_tpu's top-level ``point_fc``, ``point_cls`` and
    ``point_reg``), which mmdet3d's SparseEncoderSASSD holds."""
    return second_rules(cfg) + [
        (f'middle_encoder.{n}.weight', 'params', f'{n}/kernel', 'linear')
        for n in ('point_fc', 'point_cls', 'point_reg')]


def _sparse_unet_rules(cfg: PartA2Config, me):
    """gga_tpu's ``SparseUNet`` under the port's prefix ``me``, in flax's
    build order: ``SubMConv3dMapped_<n>`` and ``MaskedBatchNorm_<n>``
    numbered across the encoder and the decoder; the strided convs' raw
    kernels ``spconv<i + 1>``, ``conv_out`` and the inverse convs'
    ``inv_<i>``."""
    u = 'SparseUNet_0'
    rules = []
    n = dict(subm=0, bn=0)

    def subm(t, i_ch, o_ch):
        rules.append((f'{t}.weight', 'params',
                      f'{u}/SubMConv3dMapped_{n["subm"]}/kernel',
                      f'sparse3d:{i_ch}:{o_ch}'))
        n['subm'] += 1

    def raw(t, name, i_ch, o_ch):
        rules.append((f'{t}.weight', 'params', f'{u}/{name}',
                      f'sparse3d:{i_ch}:{o_ch}'))

    def bn(t):
        rules.extend(_bn_moves(t, f'{u}/MaskedBatchNorm_{n["bn"]}'))
        n['bn'] += 1

    ch = cfg.unet_channels[0][0]
    subm(f'{me}.conv_input.0', 4, ch)
    bn(f'{me}.conv_input.1')
    for i, blocks in enumerate(cfg.unet_channels):
        for j, out_ch in enumerate(blocks):
            t = f'{me}.encoder_layers.encoder_layer{i + 1}.{j}'
            if i and not j:
                raw(f'{t}.0', f'spconv{i + 1}', ch, out_ch)
            else:
                subm(f'{t}.0', ch, out_ch)
            bn(f'{t}.1')
            ch = out_ch
    raw(f'{me}.conv_out.0', 'conv_out', ch, cfg.unet_out_channels)
    bn(f'{me}.conv_out.1')
    levels = len(cfg.unet_decoder_channels)
    for d, dch in enumerate(cfg.unet_decoder_channels):
        k = levels - d
        lat = f'{me}.lateral_layer{k}'
        subm(f'{lat}.conv1', dch[0], dch[0])
        bn(f'{lat}.bn1')
        subm(f'{lat}.conv2', dch[0], dch[0])
        bn(f'{lat}.bn2')
        subm(f'{me}.merge_layer{k}.0', ch + dch[0], dch[1])
        bn(f'{me}.merge_layer{k}.1')
        up = f'{me}.upsample_layer{k}'
        if k != 1:
            raw(f'{up}.0', f'inv_{k - 1}', dch[1], dch[2])
        else:
            subm(f'{up}.0', dch[1], dch[2])
        bn(f'{up}.1')
        ch = dch[2]
    return rules


def parta2_rules(cfg: PartA2Config):
    """(torch_key, collection, flax_path, transform) for every tensor of
    gga_tpu's ``PartA2Detector``: SparseUNet (``middle_encoder``),
    SECOND + SECONDFPN, the RPN (``rpn_head``), and ``roi_head``: the
    semantic head's two linears and the bbox head. flax numbers the bbox
    head's ``SubMConvDense_<n>`` part convs first, then the seg, merge and
    down convs; its shared FCs ``Dense_<k>`` / ``BatchNorm_<k>``, its
    branches ``cls_<i>`` / ``cls_bn<i>`` / ``cls_out`` (and ``reg_``)."""
    rules = (_sparse_unet_rules(cfg, 'middle_encoder')
             + _second_fpn_rules(cfg, 'backbone', 'neck')
             + _anchor_head_rules('rpn_head'))
    sh = 'roi_head.semantic_head'
    for t, f in (('seg_cls_layer', 'Dense_0'), ('seg_reg_layer', 'Dense_1')):
        rules.append((f'{sh}.{t}.weight', 'params',
                      f'PointwiseSemanticHead_0/{f}/kernel', 'linear'))
        rules.append((f'{sh}.{t}.bias', 'params',
                      f'PointwiseSemanticHead_0/{f}/bias', 'copy'))
    b, h = cfg.bbox, 'PartA2BboxHead_0'
    bh = 'roi_head.bbox_head'
    n_conv = 0
    for t, count in (('conv_part', len(b.part_conv_channels)),
                     ('conv_seg', len(b.seg_conv_channels)),
                     ('conv_down.merge_conv', len(b.merge_conv_channels)),
                     ('conv_down.down_conv', len(b.down_conv_channels))):
        for i in range(count):
            f = f'{h}/SubMConvDense_{n_conv}'
            rules.append((f'{bh}.{t}.{i}.0.weight', 'params',
                          f'{f}/Conv_0/kernel', 'conv3d'))
            rules.extend(_bn_moves(f'{bh}.{t}.{i}.1', f'{f}/MaskedBN_0'))
            n_conv += 1
    step = 2 if b.dropout_ratio > 0 else 1
    for k in range(len(b.shared_fc_channels) - 1):
        t = f'{bh}.shared_fc.{step * k}'
        rules.append((f'{t}.conv.weight', 'params', f'{h}/Dense_{k}/kernel',
                      'linear'))
        rules.extend(_bn_moves(f'{t}.bn', f'{h}/BatchNorm_{k}'))
    for name, chans in (('cls', b.cls_channels), ('reg', b.reg_channels)):
        t = f'{bh}.conv_{name}'
        for i in range(len(chans)):
            idx = i + 1 if i else 0          # a Dropout sits at index 1
            rules.append((f'{t}.{idx}.conv.weight', 'params',
                          f'{h}/{name}_{i}/kernel', 'linear'))
            rules.extend(_bn_moves(f'{t}.{idx}.bn', f'{h}/{name}_bn{i}'))
        rules.append((f'{t}.{len(chans) + 1}.weight', 'params',
                      f'{h}/{name}_out/kernel', 'linear'))
        rules.append((f'{t}.{len(chans) + 1}.bias', 'params',
                      f'{h}/{name}_out/bias', 'copy'))
    return rules


def _to_torch_layout(name, x):
    """One flax tensor -> its mmdet3d state_dict layout."""
    x = np.asarray(x)
    if name.startswith('sparse3d'):
        # flax [K, I, O] -> spconv2 [O, kz, ky, kx, I]
        _, i_ch, o_ch = name.split(':')
        dhw = (3, 1, 1) if x.shape[0] == 3 else (3, 3, 3)
        return x.reshape(*dhw, int(i_ch), int(o_ch)).transpose(4, 0, 1, 2, 3)
    if name == 'linear':            # [I, O] -> [O, I]
        return x.T
    if name == 'conv3d':            # [kx, ky, kz, I, O] -> [O, I, kx, ky, kz]
        return x.transpose(4, 3, 0, 1, 2)
    if name == 'conv2d':            # [kh, kw, I, O] -> [O, I, kh, kw]
        return x.transpose(3, 2, 0, 1)
    if name == 'deform2d':
        # tap-major [k*k, I / groups, O] -> mmcv [O, I / groups, k, k]
        k = int(round(x.shape[0] ** 0.5))
        return x.reshape(k, k, *x.shape[1:]).transpose(3, 2, 0, 1)
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


def rules_of(cfg):
    """The rule table of the detector ``cfg`` describes. The subclasses
    (``SASSDConfig``, ``DVSECONDConfig`` of ``SECONDNetConfig``,
    ``DynamicVoxelNetConfig`` of ``PointPillarsConfig``) are tested before
    their bases; DVSECOND has SECOND's tensors."""
    for cls, rules in ((PartA2Config, parta2_rules),
                       (CenterPointConfig, centerpoint_rules),
                       (PGDModelConfig, pgd_rules),
                       (FCAF3DModelConfig, fcaf3d_rules),
                       (SASSDConfig, sassd_rules),
                       (DynamicVoxelNetConfig, _anchor_rules),
                       (SECONDNetConfig, second_rules),
                       (PointPillarsConfig, pointpillars_rules)):
        if isinstance(cfg, cls):
            return rules(cfg)
    return gga_rules(cfg)


def from_jax_variables(variables_np, cfg):
    """gga_tpu ``{'params', 'batch_stats'}`` trees (nested dicts of numpy
    arrays) of the detector ``cfg`` describes (a ``GGAModelConfig``,
    ``PGDModelConfig``, ``FCAF3DModelConfig``, ``CenterPointConfig``, or
    the config of an anchor detector: ``SECONDNetConfig``,
    ``PointPillarsConfig``, ``DynamicVoxelNetConfig``, ``DVSECONDConfig``
    or ``SASSDConfig``, or a ``PartA2Config``) ->
    the port's ``load_state_dict`` input (f32 tensors)."""
    flat = {c: _flatten(variables_np.get(c, {}))
            for c in ('params', 'batch_stats')}
    rules = rules_of(cfg)
    out = {}
    for tk, coll, fp, tr in rules:
        if fp in flat[coll]:
            arr = _to_torch_layout(tr, flat[coll][fp])
            # np.array keeps a 0-d array 0-d (fuse_lambda), as
            # np.ascontiguousarray would not
            out[tk] = torch.from_numpy(np.array(arr, dtype=np.float32,
                                                order='C'))
    return out
