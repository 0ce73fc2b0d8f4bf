"""gga_tpu (flax) variables -> the port's state_dict.

The port's modules carry mmdet3d's state_dict keys, so this is the
port's own copy of the GGA rule table and layout transforms of
``tools/model_converters/torch2flax.py`` (``gga_rules``,
``_gga_transform``), run from flax to torch, and the same for the stage-4
PGD detector (``pgd_rules``: flax's automatic names of ResNet, FPN and
PGDHead to mmdet3d's keys), the indoor FCAF3D detector
(``fcaf3d_rules``) and the supervised KITTI voxel detectors
(``second_rules`` for SECOND and DVSECOND, ``pointpillars_rules`` with
the SECOND or a RegNet backbone and the SECONDFPN or FPN neck, FreeAnchor
included, ``sassd_rules``, and DynamicVoxelNet's dense half alone, whose
voxel features and scatter have no parameters) and SSN (``ssn_rules``);
the RegNet backbones' ``regnet_rules`` are the copy of
``torch2flax.regnet_rules`` (``export_regnet`` gives the same tensors) and the nuScenes CenterPoint
family (``centerpoint_rules``: voxel and pillar, with and without the DCN
head, to mmdet3d's CenterPoint names); gga_tpu has no converter rules for
these, so theirs stand alone; and PartA2 (``parta2_rules``: SparseUNet,
SECOND + SECONDFPN, the RPN, the semantic head and the part-aggregation
bbox head, whose dense 3-D convs and linears keep torch's layouts); and
VoteNet (``votenet_rules``, the copy of ``torch2flax.votenet_rules`` and
``_votenet_pred_slices``: the fused ``pred_out`` goes to mmdet3d's
``conv_cls`` and ``conv_reg`` as ``export_votenet`` splits it); and the
point-based KITTI detectors, which ``torch2flax`` has no rules for:
3DSSD (``ssd3d_rules``) and PointRCNN (``point_rcnn_rules``), under
mmdet3d's module names:

- ``backbone.SA_modules.{i}.mlps.{j}.layer{k}.conv.weight`` / ``.bn.*``
  from ``PointNet2SAMSG_0/sa{i}/mlp{j}/fc{k}`` / ``bn{k}`` (Conv2d), and
  3DSSD's ``backbone.aggregation_mlps.{i}`` from ``sa{i}/aggregation``;
- 3DSSD's ``bbox_head.vote_module.vote_conv.{k}`` / ``conv_out`` from
  ``SSD3DHead_0/vote_mlp`` / ``vote_out``, ``bbox_head.vote_aggregation
  .mlps.{j}`` from ``vote_aggregation/mlp{j}``, ``bbox_head.conv_pred
  .shared_convs`` / ``cls_convs`` / ``conv_cls`` / ``reg_convs`` /
  ``conv_reg`` from ``pred_shared`` / ``cls_convs`` / ``conv_cls`` /
  ``reg_convs`` / ``conv_reg``;
- PointRCNN's ``neck.FP_modules.{i}.mlps.layer{k}`` from
  ``PointNetFPNeck_0/fp{i}/SharedMLP_0``; ``rpn_head.cls_layers.{3k}``
  (Linear) / ``{3k + 1}`` (norm) / ``{3n}`` (Linear with bias) from
  ``PointRPNHead_0/cls_fc{k}`` / ``cls_bn{k}`` / ``cls_out`` (and
  ``reg_``); ``roi_head.bbox_head.xyz_up_layer.{k}`` /
  ``merge_down_layer`` / ``SA_modules.{i}.mlps.0.layer{k}`` from
  ``PointRCNNBboxHead_0/xyz_up`` / ``merge_down`` / ``sa{i}`` (its
  ``SharedMLP_0`` where the level samples), and ``cls_layer.{k}`` /
  ``cls_layer.{n}`` from ``cls`` / ``cls_out`` (and ``reg``);

and the point-cloud segmentors, which ``torch2flax`` has no rules for
either: the PointNet++ ``EncoderDecoder3D`` (``encoder_decoder_rules``:
``backbone.SA_modules.*`` as VoteNet's or 3DSSD's encoder,
``decode_head.FP_modules.{i}.mlps.layer{k}`` from
``PointNet2SegHead_0/fp{i}/SharedMLP_0``, ``decode_head.pre_seg_conv``
from ``pre_seg``, ``decode_head.conv_seg`` from ``cls_seg``), DGCNN
(``dgcnn_rules``: ``backbone.GF_modules.{i}.mlps.layer{k}`` (Conv2d)
from ``backbone/gf{i}/SharedMLP_0``, ``backbone.FA_module.mlps`` from
``backbone/fa``, ``decode_head.FP_module.mlps`` from ``fp``, the
pre-seg and class layers from ``pre_seg`` / ``cls_seg``) and PAConv
(``paconv_rules``: ``backbone.SA_modules.{i}.mlps.0.layer{k}.weight_bank``
from ``sa{i}/paconv{k}/weight_bank`` as it is, ``.scorenet.mlps.layer
{0,1}`` and ``.scorenet.mlps.layer2.conv`` (Conv2d) from ``scorenet/mlp``
and ``scorenet/out``, ``.bn`` from ``bn``, and the head as
EncoderDecoder3D's from ``fp{i}/SharedMLP_0``, ``pre_seg``, ``cls_seg``);

and the VoteNet-derived indoor detectors: GroupFree3D
(``groupfree3d_rules``: ``bbox_head.points_obj_cls.mlp.layer{k}`` from
``GroupFree3DHead_0/points_obj_cls`` and ``points_obj_out``,
``conv_pred`` / ``prediction_heads.{i}`` from ``proposal_*`` / ``s{i}_*``,
``decoder_{self,cross}_posembeds.{i}`` from ``{self,cross}_pos{i}``,
``decoder_layers.{i}.attentions.{0,1}.attn`` / ``ffns.0`` / ``norms``
from ``decoder{i}/{self,cross}_attn`` / ``ffn0``, ``ffn1`` /
``norm1-3``), H3DNet (``h3dnet_rules``, ``torch2flax.h3dnet_rules`` and
the port's own keys for the refinement) and ImVoteNet
(``imvotenet_rules``); and the monocular KITTI detectors SMOKE
(``smoke_rules``: DLA-34 and the DLANeck, whose depthwise upsampler's
kernel is flipped, ``depthwise_deconv2d``, and the SMOKE head; or the
ResNet variant with its up-fuse blocks) and MonoFlex
(``monoflex_rules``: the same DLA, the head's branches and its two edge
fusions' 1-D convs and batch norms).

A released mmdet3d GGA checkpoint loads into the port directly, with no
conversion.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .models.backbones import mink_resnet
from .models.backbones.dgcnn import DGCNNConfig
from .models.backbones.paconv import PAConvConfig
from .models.backbones import dla, regnet
from .models.backbones.resnet import ARCH
from .models.detectors.centerpoint import CenterPointConfig, common_heads
from .models.detectors.dynamic_voxelnet import DynamicVoxelNetConfig
from .models.detectors.fcaf3d import FCAF3DModelConfig
from .models.detectors.groupfree3d import GroupFree3DNetConfig
from .models.detectors.h3dnet import H3DNetConfig
from .models.detectors.imvotenet import ImVoteNetConfig
from .models.detectors.imvoxelnet import (ImVoxelNetConfig,
                                          ImVoxelNetIndoorConfig)
from .models.dense_heads import monoflex_head
from .models.detectors.monoflex import MonoFlexModelConfig
from .models.detectors.mvxnet import MVXNetConfig
from .models.detectors.parta2 import PartA2Config
from .models.detectors.pgd import PGDModelConfig
from .models.detectors.point_rcnn import PointRCNNConfig
from .models.detectors.sassd import SASSDConfig
from .models.detectors.smoke import SMOKEModelConfig
from .models.detectors.ssd3d import SSD3DNetConfig
from .models.detectors.ssn import SSNConfig
from .models.detectors.votenet import VoteNetConfig
from .models.detectors.voxelnet import PointPillarsConfig, SECONDNetConfig
from .models.segmentors.encoder_decoder import EncoderDecoder3DConfig


def _bn_moves(torch_prefix, flax_prefix):
    return [(f'{torch_prefix}.weight', 'params', f'{flax_prefix}/scale',
             'copy'),
            (f'{torch_prefix}.bias', 'params', f'{flax_prefix}/bias', 'copy'),
            (f'{torch_prefix}.running_mean', 'batch_stats',
             f'{flax_prefix}/mean', 'copy'),
            (f'{torch_prefix}.running_var', 'batch_stats',
             f'{flax_prefix}/var', 'copy')]


def _second_rules(cfg, backbone):
    """gga_tpu's ``SECOND_0`` at the port's prefix ``backbone``."""
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
    return rules


def _secfpn_rules(cfg, neck):
    """gga_tpu's ``SECONDFPN_0`` at the port's prefix ``neck``."""
    rules = []
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


def _second_fpn_rules(cfg, backbone, neck):
    """SECOND (``backbone``) + SECONDFPN (``neck``) of any of gga_tpu's
    detectors that build them under ``SECOND_0`` / ``SECONDFPN_0``."""
    return _second_rules(cfg, backbone) + _secfpn_rules(cfg, neck)


def regnet_rules(arch, backbone='backbone', flax_prefix='NoStemRegNet_0',
                 in_channels=64):
    """(torch_key, collection, flax_path, transform) for gga_tpu's
    NoStemRegNet: the port's copy of ``torch2flax.regnet_rules`` (mmdet's
    ``layer{i}.{j}.conv1-3`` / ``bn1-3`` / ``downsample.0/1``, its
    ``conv_oihw`` being the port's ``conv2d``), with the torch keys under
    ``backbone`` and the flax paths under ``flax_prefix`` (empty for the
    backbone's own variables)."""
    widths, depths, _ = regnet.generate_regnet(**regnet.REGNET_ARCHS[arch])
    pre = f'{flax_prefix}/' if flax_prefix else ''
    rules = []
    blk = 0
    prev_w = in_channels
    for i, (w, d) in enumerate(zip(widths, depths)):
        for j in range(d):
            t = f'{backbone}.layer{i + 1}.{j}'
            f = f'{pre}RegNetXBlock_{blk}'
            for conv, fmod in (('conv1', 'ConvModule2d_0'),
                               ('conv3', 'ConvModule2d_1')):
                rules.append((f'{t}.{conv}.weight', 'params',
                              f'{f}/{fmod}/Conv_0/kernel', 'conv2d'))
            rules.append((f'{t}.conv2.weight', 'params',
                          f'{f}/Conv_0/kernel', 'conv2d'))
            for bn, fmod in (('bn1', 'ConvModule2d_0/BatchNorm2d_0'),
                             ('bn2', 'BatchNorm2d_0'),
                             ('bn3', 'ConvModule2d_1/BatchNorm2d_0')):
                rules += _bn_moves(f'{t}.{bn}', f'{f}/{fmod}/BatchNorm_0')
            stride = regnet.STRIDES[i] if j == 0 else 1
            if stride != 1 or prev_w != w:
                rules.append((f'{t}.downsample.0.weight', 'params',
                              f'{f}/ConvModule2d_2/Conv_0/kernel', 'conv2d'))
                rules += _bn_moves(
                    f'{t}.downsample.1',
                    f'{f}/ConvModule2d_2/BatchNorm2d_0/BatchNorm_0')
            prev_w = w
            blk += 1
    return rules


def _fpn_rules(num_levels, neck):
    """gga_tpu's ``FPN_0`` of ``num_levels`` levels and no extra ones."""
    rules = []
    for i in range(num_levels):
        for t, f in (('lateral_convs', 'lateral'), ('fpn_convs', 'fpn')):
            rules.append((f'{neck}.{t}.{i}.conv.weight', 'params',
                          f'FPN_0/{f}{i}/kernel', 'conv2d'))
            rules.append((f'{neck}.{t}.{i}.conv.bias', 'params',
                          f'FPN_0/{f}{i}/bias', 'copy'))
    return rules


def _pillar_dense_rules(cfg, neck='secfpn'):
    """The pillar detectors' PillarFeatureNet, SECOND or NoStemRegNet
    backbone and SECONDFPN or FPN neck under mmdet3d's names."""
    rules = []
    for i in range(len(cfg.pfn_channels)):
        t = f'voxel_encoder.pfn_layers.{i}'
        rules.append((f'{t}.linear.weight', 'params',
                      f'PillarFeatureNet_0/Dense_{i}/kernel', 'linear'))
        rules.extend(_bn_moves(f'{t}.norm',
                               f'PillarFeatureNet_0/MaskedBatchNorm_{i}'))
    if cfg.backbone == 'second':
        rules += _second_rules(cfg, 'backbone')
        levels = len(cfg.backbone_channels)
    else:
        rules += regnet_rules(cfg.backbone,
                              in_channels=cfg.pfn_channels[-1])
        levels = 3
    if neck == 'fpn':
        return rules + _fpn_rules(levels, 'neck')
    return rules + _secfpn_rules(cfg, 'neck')


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


def _conv_rules(rules, torch_prefix, flax_prefix, bias=True,
                transform='conv2d'):
    rules.append((f'{torch_prefix}.weight', 'params',
                  f'{flax_prefix}/kernel', transform))
    if bias:
        rules.append((f'{torch_prefix}.bias', 'params',
                      f'{flax_prefix}/bias', 'copy'))


def _resnet_rules(rules, depth, backbone, base_planes=64):
    """gga_tpu's ``ResNet_0`` under mmdet's names at the prefix
    ``backbone``: blocks numbered across stages, in a block the convs and
    norms in order, the projection shortcut last."""
    def bn(torch_prefix, flax_prefix):
        rules.extend(_bn_moves(torch_prefix, f'{flax_prefix}/BatchNorm_0'))

    r = 'ResNet_0'
    _conv_rules(rules, f'{backbone}.conv1', f'{r}/Conv_0', bias=False)
    bn(f'{backbone}.bn1', f'{r}/BatchNorm2d_0')
    stage_blocks, kind = ARCH[depth]
    n_convs, expansion = (3, 4) if kind == 'bottleneck' else (2, 1)
    name = 'Bottleneck' if kind == 'bottleneck' else 'BasicBlock'
    k, channels, planes = 0, base_planes, base_planes
    for i, n_blocks in enumerate(stage_blocks):
        for j in range(n_blocks):
            t, f = f'{backbone}.layer{i + 1}.{j}', f'{r}/{name}_{k}'
            for c in range(n_convs):
                _conv_rules(rules, f'{t}.conv{c + 1}', f'{f}/Conv_{c}',
                            bias=False)
                bn(f'{t}.bn{c + 1}', f'{f}/BatchNorm2d_{c}')
            if channels != planes * expansion or (i and not j):
                _conv_rules(rules, f'{t}.downsample.0', f'{f}/Conv_{n_convs}',
                            bias=False)
                bn(f'{t}.downsample.1', f'{f}/BatchNorm2d_{n_convs}')
            channels = planes * expansion
            k += 1
        planes *= 2


def _resnet_fpn_rules(rules, depth, backbone, neck, start_level, num_outs):
    """gga_tpu's ``ResNet_0`` and ``FPN_0`` under mmdet's names at the
    prefixes ``backbone`` and ``neck``; the FPN's extra levels continue
    the ``fpn_convs`` index."""
    _resnet_rules(rules, depth, backbone)
    n_in = len(ARCH[depth][0]) - start_level
    for i in range(n_in):
        _conv_rules(rules, f'{neck}.lateral_convs.{i}.conv',
                    f'FPN_0/lateral{i}')
        _conv_rules(rules, f'{neck}.fpn_convs.{i}.conv', f'FPN_0/fpn{i}')
    for i in range(n_in, num_outs):
        _conv_rules(rules, f'{neck}.fpn_convs.{i}.conv',
                    f'FPN_0/fpn_extra{i}')


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

    _resnet_fpn_rules(rules, cfg.backbone_depth, 'backbone', 'neck',
                      cfg.fpn_start_level, cfg.fpn_num_outs)

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


def _group_norm_rules(rules, torch_prefix, flax_prefix):
    rules.append((f'{torch_prefix}.weight', 'params', f'{flax_prefix}/scale',
                  'copy'))
    rules.append((f'{torch_prefix}.bias', 'params', f'{flax_prefix}/bias',
                  'copy'))


def _dla_conv_rules(rules, t, f):
    """gga_tpu's ``_Conv`` ``f`` (its ``Conv_0`` and ``_Norm_0``) ->
    ``t.0`` / ``t.1``."""
    _conv_rules(rules, f'{t}.0', f'{f}/Conv_0', bias=False)
    _group_norm_rules(rules, f'{t}.1', f'{f}/_Norm_0/GroupNorm_0')


def _dla_block_rules(rules, t, f):
    """gga_tpu's ``DLABasicBlock`` (``_Conv_0``, ``_Conv_1``) ->
    ``conv1`` / ``norm1``, ``conv2`` / ``norm2``."""
    for c in range(2):
        _conv_rules(rules, f'{t}.conv{c + 1}', f'{f}/_Conv_{c}/Conv_0',
                    bias=False)
        _group_norm_rules(rules, f'{t}.norm{c + 1}',
                          f'{f}/_Conv_{c}/_Norm_0/GroupNorm_0')


def _dla_tree_rules(rules, t, f, levels, in_channels, out_channels):
    if in_channels != out_channels:
        _dla_conv_rules(rules, f'{t}.project', f'{f}/project')
    if levels == 1:
        _dla_block_rules(rules, f'{t}.tree1', f'{f}/tree1')
        _dla_block_rules(rules, f'{t}.tree2', f'{f}/tree2')
        _conv_rules(rules, f'{t}.root.conv', f'{f}/root/Conv_0', bias=False)
        _group_norm_rules(rules, f'{t}.root.norm',
                          f'{f}/root/_Norm_0/GroupNorm_0')
        return
    _dla_tree_rules(rules, f'{t}.tree1', f'{f}/tree1', levels - 1,
                    in_channels, out_channels)
    _dla_tree_rules(rules, f'{t}.tree2', f'{f}/tree2', levels - 1,
                    out_channels, out_channels)


def _dla_rules(rules, channels, backbone='backbone', neck='neck'):
    """gga_tpu's ``DLANet_0`` and ``DLANeck_0`` (start level 2, end level
    5) under mmdet3d's names: the DLA levels and trees, then each IDA's
    ``proj{k}`` / ``node{k}`` (conv with a bias, GroupNorm) and ``up{k}``
    (the depthwise transposed conv's kernel, flipped) to ``projs.{k}`` /
    ``nodes.{k}`` / ``ups.{k}``."""
    levels = dla.ARCH[34][0]
    d = 'DLANet_0'
    _dla_conv_rules(rules, f'{backbone}.base_layer', f'{d}/base_layer')
    for i in range(2):
        _dla_conv_rules(rules, f'{backbone}.level{i}', f'{d}/level{i}_conv0')
    for i in range(2, len(levels)):
        _dla_tree_rules(rules, f'{backbone}.level{i}', f'{d}/level{i}',
                        levels[i], channels[i - 1], channels[i])

    def ida(t, f, steps):
        for k in range(steps):
            for name, flax_name in (('projs', 'proj'), ('nodes', 'node')):
                _conv_rules(rules, f'{t}.{name}.{k}.conv',
                            f'{f}/{flax_name}{k}/Conv_0')
                _group_norm_rules(rules, f'{t}.{name}.{k}.gn',
                                  f'{f}/{flax_name}{k}/_Norm_0/GroupNorm_0')
            rules.append((f'{t}.ups.{k}.weight', 'params', f'{f}/up{k}/kernel',
                          'depthwise_deconv2d'))

    n = len(channels) - 2
    for i in range(n - 1):
        ida(f'{neck}.dla_up.ida_{i}', f'DLANeck_0/dla_ida{i}', i + 1)
    ida(f'{neck}.ida_up', 'DLANeck_0/ida_up', 2)


def _branch_rules(rules, t, f, conv, gn):
    """A head branch's 3x3 conv (with a bias) and GroupNorm ->
    ``t.conv`` / ``t.gn``."""
    _conv_rules(rules, f'{t}.conv', f'{f}/{conv}')
    _group_norm_rules(rules, f'{t}.gn', f'{f}/{gn}')


def smoke_rules(cfg: SMOKEModelConfig):
    """(torch_key, collection, flax_path, transform) for every tensor of
    gga_tpu's ``SMOKEDetector``: the DLA backbone and neck (or, with
    ``backbone='resnet'``, ``ResNet_0`` and ``_UpFuse_{i}`` to
    ``up_fuses.{i}``: ``Conv_0`` the 3x3 ``conv_up``, ``Conv_1`` the 1x1
    ``conv_lateral``, the batch norm ``bn``), then ``SMOKEHead_0``'s
    ``hm_*`` and ``reg_*`` branches to ``conv_cls_prev.0`` /
    ``conv_cls`` and ``conv_reg_prevs.0.0`` / ``conv_regs.0``."""
    rules = []
    if cfg.backbone == 'dla':
        _dla_rules(rules, cfg.dla_channels or dla.ARCH[34][1])
    else:
        _resnet_rules(rules, cfg.img_depth, 'backbone', cfg.img_base_planes)
        for i in range(3):
            t, f = f'up_fuses.{i}', f'_UpFuse_{i}'
            _conv_rules(rules, f'{t}.conv_up', f'{f}/Conv_0', bias=False)
            _conv_rules(rules, f'{t}.conv_lateral', f'{f}/Conv_1', bias=False)
            rules.extend(_bn_moves(f'{t}.bn', f'{f}/BatchNorm2d_0/'
                                   'BatchNorm_0'))
    t, f = 'bbox_head', 'SMOKEHead_0'
    _branch_rules(rules, f'{t}.conv_cls_prev.0', f, 'hm_conv', 'hm_gn')
    _conv_rules(rules, f'{t}.conv_cls', f'{f}/hm_out')
    _branch_rules(rules, f'{t}.conv_reg_prevs.0.0', f, 'reg_conv', 'reg_gn')
    _conv_rules(rules, f'{t}.conv_regs.0', f'{f}/reg_out')
    return rules


def monoflex_rules(cfg: MonoFlexModelConfig):
    """(torch_key, collection, flax_path, transform) for every tensor of
    gga_tpu's ``MonoFlexDetector``: the DLA backbone and neck, then
    ``MonoFlexHead_0``'s ``cls_*`` branch to ``conv_cls_prev.0`` /
    ``conv_cls``, each ``reg_{group}_*`` branch to ``conv_reg_prevs.{g}.0``
    / ``conv_regs.{g}``, and the edge fusions ``edge_fuse_cls`` and
    ``edge_fuse_offsets2d`` (``conv``, ``bn``, ``out``: 1-D kernels
    [k, I, O] to [O, I, k]) to ``edge_fuse_cls`` / ``edge_fuse_reg``
    (``edge_convs.0.conv``, ``edge_convs.0.bn``, ``edge_convs.1``)."""
    rules = []
    _dla_rules(rules, cfg.dla_channels or dla.ARCH[34][1])
    t, f = 'bbox_head', 'MonoFlexHead_0'
    _branch_rules(rules, f'{t}.conv_cls_prev.0', f, 'cls_conv', 'cls_gn')
    _conv_rules(rules, f'{t}.conv_cls', f'{f}/cls_out')
    for g, (name, _) in enumerate(monoflex_head.GROUPS):
        _branch_rules(rules, f'{t}.conv_reg_prevs.{g}.0', f,
                      f'reg_{name}_conv', f'reg_{name}_gn')
        _conv_rules(rules, f'{t}.conv_regs.{g}', f'{f}/reg_{name}_out')
    if cfg.head.use_edge_fusion:
        for tn, fn in (('edge_fuse_cls', 'edge_fuse_cls'),
                       ('edge_fuse_reg', 'edge_fuse_offsets2d')):
            e, ef = f'{t}.{tn}.edge_convs', f'{f}/{fn}'
            _conv_rules(rules, f'{e}.0.conv', f'{ef}/conv', bias=False,
                        transform='conv1d')
            rules.extend(_bn_moves(f'{e}.0.bn', f'{ef}/bn'))
            _conv_rules(rules, f'{e}.1', f'{ef}/out', transform='conv1d')
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


def _conv_module_encoder_rules(cfg, me, base, out_channels, in_channels=4):
    """gga_tpu's conv_module SparseEncoder under the port's prefix ``me``:
    it numbers every block ``SparseConvBlock_<n>`` in build order (SubM
    and strided alike, conv_out last); conv_input is ``in_channels`` ->
    ``base``."""
    enc = 'SparseEncoder_0'
    rules = [(f'{me}.conv_input.0.weight', 'params',
              f'{enc}/SubMConv3dMapped_0/kernel',
              f'sparse3d:{in_channels}:{base}')]
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
    gga_tpu's ``PointPillars`` (its scatter has no parameters), with the
    SECOND or a RegNet backbone and the SECONDFPN or FPN neck; FreeAnchor's
    are the same."""
    return (_pillar_dense_rules(cfg, cfg.neck)
            + _anchor_head_rules('bbox_head'))


def ssn_rules(cfg: SSNConfig):
    """gga_tpu's ``SSNDetector``: the pillar net, SECOND or NoStemRegNet,
    SECONDFPN, and the shape-aware head under mmdet3d's ShapeAwareHead
    names (``bbox_head.heads.{i}.shared_conv.{j}.conv`` / ``.bn`` from
    ``ShapeAwareHead_0/task{i}_conv{j}``, ``conv_cls`` / ``conv_reg`` /
    ``conv_dir_cls`` from ``task{i}_cls`` / ``_reg`` / ``_dir``)."""
    rules = _pillar_dense_rules(cfg)
    for ti, task in enumerate(cfg.head.tasks):
        t, f = f'bbox_head.heads.{ti}', f'ShapeAwareHead_0/task{ti}'
        for j in range(len(task.shared_conv_channels)):
            rules.append((f'{t}.shared_conv.{j}.conv.weight', 'params',
                          f'{f}_conv{j}/Conv_0/kernel', 'conv2d'))
            rules.extend(_bn_moves(f'{t}.shared_conv.{j}.bn',
                                   f'{f}_conv{j}/BatchNorm2d_0/BatchNorm_0'))
        for tn, fn in (('conv_cls', 'cls'), ('conv_reg', 'reg'),
                       ('conv_dir_cls', 'dir')):
            rules.append((f'{t}.{tn}.weight', 'params', f'{f}_{fn}/kernel',
                          'conv2d'))
            rules.append((f'{t}.{tn}.bias', 'params', f'{f}_{fn}/bias',
                          'copy'))
    return rules


def sassd_rules(cfg: SASSDConfig):
    """gga_tpu's ``SASSD``: SECOND's tensors plus the auxiliary branch's
    linears (no bias; gga_tpu's top-level ``point_fc``, ``point_cls`` and
    ``point_reg``), which mmdet3d's SparseEncoderSASSD holds."""
    return second_rules(cfg) + [
        (f'middle_encoder.{n}.weight', 'params', f'{n}/kernel', 'linear')
        for n in ('point_fc', 'point_cls', 'point_reg')]


def mvxnet_rules(cfg: MVXNetConfig):
    """(torch_key, collection, flax_path, transform) for every tensor of
    gga_tpu's ``MVXNet`` under mmdet3d's names: ``img_backbone`` /
    ``img_neck`` from ``ResNet_0`` / ``FPN_0``; the DynamicVFE's
    ``pts_voxel_encoder.vfe_layers.{i}.{0,1}`` from ``vfe/vfe{i}`` /
    ``vfe/vfe_bn{i}`` and its ``fusion_layer`` from the top-level
    ``fusion`` (``lateral{i}`` ConvModules, ``img_transform`` /
    ``img_bn``, ``pts_transform`` / ``pts_bn``); the conv_module encoder
    (``fusion_out_channels`` -> 16 at conv_input, 128 at conv_out) and the
    SECOND stack under ``pts_``."""
    rules = []
    _resnet_fpn_rules(rules, cfg.img_depth, 'img_backbone', 'img_neck', 0,
                      len(cfg.img_levels))
    ve, fu = 'pts_voxel_encoder', 'pts_voxel_encoder.fusion_layer'
    for i in range(len(cfg.vfe_channels)):
        rules.append((f'{ve}.vfe_layers.{i}.0.weight', 'params',
                      f'vfe/vfe{i}/kernel', 'linear'))
        rules.extend(_bn_moves(f'{ve}.vfe_layers.{i}.1', f'vfe/vfe_bn{i}'))
    for i in range(len(cfg.img_levels)):
        rules.append((f'{fu}.lateral_convs.{i}.conv.weight', 'params',
                      f'fusion/lateral{i}/Conv_0/kernel', 'conv2d'))
        rules.extend(_bn_moves(f'{fu}.lateral_convs.{i}.bn',
                               f'fusion/lateral{i}/BatchNorm2d_0/'
                               'BatchNorm_0'))
    for t, f in (('img_transform', 'img'), ('pts_transform', 'pts')):
        rules.append((f'{fu}.{t}.0.weight', 'params',
                      f'fusion/{t}/kernel', 'linear'))
        rules.append((f'{fu}.{t}.0.bias', 'params', f'fusion/{t}/bias',
                      'copy'))
        rules.extend(_bn_moves(f'{fu}.{t}.1', f'fusion/{f}_bn'))
    rules.extend(_conv_module_encoder_rules(
        cfg, 'pts_middle_encoder', 16, 128, cfg.fusion_out_channels))
    rules.extend(_second_fpn_rules(cfg, 'pts_backbone', 'pts_neck'))
    return rules + _anchor_head_rules('pts_bbox_head')


def _conv_module3d_rules(rules, t, f):
    """gga_tpu's ``ConvModule3d`` ``f`` (its ``Conv_0`` and norm) ->
    ``t.conv`` / ``t.bn``."""
    rules.append((f'{t}.conv.weight', 'params', f'{f}/Conv_0/kernel',
                  'conv3d'))
    rules.extend(_bn_moves(f'{t}.bn', f'{f}/BatchNorm2d_0/BatchNorm_0'))


def _res_module3d_rules(rules, t, f, shortcut):
    """gga_tpu's ``ResModule3d`` ``f`` -> ``t.conv0`` (its ConvModule3d),
    ``t.conv1`` (its ``Conv_0`` and first norm) and, with ``shortcut``,
    ``t.downsample`` (``Conv_1`` and the second norm)."""
    _conv_module3d_rules(rules, f'{t}.conv0', f'{f}/ConvModule3d_0')
    convs = (('conv1', 0), ('downsample', 1)) if shortcut else (('conv1', 0),)
    for name, i in convs:
        rules.append((f'{t}.{name}.conv.weight', 'params',
                      f'{f}/Conv_{i}/kernel', 'conv3d'))
        rules.extend(_bn_moves(f'{t}.{name}.bn',
                               f'{f}/BatchNorm2d_{i}/BatchNorm_0'))


def imvoxelnet_rules(cfg: ImVoxelNetConfig):
    """(torch_key, collection, flax_path, transform) for every tensor of
    gga_tpu's KITTI ``ImVoxelNet`` under mmdet3d's names: ``backbone`` /
    ``neck`` (ResNet + FPN), ``neck_3d.model.{0-5}`` from
    ``OutdoorImVoxelNeck_0``'s ResModule3d / ConvModule3d pairs (the 3-D
    kernels ``[kx, ky, kz, I, O]`` to ``[O, I, kx, ky, kz]``) and
    ``bbox_head`` (Anchor3DHead)."""
    rules = []
    _resnet_fpn_rules(rules, cfg.img_depth, 'backbone', 'neck', 0, 4)
    n = 'OutdoorImVoxelNeck_0'
    for k in range(3):
        _res_module3d_rules(rules, f'neck_3d.model.{2 * k}',
                            f'{n}/ResModule3d_{k}', False)
        _conv_module3d_rules(rules, f'neck_3d.model.{2 * k + 1}',
                             f'{n}/ConvModule3d_{k}')
    return rules + _anchor_head_rules('bbox_head')


def imvoxelnet_indoor_rules(cfg: ImVoxelNetIndoorConfig):
    """(torch_key, collection, flax_path, transform) for every tensor of
    gga_tpu's ``ImVoxelNetIndoor`` under mmdet3d's names: ResNet + FPN;
    ``neck_3d.down_layer_{i}.{j}`` from ``IndoorImVoxelNeck_0``'s
    ``ResModule3d_*`` in build order, ``up_block_{i}.{0,1}`` (the
    transposed conv, flipped on its three spatial axes, ``deconv3d``) and
    ``.{3,4}`` from its ``_UpBlock3d_*`` and ``out_block_{i}`` from its
    ``ConvModule3d_*`` (both built from the coarsest level up); the
    head's ``conv_center`` / ``conv_reg`` / ``conv_cls`` and
    ``scales.{i}.scale`` from ``ImVoxelHead_0``."""
    rules = []
    _resnet_fpn_rules(rules, cfg.img_depth, 'backbone', 'neck', 0, 4)
    n, nb = 'IndoorImVoxelNeck_0', tuple(cfg.neck3d_blocks)
    k = 0
    for i, blocks in enumerate(nb):
        for j in range(blocks):
            _res_module3d_rules(rules, f'neck_3d.down_layer_{i}.{j}',
                                f'{n}/ResModule3d_{k}', j == 0 and i > 0)
            k += 1
    for u, i in enumerate(range(len(nb) - 1, -1, -1)):
        f = f'{n}/ConvModule3d_{u}'
        rules.append((f'neck_3d.out_block_{i}.0.weight', 'params',
                      f'{f}/Conv_0/kernel', 'conv3d'))
        rules.extend(_bn_moves(f'neck_3d.out_block_{i}.1',
                               f'{f}/BatchNorm2d_0/BatchNorm_0'))
        if i:       # up_block_i takes level i to level i - 1
            t, f = f'neck_3d.up_block_{i}', f'{n}/_UpBlock3d_{u}'
            rules.append((f'{t}.0.weight', 'params',
                          f'{f}/ConvTranspose_0/kernel', 'deconv3d'))
            rules.extend(_bn_moves(f'{t}.1',
                                   f'{f}/BatchNorm2d_0/BatchNorm_0'))
            rules.append((f'{t}.3.weight', 'params',
                          f'{f}/ConvModule3d_0/Conv_0/kernel', 'conv3d'))
            rules.extend(_bn_moves(f'{t}.4', f'{f}/ConvModule3d_0/'
                                   'BatchNorm2d_0/BatchNorm_0'))
    h = 'ImVoxelHead_0'
    for name in ('conv_center', 'conv_reg', 'conv_cls'):
        rules.append((f'bbox_head.{name}.weight', 'params',
                      f'{h}/{name}/kernel', 'conv3d'))
    rules.append(('bbox_head.conv_cls.bias', 'params', f'{h}/conv_cls/bias',
                  'copy'))
    for lvl in range(cfg.head.n_levels):
        rules.append((f'bbox_head.scales.{lvl}.scale', 'params',
                      f'{h}/scale_lvl{lvl}', 'copy'))
    return rules


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


def votenet_rules(cfg: VoteNetConfig):
    """(torch key, collection, flax path, transform) of VoteNet
    (``torch2flax.votenet_rules`` with the fc / bn placeholders resolved,
    plus the fused ``pred_out`` split as ``export_votenet`` splits it:
    ``cols:`` transforms take the listed column ranges). The set
    abstractions' conv weights are Conv2d ``[O, I, 1, 1]``
    (``conv1x1_2d``), every other 1x1 weight Conv1d ``[O, I, 1]``."""
    rules = []
    _sassg_rules(rules, 'backbone', 'PointNet2SASSG_0', cfg.sa_channels,
                 cfg.fp_channels)
    _vote_head_rules(rules, 'bbox_head', 'VoteHead_0', cfg.head)
    return rules


def _sassg_rules(rules, torch_prefix, flax_prefix, sa_channels, fp_channels):
    """A ``PointNet2SASSG`` under ``torch_prefix`` / ``flax_prefix``."""
    for i, chans in enumerate(sa_channels):
        _shared_mlp(rules, f'{torch_prefix}.SA_modules.{i}.mlps.0',
                    f'{flax_prefix}/sa{i}/SharedMLP_0', chans,
                    conv='conv1x1_2d')
    for i, chans in enumerate(fp_channels):
        _shared_mlp(rules, f'{torch_prefix}.FP_modules.{i}.mlps',
                    f'{flax_prefix}/fp{i}/SharedMLP_0', chans)


def _vote_head_rules(rules, t, f, h):
    """A ``VoteHead`` (config ``h``) under ``t`` / ``f``: the vote module,
    the aggregation, the shared pred convs, and gga_tpu's fused
    ``pred_out`` [obj 2 | reg n_reg | sem c] split into mmdet3d's
    ``conv_cls`` (objectness and classes) and ``conv_reg`` (the rest)."""
    _shared_mlp(rules, f'{t}.vote_module.vote_conv', f'{f}/vote_mlp',
                h.vote_conv_channels, child='{k}')
    _conv_out(rules, f'{t}.vote_module.conv_out', f'{f}/vote_out')
    _shared_mlp(rules, f'{t}.vote_aggregation.mlps.0',
                f'{f}/vote_aggregation/SharedMLP_0', h.agg_mlp)
    _shared_mlp(rules, f'{t}.conv_pred.shared_convs', f'{f}/pred_shared',
                h.pred_conv_channels)
    n_reg = h.n_reg
    cls_cols = f'cols:0-2,{2 + n_reg}-{2 + n_reg + h.num_classes}'
    reg_cols = f'cols:2-{2 + n_reg}'
    for conv, cols in (('conv_cls', cls_cols), ('conv_reg', reg_cols)):
        rules.append((f'{t}.conv_pred.{conv}.weight', 'params',
                      f'{f}/pred_out/kernel', cols))
        rules.append((f'{t}.conv_pred.{conv}.bias', 'params',
                      f'{f}/pred_out/bias', cols))


def _conv_bn(rules, torch_prefix, flax_prefix, k, conv='conv1x1'):
    """A ConvBN ``{torch_prefix}.conv`` / ``.bn`` from flax's ``fc{k}`` /
    ``bn{k}`` under ``flax_prefix``."""
    rules.append((f'{torch_prefix}.conv.weight', 'params',
                  f'{flax_prefix}/fc{k}/kernel', conv))
    rules.extend(_bn_moves(f'{torch_prefix}.bn', f'{flax_prefix}/bn{k}'))


def _shared_mlp(rules, torch_prefix, flax_prefix, channels, child='layer{k}',
                conv='conv1x1'):
    for k in range(len(channels)):
        _conv_bn(rules, f'{torch_prefix}.{child.format(k=k)}', flax_prefix,
                 k, conv)


def _conv_out(rules, torch_prefix, flax_prefix, transform='conv1x1'):
    rules.append((f'{torch_prefix}.weight', 'params',
                  f'{flax_prefix}/kernel', transform))
    rules.append((f'{torch_prefix}.bias', 'params', f'{flax_prefix}/bias',
                  'copy'))


def _samsg_rules(rules, sa_channels, aggregation_channels=None):
    bb = 'PointNet2SAMSG_0'
    for i, level in enumerate(sa_channels):
        for j, chans in enumerate(level):
            _shared_mlp(rules, f'backbone.SA_modules.{i}.mlps.{j}',
                        f'{bb}/sa{i}/mlp{j}', chans, conv='conv1x1_2d')
        if aggregation_channels and aggregation_channels[i]:
            _conv_bn(rules, f'backbone.aggregation_mlps.{i}',
                     f'{bb}/sa{i}/aggregation', 0)


def ssd3d_rules(cfg: SSD3DNetConfig):
    """(torch key, collection, flax path, transform) of 3DSSD: the MSG
    encoder with its aggregation layers, and the head (the module
    docstring lists the names)."""
    rules = []
    _samsg_rules(rules, cfg.sa_channels, cfg.aggregation_channels)
    h, hd = cfg.head, 'SSD3DHead_0'
    _shared_mlp(rules, 'bbox_head.vote_module.vote_conv', f'{hd}/vote_mlp',
                h.vote_conv_channels, child='{k}')
    _conv_out(rules, 'bbox_head.vote_module.conv_out', f'{hd}/vote_out')
    for j, chans in enumerate(h.agg_mlps):
        _shared_mlp(rules, f'bbox_head.vote_aggregation.mlps.{j}',
                    f'{hd}/vote_aggregation/mlp{j}', chans,
                    conv='conv1x1_2d')
    cp = 'bbox_head.conv_pred'
    for t, f, chans in (('shared_convs', 'pred_shared',
                         h.shared_conv_channels),
                        ('cls_convs', 'cls_convs', h.cls_conv_channels),
                        ('reg_convs', 'reg_convs', h.reg_conv_channels)):
        _shared_mlp(rules, f'{cp}.{t}', f'{hd}/{f}', chans)
    for t in ('conv_cls', 'conv_reg'):
        _conv_out(rules, f'{cp}.{t}', f'{hd}/{t}')
    return rules


def point_rcnn_rules(cfg: PointRCNNConfig):
    """(torch key, collection, flax path, transform) of PointRCNN: the MSG
    encoder, the FP neck, the RPN's linear branches and the RoI bbox head
    (the module docstring lists the names)."""
    rules = []
    _samsg_rules(rules, cfg.sa_channels)
    for i, chans in enumerate(cfg.fp_channels):
        _shared_mlp(rules, f'neck.FP_modules.{i}.mlps',
                    f'PointNetFPNeck_0/fp{i}/SharedMLP_0', chans)
    rp = 'PointRPNHead_0'
    for name, chans in (('cls', cfg.rpn.cls_channels),
                        ('reg', cfg.rpn.reg_channels)):
        t = f'rpn_head.{name}_layers'
        for k in range(len(chans)):
            rules.append((f'{t}.{3 * k}.weight', 'params',
                          f'{rp}/{name}_fc{k}/kernel', 'linear'))
            rules.extend(_bn_moves(f'{t}.{3 * k + 1}',
                                   f'{rp}/{name}_bn{k}'))
        _conv_out(rules, f'{t}.{3 * len(chans)}', f'{rp}/{name}_out',
                  'linear')
    b, bh, h = cfg.bbox, 'roi_head.bbox_head', 'PointRCNNBboxHead_0'
    _shared_mlp(rules, f'{bh}.xyz_up_layer', f'{h}/xyz_up', b.mlp_channels,
                child='{k}', conv='conv1x1_2d')
    _conv_bn(rules, f'{bh}.merge_down_layer', f'{h}/merge_down', 0,
             'conv1x1_2d')
    for i, chans in enumerate(b.sa_channels):
        f = f'{h}/sa{i}' + ('/SharedMLP_0' if b.num_points[i] > 0 else '')
        _shared_mlp(rules, f'{bh}.SA_modules.{i}.mlps.0', f, chans,
                    conv='conv1x1_2d')
    for name, chans in (('cls', b.cls_channels), ('reg', b.reg_channels)):
        _shared_mlp(rules, f'{bh}.{name}_layer', f'{h}/{name}', chans,
                    child='{k}')
        _conv_out(rules, f'{bh}.{name}_layer.{len(chans)}',
                  f'{h}/{name}_out')
    return rules


def groupfree3d_rules(cfg: GroupFree3DNetConfig):
    """(torch key, collection, flax path, transform) of GroupFree3D: the
    SSG encoder as VoteNet's and the head under mmdet3d's names (the
    module docstring lists them). An attention's ``in_proj_weight`` /
    ``in_proj_bias`` stack flax's query, key and value projections (the
    '+'-joined paths, transform ``in_proj``); its out projection's kernel
    [heads, head_dim, C] becomes torch's [C, heads * head_dim]."""
    rules = []
    _sassg_rules(rules, 'backbone', 'PointNet2SASSG_0', cfg.sa_channels,
                 cfg.fp_channels)
    h, t, f = cfg.head, 'bbox_head', 'GroupFree3DHead_0'
    ch = (h.in_channels,) * 2
    _shared_mlp(rules, f'{t}.points_obj_cls.mlp', f'{f}/points_obj_cls', ch)
    _conv_out(rules, f'{t}.points_obj_cls.mlp.layer2', f'{f}/points_obj_out')
    for tp, fp in [('conv_pred', 'proposal')] + [
            (f'prediction_heads.{i}', f's{i}')
            for i in range(h.num_decoder_layers)]:
        _shared_mlp(rules, f'{t}.{tp}.shared_convs', f'{f}/{fp}_shared', ch)
        _conv_out(rules, f'{t}.{tp}.conv_cls', f'{f}/{fp}_cls')
        _conv_out(rules, f'{t}.{tp}.conv_reg', f'{f}/{fp}_reg')
    for proj in ('decoder_query_proj', 'decoder_key_proj'):
        _conv_out(rules, f'{t}.{proj}', f'{f}/{proj}')
    for i in range(h.num_decoder_layers):
        for tp, fp in (('decoder_self_posembeds', 'self_pos'),
                       ('decoder_cross_posembeds', 'cross_pos')):
            e = f'{t}.{tp}.{i}.position_embedding_head'
            _conv_out(rules, f'{e}.0', f'{f}/{fp}{i}/fc0')
            rules.extend(_bn_moves(f'{e}.1', f'{f}/{fp}{i}/bn'))
            _conv_out(rules, f'{e}.3', f'{f}/{fp}{i}/fc1')
        d, fd = f'{t}.decoder_layers.{i}', f'{f}/decoder{i}'
        for j, name in enumerate(('self_attn', 'cross_attn')):
            a, fa = f'{d}.attentions.{j}.attn', f'{fd}/{name}'
            for tn, fn in (('weight', 'kernel'), ('bias', 'bias')):
                rules.append((f'{a}.in_proj_{tn}', 'params', '+'.join(
                    f'{fa}/{p}/{fn}' for p in ('query', 'key', 'value')),
                    'in_proj'))
            _conv_out(rules, f'{a}.out_proj', f'{fa}/out', 'out_proj')
        _conv_out(rules, f'{d}.ffns.0.layers.0.0', f'{fd}/ffn0', 'linear')
        _conv_out(rules, f'{d}.ffns.0.layers.1', f'{fd}/ffn1', 'linear')
        for k in range(3):
            rules.append((f'{d}.norms.{k}.weight', 'params',
                          f'{fd}/norm{k + 1}/scale', 'copy'))
            rules.append((f'{d}.norms.{k}.bias', 'params',
                          f'{fd}/norm{k + 1}/bias', 'copy'))
    return rules


def h3dnet_rules(cfg: H3DNetConfig):
    """(torch key, collection, flax path, transform) of H3DNet. On every
    key ``torch2flax.h3dnet_rules`` maps (the towers, the fused
    aggregation, the RPN and the three primitive heads) it is that table,
    plus the RPN's ``conv_cls`` / ``conv_reg`` split as ``export_h3dnet``
    splits them. gga_tpu's refinement has no mmdet3d counterpart
    (``torch2flax.py:362-374``), so its keys are the port's own:
    ``roi_head.bbox_head.{surface,line}_matcher.mlps.0.layer{k}``,
    ``roi_head.bbox_head.{matching,sem_matching}_conv.layer0`` and
    ``_pred``, ``roi_head.bbox_head.feat_agg.layer{k}``,
    ``roi_head.bbox_head.refine_proj``, ``roi_head.refine_shared
    .layer{k}`` and ``roi_head.refine_out`` (1x1 Conv1d weights)."""
    rules = []
    bb = cfg.backbone
    for i in range(bb.num_streams):
        _sassg_rules(rules, f'backbone.backbone_list.{i}',
                     f'backbone/backbone{i}', bb.sa_channels, bb.fp_channels)
    _conv_bn(rules, 'backbone.aggregation_layers.layer0',
             'backbone/aggregation', 0)
    _vote_head_rules(rules, 'rpn_head', 'rpn_head', cfg.rpn)
    for prim in cfg.primitives:
        t, f = f'roi_head.primitive_{prim.mode}', f'primitive_{prim.mode}'
        _conv_bn(rules, f'{t}.flag_conv', f'{f}/flag_conv', 0)
        _conv_out(rules, f'{t}.flag_pred', f'{f}/flag_pred')
        _shared_mlp(rules, f'{t}.vote_module.vote_conv', f'{f}/vote_mlp',
                    prim.vote_conv_channels, child='{k}')
        _conv_out(rules, f'{t}.vote_module.conv_out', f'{f}/vote_out')
        _shared_mlp(rules, f'{t}.vote_aggregation.mlps.0',
                    f'{f}/vote_aggregation/SharedMLP_0', prim.agg_mlp)
        _shared_mlp(rules, f'{t}.conv_pred', f'{f}/conv_pred',
                    prim.feat_channels, child='{k}')
        _conv_out(rules, f'{t}.conv_pred.conv_out', f'{f}/pred_out')
    b, t, f = cfg.bbox, 'roi_head.bbox_head', 'bbox_head'
    for m in ('surface_matcher', 'line_matcher'):
        _shared_mlp(rules, f'{t}.{m}.mlps.0', f'{f}/{m}/SharedMLP_0',
                    b.match_mlp)
    for m in ('matching', 'sem_matching'):
        _shared_mlp(rules, f'{t}.{m}_conv', f'{f}/{m}_conv', (128,))
        _conv_out(rules, f'{t}.{m}_pred', f'{f}/{m}_pred')
    _shared_mlp(rules, f'{t}.feat_agg', f'{f}/feat_agg', b.agg_channels)
    _conv_out(rules, f'{t}.refine_proj', f'{f}/refine_proj')
    _shared_mlp(rules, 'roi_head.refine_shared', 'refine_shared',
                cfg.rpn.pred_conv_channels)
    _conv_out(rules, 'roi_head.refine_out', 'refine_out')
    return rules


def imvotenet_rules(cfg: ImVoteNetConfig):
    """(torch key, collection, flax path, transform) of ImVoteNet under
    mmdet3d's names: ``pts_backbone`` (VoteNet's SSG encoder),
    ``img_mlp.mlp.layer{k}`` and the three towers
    ``pts_bbox_head_{joint,pts,img}`` (VoteNet's head each)."""
    rules = []
    _sassg_rules(rules, 'pts_backbone', 'PointNet2SASSG_0', cfg.sa_channels,
                 cfg.fp_channels)
    _shared_mlp(rules, 'img_mlp.mlp', 'img_mlp', cfg.img_mlp_channels)
    for name in ('joint', 'pts', 'img'):
        _vote_head_rules(rules, f'pts_bbox_head_{name}', f'head_{name}',
                         cfg.head)
    return rules


def _seg_head_rules(rules, flax_prefix, fp_channels):
    """A segmentation head under ``decode_head``: the feature propagations
    from ``{flax_prefix}fp{i}/SharedMLP_0``, ``pre_seg`` and ``cls_seg``."""
    for i, chans in enumerate(fp_channels):
        _shared_mlp(rules, f'decode_head.FP_modules.{i}.mlps',
                    f'{flax_prefix}fp{i}/SharedMLP_0', chans)
    _conv_bn(rules, 'decode_head.pre_seg_conv', f'{flax_prefix}pre_seg', 0)
    _conv_out(rules, 'decode_head.conv_seg', f'{flax_prefix}cls_seg')


def encoder_decoder_rules(cfg: EncoderDecoder3DConfig):
    """(torch key, collection, flax path, transform) of the PointNet++
    segmentor: the SSG encoder without feature propagation, or the MSG
    encoder without aggregation layers, and ``PointNet2SegHead``."""
    rules = []
    if cfg.msg:
        _samsg_rules(rules, cfg.msg_sa_channels)
    else:
        _sassg_rules(rules, 'backbone', 'PointNet2SASSG_0', cfg.sa_channels,
                     ())
    _seg_head_rules(rules, 'PointNet2SegHead_0/', cfg.fp_channels)
    return rules


def dgcnn_rules(cfg: DGCNNConfig):
    """(torch key, collection, flax path, transform) of DGCNN (the module
    docstring lists the names)."""
    rules = []
    for i, chans in enumerate(cfg.gf_channels):
        _shared_mlp(rules, f'backbone.GF_modules.{i}.mlps',
                    f'backbone/gf{i}/SharedMLP_0', chans, conv='conv1x1_2d')
    _shared_mlp(rules, 'backbone.FA_module.mlps', 'backbone/fa',
                cfg.fa_channels)
    _shared_mlp(rules, 'decode_head.FP_module.mlps', 'fp', cfg.fp_channels)
    _conv_bn(rules, 'decode_head.pre_seg_conv', 'pre_seg', 0)
    _conv_out(rules, 'decode_head.conv_seg', 'cls_seg')
    return rules


def paconv_rules(cfg: PAConvConfig):
    """(torch key, collection, flax path, transform) of PAConv: each set
    abstraction's PAConv layers (weight bank, ScoreNet, BatchNorm), then
    the head (the module docstring lists the names)."""
    rules = []
    for i, chans in enumerate(cfg.sa_channels):
        for k in range(len(chans)):
            t = f'backbone.SA_modules.{i}.mlps.0.layer{k}'
            f = f'sa{i}/paconv{k}'
            rules.append((f'{t}.weight_bank', 'params', f'{f}/weight_bank',
                          'copy'))
            _shared_mlp(rules, f'{t}.scorenet.mlps', f'{f}/scorenet/mlp',
                        (16, 16), conv='conv1x1_2d')
            _conv_out(rules, f'{t}.scorenet.mlps.layer2.conv',
                      f'{f}/scorenet/out', 'conv1x1_2d')
            rules.extend(_bn_moves(f'{t}.bn', f'{f}/bn'))
    _seg_head_rules(rules, '', cfg.fp_channels)
    return rules


def _to_torch_layout(name, x):
    """One flax tensor -> its mmdet3d state_dict layout."""
    x = np.asarray(x)
    if name.startswith('cols:'):
        # the listed [start, end) column ranges of a kernel [I, O] (laid
        # out as a 1x1 Conv1d) or of a bias [O]
        spans = [tuple(map(int, r.split('-')))
                 for r in name[len('cols:'):].split(',')]
        x = np.concatenate([x[..., a:b] for a, b in spans], -1)
        return x.T[..., None] if x.ndim == 2 else x
    if name == 'in_proj':
        # the query, key and value kernels [3, C, heads, head_dim] -> rows
        # [3 * heads * head_dim, C], or their biases -> [3 * C]
        if x.ndim == 4:
            return x.reshape(3, x.shape[1], -1).transpose(0, 2, 1).reshape(
                -1, x.shape[1])
        return x.reshape(-1)
    if name == 'out_proj':          # [heads, head_dim, C] -> [C, C]
        return x.reshape(-1, x.shape[-1]).T
    if name == 'conv1x1':           # [I, O] -> [O, I, 1]
        return x.T[..., None]
    if name == 'conv1d':            # [k, I, O] -> [O, I, k]
        return x.transpose(2, 1, 0)
    if name == 'depthwise_deconv2d':
        # gga_tpu's depthwise upsampler [kh, kw, 1, C], which it
        # correlates with the dilated input -> conv_transpose2d's
        # [C, 1, kh, kw], flipped: conv_transpose2d convolves
        return x[::-1, ::-1].transpose(3, 2, 0, 1)
    if name == 'conv1x1_2d':        # [I, O] -> [O, I, 1, 1]
        return x.T[..., None, None]
    if name.startswith('sparse3d'):
        # flax [K, I, O] -> spconv2 [O, kz, ky, kx, I]
        _, i_ch, o_ch = name.split(':')
        dhw = (3, 1, 1) if x.shape[0] == 3 else (3, 3, 3)
        return x.reshape(*dhw, int(i_ch), int(o_ch)).transpose(4, 0, 1, 2, 3)
    if name == 'linear':            # [I, O] -> [O, I]
        return x.T
    if name == 'conv3d':            # [kx, ky, kz, I, O] -> [O, I, kx, ky, kz]
        return x.transpose(4, 3, 0, 1, 2)
    if name == 'deconv3d':
        # flax ConvTranspose [kx, ky, kz, I, O] -> torch [I, O, kx, ky, kz]
        # with the three spatial axes flipped (flax's correlates)
        return x[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
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
    for cls, rules in ((EncoderDecoder3DConfig, encoder_decoder_rules),
                       (DGCNNConfig, dgcnn_rules),
                       (PAConvConfig, paconv_rules),
                       (VoteNetConfig, votenet_rules),
                       (GroupFree3DNetConfig, groupfree3d_rules),
                       (H3DNetConfig, h3dnet_rules),
                       (ImVoteNetConfig, imvotenet_rules),
                       (MVXNetConfig, mvxnet_rules),
                       (ImVoxelNetConfig, imvoxelnet_rules),
                       (ImVoxelNetIndoorConfig, imvoxelnet_indoor_rules),
                       (SMOKEModelConfig, smoke_rules),
                       (MonoFlexModelConfig, monoflex_rules),
                       (SSD3DNetConfig, ssd3d_rules),
                       (PointRCNNConfig, point_rcnn_rules),
                       (PartA2Config, parta2_rules),
                       (CenterPointConfig, centerpoint_rules),
                       (PGDModelConfig, pgd_rules),
                       (FCAF3DModelConfig, fcaf3d_rules),
                       (SSNConfig, ssn_rules),
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
    or ``SASSDConfig``, or a ``PartA2Config``, ``VoteNetConfig``,
    ``SSD3DNetConfig``, ``PointRCNNConfig``, ``GroupFree3DNetConfig``,
    ``H3DNetConfig``, ``ImVoteNetConfig``, ``SSNConfig`` or
    ``FreeAnchorPointPillarsConfig``, or a segmentor's:
    ``EncoderDecoder3DConfig``, ``DGCNNConfig`` or ``PAConvConfig``, or
    ``SMOKEModelConfig`` or ``MonoFlexModelConfig``) ->
    the port's ``load_state_dict`` input (f32 tensors)."""
    return convert_with_rules(variables_np, rules_of(cfg))


def convert_with_rules(variables_np, rules):
    """gga_tpu ``{'params', 'batch_stats'}`` trees -> the state_dict the
    ``rules`` name (f32 tensors); a tensor whose flax path is missing is
    left out."""
    flat = {c: _flatten(variables_np.get(c, {}))
            for c in ('params', 'batch_stats')}
    out = {}
    for tk, coll, fp, tr in rules:
        paths = fp.split('+')
        if all(p in flat[coll] for p in paths):
            arr = _to_torch_layout(tr, [flat[coll][p] for p in paths]
                                   if len(paths) > 1 else flat[coll][fp])
            # np.array keeps a 0-d array 0-d (fuse_lambda), as
            # np.ascontiguousarray would not
            out[tk] = torch.from_numpy(np.array(arr, dtype=np.float32,
                                                order='C'))
    return out
