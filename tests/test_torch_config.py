"""The port's config files and detector builder against gga_tpu's: the same
``configs/gga`` files parse to the same dicts, overrides agree, and
``build_detector`` gives model configs equal field by field (nested head
included), for the GGA configs and the shipped KITTI voxel detectors:
SECOND (3-class, car, the benchmark one), PointPillars (3-class, car,
both benchmark ones), the three dynamic-voxelization configs, SASSD and
all 16 nuScenes CenterPoint configs (voxel and pillar, DCN head, circle
NMS, tta), the three PartA2 configs (3-class, car, the benchmark one),
the three VoteNet configs (SUN RGB-D, ScanNet, ScanNet with the IoU
loss), FCAF3D's ScanNet config, the two point-based KITTI configs and
the six VoteNet-derived indoor configs (the four GroupFree3D, H3DNet's
and ImVoteNet's) and the fifteen segmentor configs (six PointNet++
EncoderDecoder3D, seven DGCNN, two PAConv);
and 20 of the 23 nuScenes and Lyft pillar configs of FreeAnchor, SSN,
the RegNet backbones and PointPillars' FPN neck (six
``configs/free_anchor``, eight ``configs/regnet``, four ``configs/ssn``,
five ``configs/pointpillars``) and the two monocular KITTI configs (SMOKE
and MonoFlex, whose full-width models hold as many weights and
statistics as gga_tpu's variables); the _fp16_ SECOND and PointPillars
configs parse to model configs equal to gga_tpu's. Also the port's
refusal of gga_tpu's TPU-only encoder options and of the _fp16_ SECOND
and PointPillars configs, and the class order that the SSN and FreeAnchor
configs share with gga_tpu.
"""
import ast
import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from gga_tpu import config as jconfig
from gga_tpu.models import builder as jbuilder
from gga_tpu_torch import config as tconfig
from gga_tpu_torch.models import builder as tbuilder
from gga_tpu_torch.models.backbones import dgcnn as tdgcnn
from gga_tpu_torch.models.backbones import paconv as tpaconv
from gga_tpu_torch.models.detectors import centerpoint as tcp
from gga_tpu_torch.models.detectors import centerpoint_gga as tdet
from gga_tpu_torch.models.detectors import dynamic_voxelnet as tdv
from gga_tpu_torch.models.detectors import fcaf3d as tfcaf3d
from gga_tpu_torch.models.detectors import groupfree3d as tgroupfree3d
from gga_tpu_torch.models.detectors import h3dnet as th3dnet
from gga_tpu_torch.models.detectors import imvotenet as timvotenet
from gga_tpu_torch.models.detectors import imvoxelnet as timvoxelnet
from gga_tpu_torch.models.detectors import monoflex as tmonoflex
from gga_tpu_torch.models.detectors import mvxnet as tmvxnet
from gga_tpu_torch.models.detectors import parta2 as tparta2
from gga_tpu_torch.models.detectors import pgd as tpgd
from gga_tpu_torch.models.detectors import point_rcnn as tpoint_rcnn
from gga_tpu_torch.models.detectors import sassd as tsassd
from gga_tpu_torch.models.detectors import smoke as tsmoke
from gga_tpu_torch.models.detectors import ssd3d as tssd3d
from gga_tpu_torch.models.detectors import ssn as tssn
from gga_tpu_torch.models.detectors import votenet as tvotenet
from gga_tpu_torch.models.detectors import voxelnet as tvoxelnet
from gga_tpu_torch.models.segmentors import encoder_decoder as tenc
from gga_tpu_torch.ops import sparse as sp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GGA_CONFIGS = sorted((ROOT / 'configs' / 'gga').glob('*.py'))
DETECTOR_CONFIGS = ('gga_kitti.py', 'gga_kitti_tiny.py',
                    'gga_kitti_matching.py')
# the supervised KITTI configs, by their path under configs/
SECOND = 'second/hv_second_secfpn_6x8_80e_kitti-3d-3class.py'
POINTPILLARS = 'pointpillars/hv_pointpillars_secfpn_6x8_160e_kitti-3d-3class.py'
# the other KITTI voxel detectors' configs, with the detector each builds
VOXEL_FAMILY = {
    'second/hv_second_secfpn_6x8_80e_kitti-3d-car.py':
        (tvoxelnet.SECONDDetector, tvoxelnet.SECONDNetConfig),
    'benchmark/hv_second_secfpn_4x8_80e_pcdet_kitti-3d-3class.py':
        (tvoxelnet.SECONDDetector, tvoxelnet.SECONDNetConfig),
    'pointpillars/hv_pointpillars_secfpn_6x8_160e_kitti-3d-car.py':
        (tvoxelnet.PointPillars, tvoxelnet.PointPillarsConfig),
    'benchmark/hv_pointpillars_secfpn_3x8_100e_det3d_kitti-3d-car.py':
        (tvoxelnet.PointPillars, tvoxelnet.PointPillarsConfig),
    'benchmark/hv_pointpillars_secfpn_4x8_80e_pcdet_kitti-3d-3class.py':
        (tvoxelnet.PointPillars, tvoxelnet.PointPillarsConfig),
    'dynamic_voxelization/dv_pointpillars_secfpn_6x8_160e_kitti-3d-car.py':
        (tdv.DynamicVoxelNet, tdv.DynamicVoxelNetConfig),
    'dynamic_voxelization/dv_second_secfpn_6x8_80e_kitti-3d-car.py':
        (tdv.DVSECONDDetector, tdv.DVSECONDConfig),
    'dynamic_voxelization/dv_second_secfpn_2x8_cosine_80e_kitti-3d-3class.py':
        (tdv.DVSECONDDetector, tdv.DVSECONDConfig),
    'sassd/sassd_6x8_80e_kitti-3d-3class.py': (tsassd.SASSD,
                                               tsassd.SASSDConfig),
    'parta2/hv_PartA2_secfpn_2x8_cyclic_80e_kitti-3d-3class.py':
        (tparta2.PartA2Detector, tparta2.PartA2Config),
    'parta2/hv_PartA2_secfpn_2x8_cyclic_80e_kitti-3d-car.py':
        (tparta2.PartA2Detector, tparta2.PartA2Config),
    'benchmark/hv_PartA2_secfpn_4x8_cyclic_80e_pcdet_kitti-3d-3class.py':
        (tparta2.PartA2Detector, tparta2.PartA2Config),
}
# the nuScenes CenterPoint configs, by their path under configs/
CENTERPOINT = tuple(f'centerpoint/{p.name}' for p in sorted(
    (ROOT / 'configs' / 'centerpoint').glob('*.py')))
# CenterPointConfig.encoder_paddings: gga_tpu's default and the port's
GGA_TPU_CP_PADDINGS = ((1,), (1, 1, 1), (1, 1, 1), ((1, 1, 0), 1))
CP_PADDINGS = ((1,), (1, 1, 1), (1, 1, 1), ((0, 1, 1), 1))
# the indoor configs, with the detector each builds
INDOOR = {
    'votenet/votenet_16x8_sunrgbd-3d-10class.py': (tvotenet.VoteNet,
                                                   tvotenet.VoteNetConfig),
    'votenet/votenet_8x8_scannet-3d-18class.py': (tvotenet.VoteNet,
                                                  tvotenet.VoteNetConfig),
    'votenet/votenet_iouloss_8x8_scannet-3d-18class.py':
        (tvotenet.VoteNet, tvotenet.VoteNetConfig),
    'fcaf3d/fcaf3d_8x2_scannet-3d-18class.py': (tfcaf3d.FCAF3DDetector,
                                                tfcaf3d.FCAF3DModelConfig),
}
# the VoteNet-derived indoor configs, with the detector each builds
VOTE_FAMILY = {
    **{f'groupfree3d/{p.name}': (tgroupfree3d.GroupFree3DNet,
                                 tgroupfree3d.GroupFree3DNetConfig)
       for p in sorted((ROOT / 'configs' / 'groupfree3d').glob('*.py'))},
    'h3dnet/h3dnet_3x8_scannet-3d-18class.py': (th3dnet.H3DNet,
                                                th3dnet.H3DNetConfig),
    'imvotenet/imvotenet_stage2_16x8_sunrgbd-3d-10class.py':
        (timvotenet.ImVoteNet, timvotenet.ImVoteNetConfig),
}
# the point-based KITTI detectors' configs, with the detector each builds
POINT_FAMILY = {
    '3dssd/3dssd_4x4_kitti-3d-car.py': (tssd3d.SSD3DNet,
                                        tssd3d.SSD3DNetConfig),
    'point_rcnn/point_rcnn_2x8_kitti-3d-3classes.py':
        (tpoint_rcnn.PointRCNNDetector, tpoint_rcnn.PointRCNNConfig),
}
# the point-cloud segmentors' configs, with the segmentor each builds
SEGMENTORS = {
    f'{family}/{p.name}': kinds
    for family, kinds in (
        ('pointnet2', (tenc.EncoderDecoder3D, tenc.EncoderDecoder3DConfig)),
        ('dgcnn', (tdgcnn.DGCNNSegmentor, tdgcnn.DGCNNConfig)),
        ('paconv', (tpaconv.PAConvSegmentor, tpaconv.PAConvConfig)))
    for p in sorted((ROOT / 'configs' / family).glob('*.py'))}
# the image-fusion and image-to-voxel configs, with the detector each builds
FUSION = {
    'mvxnet/dv_mvx-fpn_second_secfpn_adamw_2x8_40e_kitti-3d-3class.py':
        (tmvxnet.MVXNet, tmvxnet.MVXNetConfig),
    'imvoxelnet/imvoxelnet_4x8_kitti-3d-car.py':
        (timvoxelnet.ImVoxelNet, timvoxelnet.ImVoxelNetConfig),
    'imvoxelnet/imvoxelnet_4x2_sunrgbd-3d-10class.py':
        (timvoxelnet.ImVoxelNetIndoor, timvoxelnet.ImVoxelNetIndoorConfig),
}
# the monocular KITTI configs, with the detector each builds
MONO = {
    'smoke/smoke_dla34_dlaneck_gn-all_8x4_6x_kitti-mono3d.py':
        (tsmoke.SMOKEDetector, tsmoke.SMOKEModelConfig),
    'monoflex/monoflex_dla34_dlaneck_gn-all_2x4_6x_kitti-mono3d.py':
        (tmonoflex.MonoFlexDetector, tmonoflex.MonoFlexModelConfig),
}
# FreeAnchor, SSN, the RegNet backbones and PointPillars' FPN neck and
# bf16 (nuScenes and Lyft), with the detector each builds
PILLAR_FAMILY = {
    **{f'free_anchor/{p.name}': (tvoxelnet.PointPillars,
                                 tvoxelnet.FreeAnchorPointPillarsConfig)
       for p in sorted((ROOT / 'configs' / 'free_anchor').glob('*.py'))},
    **{f'regnet/{p.name}': (tvoxelnet.PointPillars,
                            tvoxelnet.PointPillarsConfig)
       for p in sorted((ROOT / 'configs' / 'regnet').glob('*.py'))},
    **{f'ssn/{p.name}': (tssn.SSNDetector, tssn.SSNConfig)
       for p in sorted((ROOT / 'configs' / 'ssn').glob('*.py'))},
    **{f'pointpillars/{p.name}': (tvoxelnet.PointPillars,
                                  tvoxelnet.PointPillarsConfig)
       for p in sorted((ROOT / 'configs' / 'pointpillars').glob('*.py'))
       if '_fpn_' in p.name or p.name == (
           'hv_pointpillars_secfpn_sbn-all_fp16_2x8_2x_nus-3d.py')},
}
# of those, the three _fp16_ (bf16) ones: their model configs equal
# gga_tpu's, and the builder refuses them (their whole bf16 step missed
# the bf16 gates on the card)
FP16_PILLARS = tuple(p for p in PILLAR_FAMILY if '_fp16_' in p)
FP16_SECOND = ('second/hv_second_secfpn_fp16_6x8_80e_kitti-3d-3class.py',
               'second/hv_second_secfpn_fp16_6x8_80e_kitti-3d-car.py')

OPTIONS = {'model.compute_dtype': 'bfloat16', 'data.samples_per_gpu': '4',
           'head.max_objs': '64', 'optimizer.betas': '(0.9, 0.99)',
           'new.block.key': "'x'", 'data_root': '/data/kitti/'}


def _plain(obj):
    """Config trees as plain dicts, lists and tuples (types kept)."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def _fields(dc):
    """A frozen config as nested (name, value) pairs, dataclass fields
    (and tuples of them, as H3DNet's primitive heads) compared
    recursively."""
    def value(v):
        if dataclasses.is_dataclass(v):
            return _fields(v)
        if isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            return tuple(map(value, v))
        return v
    return {f.name: value(getattr(dc, f.name))
            for f in dataclasses.fields(dc)}


def _bev_grid(mc):
    """(nz, ny, nx) of the conv_module SparseEncoder's output."""
    grid = mc.sparse_shape
    for pad in (mc.encoder_paddings[1][0], mc.encoder_paddings[2][0],
                mc.encoder_paddings[3][0]):
        grid = sp._ds_prep(grid, 3, 2, pad)[3]
    return sp._ds_prep(grid, (3, 1, 1), (2, 1, 1), 0)[3]


def test_gga_tpu_centerpoint_padding_leaves_the_bev_a_column_short():
    """gga_tpu's default stage-3 padding (1, 1, 0) pads z and y, not x: its
    0.1 m voxel config's BEV is 128 x 127, and tracing its detector fails
    where SECONDFPN concatenates it with the 128 x 128 upsampled level.
    The port's (0, 1, 1) gives 128 x 128."""
    import jax
    import jax.numpy as jnp
    from gga_tpu.models.detectors import centerpoint as jcp
    ref = jcp.CenterPointConfig()
    assert ref.encoder_paddings == GGA_TPU_CP_PADDINGS
    assert _bev_grid(ref) == (2, 128, 127)
    assert _bev_grid(tcp.CenterPointConfig()) == (2, 128, 128)
    model = jcp.CenterPointDetector(ref)
    pts = jax.ShapeDtypeStruct((1, 4000, 5), jnp.float32)
    valid = jax.ShapeDtypeStruct((1, 4000), jnp.bool_)
    with pytest.raises(TypeError, match=r'\(1, 128, 127, 256\), '
                                        r'\(1, 128, 128, 256\)'):
        jax.eval_shape(lambda p, v: model.init(jax.random.PRNGKey(0), p, v,
                                               train=False), pts, valid)


def test_there_are_sixteen_centerpoint_configs():
    assert len(CENTERPOINT) == 16


def test_there_are_fifteen_segmentor_configs():
    assert len(SEGMENTORS) == 15
    assert sum(k.startswith('dgcnn/') for k in SEGMENTORS) == 7


def test_there_are_five_gga_configs():
    assert [p.name for p in GGA_CONFIGS] == [
        'gga_kitti.py', 'gga_kitti_matching.py', 'gga_kitti_tiny.py',
        'gga_pdg.py', 'gga_sunrgbd.py']


def test_reading_the_configs_imports_nothing_of_gga_tpu():
    """The config files import nothing, and reading them (bases in other
    folders included) loads no module of gga_tpu or tools."""
    for path in GGA_CONFIGS:
        tree = ast.parse(path.read_text())
        assert not [n for n in ast.walk(tree)
                    if isinstance(n, (ast.Import, ast.ImportFrom))], path
    code = ('import sys\n'
            'from gga_tpu_torch.config import Config\n'
            'cfgs = [Config.fromfile(p) for p in sys.argv[1:]]\n'
            'bad = sorted(m for m in sys.modules\n'
            '             if m.split(".")[0] in ("gga_tpu", "tools"))\n'
            'assert len(cfgs) == 5 and not bad, bad\n')
    subprocess.run([sys.executable, '-c', code, *map(str, GGA_CONFIGS)],
                   cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize('path', GGA_CONFIGS, ids=lambda p: p.name)
def test_fromfile_equals_gga_tpu(path):
    port = tconfig.Config.fromfile(str(path))
    ref = jconfig.Config.fromfile(str(path))
    assert isinstance(port, tconfig.Config)
    assert _plain(port) == _plain(ref)
    assert port.dump() == ref.dump()


@pytest.mark.parametrize('name', DETECTOR_CONFIGS)
def test_merge_from_options_agrees(name):
    path = str(ROOT / 'configs' / 'gga' / name)
    port = tconfig.Config.fromfile(path).merge_from_options(OPTIONS)
    ref = jconfig.Config.fromfile(path).merge_from_options(OPTIONS)
    assert _plain(port) == _plain(ref)
    assert port.model.compute_dtype == 'bfloat16'
    assert port.optimizer.betas == (0.9, 0.99)
    assert port.new.block.key == 'x'


@pytest.mark.parametrize('name', DETECTOR_CONFIGS + (
    'gga_pdg.py', 'gga_sunrgbd.py', SECOND, POINTPILLARS, *VOXEL_FAMILY,
    *CENTERPOINT, *INDOOR, *POINT_FAMILY, *VOTE_FAMILY, *SEGMENTORS,
    *FUSION, *(p for p in PILLAR_FAMILY if p not in FP16_PILLARS), *MONO))
def test_build_detector_config_equals_gga_tpu(name):
    path = str(ROOT / 'configs' / ('' if '/' in name else 'gga') / name)
    model, mc = tbuilder.build_detector(tconfig.Config.fromfile(path))
    jmodel, ref = jbuilder.build_detector(jconfig.Config.fromfile(path))
    pgd = name == 'gga_pdg.py'
    indoor = name == 'gga_sunrgbd.py'
    det, cfg_cls = {
        'gga_pdg.py': (tpgd.PGDDetector, tpgd.PGDModelConfig),
        'gga_sunrgbd.py': (tfcaf3d.FCAF3DDetector, tfcaf3d.FCAF3DModelConfig),
        SECOND: (tvoxelnet.SECONDDetector, tvoxelnet.SECONDNetConfig),
        POINTPILLARS: (tvoxelnet.PointPillars, tvoxelnet.PointPillarsConfig),
        **VOXEL_FAMILY, **INDOOR, **POINT_FAMILY, **VOTE_FAMILY,
        **SEGMENTORS, **FUSION, **PILLAR_FAMILY, **MONO,
        **dict.fromkeys(CENTERPOINT, (tcp.CenterPointDetector,
                                      tcp.CenterPointConfig)),
    }.get(name, (tdet.GGADetector, tdet.GGAModelConfig))
    assert type(model) is det and type(mc) is cfg_cls
    fields, ref_fields = _fields(mc), _fields(ref)
    if name in CENTERPOINT:
        # the port repairs gga_tpu's stage-3 padding, whose reversed
        # (z, y, x) order leaves the voxel configs' BEV a column short of
        # the neck's upsampled level (test_gga_tpu_centerpoint_padding_...)
        assert ref_fields['encoder_paddings'] == GGA_TPU_CP_PADDINGS
        ref_fields['encoder_paddings'] = CP_PADDINGS
    assert fields == ref_fields
    hash(mc)                                  # frozen and hashable
    if indoor:
        assert mc.depth == 34 and mc.voxel_size == mc.head.voxel_size == 0.01
        assert mc.head.n_classes == 10 and mc.head.n_reg_outs == 8
        assert mc.grid_zyx == (512, 1280, 1280)
    elif name in MONO:
        # full width: DLA-34's levels, the 64-channel stride-4 map, and as
        # many weights and statistics as gga_tpu's variables at 384 x 1248
        assert model.backbone.out_channels == (16, 32, 64, 128, 256, 512)
        assert model.neck.ida_up.nodes[-1].conv.out_channels == 64
        shapes = jax.eval_shape(
            lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False),
            jax.ShapeDtypeStruct((1, 384, 1248, 3), 'float32'))
        assert sum(math.prod(x.shape) for x in jax.tree_util.tree_leaves(
            shapes)) == sum(t.numel() for t in model.state_dict().values())
    elif pgd:
        assert mc.backbone_depth == 101 and mc.fpn_channels == 256
        assert mc.head.feat_channels == 256 and mc.head.stacked_convs == 2
    elif name == SECOND:
        assert mc.sparse_shape == (41, 1600, 1408)
        assert mc.encoder_paddings[3] == ((0, 1, 1), 1, 1)
        assert model.middle_encoder.bev_channels == 256
        assert sum(p.numel() for p in model.parameters()) == 5325576
    elif name == POINTPILLARS:
        assert mc.scatter_shape == (496, 432)
        assert mc.backbone_layers == (3, 5, 5)
    elif det is tparta2.PartA2Detector:
        car = name.endswith('-car.py')
        assert mc.rpn.num_classes == (1 if car else 3)
        assert mc.sparse_shape == (41, 1600, 1408)
        assert mc.unet_budgets == (16000, 14000, 12000)
        # SparseUNet's BEV: 128 channels x 2 levels of z on 200 x 176
        assert model.middle_encoder.bev_channels == 256
        assert model.middle_encoder.seg_channels == 16
        # 7^3 cells of the 256-wide last down conv into the first FC
        fc = model.roi_head['bbox_head'].shared_fc[0].conv
        assert fc.in_features == 256 * 7 ** 3 and fc.out_features == 512
    elif name in VOXEL_FAMILY:
        car = name.endswith('-car.py')
        assert mc.head.num_classes == (1 if car else 3)
        assert mc.compute_dtype == 'float32'
        if det is tsassd.SASSD:
            assert mc.aux_channels == 64
            # SECOND's 5 325 576 and the branch's 112 x 64 + 64 x 4
            assert sum(p.numel() for p in model.parameters()) == (
                5325576 + 112 * 64 + 64 * 4)
        elif det is tdv.DynamicVoxelNet:
            assert mc.scatter_shape == (496, 432)
            assert model.backbone.blocks[0][0].in_channels == 4
    elif det is tmvxnet.MVXNet:
        assert mc.img_depth == 50 and mc.vfe_channels == (64, 64)
        # the fused VFE feeds the encoder 128 channels
        assert model.pts_middle_encoder.conv_input[0].in_channels == 128
        assert model.pts_middle_encoder.bev_channels == 256
    elif det is timvoxelnet.ImVoxelNet:
        assert mc.n_voxels == (216, 248, 12) and mc.head.num_classes == 1
    elif det is timvoxelnet.ImVoxelNetIndoor:
        assert mc.n_voxels == (40, 40, 16) and mc.head.n_classes == 10
        assert mc.head.nms_pre == 1000
    elif name in CENTERPOINT:
        assert mc.tasks == (1, 2, 2, 1, 2, 2)
        assert mc.dcn_head == ('_dcn_' in name)
        assert mc.nms_type == ('circle' if 'circlenms' in name
                               else 'rotated')
        assert mc.with_velocity == (not name.endswith('novelo.py'))
        assert mc.pillar == ('02pillar' in name)
        if mc.pillar:
            assert mc.neck_strides == (0.5, 1, 2)
            # the stride-0.5 level is a 2x2 stride-2 conv
            assert model.pts_neck.deblocks[0][0].kernel_size == (2, 2)
        else:
            side = 1440 if '0075' in name else 1024
            assert mc.sparse_shape == (41, side, side)
            # a BEV of 2 x 128 channels on the head's side / 8 square map
            assert model.pts_middle_encoder.bev_channels == 256
            assert _bev_grid(mc) == (2, side // 8, side // 8)
    elif det is tvotenet.VoteNet:
        scannet = 'scannet' in name
        assert mc.num_points == (2048, 1024, 512, 256)
        assert mc.head.num_classes == (18 if scannet else 10)
        assert mc.head.with_rot == (not scannet)
        assert mc.head.num_dir_bins == (1 if scannet else 12)
        assert mc.head.iou_loss_weight == (10 / 3 if 'iouloss' in name
                                           else 0.0)
        # the fused prediction: objectness and classes, then the
        # partial-bin regression
        assert model.bbox_head.conv_pred.conv_cls.weight.shape[0] == (
            2 + mc.head.num_classes)
        assert model.bbox_head.conv_pred.conv_reg.weight.shape[0] == (
            3 + 2 * mc.head.num_dir_bins + 4 * mc.head.num_sizes)
    elif det is tssd3d.SSD3DNet:
        assert mc.num_points == (4096, 512, (256, 256))
        assert mc.fps_mods == (('D-FPS',), ('FS',), ('F-FPS', 'D-FPS'))
        assert mc.fps_sample_range_lists == ((-1,), (-1,), (512, -1))
        assert mc.head.num_classes == 1 and mc.head.num_candidates == 256
        # the aggregation layers' 64 / 128 / 256, the head's MSG of 512 +
        # 1 024 and 3 + 3 + 2 x 12 regression channels
        assert model.backbone.level_channels == [1, 64, 128, 256]
        assert model.bbox_head.vote_aggregation.out_channels == 1536
        assert model.bbox_head.conv_pred.conv_reg.weight.shape[0] == 30
    elif det is tpoint_rcnn.PointRCNNDetector:
        assert mc.num_points == (4096, 1024, 256, 64)
        assert mc.rpn.num_classes == 3 and mc.rpn.nms_pre == 1024
        assert mc.roi.num_rois == 128 and mc.roi.roi_pts_budget == 512
        # no aggregation layers: each level the sum of its branches
        assert model.backbone.level_channels == [1, 96, 256, 512, 1024]
        assert model.neck.out_channels == 128
        # the up-lifted xyz channels and the backbone's 128 merged
        bh = model.roi_head['bbox_head']
        assert bh.merge_down_layer.conv.weight.shape[:2] == (128, 256)
    elif det is tgroupfree3d.GroupFree3DNet:
        wide = '-w2x-' in name
        assert mc.in_channels == 3 and mc.fp_channels[-1][-1] == 288
        assert mc.sa_channels[1] == ((256, 256, 512) if wide
                                     else (128, 128, 256))
        assert mc.head.num_decoder_layers == (6 if '-L6-' in name else 12)
        assert mc.head.num_proposal == (512 if name.endswith('O512.py')
                                        else 256)
        assert mc.head.num_classes == 18 and not mc.head.with_rot
        assert len(model.bbox_head.decoder_layers) == (
            mc.head.num_decoder_layers)
        # [objectness | 18 classes] and 3 + 2 x 1 + 4 x 18 regression
        head = model.bbox_head.prediction_heads[-1]
        assert head.conv_cls.weight.shape[0] == 19
        assert head.conv_reg.weight.shape[0] == 77
        attn = model.bbox_head.decoder_layers[0].attentions[1].attn
        assert tuple(attn.in_proj_weight.shape) == (3 * 288, 288)
    elif det is th3dnet.H3DNet:
        assert mc.backbone.num_streams == 4
        assert len(model.backbone.backbone_list) == 4
        # the four towers' 256 fused into 256
        assert model.backbone.aggregation_layers.layer0.conv.weight.shape[
            :2] == (256, 1024)
        assert mc.rpn.num_classes == 18 and mc.rpn.num_dir_bins == 1
        assert [p.mode for p in mc.primitives] == ['z', 'xy', 'line']
        # 6 face and 12 edge centres of 128 channels each
        bh = model.roi_head['bbox_head']
        assert bh.feat_agg.layer0.conv.weight.shape[1] == 18 * 128
        assert model.roi_head['refine_out'].weight.shape[0] == (
            2 + mc.rpn.n_reg + 18)
    elif det is timvotenet.ImVoteNet:
        assert mc.num_sampled_seed == 1024 and mc.loss_weights == (
            0.8, 0.1, 0.1)
        assert mc.fusion.num_classes == 10 and mc.fusion.cue_channels == 18
        assert mc.num_seeds == 1024
        # the joint tower's [point 256 | image 256] features
        assert [getattr(model, f'pts_bbox_head_{n}').cfg.in_channels
                for n in ('joint', 'pts', 'img')] == [512, 256, 256]
    elif name in SEGMENTORS:
        s3dis = 's3dis' in name
        assert mc.num_classes == (13 if s3dis else 20)
        # mmdet3d's S3DIS xyz | rgb | normalised xyz, but for the SSG
        # PointNet++; xyz alone for the xyz-only configs
        nine = s3dis and (det is not tenc.EncoderDecoder3D or mc.msg)
        assert mc.in_channels == (3 if 'xyz-only' in name
                                  else 9 if nine else 6)
        bb = model.backbone
        if det is tdgcnn.DGCNNSegmentor:
            assert mc.knn_modes == ('D-KNN', 'F-KNN', 'F-KNN')
            assert bb.GF_modules[0].mlps.layer0.conv.weight.shape[1] == 18
            # the global 1 024 and the three GF modules' 64 each
            assert bb.out_channels == 1024 + 3 * 64
        elif det is tpaconv.PAConvSegmentor:
            assert mc.num_kernels == 8
            assert bb.SA_modules[0].mlps[0].layer0.weight_bank.shape == (
                12, 8 * 32)
        else:
            assert mc.msg == ('_msg_' in name)
            first = bb.SA_modules[0].mlps[0].layer0.conv.weight
            assert first.shape[1] == mc.in_channels
            # the head's last propagation takes no raw features
            assert model.decode_head.FP_modules[-1].mlps.layer0.conv.weight \
                .shape[1] == mc.fp_channels[-2][-1]
    elif name in PILLAR_FAMILY:
        lyft = name.endswith('lyft-3d.py')
        assert mc.head.num_classes == (9 if lyft else 10)
        if 'regnet' in name:
            assert mc.backbone.startswith('regnetx_')
            assert type(model.backbone).__name__ == 'NoStemRegNet'
        if det is tvoxelnet.PointPillars:
            assert mc.compute_dtype == 'float32'
            assert model.fpn == (mc.neck == 'fpn') == ('_fpn_' in name)
    elif name in INDOOR:
        assert mc.head.n_classes == 18 and mc.head.n_reg_outs == 6
        assert not mc.head.with_yaw and mc.depth == 34
    elif name != 'gga_kitti_tiny.py':
        assert mc.encoder_paddings[2] == (0, 0, (0, 1, 1))
        assert mc.head.max_objs == 128 and mc.max_per_task == 100


@pytest.mark.parametrize('name', FP16_SECOND + FP16_PILLARS)
def test_anchor_detectors_refuse_the_fp16_configs(name):
    """The _fp16_ SECOND and PointPillars configs wait: the builder
    refuses bf16 by name, citing the ROADMAP item (and, for PointPillars,
    the card's measured gate)."""
    pillars = name in FP16_PILLARS
    with pytest.raises(NotImplementedError,
                       match='_fp16_ PointPillars.*_fp16_ SECOND configs '
                             '\\(bf16\\).*cosine floor' if pillars else
                       '_fp16_ SECOND configs \\(bf16\\)'):
        tbuilder.build_detector(
            tconfig.Config.fromfile(str(ROOT / 'configs' / name)))


def test_there_are_23_pillar_family_configs():
    kinds = [p.split('/')[0] for p in PILLAR_FAMILY]
    assert {k: kinds.count(k) for k in set(kinds)} == dict(
        free_anchor=6, regnet=8, ssn=4, pointpillars=5)
    assert sum('_fp16_' in p for p in PILLAR_FAMILY) == 3


@pytest.mark.parametrize('name', [
    'free_anchor/hv_pointpillars_fpn_sbn-all_free-anchor_4x8_2x_nus-3d.py',
    'ssn/hv_ssn_secfpn_sbn-all_2x16_2x_nus-3d.py'])
def test_nuscenes_label_0_takes_the_bicycle_anchor_in_both(name):
    """A finding about the reference, mirrored: the SSN and FreeAnchor
    nuScenes configs list their per-class anchors in SSN's order (bicycle
    first, car at index 5) but set no ``class_names`` of their own, and
    the dataset labels by ``NUS_CLASSES`` (car first). So label 0, car, is
    assigned the bicycle anchor (1.68 x 0.60 x 1.27) in both packages."""
    from gga_tpu.data.nuscenes import NUS_CLASSES as J_NUS
    from gga_tpu_torch.data.nuscenes import NUS_CLASSES as T_NUS
    path = str(ROOT / 'configs' / name)
    port = tconfig.Config.fromfile(path)
    ref = jconfig.Config.fromfile(path)
    assert J_NUS[0] == T_NUS[0] == 'car'
    assert port.class_names[0] == ref.class_names[0] == 'car'
    bicycle = (1.68452161, 0.60058911, 1.27192197)
    car = (4.60718145, 1.95017717, 1.72270761)
    for cfg, builder in ((port, tbuilder), (ref, jbuilder)):
        mc = builder.build_detector(cfg)[1]
        assert mc.head.anchor_sizes[0] == bicycle
        assert mc.head.anchor_sizes[5] == car


@pytest.mark.parametrize('name', FP16_SECOND + FP16_PILLARS)
def test_fp16_second_configs_equal_gga_tpu(name):
    """The _fp16_ SECOND and PointPillars configs' model configs (the port
    refuses to build the detector) equal gga_tpu's field by field."""
    path = str(ROOT / 'configs' / name)
    pillars = name in FP16_PILLARS
    mc = tbuilder.config_from_dict(
        tvoxelnet.PointPillarsConfig if pillars
        else tvoxelnet.SECONDNetConfig,
        dict(tconfig.Config.fromfile(path)['model']))
    _, ref = jbuilder.build_detector(jconfig.Config.fromfile(path))
    assert _fields(mc) == _fields(ref)
    assert mc.compute_dtype == 'bfloat16'
    assert mc.head.num_classes == (10 if pillars else 1 if name.endswith(
        '-car.py') else 3)


def test_unknown_key_raises_in_both():
    for cfg_mod, builder in ((tconfig, tbuilder), (jconfig, jbuilder)):
        cfg = cfg_mod.Config.fromfile(
            str(ROOT / 'configs' / 'gga' / 'gga_kitti_tiny.py'))
        cfg.merge_from_options({'model.encoder_chanels': '[[8]]'})
        with pytest.raises(KeyError, match='encoder_chanels'):
            builder.build_detector(cfg)
        cfg = cfg_mod.Config.fromfile(
            str(ROOT / 'configs' / 'gga' / 'gga_kitti_tiny.py'))
        cfg.merge_from_options({'head.max_obj': '3'})
        with pytest.raises(KeyError, match='max_obj'):
            builder.build_detector(cfg)


def test_primitive_list_builds_as_gga_tpu(tmp_path):
    """A list of dicts for a tuple-of-dataclass field (H3DNet's
    ``primitives``) builds one element a dict, as gga_tpu's builder."""
    path = tmp_path / 'h3dnet_narrow.py'
    path.write_text(
        f"_base_ = ['{ROOT}/configs/h3dnet/h3dnet_3x8_scannet-3d-18class.py']"
        "\nmodel = dict(primitives=[dict(mode=m, num_proposal=128, "
        "agg_mlp=[64, 64]) for m in ('z', 'xy', 'line')])\n")
    model, mc = tbuilder.build_detector(tconfig.Config.fromfile(str(path)))
    _, ref = jbuilder.build_detector(jconfig.Config.fromfile(str(path)))
    assert _fields(mc) == _fields(ref)
    assert [p.num_proposal for p in mc.primitives] == [128] * 3
    assert model.roi_head['bbox_head'].surface_matcher.mlps[0].layer0.conv \
        .weight.shape[1] == 3 + 64


def test_registry_names_the_known_types():
    reg = tconfig.Registry('things')
    reg.register(dict, name='D')
    with pytest.raises(KeyError, match='already registered'):
        reg.register(dict, name='D')
    with pytest.raises(KeyError, match="known: \\['D'\\]"):
        reg.get('E')
    assert reg.build({'type': 'D', 'a': 1}) == {'a': 1}
    cfg = tconfig.Config.fromfile(
        str(ROOT / 'configs' / 'gga' / 'gga_kitti_tiny.py'))
    cfg.model.type = 'MaskRCNN'           # not ported yet
    with pytest.raises(KeyError, match='GGADetector'):
        tbuilder.build_detector(cfg)
    # FreeAnchor, SSN, SMOKE and MonoFlex are registered, with gga_tpu's
    # names
    for name in ('FreeAnchorPointPillars', 'SSNDetector', 'SMOKEDetector',
                 'MonoFlexDetector'):
        assert callable(tconfig.MODELS.get(name))
        assert callable(jconfig.MODELS.get(name))
    with pytest.raises(KeyError, match='FreeAnchorPointPillars.*SSNDetector'):
        tbuilder.build_detector(cfg)


def test_encoder_tile_fields_default_as_gga_tpu_and_are_refused():
    from gga_tpu.models.detectors.centerpoint_gga import \
        GGAModelConfig as JCfg
    port, ref = tdet.GGAModelConfig(), JCfg()
    for f in ('encoder_tile_stages', 'encoder_tile_shape',
              'encoder_tile_budgets', 'remat_encoder'):
        assert getattr(port, f) == getattr(ref, f), f
    tiny = str(ROOT / 'configs' / 'gga' / 'gga_kitti_tiny.py')
    for key, val in (('encoder_tile_shape', '[2, 8, 8]'),
                     ('encoder_tile_budgets', '[0, 512, 512, 512]'),
                     ('encoder_tile_stages', '[1, 2]'),
                     ('remat_encoder', 'True')):
        cfg = tconfig.Config.fromfile(tiny).merge_from_options(
            {f'model.{key}': val})
        jcfg = jconfig.Config.fromfile(tiny)
        jcfg.merge_from_options({f'model.{key}': val})
        jbuilder.build_detector(jcfg)        # gga_tpu accepts the field
        with pytest.raises(NotImplementedError, match='row engine'):
            tbuilder.build_detector(cfg)
    # the defaults spelled out in a config still build
    cfg = tconfig.Config.fromfile(tiny).merge_from_options({
        'model.encoder_tile_shape': '[2, 4, 4]',
        'model.encoder_tile_budgets': '[0, 7168, 3072, 1536]'})
    tbuilder.build_detector(cfg)
