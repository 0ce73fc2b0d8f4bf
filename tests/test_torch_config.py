"""The port's config files and detector builder against gga_tpu's: the same
``configs/gga`` files parse to the same dicts, overrides agree, and
``build_detector`` gives model configs equal field by field (nested head
included), for the GGA configs and the shipped KITTI voxel detectors:
SECOND (3-class, car, the benchmark one), PointPillars (3-class, car,
both benchmark ones), the three dynamic-voxelization configs, SASSD and
all 16 nuScenes CenterPoint configs (voxel and pillar, DCN head, circle
NMS, tta) and the three PartA2 configs (3-class, car, the benchmark one);
the _fp16_ SECOND configs parse to model configs equal to gga_tpu's.
Also the port's refusal of gga_tpu's TPU-only encoder options, of the
PointPillars backbones and necks it does not have, and of the _fp16_
SECOND and PointPillars configs.
"""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gga_tpu import config as jconfig
from gga_tpu.models import builder as jbuilder
from gga_tpu_torch import config as tconfig
from gga_tpu_torch.models import builder as tbuilder
from gga_tpu_torch.models.detectors import centerpoint as tcp
from gga_tpu_torch.models.detectors import centerpoint_gga as tdet
from gga_tpu_torch.models.detectors import dynamic_voxelnet as tdv
from gga_tpu_torch.models.detectors import fcaf3d as tfcaf3d
from gga_tpu_torch.models.detectors import parta2 as tparta2
from gga_tpu_torch.models.detectors import pgd as tpgd
from gga_tpu_torch.models.detectors import sassd as tsassd
from gga_tpu_torch.models.detectors import voxelnet as tvoxelnet
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
    compared recursively."""
    return {f.name: (_fields(getattr(dc, f.name))
                     if dataclasses.is_dataclass(getattr(dc, f.name))
                     else getattr(dc, f.name))
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
    *CENTERPOINT))
def test_build_detector_config_equals_gga_tpu(name):
    path = str(ROOT / 'configs' / ('' if '/' in name else 'gga') / name)
    model, mc = tbuilder.build_detector(tconfig.Config.fromfile(path))
    _, ref = jbuilder.build_detector(jconfig.Config.fromfile(path))
    pgd = name == 'gga_pdg.py'
    indoor = name == 'gga_sunrgbd.py'
    det, cfg_cls = {
        'gga_pdg.py': (tpgd.PGDDetector, tpgd.PGDModelConfig),
        'gga_sunrgbd.py': (tfcaf3d.FCAF3DDetector, tfcaf3d.FCAF3DModelConfig),
        SECOND: (tvoxelnet.SECONDDetector, tvoxelnet.SECONDNetConfig),
        POINTPILLARS: (tvoxelnet.PointPillars, tvoxelnet.PointPillarsConfig),
        **VOXEL_FAMILY,
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
    elif name != 'gga_kitti_tiny.py':
        assert mc.encoder_paddings[2] == (0, 0, (0, 1, 1))
        assert mc.head.max_objs == 128 and mc.max_per_task == 100


@pytest.mark.parametrize('field', [dict(backbone='regnetx_400mf'),
                                   dict(neck='fpn')])
def test_pointpillars_refuses_what_it_lacks(field):
    cfg = tvoxelnet.PointPillarsConfig(**field)
    with pytest.raises(NotImplementedError,
                       match='FreeAnchor, SSN and the RegNet backbones'):
        tvoxelnet.PointPillars(cfg)


@pytest.mark.parametrize('name', [*FP16_SECOND, 'pointpillars'])
def test_anchor_detectors_refuse_the_fp16_configs(name):
    """The _fp16_ SECOND configs wait for their slice, and gga_tpu's
    _fp16_ PointPillars configs are nuScenes ones with an FPN neck: both
    detectors refuse bf16 by name, citing the ROADMAP item."""
    if name == 'pointpillars':
        with pytest.raises(NotImplementedError,
                           match='_fp16_.*FreeAnchor, SSN and the RegNet '
                                 'backbones'):
            tvoxelnet.PointPillars(
                tvoxelnet.PointPillarsConfig(compute_dtype='bfloat16'))
    else:
        with pytest.raises(NotImplementedError,
                           match='_fp16_ SECOND configs \\(bf16\\)'):
            tbuilder.build_detector(
                tconfig.Config.fromfile(str(ROOT / 'configs' / name)))


@pytest.mark.parametrize('name', FP16_SECOND)
def test_fp16_second_configs_equal_gga_tpu(name):
    """The _fp16_ SECOND configs' model configs (the port refuses to build
    the detector) equal gga_tpu's field by field."""
    path = str(ROOT / 'configs' / name)
    mc = tbuilder.config_from_dict(
        tvoxelnet.SECONDNetConfig,
        dict(tconfig.Config.fromfile(path)['model']))
    _, ref = jbuilder.build_detector(jconfig.Config.fromfile(path))
    assert _fields(mc) == _fields(ref)
    assert mc.compute_dtype == 'bfloat16'
    assert mc.head.num_classes == (1 if name.endswith('-car.py') else 3)


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
    cfg.model.type = 'PointRCNNDetector'
    with pytest.raises(KeyError, match='GGADetector'):
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
