"""The port's config files and detector builder against gga_tpu's: the same
``configs/gga`` files parse to the same dicts, overrides agree, and
``build_detector`` gives model configs equal field by field (nested head
included). Also the port's refusal of gga_tpu's TPU-only encoder options.
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
from gga_tpu_torch.models.detectors import centerpoint_gga as tdet
from gga_tpu_torch.models.detectors import fcaf3d as tfcaf3d
from gga_tpu_torch.models.detectors import pgd as tpgd

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GGA_CONFIGS = sorted((ROOT / 'configs' / 'gga').glob('*.py'))
DETECTOR_CONFIGS = ('gga_kitti.py', 'gga_kitti_tiny.py',
                    'gga_kitti_matching.py')
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


@pytest.mark.parametrize('name', DETECTOR_CONFIGS + ('gga_pdg.py',
                                                    'gga_sunrgbd.py'))
def test_build_detector_config_equals_gga_tpu(name):
    path = str(ROOT / 'configs' / 'gga' / name)
    model, mc = tbuilder.build_detector(tconfig.Config.fromfile(path))
    _, ref = jbuilder.build_detector(jconfig.Config.fromfile(path))
    pgd = name == 'gga_pdg.py'
    indoor = name == 'gga_sunrgbd.py'
    det, cfg_cls = ((tpgd.PGDDetector, tpgd.PGDModelConfig) if pgd else
                    (tfcaf3d.FCAF3DDetector, tfcaf3d.FCAF3DModelConfig)
                    if indoor else (tdet.GGADetector, tdet.GGAModelConfig))
    assert isinstance(model, det) and isinstance(mc, cfg_cls)
    assert _fields(mc) == _fields(ref)
    hash(mc)                                  # frozen and hashable
    if indoor:
        assert mc.depth == 34 and mc.voxel_size == mc.head.voxel_size == 0.01
        assert mc.head.n_classes == 10 and mc.head.n_reg_outs == 8
        assert mc.grid_zyx == (512, 1280, 1280)
    elif pgd:
        assert mc.backbone_depth == 101 and mc.fpn_channels == 256
        assert mc.head.feat_channels == 256 and mc.head.stacked_convs == 2
    elif name != 'gga_kitti_tiny.py':
        assert mc.encoder_paddings[2] == (0, 0, (0, 1, 1))
        assert mc.head.max_objs == 128 and mc.max_per_task == 100


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
    cfg.model.type = 'CenterPointDetector'
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
