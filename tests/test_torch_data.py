"""The port's stage-1 data preparation and input pipeline against gga_tpu's,
exactly, on the same synthetic mini-KITTI files (3 train scenes, the sizes
of tests/test_train/test_end_to_end.py) and the same seeds: scene infos
and GT point counts, the GGA weak labels with the C++ region grow and with
the numpy one, the reduced clouds and the GT database files, every key of
every dataset item over two epochs, and loader batches against
``PrefetchLoader(num_workers=1)``.
"""
import os
import pickle
import shutil
import unittest.mock as mock

import numpy as np
import pytest
import torch

from gga_tpu.data import dataset as jds
from gga_tpu.data import sampler as jsampler
from gga_tpu.data.kitti import gga_labels as jgl
from gga_tpu.data.kitti import gt_database as jgt
from gga_tpu.data.kitti import io as jio
from gga_tpu.data.kitti import native as jnative
from gga_tpu_torch.data import dataset as tds
from gga_tpu_torch.data import sampler as tsampler
from gga_tpu_torch.data.kitti import gga_labels as tgl
from gga_tpu_torch.data.kitti import gt_database as tgt
from gga_tpu_torch.data.kitti import io as tio
from gga_tpu_torch.data.kitti import native as tnative

from .test_data.fixtures import make_scene, write_kitti_scene

torch.set_num_threads(1)

N_SCENES = 3
BOXES = np.array([[12.0, 2.0, -1.7, 3.9, 1.6, 1.55, 0.3],
                  [20.0, -4.0, -1.7, 0.8, 0.6, 1.75, -0.2],
                  [28.0, 6.0, -1.7, 1.76, 0.6, 1.73, 1.0]])
NAMES = ['Car', 'Pedestrian', 'Cyclist']
SAMPLE_GROUPS = dict(Car=3, Pedestrian=3, Cyclist=3)


def assert_same(a, b, path='info'):
    """Exact equality of nested dicts / lists / arrays, dtypes included."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f'{path}[{k!r}]')
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f'{path}[{i}]')
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


@pytest.fixture(scope='module')
def raw_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('kitti_raw'))
    rng = np.random.RandomState(0)
    for idx in range(N_SCENES):
        boxes = BOXES.copy()
        boxes[:, 1] += idx
        pts = make_scene(rng, boxes, NAMES, n_ground=2000, n_clutter=200,
                         pts_per_box=200)
        write_kitti_scene(root, idx, pts, boxes, NAMES)
    return root


def _infos(io, gl, root):
    infos = []
    for idx in range(N_SCENES):
        info = io.create_scene_info(root, 'train', idx)
        io.compute_num_points_in_gt(root, info)
        gl.calculate_gga_labels(
            io.load_velodyne(f'{root}/training/velodyne/{idx:06d}.bin'),
            info, rng=np.random.RandomState(idx))
        infos.append(info)
    return infos


@pytest.fixture(scope='module')
def prepared(raw_root, tmp_path_factory):
    """Each package's stage 1 in its own copy of the raw files."""
    out = {}
    for name, io, gl, gt in (('port', tio, tgl, tgt),
                             ('gga_tpu', jio, jgl, jgt)):
        root = str(tmp_path_factory.mktemp(f'kitti_{name}'))
        shutil.copytree(raw_root, root, dirs_exist_ok=True)
        infos = _infos(io, gl, root)
        gt.create_reduced_point_clouds(root, infos)
        gt.create_gga_gt_database(root, infos)
        with open(os.path.join(root, 'kitti_infos_train_GGA.pkl'),
                  'wb') as f:
            pickle.dump(infos, f)
        out[name] = (root, infos)
    return out


def test_scene_info_and_points_in_gt_equal(raw_root):
    for idx in range(N_SCENES):
        port = tio.create_scene_info(raw_root, 'train', idx)
        ref = jio.create_scene_info(raw_root, 'train', idx)
        tio.compute_num_points_in_gt(raw_root, port)
        jio.compute_num_points_in_gt(raw_root, ref)
        assert_same(port, ref)
        assert (port['annos']['num_points_in_gt'] > 0).all()
    assert tio.read_split_ids(raw_root, 'train') == list(range(N_SCENES))
    assert list(tio.read_image_shape(
        f'{raw_root}/training/image_2/000000.png')) == [375, 1242]


@pytest.mark.parametrize('region_grow', ['native', 'numpy'])
def test_gga_labels_equal(raw_root, region_grow):
    if region_grow == 'native':
        assert tnative.available() and jnative.available()
        ctx = mock.patch.object(tnative, 'region_grow_native',
                                tnative.region_grow_native)
    else:
        ctx = mock.patch.multiple(tnative, region_grow_native=lambda *a: None)
    with ctx, mock.patch.object(
            jnative, 'region_grow_native',
            jnative.region_grow_native if region_grow == 'native'
            else (lambda *a: None)):
        port = _infos(tio, tgl, raw_root)
        ref = _infos(jio, jgl, raw_root)
    assert_same(port, ref)
    valid = np.concatenate([i['annos']['GGA_mask_valid'] for i in port])
    assert valid.sum() >= 2 * N_SCENES


def test_reduced_clouds_and_gt_database_equal(prepared):
    (proot, pinfos), (jroot, jinfos) = prepared['port'], prepared['gga_tpu']
    assert_same(pinfos, jinfos)
    for idx in range(N_SCENES):
        rel = f'training/velodyne_reduced/{idx:06d}.bin'
        with open(os.path.join(proot, rel), 'rb') as a, \
                open(os.path.join(jroot, rel), 'rb') as b:
            assert a.read() == b.read(), rel
    pdb = sorted(os.listdir(os.path.join(proot, 'kitti_gt_database_GGA')))
    jdb = sorted(os.listdir(os.path.join(jroot, 'kitti_gt_database_GGA')))
    assert pdb == jdb and len(pdb) >= N_SCENES
    for name in pdb:
        with open(os.path.join(proot, 'kitti_gt_database_GGA', name),
                  'rb') as a, open(os.path.join(
                      jroot, 'kitti_gt_database_GGA', name), 'rb') as b:
            assert a.read() == b.read(), name
    with open(os.path.join(proot, 'kitti_dbinfos_train_GGA.pkl'), 'rb') as a, \
            open(os.path.join(jroot, 'kitti_dbinfos_train_GGA.pkl'),
                 'rb') as b:
        assert_same(pickle.load(a), pickle.load(b), 'dbinfos')


def _datasets(root, seed=0):
    """The port's and gga_tpu's train datasets with a database sampler,
    fresh (the samplers' rngs are stateful)."""
    out = []
    for ds_mod, smp_mod in ((tds, tsampler), (jds, jsampler)):
        smp = smp_mod.GGADataBaseSampler(
            os.path.join(root, 'kitti_dbinfos_train_GGA.pkl'), root,
            classes=ds_mod.KittiGGADataset.CLASSES,
            sample_groups=SAMPLE_GROUPS, rate=1.0,
            prepare=dict(filter_by_difficulty=[-1],
                         filter_by_min_points=dict(Car=5, Pedestrian=5,
                                                   Cyclist=5)),
            seed=seed)
        out.append(ds_mod.KittiGGADataset(
            root, os.path.join(root, 'kitti_infos_train_GGA.pkl'),
            db_sampler=smp, pc_range=(0, -40, -3, 70.4, 40, 1),
            max_points=4096, max_objs=16, max_cluster_pts=64, seed=seed))
    return out


def test_dataset_items_equal(prepared):
    root = prepared['port'][0]
    port, ref = _datasets(root)
    assert isinstance(port, torch.utils.data.Dataset)
    assert len(port) == len(ref) == N_SCENES
    n_obj = 0
    for epoch in (0, 1):
        port.epoch = ref.epoch = epoch
        for i in range(N_SCENES):
            a, b = port[i], ref[i]
            assert set(a) == set(b) == {
                'points', 'points_valid', 'labels', 'obj_valid',
                'init_pseudo', 'boxes_img', 'bdry_masks', 'lidar2img',
                'ibp_xy', 'ibp_valid', 'gt_boxes', 'sample_idx'}
            assert_same(a, b, f'epoch {epoch} item {i}')
            n_obj += int(a['obj_valid'].sum())
    assert n_obj > 2 * N_SCENES         # scene objects plus pasted ones


@pytest.mark.parametrize('workers', [0, 1])
def test_loader_epoch_equals_prefetch_loader(prepared, workers):
    root = prepared['port'][0]
    port, ref = _datasets(root, seed=3)
    loader = tds.EpochLoader(port, batch_size=1, num_workers=workers, seed=3)
    ref_loader = jds.PrefetchLoader(ref, 1, num_workers=1, seed=3)
    for epoch in (0, 1, 2):
        got = list(loader.epoch(epoch))
        want = list(ref_loader.epoch(epoch))
        assert len(got) == len(want) == len(loader) == N_SCENES
        assert_same(got, want, f'epoch {epoch}')
    # a resume inside an epoch skips its first batches
    port, ref = _datasets(root, seed=3)
    loader = tds.EpochLoader(port, batch_size=1, num_workers=0, seed=3)
    order = [int(b['sample_idx'][0]) for b in loader.epoch(1)]
    assert [int(b['sample_idx'][0])
            for b in loader.epoch(1, skip=2)] == order[2:]
