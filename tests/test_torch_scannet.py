"""The port's ``ScanNetDataset`` against gga_tpu's, CPU: on infos the
port's converter writes from a raw ScanNet layout (scenes with more and
with fewer points than the sample, with and without boxes, more boxes
than ``max_objs``), both datasets built from one seed give the same
items, array for array and bit for bit, over two epochs of
``epoch_batches`` in train mode (the point sample and both flips drawn in
gga_tpu's order) and in test mode, and item by item through the port's
``torch.utils.data.Dataset`` interface.
"""
import os

import numpy as np
import pytest

from gga_tpu.data.scannet import ScanNetDataset as JScanNet
from gga_tpu_torch.data.indoor_converter import create_scannet_infos
from gga_tpu_torch.data.scannet import ScanNetDataset

NUM_POINTS, MAX_OBJS = 400, 3


@pytest.fixture(scope='module')
def infos(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('scannet'))
    inst = os.path.join(root, 'scannet_instance_data')
    os.makedirs(inst)
    os.makedirs(os.path.join(root, 'meta_data'))
    rng = np.random.RandomState(0)
    scenes = [f'scene{i:04d}_00' for i in range(6)]
    for i, scene in enumerate(scenes):
        n = (250, 400, 900, 1300, 300, 700)[i]
        np.save(os.path.join(inst, f'{scene}_vert.npy'),
                rng.uniform(-3, 3, (n, 6)).astype(np.float32))
        m = (0, 1, 2, 4, 3, 5)[i]
        boxes = np.concatenate([rng.uniform(-2, 2, (m, 3)),
                                rng.uniform(0.3, 1.5, (m, 3)),
                                rng.choice([3, 4, 5, 39], (m, 1))], -1)
        np.save(os.path.join(inst, f'{scene}_aligned_bbox.npy'), boxes)
        np.save(os.path.join(inst, f'{scene}_unaligned_bbox.npy'), boxes)
        np.save(os.path.join(inst, f'{scene}_axis_align_matrix.npy'),
                np.eye(4))
        for kind in ('sem', 'ins'):
            np.save(os.path.join(inst, f'{scene}_{kind}_label.npy'),
                    rng.randint(0, 5, n).astype(np.int64))
    with open(os.path.join(root, 'meta_data', 'scannetv2_train.txt'),
              'w') as f:
        f.write('\n'.join(scenes) + '\n')
    return root, create_scannet_infos(root, workers=1)['train']


@pytest.mark.parametrize('test_mode', [False, True])
def test_epoch_batches_equal_gga_tpu(infos, test_mode):
    root, pkl = infos
    kw = dict(num_points=NUM_POINTS, max_objs=MAX_OBJS, test_mode=test_mode,
              seed=3)
    ref, port = JScanNet(root, pkl, **kw), ScanNetDataset(root, pkl, **kw)
    for epoch in range(2):
        got = list(port.epoch_batches(2, seed=epoch))
        want = list(ref.epoch_batches(2, seed=epoch))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert list(a) == list(b)
            for k in b:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # every box kept up to max_objs, a zero yaw column
    assert got[0]['gt_boxes'].shape == (2, MAX_OBJS, 7)
    assert not got[0]['gt_boxes'][..., 6].any()


def test_items_equal_gga_tpu(infos):
    root, pkl = infos
    kw = dict(num_points=NUM_POINTS, max_objs=MAX_OBJS, seed=7)
    ref, port = JScanNet(root, pkl, **kw), ScanNetDataset(root, pkl, **kw)
    assert len(port) == len(ref) == 6
    for i in (5, 0, 3, 3, 1):
        a, b = port[i], ref[i]
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f'{i} {k}')
    assert port[0]['obj_valid'].sum() == 0
    assert port[3]['obj_valid'].sum() == MAX_OBJS
