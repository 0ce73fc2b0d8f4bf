"""The port's nuScenes dataset and evaluation against gga_tpu's, CPU.

- ``NuScenesDataset``: every sample of two epochs, in train mode (more
  sweeps than ``sweeps_num``, so the generator picks them; more points
  than ``max_points``, so it subsamples) and in test mode, and the
  batches of ``epoch_batches``, equal to gga_tpu's bit for bit, on a
  fixture built as ``tests/test_data/test_nuscenes.py`` builds its own
  (sweeps with a sensor-to-lidar transform and a time lag, a NaN
  velocity, a box with no lidar point, a class outside the ten);
- ``eval_ground_truth`` and ``format_results`` (boxes moved to the global
  frame through each info's lidar2ego and ego2global) exactly;
- ``nuscenes_eval`` on the same ground truth and detections within 1e-9.
"""
import os
import pickle

import numpy as np
import pytest

from gga_tpu.data import nuscenes as jnus
from gga_tpu.eval import nuscenes_eval as jeval
from gga_tpu_torch.data import nuscenes as tnus
from gga_tpu_torch.eval import nuscenes_eval as teval

N_SAMPLES = 4
NAMES = ['car', 'pedestrian', 'truck', 'barrier', 'animal']


def _rot_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def _write_fixture(root, n_samples=N_SAMPLES):
    os.makedirs(f'{root}/sweeps', exist_ok=True)
    rng = np.random.RandomState(0)
    infos = []
    for i in range(n_samples):
        pts = rng.uniform(-60, 60, (700, 5)).astype(np.float32)
        path = f'{root}/sample_{i}.bin'
        pts.tofile(path)
        ts = 1_000_000 * (n_samples - i)     # stored out of time order
        sweeps = []
        for k in range(4):
            sw = rng.uniform(-40, 40, (200 + 10 * k, 5)).astype(np.float32)
            sw_path = f'sweeps/sweep_{i}_{k}.bin'      # relative to root
            sw.tofile(f'{root}/{sw_path}')
            sweeps.append(dict(
                data_path=sw_path, timestamp=ts - 50_000 * (k + 1),
                sensor2lidar_rotation=_rot_z(0.01 * (k + 1)),
                sensor2lidar_translation=np.array([0.3 * (k + 1), 0.1, 0.])))
        boxes = np.array([[5.0, 2.0, 0.25, 4.0, 1.8, 1.5, 0.3],
                          [-8.0, -3.0, 0.4, 0.6, 0.6, 1.8, 0.0],
                          [12.0, 9.0, 1.0, 7.0, 2.5, 3.0, 1.2],
                          [3.0, -14.0, 0.3, 2.0, 0.5, 1.0, -0.4],
                          [-2.0, 6.0, 0.2, 1.0, 0.5, 0.8, 2.0]])
        boxes[:, :2] += rng.uniform(-1, 1, (5, 2))
        infos.append(dict(
            token=f'tok{i}', lidar_path=path, timestamp=ts, sweeps=sweeps,
            gt_boxes=boxes, gt_names=np.array(NAMES),
            gt_velocity=np.array([[1.0, 0.5], [np.nan, np.nan],
                                  [3.0, -1.0], [0.0, 0.0], [0.2, 0.1]]),
            num_lidar_pts=np.array([50, 12, 0, 7, 3]),
            valid_flag=np.array([True, True, False, True, True]),
            lidar2ego_rotation_matrix=_rot_z(0.02 * i),
            lidar2ego_translation=np.array([0.9, 0.0, 1.8]),
            ego2global_rotation_matrix=_rot_z(0.5 + i),
            ego2global_translation=np.array([600.0 + i, 1600.0, 0.0])))
    info_path = f'{root}/nuscenes_infos_train.pkl'
    with open(info_path, 'wb') as f:
        pickle.dump(dict(infos=infos, metadata=dict(version='v1.0-mini')), f)
    return info_path


@pytest.fixture(scope='module')
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('nuscenes'))
    return root, _write_fixture(root)


def _assert_same(a, b):
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key


@pytest.mark.parametrize('test_mode', [False, True])
@pytest.mark.parametrize('max_points', [1200, 5000])
def test_samples_and_batches_equal_gga_tpu(fixture, test_mode, max_points):
    root, info = fixture
    kw = dict(max_points=max_points, max_objs=4, sweeps_num=2,
              test_mode=test_mode, seed=3)
    port, ref = tnus.NuScenesDataset(root, info, **kw), \
        jnus.NuScenesDataset(root, info, **kw)
    assert [i['token'] for i in port.data_infos] == \
        [i['token'] for i in ref.data_infos]
    for epoch in (0, 1):
        port.epoch = ref.epoch = epoch
        for idx in range(len(port)):
            a, b = port.get_sample(idx), ref.get_sample(idx)
            _assert_same(a, b)
        batches = [list(ds.epoch_batches(2, seed=epoch)) for ds in (port, ref)]
        assert len(batches[0]) == len(batches[1]) == 2
        for x, y in zip(*batches):
            _assert_same(x, y)
    s = port.get_sample(0)
    assert s['points'].shape == (max_points, 5)
    # the time lags of the key frame and its two sweeps
    dts = np.unique(np.round(s['points'][s['points_valid']][:, 4], 3))
    assert len(dts) == 3 and dts[0] == 0.0
    if not test_mode:
        assert s['gt_boxes'].shape == (4, 9)
        # of five boxes one has no lidar point, one a class outside the ten
        assert s['gt_valid'].sum() == 3


def test_ground_truth_and_format_results_equal_gga_tpu(fixture, tmp_path):
    root, info = fixture
    port = tnus.NuScenesDataset(root, info, use_valid_flag=True)
    ref = jnus.NuScenesDataset(root, info, use_valid_flag=True)
    for a, b in zip(port.eval_ground_truth(), ref.eval_ground_truth()):
        _assert_same(a, b)
    rng = np.random.RandomState(1)
    dets = [dict(boxes_3d=rng.uniform(-30, 30, (6, 9)),
                 scores_3d=rng.rand(6), labels_3d=rng.randint(0, 10, 6))
            for _ in range(N_SAMPLES)]
    dets[1]['boxes_3d'] = dets[1]['boxes_3d'][:, :7]     # no velocity
    out = port.format_results(dets, str(tmp_path / 'port' / 'res.json'))
    want = ref.format_results(dets, str(tmp_path / 'ref' / 'res.json'))
    assert out == want
    with open(tmp_path / 'port' / 'res.json') as f, \
            open(tmp_path / 'ref' / 'res.json') as g:
        assert f.read() == g.read()


def _eval_inputs(seed=0, n=6):
    """Ground truth and noisy detections of the ten classes: velocities,
    attributes, misses, false positives."""
    rng = np.random.RandomState(seed)
    gts, preds = [], []
    classes = jeval.NUS_CLASSES
    for _ in range(n):
        k = rng.randint(8, 16)
        gb = np.concatenate([rng.uniform(-40, 40, (k, 2)),
                             rng.uniform(-2, 0, (k, 1)),
                             rng.uniform(0.5, 5, (k, 3)),
                             rng.uniform(-np.pi, np.pi, (k, 1)),
                             rng.uniform(-5, 5, (k, 2))], 1)
        names = np.array([classes[i] for i in rng.randint(0, 10, k)])
        attrs = np.array(['a', 'b'])[rng.randint(0, 2, k)]
        keep = rng.rand(k) < 0.8
        pb = gb[keep] + rng.normal(0, 0.6, gb[keep].shape)
        extra = rng.randint(2, 6)
        pb = np.concatenate([pb, np.concatenate([
            rng.uniform(-40, 40, (extra, 2)), rng.uniform(-2, 0, (extra, 1)),
            rng.uniform(0.5, 5, (extra, 3)),
            rng.uniform(-np.pi, np.pi, (extra, 1)),
            rng.uniform(-5, 5, (extra, 2))], 1)])
        pn = np.concatenate([names[keep], [classes[i] for i in
                                           rng.randint(0, 10, extra)]])
        pa = np.array(['a', 'b'])[rng.randint(0, 2, len(pn))]
        gts.append(dict(boxes=gb, names=names, attrs=attrs))
        preds.append(dict(boxes=pb, names=pn, scores=rng.rand(len(pn)),
                          attrs=pa))
    return gts, preds


def test_nuscenes_eval_matches_gga_tpu():
    gts, preds = _eval_inputs()
    out = teval.nuscenes_eval(gts, preds)
    ref = jeval.nuscenes_eval(gts, preds)
    assert set(out) == set(ref)
    for key, v in ref.items():
        np.testing.assert_allclose(out[key], v, rtol=0, atol=1e-9,
                                   err_msg=key)
    assert 0 < out['mAP'] < 1 and 0 < out['NDS'] < 1
