"""The port's Lyft dataset and evaluation against gga_tpu's, CPU.

- ``LyftDataset``: every sample of two epochs, in train and test mode,
  and the batches of ``epoch_batches``, equal to gga_tpu's bit for bit on
  the nuScenes-format fixture of ``tests/test_torch_nuscenes.py`` (Lyft
  has no velocity channels; 'barrier' is not a Lyft class, 'animal' is);
  ``eval_ground_truth`` exactly;
- ``rotated_iou_3d`` (numpy) against gga_tpu's ``xp=np`` branch;
- ``lyft_eval`` on ground truth and noisy, partly matching predictions of
  the nine classes within 1e-12.
"""
import numpy as np
import pytest

from gga_tpu.core import rotated_iou as jriou
from gga_tpu.data import nuscenes as jnus
from gga_tpu.eval import lyft_eval as jeval
from gga_tpu_torch.core import np_rotated_iou as triou
from gga_tpu_torch.data import nuscenes as tnus
from gga_tpu_torch.eval import lyft_eval as teval

from .test_torch_nuscenes import _assert_same, _write_fixture


@pytest.fixture(scope='module')
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('lyft'))
    return root, _write_fixture(root)


def test_classes_and_defaults_equal_gga_tpu(fixture):
    assert tnus.LYFT_CLASSES == jnus.LYFT_CLASSES
    port = tnus.LyftDataset(*fixture)
    ref = jnus.LyftDataset(*fixture)
    assert not port.with_velocity and not ref.with_velocity
    np.testing.assert_array_equal(port.pc_range, ref.pc_range)
    np.testing.assert_array_equal(port.pc_range, [-80, -80, -10, 80, 80, 10])


@pytest.mark.parametrize('test_mode', [False, True])
def test_samples_and_batches_equal_gga_tpu(fixture, test_mode):
    kw = dict(max_points=1500, max_objs=4, sweeps_num=2,
              test_mode=test_mode, seed=5)
    port, ref = tnus.LyftDataset(*fixture, **kw), \
        jnus.LyftDataset(*fixture, **kw)
    for epoch in (0, 1):
        port.epoch = ref.epoch = epoch
        for idx in range(len(port)):
            _assert_same(port.get_sample(idx), ref.get_sample(idx))
        for x, y in zip(*[list(ds.epoch_batches(2, seed=epoch))
                          for ds in (port, ref)]):
            _assert_same(x, y)
    s = port.get_sample(0)
    assert s['points'].shape == (1500, 5)
    if not test_mode:
        assert s['gt_boxes'].shape == (4, 7)
        # car, pedestrian, truck and animal are Lyft classes (the truck
        # has no lidar point), barrier is not
        assert s['gt_valid'].sum() == 3
        assert set(s['gt_labels'][s['gt_valid']]) == {
            tnus.LYFT_CLASSES.index(n) for n in ('car', 'pedestrian',
                                                 'animal')}
    for a, b in zip(port.eval_ground_truth(), ref.eval_ground_truth()):
        _assert_same(a, b)


def _boxes(rng, k):
    return np.concatenate([rng.uniform(-30, 30, (k, 2)),
                           rng.uniform(-2, 0, (k, 1)),
                           rng.uniform(0.5, 5, (k, 3)),
                           rng.uniform(-np.pi, np.pi, (k, 1))], 1)


def test_rotated_iou_3d_matches_gga_tpu():
    rng = np.random.RandomState(2)
    a = _boxes(rng, 12)
    b = np.concatenate([a[:6] + rng.normal(0, 0.3, (6, 7)), _boxes(rng, 5)])
    out = triou.rotated_iou_3d(a, b)
    ref = np.asarray(jriou.rotated_iou_3d(a, b, xp=np))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    assert (np.diag(out[:6, :6]) > 0.2).all()


def test_lyft_eval_matches_gga_tpu():
    rng = np.random.RandomState(0)
    classes = jnus.LYFT_CLASSES
    gts, preds = [], []
    for _ in range(5):
        k = rng.randint(6, 12)
        gb = _boxes(rng, k)
        names = np.array([classes[i] for i in rng.randint(0, 8, k)])
        keep = rng.rand(k) < 0.8
        pb = gb[keep] + rng.normal(0, 0.08, gb[keep].shape)
        extra = rng.randint(1, 4)
        pb = np.concatenate([pb, _boxes(rng, extra)])
        pn = np.concatenate([names[keep], [classes[i] for i in
                                           rng.randint(0, 9, extra)]])
        gts.append(dict(boxes=gb, names=names))
        preds.append(dict(boxes=pb, names=pn, scores=rng.rand(len(pn))))
    out = teval.lyft_eval(gts, preds, classes)
    ref = jeval.lyft_eval(gts, preds, classes)
    assert set(out) == set(ref) and 'mAP' in out
    for key, v in ref.items():
        np.testing.assert_allclose(out[key], v, rtol=0, atol=1e-12,
                                   err_msg=key)
    assert 0 < out['mAP'] < 1
    assert teval.IOU_THRESHOLDS == jeval.IOU_THRESHOLDS
