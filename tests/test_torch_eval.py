"""The port's host-side eval against gga_tpu's: the numpy rotated overlap
of the KITTI evaluator within 1e-9 for every criterion, ``calculate_iou_
partly``, ``eval_class``, ``do_eval`` and ``kitti_eval`` equal on the
golden inputs of tests/test_eval/test_kitti_eval_golden.py, and
``detections_to_kitti_annos``, ``write_kitti_submission`` and
``pseudo_label_matching`` equal on the same detections.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from gga_tpu.core.rotated_iou import \
    rotated_iou_camera_eval as j_rotated_iou_camera_eval
from gga_tpu.data.kitti import pseudo_labels as jpl
from gga_tpu.eval import kitti_eval as jke
from gga_tpu.eval import submission as jsub
from gga_tpu_torch.core.np_rotated_iou import rotated_iou_camera_eval
from gga_tpu_torch.data.kitti import gga_labels as tgl
from gga_tpu_torch.data.kitti import io as tio
from gga_tpu_torch.data.kitti import pseudo_labels as tpl
from gga_tpu_torch.eval import kitti_eval as tke
from gga_tpu_torch.eval import submission as tsub

from .test_data.fixtures import make_scene, write_kitti_scene
from .test_eval.test_kitti_eval_golden import MIN_OVERLAPS, _fixture_annos
from .test_torch_data import assert_same

torch.set_num_threads(1)

CLASSES = ['Pedestrian', 'Cyclist', 'Car']


def _boxes(rng, n):
    """Camera-eval boxes (x, z, l, w, ry): overlapping, touching, nested
    and far apart pairs."""
    b = np.stack([rng.uniform(-3, 3, n), rng.uniform(5, 11, n),
                  rng.uniform(0.5, 4.5, n), rng.uniform(0.4, 2.0, n),
                  rng.uniform(-np.pi, np.pi, n)], 1)
    b[1] = b[0]                                      # identical
    b[2, :2] = b[0, :2]
    b[2, 2:4] = b[0, 2:4] / 2                        # nested
    b[3, :] = b[0] + [b[0, 2], 0, 0, 0, 0]           # shifted by a length
    b[3, 4] = 0.0
    b[0, 4] = 0.0
    return b


@pytest.mark.parametrize('criterion', [-1, 0, 1, 2])
def test_rotated_iou_camera_eval_matches(criterion):
    rng = np.random.RandomState(criterion + 5)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    got = rotated_iou_camera_eval(a, b, criterion)
    want = j_rotated_iou_camera_eval(a, b, criterion)
    assert got.shape == (40, 30) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert (got > 0).sum() >= 40


@pytest.mark.parametrize('metric', [0, 1, 2])
def test_calculate_iou_partly_equal(metric):
    gt, dt = _fixture_annos()
    got = tke.calculate_iou_partly([gt, gt], [dt, dt], metric, num_parts=2)
    want = jke.calculate_iou_partly([gt, gt], [dt, dt], metric, num_parts=2)
    assert_same(list(got), list(want), f'metric {metric}')


def test_kitti_eval_equal_on_golden_inputs():
    gt, dt = _fixture_annos()
    got_res, got = tke.kitti_eval([gt], [dt], CLASSES)
    want_res, want = jke.kitti_eval([gt], [dt], CLASSES)
    assert got_res == want_res
    assert got == want and len(got) > 50
    assert_same(tke.kitti_eval([gt], [dt], [1, 2, 0]),
                jke.kitti_eval([gt], [dt], [1, 2, 0]), 'kitti_eval ids')
    gt2, dt2 = _fixture_annos(with_3d=False)
    assert_same(tke.eval_class([gt2], [dt2], [1, 2, 0], [0, 1, 2], 0,
                               MIN_OVERLAPS, compute_aos=True),
                jke.eval_class([gt2], [dt2], [1, 2, 0], [0, 1, 2], 0,
                               MIN_OVERLAPS, compute_aos=True), 'eval_class')
    types = ('bbox', 'bev', '3d', 'aos')
    assert_same(list(tke.do_eval([gt], [dt], [1, 2, 0], MIN_OVERLAPS, types)),
                list(jke.do_eval([gt], [dt], [1, 2, 0], MIN_OVERLAPS, types)),
                'do_eval')


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    """Two synthetic scenes with GGA infos, and detections: each GT box
    jittered, a box outside the image, one behind the camera, and a
    scene with no detections."""
    root = str(tmp_path_factory.mktemp('kitti_eval'))
    rng = np.random.RandomState(0)
    boxes = np.array([[12.0, 2.0, -1.7, 3.9, 1.6, 1.55, 0.3],
                      [20.0, -4.0, -1.7, 0.8, 0.6, 1.75, -0.2],
                      [25.0, 5.0, -1.7, 1.76, 0.6, 1.73, 2.0]])
    names = ['Car', 'Pedestrian', 'Cyclist']
    infos, dets = [], []
    for idx in range(2):
        pts = make_scene(rng, boxes, names, n_ground=2000, n_clutter=200,
                         pts_per_box=200)
        write_kitti_scene(root, idx, pts, boxes, names)
        info = tio.create_scene_info(root, 'train', idx)
        tio.compute_num_points_in_gt(root, info)
        tgl.calculate_gga_labels(pts, info, rng=np.random.RandomState(idx))
        infos.append(info)
        jit = boxes + rng.normal(0, 0.2, boxes.shape) * [1, 1, 0, 1, 1, 0, 1]
        extra = np.array([[20.0, 30.0, -1.7, 4.0, 1.7, 1.5, 0.0],
                          [-5.0, 0.0, -1.7, 4.0, 1.7, 1.5, 0.0]])
        # w > l on one box: the matching swaps dims and turns it by pi/2
        jit[0, 3:5] = jit[0, [4, 3]]
        dets.append(dict(
            boxes_3d=np.concatenate([jit, extra]).astype(np.float32),
            scores_3d=rng.uniform(0.1, 1.0, 5).astype(np.float32),
            labels_3d=np.array([2, 0, 1, 2, 2], np.int32)))
    dets[1] = dict(boxes_3d=np.zeros((0, 7), np.float32),
                   scores_3d=np.zeros(0, np.float32),
                   labels_3d=np.zeros(0, np.int32))
    return root, infos, dets


def test_detections_to_kitti_annos_and_submission_equal(scenes, tmp_path):
    _, infos, dets = scenes
    got = tsub.detections_to_kitti_annos(dets, infos, CLASSES)
    want = jsub.detections_to_kitti_annos(dets, infos, CLASSES)
    assert_same(got, want, 'annos')
    assert len(got[0]['name']) == 3 and len(got[1]['name']) == 0
    tsub.write_kitti_submission(got, infos, str(tmp_path / 'port'))
    jsub.write_kitti_submission(want, infos, str(tmp_path / 'ref'))
    for name in sorted(os.listdir(tmp_path / 'ref')):
        assert ((tmp_path / 'port' / name).read_text()
                == (tmp_path / 'ref' / name).read_text())


def test_pseudo_label_matching_equal(scenes, tmp_path):
    _, infos, dets = scenes
    annos = tsub.detections_to_kitti_annos(dets, infos, CLASSES)
    got = tpl.pseudo_label_matching(infos, annos, out_path=str(
        tmp_path / 'port' / 'pseudo.pkl'))
    want = jpl.pseudo_label_matching(infos, annos, out_path=str(
        tmp_path / 'ref' / 'pseudo.pkl'))
    assert_same(list(got), list(want), 'matching')
    with open(tmp_path / 'port' / 'pseudo.pkl', 'rb') as a, \
            open(tmp_path / 'ref' / 'pseudo.pkl', 'rb') as b:
        assert_same(pickle.load(a), pickle.load(b), 'pkl')
    a0 = got[0][0]['annos']
    assert len(a0['name']) == 3
    assert (a0['dimensions'][:, 0] >= a0['dimensions'][:, 2]).all()
    assert 'GGA_init_pseudo_label' in a0
