"""The end of stage 3 through the port's tools, in-process on the CPU at
``configs/gga/gga_kitti_tiny.py`` on a synthetic mini-KITTI (4 scenes),
against gga_tpu with the same weights (gga_tpu's tiny detector with
numpy-drawn weights, carried into a port checkpoint by
``convert.from_jax_variables``):

- ``tools/test.py --eval --format-only``: the submission files of
  gga_tpu's ``run_inference`` + ``detections_to_kitti_annos`` +
  ``write_kitti_submission`` (the same files and rows, each number equal
  to its printed precision) and its KITTI AP (within 1e-6);
- ``apis.aug_inference_detector`` against gga_tpu's (boxes and scores
  within rtol 1e-4 + atol 1e-4, the forward's tolerance in
  tests/test_torch_detector.py; the same labels), and ``tools/test.py
  --aug-test`` through to its submission files;
- the mono3d COCO json of the port's stage-3 pseudo infos, equal to
  gga_tpu's ``export_mono3d_coco`` of them, and
  ``create_data_gga_retrain_mono`` on the pkl.
"""
import json
import os
import pickle
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gga_tpu import apis as japis
from gga_tpu import tools_lib as jtools
from gga_tpu.config import Config as JConfig
from gga_tpu.data import pipelines as jpl
from gga_tpu.data.kitti import mono_export as jmono
from gga_tpu.eval import submission as jsub
from gga_tpu.eval.kitti_eval import kitti_eval as jkitti_eval
from gga_tpu.models.builder import build_detector as jbuild
from gga_tpu_torch import apis, convert, tools_lib
from gga_tpu_torch.config import Config
from gga_tpu_torch.data.kitti import mono_export as tmono
from gga_tpu_torch.tools import create_data_gga, create_data_gga_retrain_mono
from gga_tpu_torch.tools import generate_pseudo_labels_gga
from gga_tpu_torch.tools import test as test_cli
from gga_tpu_torch.train import checkpoints as ckpt

from .test_data.fixtures import make_scene, write_kitti_scene
from .test_torch_detector import _fill

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = str(ROOT / 'configs' / 'gga' / 'gga_kitti_tiny.py')
CLASSES = ('Pedestrian', 'Cyclist', 'Car')
INFO = 'kitti_infos_trainval_GGA.pkl'
AUG_INFO = 'kitti_infos_aug1.pkl'   # the first scene


@pytest.fixture(scope='module')
def stage3(tmp_path_factory):
    """Stage 1 on 4 scenes; gga_tpu's tiny detector with numpy weights
    and a port checkpoint of the same weights."""
    root = str(tmp_path_factory.mktemp('kitti_test_cli'))
    rng = np.random.RandomState(0)
    boxes = np.array([[12.0, 2.0, -1.7, 3.9, 1.6, 1.55, 0.3],
                      [20.0, -4.0, -1.7, 0.8, 0.6, 1.75, -0.2],
                      [28.0, 6.0, -1.7, 1.76, 0.6, 1.73, 1.0]])
    names = ['Car', 'Pedestrian', 'Cyclist']
    for idx in range(4):
        shifted = boxes + [0, idx, 0, 0, 0, 0, 0]
        pts = make_scene(rng, shifted, names, n_ground=2000, n_clutter=200,
                         pts_per_box=200)
        write_kitti_scene(root, idx, pts, shifted, names,
                          split='train' if idx < 3 else 'val')
    create_data_gga.main(['kitti', '--root-path', root, '--workers', '2'])
    with open(os.path.join(root, INFO), 'rb') as f:
        infos = pickle.load(f)
    with open(os.path.join(root, AUG_INFO), 'wb') as f:
        pickle.dump(infos[:1], f)

    opts = {'data_root': root}
    jcfg = JConfig.fromfile(TINY).merge_from_options(opts)
    model, jmc = jbuild(jcfg)
    pts = np.zeros((1, 128, 4), np.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), pts, pts[..., 0] > 0, train=False))
    variables = _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                      np.random.RandomState(2))
    state = types.SimpleNamespace(**variables)

    cfg = Config.fromfile(TINY).merge_from_options(opts)
    mc = tools_lib.model_config_from_cfg(cfg)
    trainer = apis.init_trainer(mc, 20, device='cpu')
    trainer.model.load_state_dict(convert.from_jax_variables(variables, mc))
    ckpt_dir = os.path.join(root, 'checkpoints')
    ckpt.save_checkpoint(ckpt_dir, trainer)
    return dict(root=root, infos=infos, ckpt=ckpt_dir, cfg=cfg,
                jax=(model, jmc, state, jcfg))


def _cli(stage3, *args):
    return test_cli.main([TINY, '--checkpoint', stage3['ckpt'], '--device',
                          'cpu', *args, '--cfg-options',
                          f'data_root={stage3["root"]}'])


def _assert_same_submission(got_dir, want_dir):
    """The same files with the same rows, each number equal to its printed
    precision beside the forward's tolerance (rtol 1e-4, atol 1e-4 plus
    one unit of the fourth decimal): the two frameworks' f32 sums differ
    in the last bits, which can move a printed last digit. Rows are in
    score order, where near-equal scores may swap, so both are sorted by
    class and location first."""
    names = sorted(os.listdir(got_dir))
    assert names == sorted(os.listdir(want_dir)) and names
    n_rows = 0
    for name in names:
        rows = []
        for d in (got_dir, want_dir):
            with open(os.path.join(d, name)) as f:
                lines = [ln.split() for ln in f.read().splitlines()]
            cls = np.array([ln[0] for ln in lines])
            num = np.array([ln[1:] for ln in lines], np.float64).reshape(
                len(lines), 15)
            order = np.lexsort((num[:, 11], cls))
            rows.append((cls[order], num[order]))
        (cg, ng), (cw, nw) = rows
        np.testing.assert_array_equal(cg, cw, err_msg=name)
        np.testing.assert_allclose(ng, nw, rtol=1e-4, atol=2e-4,
                                   err_msg=name)
        n_rows += len(cg)
    assert n_rows > 0


def test_test_cli_eval_and_submission_equal_gga_tpu(stage3, tmp_path):
    model, jmc, state, jcfg = stage3['jax']
    infos = stage3['infos']
    jdets = jtools.run_inference(model, jmc, state, jcfg, infos, 2)
    jannos = jsub.detections_to_kitti_annos(jdets, infos, CLASSES)
    assert sum(len(a['name']) for a in jannos) > 0
    jsub.write_kitti_submission(jannos, infos, str(tmp_path / 'jax'))
    _, want_ap = jkitti_eval([i['annos'] for i in infos], jannos,
                             list(CLASSES))

    res = _cli(stage3, '--info', INFO, '--batch-size', '2', '--eval',
               '--format-only', '--submission-dir', str(tmp_path / 'port'))
    assert res['scenes'] == 4 and res['submission_dir'] == str(
        tmp_path / 'port')
    assert res['detections'] == sum(len(a['name']) for a in jannos)
    _assert_same_submission(tmp_path / 'port', tmp_path / 'jax')
    assert set(res['ap']) == set(want_ap)
    for k, v in want_ap.items():
        assert abs(res['ap'][k] - v) <= 1e-6, k


def _assert_same_detections(got, want, what):
    """Same detections, in score order up to swaps of near-equal scores."""
    assert len(got['scores_3d']) == len(want['scores_3d']) > 0, what
    og = np.lexsort((got['boxes_3d'][:, 0], got['labels_3d']))
    ow = np.lexsort((want['boxes_3d'][:, 0], want['labels_3d']))
    np.testing.assert_array_equal(got['labels_3d'][og],
                                  want['labels_3d'][ow], err_msg=what)
    for k in ('boxes_3d', 'scores_3d'):
        np.testing.assert_allclose(got[k][og], want[k][ow], rtol=1e-4,
                                   atol=1e-4, err_msg=f'{what} {k}')


@pytest.fixture(scope='module')
def jax_aug(stage3):
    """gga_tpu's aug_inference_detector on the first scene (its jit and
    its eager merge take about half a minute a scene on the CPU)."""
    _, _, _, jcfg = stage3['jax']
    out = []
    for info in stage3['infos'][:1]:
        s = jpl.load_sample(info, jcfg.data_root,
                            pts_prefix=jcfg.data.pts_prefix)
        out.append(japis.aug_inference_detector(stage3['jax'], s['points']))
    return out


def test_aug_inference_detector_matches_gga_tpu(stage3, jax_aug):
    cfg = stage3['cfg']
    bundle, _ = apis.init_model(cfg, stage3['ckpt'], device='cpu')
    for i, info in enumerate(stage3['infos'][:1]):
        s = jpl.load_sample(info, cfg.data_root,
                            pts_prefix=cfg.data.pts_prefix)
        got = apis.aug_inference_detector((bundle, cfg), s['points'])
        _assert_same_detections(got, jax_aug[i], f'scene {i}')


def test_test_cli_aug_test_writes_the_tta_detections(stage3, jax_aug,
                                                     tmp_path):
    infos = stage3['infos'][:1]
    jannos = jsub.detections_to_kitti_annos(jax_aug, infos, CLASSES)
    jsub.write_kitti_submission(jannos, infos, str(tmp_path / 'jax'))
    res = _cli(stage3, '--info', AUG_INFO, '--aug-test', '--format-only',
               '--submission-dir', str(tmp_path / 'port'))
    assert res['scenes'] == 1
    _assert_same_submission(tmp_path / 'port', tmp_path / 'jax')


def test_mono3d_export_equals_gga_tpu(stage3):
    root = stage3['root']
    pkl = os.path.join(root, 'kitti_infos_trainval_GGA_pseudo.pkl')
    generate_pseudo_labels_gga.main([
        TINY, '--checkpoint', stage3['ckpt'], '--device', 'cpu',
        '--batch-size', '2', '--out', pkl, '--cfg-options',
        f'data_root={root}'])
    with open(pkl, 'rb') as f:
        pseudo = pickle.load(f)
    want = jmono.export_mono3d_coco(pseudo, os.path.join(root, 'j.json'))
    got = tmono.export_mono3d_coco(pseudo, os.path.join(root, 't.json'))
    assert got == want and len(got['images']) == 4
    with open(os.path.join(root, 'j.json')) as a, \
            open(os.path.join(root, 't.json')) as b:
        assert a.read() == b.read()

    res = create_data_gga_retrain_mono.main(['kitti', '--root-path', root])
    assert res['test'] is None             # no test split here
    out = res['trainval_pseudo']
    assert out['json'] == pkl.replace('.pkl', '_mono3d.coco.json')
    with open(out['json']) as f:
        coco = json.load(f)
    n_obj = sum(int(np.isin(i['annos']['name'], CLASSES).sum())
                for i in pseudo)
    assert out['images'] == len(coco['images']) == len(pseudo)
    assert out['annotations'] == len(coco['annotations']) == n_obj > 0
