"""The indoor retrain's host side, decode and CLI against gga_tpu, CPU.

- ``SunRgbdDataset``: items (train-time draws, at fewer and at more
  points than a scene has, and in test mode) and ``epoch_batches``
  exactly equal to gga_tpu's on a mini SUN RGB-D written by
  ``chip_smoke.write_mini_sunrgbd``, and the port's ``EpochLoader`` over
  it equal to gga_tpu's ``epoch_batches``;
- ``indoor_eval``: every AP and mAP within 1e-6 of gga_tpu's on
  synthetic rotated boxes;
- ``decode`` on gga_tpu's eval-mode head outputs, and ``apis.infer_indoor``
  on the clouds, against gga_tpu's forward and decode (tiny config, BN
  statistics of a train-mode pass, so activations stay O(1), as a
  trained model's): the same kept set per class, boxes and scores at
  1e-3 (``jax.lax.top_k`` and the port's stable sort agree on ties, but
  the kept detections are compared as sets, by score);
- the tiny CLI (``train_fcaf3d --tiny --device cpu --max-steps 2``, then
  ``--resume`` to 3): its first logged loss equals gga_tpu's loss on the
  same first batch (gga_tpu's ``SunRgbdDataset`` read as gga_tpu's tool
  reads it) from the CLI's initial weights at rtol 1e-4; each step's lr;
  its checkpoints; and ``infer_indoor`` + ``indoor_eval`` from the last
  one give the AP keys.
"""
import json
import os
import pickle
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gga_tpu.data import sunrgbd as jsun
from gga_tpu.eval import indoor_eval as jeval
from gga_tpu.models.dense_heads import fcaf3d_head as jfh
from gga_tpu.models.detectors import fcaf3d as jdet
from gga_tpu_torch import apis, convert
from gga_tpu_torch.data import sunrgbd as tsun
from gga_tpu_torch.data.dataset import EpochLoader
from gga_tpu_torch.eval import indoor_eval as teval
from gga_tpu_torch.models.dense_heads import fcaf3d_head as tfh
from gga_tpu_torch.models.detectors import fcaf3d as tdet
from gga_tpu_torch.tools import train_fcaf3d
from gga_tpu_torch.train import checkpoints as ckpt
from tests.test_torch_fcaf3d import (B, clouds, fill_variables,
                                     to_jax_variables)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('sunrgbd'))
    return root, chip_smoke.write_mini_sunrgbd(root, n_scenes=6,
                                               n_points=3000)


def _equal_items(a, b):
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize('num_points,test_mode', [(2048, False),
                                                  (4000, False),
                                                  (2048, True)])
def test_dataset_items_and_batches_equal_gga_tpu(mini, num_points,
                                                 test_mode):
    root, pkl = mini
    kw = dict(num_points=num_points, max_objs=8, test_mode=test_mode,
              seed=3)
    ds, ref = tsun.SunRgbdDataset(root, pkl, **kw), jsun.SunRgbdDataset(
        root, pkl, **kw)
    for i in (0, 3, 3, 5):
        _equal_items(ds[i], ref[i])
    for a, b in zip(ds.epoch_batches(2, seed=1),
                    ref.epoch_batches(2, seed=1)):
        _equal_items(a, b)


def test_epoch_loader_equals_epoch_batches(mini):
    root, pkl = mini
    ds, ref = tsun.SunRgbdDataset(root, pkl), jsun.SunRgbdDataset(root, pkl)
    loader = EpochLoader(ds, 4)
    for epoch in (0, 1):
        got = list(loader.epoch(epoch))
        want = list(ref.epoch_batches(4, seed=epoch))
        assert len(got) == len(want) == 1
        for a, b in zip(got, want):
            _equal_items(a, b)


def test_indoor_eval_equals_gga_tpu():
    rng = np.random.RandomState(4)
    gts, dts = [], []
    for n in (5, 0, 7):
        boxes = np.concatenate([rng.uniform(-4, 4, (n, 2)),
                                rng.uniform(-1, 1, (n, 1)),
                                rng.uniform(0.4, 2, (n, 3)),
                                rng.uniform(-3, 3, (n, 1))], 1)
        labels = rng.randint(0, 4, n)
        gts.append(dict(gt_boxes=boxes, labels=labels))
        noisy = boxes + rng.randn(n, 7) * [0.1, 0.1, 0.05, 0.1, 0.1, 0.05,
                                           0.1]
        extra = np.concatenate([rng.uniform(-4, 4, (3, 2)),
                                rng.uniform(-1, 1, (3, 1)),
                                rng.uniform(0.4, 2, (3, 3)),
                                rng.uniform(-3, 3, (3, 1))], 1)
        dts.append(dict(boxes=np.concatenate([noisy, extra]),
                        labels=np.concatenate([labels,
                                               rng.randint(0, 4, 3)]),
                        scores=rng.rand(n + 3)))
    classes = ('bed', 'table', 'sofa', 'chair', 'toilet')
    text, ret = teval.indoor_eval(gts, dts, classes=classes)
    rtext, rret = jeval.indoor_eval(gts, dts, classes=classes)
    assert set(ret) == set(rret) and 'mAP_0.25' in ret
    assert rret['mAP_0.25'] > 10
    for k, v in rret.items():
        assert abs(ret[k] - v) <= 1e-6, k
    assert text == rtext


@pytest.fixture(scope='module')
def eval_setup():
    """gga_tpu's tiny model with drawn weights and BN statistics of the
    port's train-mode pass from zero (its update over 0.01), and gga_tpu's
    eval-mode head outputs and decode."""
    cfg = jdet.FCAF3DModelConfig.tiny()
    tcfg = tdet.FCAF3DModelConfig.tiny()
    model = jdet.FCAF3DDetector(cfg)
    inputs = clouds()
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), *inputs, train=False))
    drawn = fill_variables(shapes)
    zero = dict(drawn, batch_stats=jax.tree_util.tree_map(
        np.zeros_like, drawn['batch_stats']))
    det = apis.init_fcaf3d_detector(
        tcfg, convert.from_jax_variables(zero, tcfg), device='cpu').model
    with torch.no_grad():
        det.train()(*map(torch.from_numpy, inputs))
    stats = to_jax_variables(
        {k: v / 0.01 if k.endswith(('running_mean', 'running_var')) else v
         for k, v in det.state_dict().items()}, tcfg)['batch_stats']
    variables = dict(drawn, batch_stats=stats)
    outs, dets = jax.jit(lambda v, *x: (lambda o: (o, jfh.decode(
        cfg.head, o)))(model.apply(v, *x, train=False)))(variables, *inputs)
    return (cfg, tcfg, variables, inputs, outs,
            {k: np.asarray(v) for k, v in dets.items()})


def _kept(d, b, c):
    sel = d['valid'][b] & (d['labels'][b] == c)
    order = np.argsort(-d['scores'][b][sel], kind='stable')
    return {k: d[k][b][sel][order] for k in ('scores', 'boxes')}


@pytest.mark.parametrize('path', ['decode', 'infer_indoor'])
def test_decode_matches_gga_tpu(eval_setup, path):
    cfg, tcfg, variables, inputs, jouts, ref = eval_setup
    if path == 'decode':
        out = tfh.decode(tcfg.head, [{k: torch.from_numpy(np.array(v))
                                      for k, v in o.items()} for o in jouts])
    else:
        bundle = apis.init_fcaf3d_detector(
            tcfg, convert.from_jax_variables(variables, tcfg), device='cpu')
        out = apis.infer_indoor(bundle, *inputs)
    out = {k: v.numpy() for k, v in out.items()}
    assert out['boxes'].shape == ref['boxes'].shape
    n_kept = 0
    for b in range(B):
        for c in range(cfg.head.n_classes):
            r, o = _kept(ref, b, c), _kept(out, b, c)
            assert len(o['scores']) == len(r['scores']), (b, c)
            n_kept += len(r['scores'])
            for k in r:
                np.testing.assert_allclose(o[k], r[k], rtol=1e-3, atol=1e-3,
                                           err_msg=f'{b} {c} {k}')
    assert n_kept > 4


def test_tiny_cli_first_loss_equals_gga_tpu(mini, tmp_path):
    root, pkl = mini
    work = str(tmp_path / 'work')
    argv = [str(ROOT / 'configs' / 'gga' / 'gga_sunrgbd.py'), '--tiny',
            '--device', 'cpu', '--info', pkl, '--data-root', root,
            '--work-dir', work, '--num-points', '512', '--batch-size', '2',
            '--cfg-options', 'log_interval=1']
    first = train_fcaf3d.main(argv + ['--max-steps', '2'])
    resumed = train_fcaf3d.main(argv + ['--max-steps', '3', '--resume'])
    assert (first['start_step'], first['end_step']) == (0, 2)
    assert (resumed['start_step'], resumed['end_step']) == (2, 3)
    assert first['steps_per_epoch'] == 6 * 3 // 2
    with open(os.path.join(work, 'train_log.jsonl')) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln['step'] for ln in lines] == [1, 2, 3]
    for ln in lines:
        assert np.isfinite(ln['loss']) and ln['lr'] == 1e-3
    ckpt_dir = os.path.join(work, 'checkpoints')
    assert ckpt.latest_step(ckpt_dir) == 3

    # gga_tpu's loss on gga_tpu's first batch, from the CLI's weights
    cfg = jdet.FCAF3DModelConfig.tiny()
    tcfg = tdet.FCAF3DModelConfig.tiny()
    init = apis.init_fcaf3d_detector(tcfg, device='cpu').model.state_dict()
    variables = to_jax_variables(init, tcfg)
    ref_ds = jsun.SunRgbdDataset(root, pkl, num_points=512,
                                 max_objs=cfg.head.max_objs)
    ref_ds[0]                       # gga_tpu's tool inits on this item
    batch = next(ref_ds.epoch_batches(2, seed=0))
    model = jdet.FCAF3DDetector(cfg)

    def loss(v, b):
        outs, _ = model.apply(v, b['points'], b['colors'],
                              b['points_valid'], train=True,
                              mutable=['batch_stats'])
        return jfh.loss(cfg.head, outs, b['gt_boxes'], b['gt_labels'],
                        b['obj_valid'])[1]

    ref = jax.jit(loss)(variables, batch)
    assert float(ref['num_pos']) > 0
    np.testing.assert_allclose(lines[0]['loss'], float(ref['loss']),
                               rtol=1e-4)
    np.testing.assert_allclose(lines[0]['num_pos'], float(ref['num_pos']))

    # inference and the indoor eval from the newest checkpoint
    bundle = apis.init_fcaf3d_detector(tcfg, ckpt.load_variables(ckpt_dir),
                                       device='cpu')
    ds = tsun.SunRgbdDataset(root, pkl, num_points=512, max_objs=8,
                             test_mode=True)
    items = [ds[i] for i in range(2)]
    b = {k: np.stack([it[k] for it in items]) for k in items[0]}
    dets = apis.infer_indoor(bundle, b['points'], b['colors'],
                             b['points_valid'])
    dt = [dict(boxes=dets['boxes'][i][dets['valid'][i]].numpy(),
               labels=dets['labels'][i][dets['valid'][i]].numpy(),
               scores=dets['scores'][i][dets['valid'][i]].numpy())
          for i in range(2)]
    gt = [dict(gt_boxes=it['gt_boxes'][it['obj_valid']],
               labels=it['gt_labels'][it['obj_valid']]) for it in items]
    _, ret = teval.indoor_eval(gt, dt, classes=tsun.CLASSES)
    assert {'mAP_0.25', 'mAP_0.50'} <= set(ret)
