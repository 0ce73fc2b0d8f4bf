"""The port's accuracy bench (``gga_tpu_torch/tools/accuracy_bench.py``)
against gga_tpu's (``tools/accuracy_bench.py``), on the CPU.

- ``make_synth_kitti``: the same 16 scenes from seed 0 in both packages,
  bit for bit: velodyne and reduced clouds, calib and label text, every
  info field (the ``GGA_*`` weak-label fields too), and the images pixel
  for pixel (the port's ``read_png`` of its own file, and Pillow's decode
  of it, against Pillow's decode of gga_tpu's).
- ``score_stage1_labels``: the same AP dict on the first 8 scenes and on
  all 16, which is also the value ``chip_smoke.py``'s accuracy phase
  gates on (``ACC_STAGE1_AP``; numpy only, so exact).
- ``evaluate_pseudo`` with gga_tpu's tiny weights carried over by
  ``convert.from_jax_variables``: the det annos and the matched pseudo
  infos equal as sets of boxes (names exact, floats within 1e-4), and the
  same AP dict.
- The first 3 weak-train losses from the same weights and batches
  (``--cfg tiny`` with the small config's class priors, all four loss
  flags, ``--flat-lr``, gga_tpu's SRL draws passed in) at rtol 1e-4.
- ``GGAModelConfig.small()`` equals gga_tpu's field by field.
"""
import dataclasses
import functools
import importlib.util
import pickle
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gga_tpu.models.detectors import centerpoint_gga as jdet
from gga_tpu.train.loop import create_train_state, gga_train_step as jstep
from gga_tpu.train.optim import build_optimizer
from gga_tpu_torch import apis, convert
from gga_tpu_torch.data.kitti.png import read_png
from gga_tpu_torch.models.detectors import centerpoint_gga as tdet
from gga_tpu_torch.tools import accuracy_bench as tab
from gga_tpu_torch.train.loop import gga_train_step

from .test_torch_detector import _fill

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_SCENES = 16
K_DET = 6       # detections a task of the evaluate_pseudo case
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f'gga_tpu_{name}', ROOT / 'tools' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jab = _load_tool('accuracy_bench')


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    """(gga_tpu's root and infos, the port's root and infos) of the same
    N_SCENES scenes."""
    out = []
    for mod, name in ((jab, 'gga_tpu'), (tab, 'port')):
        root = tmp_path_factory.mktemp(name)
        infos, _ = mod.make_synth_kitti(str(root), N_SCENES)
        out += [root, infos]
    return out


def _assert_same(a, b, path='info'):
    """Equal nested dicts / lists of numpy arrays and scalars, dtypes
    included."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f'{path}.{k}')
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f'{path}[{i}]')
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_scenes_and_infos_match_gga_tpu(scenes):
    jroot, jinfos, troot, tinfos = scenes
    _assert_same(jinfos, tinfos)
    assert any(len(i['annos']['GGA_init_pseudo_label']) for i in tinfos)
    for name in ('kitti_infos_train_GGA.pkl', 'ImageSets/train.txt'):
        assert (jroot / name).read_bytes() == (troot / name).read_bytes()
    for idx in range(N_SCENES):
        for sub in ('velodyne', 'velodyne_reduced', 'calib', 'label_2'):
            ext = 'bin' if sub.startswith('velodyne') else 'txt'
            rel = f'training/{sub}/{idx:06d}.{ext}'
            assert (jroot / rel).read_bytes() == (troot / rel).read_bytes(), \
                rel
        rel = f'training/image_2/{idx:06d}.png'
        want = np.asarray(Image.open(jroot / rel).convert('RGB'))
        np.testing.assert_array_equal(read_png(troot / rel), want,
                                      err_msg=rel)
        port = Image.open(troot / rel)        # a PNG any reader takes
        assert port.mode == 'RGB'
        np.testing.assert_array_equal(np.asarray(port), want, err_msg=rel)


@pytest.mark.parametrize('n', [8, N_SCENES])
def test_stage1_ap_matches_gga_tpu(scenes, n):
    _, jinfos, _, tinfos = scenes
    want = jab.score_stage1_labels(jinfos[:n])
    got = tab.score_stage1_labels(tinfos[:n])
    assert got == want
    assert 0.0 < got['AP11_3D_mod'] <= 100.0
    if n == chip_smoke.ACC_SCENES:
        assert got == chip_smoke.ACC_STAGE1_AP


def _variables(model, cfg, seed):
    pts = np.zeros((1, tab.MAX_POINTS, 4), np.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), pts, np.ones((1, tab.MAX_POINTS), bool),
        train=False))
    return _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                 np.random.RandomState(seed))


def _capture(monkeypatch, module, name, into):
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        into.append(out)
        return out
    monkeypatch.setattr(module, name, wrapper)


def _close(a, b, path):
    """Equal names, floats within 1e-4. The objects of an anno dict (its
    arrays of one length per box) are compared as sets: a box is matched
    to the nearest box of the other package by location, size and yaw
    (decode ranks by logits, and near-equal logits may swap)."""
    if isinstance(a, dict) and 'location' in a and 'name' in a:
        n = len(a['name'])
        assert len(b['name']) == n, path
        feat = [np.concatenate([np.asarray(x['location'], np.float64),
                                np.asarray(x['dimensions'], np.float64),
                                np.asarray(x['rotation_y'],
                                           np.float64)[:, None]], 1)
                for x in (a, b)]
        dist = np.abs(feat[1][:, None] - feat[0][None]).sum(-1)
        perm = dist.argmin(1) if n else np.zeros(0, np.int64)
        assert sorted(perm) == list(range(n)), path
        assert set(a) == set(b), path
        for k in a:
            x = a[k]
            if isinstance(x, np.ndarray) and x.ndim and len(x) == n:
                x = x[perm]
            _close(x, b[k], f'{path}.{k}')
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f'{path}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f'{path}[{i}]')
    else:
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind in 'fc':
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(b, a, err_msg=path)


def test_evaluate_pseudo_matches_gga_tpu(scenes, tmp_path, monkeypatch):
    """gga_tpu's ``evaluate_pseudo`` (its jitted infer) and the port's on
    the same 8 scenes and weights: the det annos (scores are the heatmap
    logits), the matched pseudo infos of both dumps and the AP dict.

    Drawn weights give every empty BEV cell the same logit, so the decode
    keeps the top K_DET per task (tiny keeps 16), which these weights and
    scenes hold apart by more than the packages' f32 noise: a tie at the
    top-k's edge would let each package keep another cell."""
    from gga_tpu.data.dataset import KittiGGADataset
    from gga_tpu.eval import submission as jsub
    _, _, troot, tinfos = scenes
    infos = tinfos[:8]
    info_path = tmp_path / 'infos.pkl'
    with open(info_path, 'wb') as f:
        pickle.dump(infos, f)
    jcfg = dataclasses.replace(jdet.GGAModelConfig.tiny(),
                               max_per_task=K_DET, post_max_size=K_DET)
    model = jdet.GGADetector(jcfg)
    variables = _variables(model, jcfg, seed=3)
    kw = dict(max_points=tab.MAX_POINTS, max_objs=jcfg.head.max_objs,
              max_cluster_pts=128, pc_range=jcfg.point_cloud_range,
              test_mode=True)
    jds = KittiGGADataset(str(troot), str(info_path), **kw)
    jdets, tdets = [], []
    _capture(monkeypatch, jsub, 'detections_to_kitti_annos', jdets)
    _capture(monkeypatch, tab, 'detections_to_kitti_annos', tdets)
    state = type('State', (), dict(params=variables['params'],
                                   batch_stats=variables['batch_stats']))
    want = jab.evaluate_pseudo(model, jcfg, state, jds, infos,
                               dump_path=str(tmp_path / 'j.pkl'))

    tcfg = dataclasses.replace(tdet.GGAModelConfig.tiny(),
                               max_per_task=K_DET, post_max_size=K_DET)
    bundle = apis.init_detector(tcfg, convert.from_jax_variables(
        variables, tcfg), device='cpu')
    _, tds = tab.datasets(str(troot), str(info_path), tcfg)
    got = tab.evaluate_pseudo(bundle, tds, infos,
                              dump_path=str(tmp_path / 't.pkl'))
    assert got == want
    # the precondition: the K_DET + 1 largest logits of each task and
    # scene are apart
    pts = np.zeros((len(infos), tab.MAX_POINTS, 4), np.float32)
    val = np.zeros(pts.shape[:2], bool)
    for j in range(len(infos)):
        p = tds.get_sample(j)['points'][:tab.MAX_POINTS]
        pts[j, :len(p)], val[j, :len(p)] = p[:, :4], True
    with torch.no_grad():
        preds = bundle.model(torch.from_numpy(pts), torch.from_numpy(val))
    for tp in preds:
        top = torch.topk(tp['heatmap'].flatten(1), K_DET + 1).values
        assert (top[:, :-1] - top[:, 1:]).min() > 1e-5
    assert sum(len(a['name']) for a in tdets[0]) > 0
    _close(jdets, tdets, 'det_annos')
    with open(tmp_path / 'j.pkl', 'rb') as f:
        jpseudo = pickle.load(f)
    with open(tmp_path / 't.pkl', 'rb') as f:
        tpseudo = pickle.load(f)
    _close(jpseudo, tpseudo, 'pseudo_infos')


def test_weak_train_losses_match_gga_tpu(scenes):
    """Three weak-train steps of the bench's loop in both packages: the
    same batches (``RandomState(epoch + 1)`` order), the tiny config with
    the small config's class priors and every loss flag, flat AdamW, and
    gga_tpu's SRL draw of each step (``fold_in(PRNGKey(1), step)``)."""
    from gga_tpu.data.dataset import KittiGGADataset
    jroot, _, troot, _ = scenes
    flags = dict(pal=True, dim_prior=3.0, yaw_prior=1.0, containment=1.0)
    priors = jdet.GGAModelConfig.small().task_dim_priors
    tcfg = tab.bench_config(dataclasses.replace(
        tdet.GGAModelConfig.tiny(), task_dim_priors=priors), **flags)
    # gga_tpu's main, :281-306
    jcfg = dataclasses.replace(jdet.GGAModelConfig.tiny(),
                               task_dim_priors=priors)
    jcfg = dataclasses.replace(jcfg, head=dataclasses.replace(
        jcfg.head, pal_in_total_loss=True,
        task_dim_priors=jcfg.task_dim_priors, loss_dim_prior_weight=3.0,
        loss_yaw_prior_weight=1.0, loss_containment_weight=1.0))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)

    steps, batch_size, lr = 3, 2, 2e-4
    model = jdet.GGADetector(jcfg)
    variables = _variables(model, jcfg, seed=5)
    state = create_train_state(model, variables, build_optimizer(
        total_steps=steps, lr=lr, cyclic=False))
    step_fn = jax.jit(functools.partial(jstep, head_cfg=jcfg.head))
    info = 'kitti_infos_train_GGA.pkl'
    jds = KittiGGADataset(str(jroot), str(jroot / info), max_points=8192,
                          max_objs=jcfg.head.max_objs, max_cluster_pts=128,
                          pc_range=jcfg.point_cloud_range)
    jbatches = jds.epoch_batches(batch_size, shuffle=True, seed=1)

    trainer = apis.init_trainer(
        tcfg, steps, convert.from_jax_variables(variables, tcfg),
        device='cpu', optimizer=dict(lr=lr, cyclic=False))
    tds, _ = tab.datasets(str(troot), str(troot / info), tcfg)
    tbatches = tab.weak_batches(tds, batch_size)
    rng = jax.random.PRNGKey(1)
    n_tasks = len(jcfg.head.task_num_classes)
    for step in range(steps):
        jb = next(jbatches)
        epoch, tb = next(tbatches)
        assert epoch == 0
        for k in ('points', 'points_valid', 'init_pseudo', 'ibp_xy'):
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        jb.pop('gt_boxes')
        jb.pop('sample_idx')
        state, jlogs = step_fn(state, jb, rng)
        keys = jax.random.split(jax.random.fold_in(rng, step), n_tasks)
        draw = np.stack([np.asarray(jax.random.normal(k, (batch_size,)))
                         for k in keys])
        b = {k: torch.as_tensor(tb[k], dtype=dt)
             for k, dt in apis._BATCH_DTYPES.items()}
        logs = gga_train_step(trainer, b, tcfg.head,
                              srl_normal=torch.from_numpy(draw))
        for key in ('loss', 'task2.loss_heatmap', 'task2.loss_dim_prior',
                    'task2.loss_yaw_prior', 'task2.loss_containment',
                    'task2.distancemin', 'grad_norm'):
            np.testing.assert_allclose(float(logs[key]), float(jlogs[key]),
                                       rtol=1e-4, err_msg=f'{key} step {step}')
    assert trainer.optimizer.count == steps


def test_small_config_matches_gga_tpu():
    want = dataclasses.asdict(jdet.GGAModelConfig.small())
    got = dataclasses.asdict(tdet.GGAModelConfig.small())
    assert set(got) == set(want)
    for key, v in want.items():
        assert got[key] == v, key
