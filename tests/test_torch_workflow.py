"""Stages 1-3 of the GGA workflow through the port's command-line tools,
in-process on the CPU at ``configs/gga/gga_kitti_tiny.py`` on a synthetic
mini-KITTI (3 train + 1 val scenes, the sizes of
tests/test_train/test_end_to_end.py); the checkpoints' two load semantics
and ``max_to_keep``; and stage 3's annos against gga_tpu's
``run_inference`` + ``detections_to_kitti_annos`` with the same weights
(boxes within rtol 1e-4 + atol 1e-4, the forward's tolerance in
tests/test_torch_detector.py).
"""
import json
import math
import os
import pickle
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gga_tpu import tools_lib as jtools
from gga_tpu.config import Config as JConfig
from gga_tpu.eval import submission as jsub
from gga_tpu.models.builder import build_detector as jbuild
from gga_tpu_torch import apis, convert, tools_lib
from gga_tpu_torch.config import Config
from gga_tpu_torch.eval import submission as tsub
from gga_tpu_torch.tools import create_data_gga, generate_pseudo_labels_gga
from gga_tpu_torch.tools import train as train_cli
from gga_tpu_torch.train import checkpoints as ckpt
from gga_tpu_torch.train.optim import cyclic_cos_schedule

from .test_data.fixtures import make_scene, write_kitti_scene
from .test_torch_detector import _fill
from .test_torch_gga_head import _batch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = str(ROOT / 'configs' / 'gga' / 'gga_kitti_tiny.py')
CLASSES = ('Pedestrian', 'Cyclist', 'Car')


@pytest.fixture(scope='module')
def workflow(tmp_path_factory):
    """Stage 1, train 4 steps, resume to 6, stage 3 with --eval."""
    root = str(tmp_path_factory.mktemp('kitti_cli'))
    rng = np.random.RandomState(0)
    boxes = np.array([[12.0, 2.0, -1.7, 3.9, 1.6, 1.55, 0.3],
                      [20.0, -4.0, -1.7, 0.8, 0.6, 1.75, -0.2],
                      [28.0, 6.0, -1.7, 1.76, 0.6, 1.73, 1.0]])
    names = ['Car', 'Pedestrian', 'Cyclist']
    for idx in range(4):
        pts = make_scene(rng, boxes + [0, idx, 0, 0, 0, 0, 0], names,
                         n_ground=2000, n_clutter=200, pts_per_box=200)
        write_kitti_scene(root, idx, pts, boxes + [0, idx, 0, 0, 0, 0, 0],
                          names, split='train' if idx < 3 else 'val')
    prep = create_data_gga.main(['kitti', '--root-path', root,
                                 '--workers', '2'])
    work = os.path.join(root, 'work')
    opts = ['--cfg-options', f'data_root={root}', 'loader_workers=0',
            'eval_interval=1']
    first = train_cli.main([TINY, '--work-dir', work, '--device', 'cpu',
                            '--max-steps', '4', *opts])
    resumed = train_cli.main([TINY, '--work-dir', work, '--device', 'cpu',
                              '--max-steps', '6', '--resume', *opts])
    out = os.path.join(root, 'pseudo', 'pseudo.pkl')
    stage3 = generate_pseudo_labels_gga.main([
        TINY, '--checkpoint', os.path.join(work, 'checkpoints'), '--eval',
        '--device', 'cpu', '--out', out, '--cfg-options',
        f'data_root={root}'])
    return dict(root=root, work=work, prep=prep, first=first,
                resumed=resumed, stage3=stage3)


def test_stage1_writes_infos_clouds_and_database(workflow):
    root, prep = workflow['root'], workflow['prep']
    assert prep['scenes'] == dict(train=3, val=1)
    assert prep['region_grow'] in ('native', 'numpy')
    for name in ('train', 'val', 'trainval'):
        with open(os.path.join(root, f'kitti_infos_{name}_GGA.pkl'),
                  'rb') as f:
            infos = pickle.load(f)
        assert len(infos) == dict(train=3, val=1, trainval=4)[name]
        assert 'GGA_init_pseudo_label' in infos[0]['annos']
    assert len(os.listdir(os.path.join(
        root, 'training', 'velodyne_reduced'))) == 4
    with open(os.path.join(root, 'kitti_dbinfos_train_GGA.pkl'), 'rb') as f:
        db = pickle.load(f)
    assert set(db) <= set(CLASSES) and sum(map(len, db.values())) >= 3


def test_stage2_trains_logs_checkpoints_and_resumes(workflow):
    work, first, resumed = (workflow['work'], workflow['first'],
                            workflow['resumed'])
    assert os.path.isfile(os.path.join(work, 'config_dump.py'))
    assert (first['start_step'], first['end_step']) == (0, 4)
    assert (resumed['start_step'], resumed['end_step']) == (4, 6)
    with open(os.path.join(work, 'train_log.jsonl')) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln['step'] for ln in lines] == [1, 2, 3, 4, 5, 6]
    assert all(math.isfinite(ln['loss']) for ln in lines)
    assert all(math.isfinite(ln['grad_norm']) for ln in lines)
    # 4 train+val scenes, batch 1: 4 steps an epoch; step s runs at the
    # schedule's value for optimizer count s - 1 of its run's total
    cfg = Config.fromfile(TINY)
    for ln in lines:
        total = 4 if ln['step'] <= 4 else 6
        sched = cyclic_cos_schedule(
            cfg.optimizer.lr, cfg.optimizer.lr_target_ratio,
            cfg.optimizer.step_ratio_up, total)
        assert ln['lr'] == pytest.approx(sched(ln['step'] - 1), rel=1e-12)
        assert ln['epoch'] == (ln['step'] - 1) // 4
    assert ckpt.latest_step(os.path.join(work, 'checkpoints')) == 6
    assert resumed['ckpt_load_ms'] > 0 and first['ckpt_bytes'] > 0
    assert 0 <= first['loader_wait_share'] < 1


def test_stage3_writes_the_pseudo_pkl(workflow):
    s3 = workflow['stage3']
    assert s3['infos'] == 4
    with open(s3['out'], 'rb') as f:
        pseudo = pickle.load(f)
    assert len(pseudo) == 4
    assert all('GGA_init_pseudo_label' in i['annos'] for i in pseudo)
    assert 'KITTI/Car_3D_AP11_moderate_strict' in s3['ap']


def test_clis_need_a_card_or_the_cpu(workflow, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_cli.main([TINY, '--work-dir', str(tmp_path)])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        generate_pseudo_labels_gga.main([
            TINY, '--checkpoint', os.path.join(workflow['work'],
                                               'checkpoints')])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tools_lib.build_model_from_cfg(Config.fromfile(TINY), None, 'cuda')
    # the shipped f32 configs and bf16 models run on CUDA as they are; a
    # dtype the sparse-conv kernels do not take fails at model build
    mc = tools_lib.model_config_from_cfg(Config.fromfile(TINY))
    assert mc.compute_dtype == 'float32'
    apis.check_compute_dtype(mc, 'cuda')
    apis.check_compute_dtype(mc, 'cpu')
    for dtype in ('bfloat16', 'float16'):
        cfg = Config.fromfile(TINY).merge_from_options(
            {'model.compute_dtype': dtype})
        mc = tools_lib.model_config_from_cfg(cfg)
        if dtype == 'bfloat16':
            apis.check_compute_dtype(mc, 'cuda')
        else:
            with pytest.raises(ValueError, match='float32 or bfloat16'):
                apis.check_compute_dtype(mc, 'cuda')


@pytest.mark.parametrize('flag', ['--rank', '--world'])
def test_stage3_cli_takes_no_rank_or_world(workflow, flag, capsys):
    """Sharded stage 3 is not ported: the flags are refused, not ignored."""
    with pytest.raises(SystemExit):
        generate_pseudo_labels_gga.main([
            TINY, '--checkpoint', os.path.join(workflow['work'],
                                               'checkpoints'),
            '--device', 'cpu', flag, '1'])
    assert 'unrecognized arguments' in capsys.readouterr().err


def _trainer(seed=0):
    mc = tools_lib.model_config_from_cfg(Config.fromfile(TINY))
    return apis.init_trainer(mc, 20, device='cpu', seed=seed)


def _step_batch(seed):
    pts = np.random.RandomState(seed).uniform(
        [0, -40, -3, 0], [70, 40, 1, 1], (2, 1024, 4)).astype(np.float32)
    return dict(_batch(seed=seed, edge_cases=False), points=pts,
                points_valid=np.ones((2, 1024), bool))


def test_checkpoint_resume_load_from_and_max_to_keep(tmp_path):
    d = str(tmp_path / 'ckpt')
    batches = [_step_batch(s) for s in range(3)]
    run = _trainer()
    for b in batches[:2]:
        apis.train_step(run, b)
    ckpt.save_checkpoint(d, run)
    assert ckpt.latest_step(d) == 2 and os.listdir(d) == ['step_2.pt']
    want = float(apis.train_step(run, batches[2])['loss'])

    resumed = _trainer(seed=5)
    _, ok = ckpt.resume_from(d, resumed)
    assert ok and resumed.step == 2 and resumed.optimizer.count == 2
    saved = torch.load(os.path.join(d, 'step_2.pt'), weights_only=True)
    a = resumed.optimizer.adamw.state_dict()['state']
    b = saved['optimizer']['adamw']['state']
    assert set(a) == set(b) and len(a) > 10
    for i in a:
        for k in a[i]:
            assert torch.equal(a[i][k], b[i][k]), (i, k)
    # the next step, SRL draw included, is the uninterrupted run's
    assert float(apis.train_step(resumed, batches[2])['loss']) == want

    loaded = _trainer(seed=5)
    _, ok = ckpt.load_from(d, loaded)
    assert ok and loaded.step == 0 and loaded.optimizer.count == 0
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v, saved['model'][k]), k
    assert not loaded.optimizer.adamw.state
    assert ckpt.load_from(str(tmp_path / 'none'), loaded) == (loaded, False)
    with pytest.raises(FileNotFoundError):
        ckpt.load_variables(str(tmp_path / 'none'))

    for s in range(3, 10):
        ckpt.save_checkpoint(d, run, step=s, max_to_keep=5)
    assert sorted(os.listdir(d)) == sorted(f'step_{s}.pt'
                                           for s in range(5, 10))
    assert ckpt.latest_step(d) == 9
    sd = ckpt.load_variables(d, step=7)
    assert set(sd) == set(run.model.state_dict())


def test_stage3_annos_match_gga_tpu(workflow):
    """gga_tpu's tiny detector with numpy-drawn weights, the same weights
    in the port (``convert.from_jax_variables``); the port's run through
    the stage-3 CLI from a checkpoint of them."""
    root = workflow['root']
    opts = {'data_root': root}
    jcfg = JConfig.fromfile(TINY).merge_from_options(opts)
    model, jmc = jbuild(jcfg)
    pts = np.zeros((1, 128, 4), np.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), pts, pts[..., 0] > 0, train=False))
    variables = _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                      np.random.RandomState(2))
    with open(os.path.join(root, 'kitti_infos_trainval_GGA.pkl'), 'rb') as f:
        infos = pickle.load(f)
    state = types.SimpleNamespace(**variables)
    jdets = jtools.run_inference(model, jmc, state, jcfg, infos, 2)
    want = jsub.detections_to_kitti_annos(jdets, infos, CLASSES)

    cfg = Config.fromfile(TINY).merge_from_options(opts)
    trainer = _trainer()
    trainer.model.load_state_dict(convert.from_jax_variables(
        variables, tools_lib.model_config_from_cfg(cfg)))
    d = os.path.join(root, 'jax_weights')
    ckpt.save_checkpoint(d, trainer)
    bundle, _ = apis.init_model(cfg, d, device='cpu')
    dets = apis.single_device_test((bundle, cfg), infos, batch_size=2)
    got = tsub.detections_to_kitti_annos(dets, infos, CLASSES)
    assert sum(len(a['name']) for a in want) > 0
    res = generate_pseudo_labels_gga.main([
        TINY, '--checkpoint', d, '--device', 'cpu', '--batch-size', '2',
        '--out', os.path.join(root, 'pseudo', 'from_jax.pkl'),
        '--cfg-options', f'data_root={root}'])
    with open(res['out'], 'rb') as f:
        cli = pickle.load(f)
    for i, (a, b) in enumerate(zip(got, want)):
        assert len(a['name']) == len(b['name']), i
        # same detections; rows in score order, near-equal scores may swap
        oa = np.lexsort((a['location'][:, 0], a['name']))
        ob = np.lexsort((b['location'][:, 0], b['name']))
        np.testing.assert_array_equal(a['name'][oa], b['name'][ob])
        for k in ('location', 'dimensions', 'rotation_y', 'score', 'bbox',
                  'alpha'):
            np.testing.assert_allclose(a[k][oa], b[k][ob], rtol=1e-4,
                                       atol=1e-4 if k != 'bbox' else 1e-2,
                                       err_msg=f'scene {i} {k}')
        assert len(cli[i]['annos']['name']) <= len(a['name'])
