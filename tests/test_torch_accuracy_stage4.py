"""The port's stage-4 accuracy bench
(``gga_tpu_torch/tools/accuracy_bench_stage4.py``) against gga_tpu's
(``tools/accuracy_bench_stage4.py``), on the CPU.

On 8 synthetic scenes (``accuracy_bench.make_synth_kitti``, seed 0; the
scenes themselves are held against gga_tpu's in
``tests/test_torch_accuracy.py``):

- ``stage1_pseudo_infos`` and ``score_pseudo_vs_gt`` equal gga_tpu's;
  ``render_images`` writes gga_tpu's pixels;
- the scenes stacked for training (``stack_dataset``) equal gga_tpu's
  ``stack_dataset_on_device``, and ``normalize_images`` its
  ``normalize_images``, exactly;
- the bench's lr schedule equals gga_tpu's optax schedule within two
  float32 ulps of the lr at every boundary, in both modes;
- the first PGD loss from the same weights (gga_tpu's tiny variables
  through ``convert.from_jax_variables``) and the same batch at rtol 1e-4,
  each of its terms at 1e-3.

The CLIs are run by ``tests/test_torch_accuracy_cli.py``.
"""
import importlib.util
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gga_tpu.data.kitti.mono_dataset import KittiMonoDataset as JMono
from gga_tpu.models.dense_heads import pgd_head as jph
from gga_tpu.models.detectors import pgd as jpgd
from gga_tpu_torch import apis, convert
from gga_tpu_torch.data.kitti import io as kio
from gga_tpu_torch.data.kitti.mono_dataset import KittiMonoDataset
from gga_tpu_torch.data.kitti.png import read_png
from gga_tpu_torch.models.detectors import pgd as tpgd
from gga_tpu_torch.tools import accuracy_bench as tab
from gga_tpu_torch.tools import accuracy_bench_stage4 as tab4
from gga_tpu_torch.train.loop import TrainState
from gga_tpu_torch.train.optim import PGDOptimizer

from .test_data.fixtures import render_scene_image
from .test_torch_accuracy import _assert_same
from .test_torch_pgd import _fill

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_SCENES = 8
spec = importlib.util.spec_from_file_location(
    'gga_tpu_accuracy_bench_stage4', ROOT / 'tools' /
    'accuracy_bench_stage4.py')
jab4 = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jab4)


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    """The root of 8 synthetic scenes, their infos, and the pkl of their
    stage-1 pseudo infos (what the stage-4 bench trains on)."""
    root = tmp_path_factory.mktemp('accuracy')
    infos, _ = tab.make_synth_kitti(str(root), N_SCENES)
    pkl = root / 'kitti_infos_pseudo_mono.pkl'
    with open(pkl, 'wb') as f:
        pickle.dump(tab4.stage1_pseudo_infos(infos), f)
    return root, infos, pkl


def test_stage1_pseudo_infos_match_gga_tpu(scenes):
    _, infos, _ = scenes
    want = jab4.stage1_pseudo_infos(infos)
    got = tab4.stage1_pseudo_infos(infos)
    _assert_same(want, got)
    assert sum(len(i['annos']['name']) for i in got) > N_SCENES
    score = tab4.score_pseudo_vs_gt(got, infos)
    assert score == jab4.score_pseudo_vs_gt(want, infos)
    assert score['AP11_3D_mod_loose'] > 0.0


def test_render_images_match_gga_tpu(scenes):
    root, infos, _ = scenes
    tab4.render_images(str(root), infos[:2])
    for info in infos[:2]:
        idx = info['image']['image_idx']
        pts = kio.load_velodyne(root / f'training/velodyne/{idx:06d}.bin')
        np.testing.assert_array_equal(
            read_png(root / info['image']['image_path']),
            render_scene_image(pts))


@pytest.fixture(scope='module')
def stacks(scenes):
    """(gga_tpu's stacked scenes, the port's) of the stage-1 pseudo pkl."""
    root, _, pkl = scenes
    want = jab4.stack_dataset_on_device(JMono(str(root), str(pkl),
                                              max_objs=16))
    got = tab4.stack_dataset(KittiMonoDataset(str(root), str(pkl),
                                              max_objs=16), 'cpu')
    return {k: np.asarray(v) for k, v in want.items()}, got


def test_stacked_scenes_match_gga_tpu(stacks):
    want, got = stacks
    assert set(got) == set(want)
    for key, v in want.items():
        assert got[key].numpy().dtype == v.dtype, key
        np.testing.assert_array_equal(got[key].numpy(), v, err_msg=key)
    np.testing.assert_array_equal(
        tab4.normalize_images(got['image_u8']).numpy(),
        np.asarray(jax.jit(jab4.normalize_images)(want['image_u8'])))


def _optax_schedule(lr, steps, schedule):
    """gga_tpu's bench schedule (tools/accuracy_bench_stage4.py:328-340)."""
    warmup = min(500, steps // 4)
    if schedule == 'step':
        d1 = max(warmup + 1, int(steps * 32 / 48))
        d2 = max(d1 + 1, int(steps * 44 / 48))
        return optax.join_schedules(
            [optax.linear_schedule(lr / 3, lr, warmup),
             optax.constant_schedule(lr),
             optax.constant_schedule(lr * 0.1),
             optax.constant_schedule(lr * 0.01)],
            [warmup, d1, d2]), (warmup, d1, d2)
    return optax.join_schedules(
        [optax.linear_schedule(lr / 3, lr, warmup),
         optax.constant_schedule(lr)], [warmup]), (warmup,)


@pytest.mark.parametrize('schedule', ['step', 'flat'])
@pytest.mark.parametrize('steps', [3, 6, 40, 3000, 8000])
def test_lr_schedule_matches_gga_tpu(schedule, steps):
    lr = 2e-3
    ref, bounds = _optax_schedule(lr, steps, schedule)
    out = tab4.lr_schedule(lr, steps, schedule)
    checked = sorted({max(s, 0) for b in bounds + (steps,)
                      for s in (b - 1, b, b + 1)} | {0, 1})
    for step in checked:
        np.testing.assert_allclose(out(step), float(ref(jnp.int32(step))),
                                   rtol=0, atol=2 * 2 ** -23 * lr,
                                   err_msg=f'step {step}')


def test_first_pgd_loss_matches_gga_tpu(stacks):
    """The bench's first train step: the first batch of epoch 0
    (``RandomState(1)`` order, B = 2) through gga_tpu's train-mode loss
    (jitted) and the port's ``apis.pgd_train_step``."""
    want, got = stacks
    batch_size = 2
    idx = tab4.epoch_order(N_SCENES, batch_size, 0)[0]
    jcfg = jpgd.PGDModelConfig.tiny()
    model = jpgd.PGDDetector(jcfg)
    img0 = np.zeros((1, *want['image_u8'].shape[1:]), np.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), img0,
                                               train=False))
    variables = _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                      np.random.RandomState(2))
    fsz = [(img0.shape[1] // s, img0.shape[2] // s)
           for s in jcfg.head.strides]
    pts = jph.level_points(jcfg.head, fsz)
    points = jnp.concatenate(pts)
    strides = jnp.concatenate([jnp.full((p.shape[0],), s, jnp.float32)
                               for p, s in zip(pts, jcfg.head.strides)])
    ranges = jnp.concatenate([
        jnp.broadcast_to(jnp.asarray(r, jnp.float32), (p.shape[0], 2))
        for p, r in zip(pts, jcfg.head.regress_ranges)])

    # gga_tpu's train_step loss (tools/accuracy_bench_stage4.py:366-383)
    @jax.jit
    def loss(v, batch):
        images = jab4.normalize_images(batch.pop('image_u8'))
        targets = jax.vmap(lambda b, l, c3, c2, d, m: jph.build_targets(
            jcfg.head, points, strides, ranges, b, l, c3, c2, d, m))(
                batch['gt_bboxes'], batch['gt_labels'], batch['gt_cam3d'],
                batch['centers2d'], batch['depths'], batch['obj_valid'])
        (preds, fuse), _ = model.apply(v, images, train=True,
                                       mutable=['batch_stats'])
        return jph.loss(jcfg.head, preds, fuse, targets, batch['cam2img'],
                        fsz)

    total, jlogs = loss(variables, {k: v[idx] for k, v in want.items()})

    tcfg = tpgd.PGDModelConfig.tiny()
    model_t = apis.init_pgd_detector(
        tcfg, convert.from_jax_variables(variables, tcfg),
        device='cpu').model
    trainer = TrainState(
        model=model_t, optimizer=PGDOptimizer(
            model_t.parameters(), tab4.lr_schedule(2e-3, 10), momentum=0.9,
            weight_decay=1e-4, grad_clip=35.0),
        step=0, generator=torch.Generator())
    t_idx = torch.from_numpy(idx)
    batch = {k: v[t_idx] for k, v in got.items() if k != 'image_u8'}
    batch['image'] = tab4.normalize_images(got['image_u8'][t_idx])
    logs = apis.pgd_train_step(trainer, batch)
    assert float(jlogs['num_pos']) > 0
    assert float(logs['num_pos']) == float(jlogs['num_pos'])
    np.testing.assert_allclose(float(logs['loss']), float(total), rtol=1e-4)
    # each term within 1e-3: drawn weights on images of +-150 give the
    # depth and size terms exp() of large predicted log-sigmas, which turn
    # the packages' f32 noise into relative gaps of up to 8e-4; the terms'
    # sum holds 1e-4
    for key, v in jlogs.items():
        np.testing.assert_allclose(float(logs[key]), float(v), rtol=1e-3,
                                   err_msg=key)
