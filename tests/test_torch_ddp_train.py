"""The port's data-parallel train steps, sharded stage 3 and dry run at
two ``gloo`` ranks on the CPU.

Two spawned ranks of one group (a FileStore under the test's tmp dir)
each take their rows of the same global batch, from the same weights:

(a) The GGA weak step, ``GGAModelConfig.tiny()``, B = 4 global (2 a
    rank), P = 512 points, gga_tpu's 1-vs-N batch
    (``__graft_entry__``'s inputs, copied into ``gga_tpu_torch.entry``)
    and gga_tpu's SRL draw of ``PRNGKey(7)``, each rank its columns:
    against gga_tpu's ``value_and_grad`` on a 2-device mesh, jitted once,
    with gga_tpu's own 1-vs-N tolerances
    (tests/test_train/test_multichip.py): the loss at rtol 1e-5, the
    whole gradient (before the clip) at relative L2 < 1e-3, each leaf at
    < 1e-2 (of max(its norm, 1e-4 of the whole's)), the batch-norm
    statistics at atol 1e-5 / rtol 1e-4.
(b) The same step with the SRL draw from the trainer's generator (every
    rank draws the global [T, 4] and keeps its columns) against the port's
    one-process step on the whole batch: every logged term at rtol 1e-5
    but the unclipped gradient norm at 1e-4 (the BPL term's gradient
    moves by 3e-5 under the regrouped f32 sums, its loss by 2e-6;
    gga_tpu's own norm on this batch moves by 1.0e-4 between 1 and 2
    devices), the weights after the step bit-equal on the two ranks and within
    1e-4 of the one-process weights where the gradient is above 1e-3 of
    its tensor's largest (else within 2 lr: Adam's first step is about
    lr * sign(g)).
(c) The PGD and FCAF3D tiny steps (B = 4 global), seeded weights, against
    the port's one-process step on the whole batch: every logged term at
    rtol 1e-5, the batch-norm statistics at rtol 1e-5 plus 1e-6, and the
    weights bit-equal on the two ranks. The clipped gradients are held at
    rtol 1e-4 plus 1e-5 of each tensor's largest against one process that
    runs the group's code (``mesh`` with its collectives the identity: the
    global moments as two-pass sums), and against the plain one-process
    step at gga_tpu's 1-vs-N tolerances (whole relative L2 < 1e-3, each
    leaf < 1e-2), PGD's whole at < 5e-3: at these random weights the
    tiny ResNet's ReLU and max-pool decisions sit at rounding level, so
    the f32 step itself lands 3.6e-4 (torch.var moments) or 1.9e-3
    (two-pass moments) of the gradient's norm from the float64 step, and
    the two f32 steps 2.1e-3 apart.
(d) The stage-3 CLI as ``--rank r --world 2 --tmpdir`` on a mini KITTI:
    rank 0's merged pseudo pkl equals the one-process pkl, every value.
(e) ``entry.dryrun_multichip(2, device='cpu')``: the full-width GGA step
    on the dry run's grid, one scene a rank.

The ranks run while this process computes the references.
"""
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from gga_tpu_torch import apis, entry
from gga_tpu_torch.models.detectors import centerpoint_gga as tdet
from gga_tpu_torch.models.detectors.fcaf3d import FCAF3DModelConfig
from gga_tpu_torch.models.detectors.pgd import PGDModelConfig
from gga_tpu_torch.parallel import mesh
from gga_tpu_torch.tools import generate_pseudo_labels_gga as stage3
from gga_tpu_torch.train.loop import gga_train_step

from .test_torch_parallel import join_ranks, start_ranks

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = str(ROOT / 'configs' / 'gga' / 'gga_kitti_tiny.py')
B, P, WORLD = 4, 512, 2


def _tensors(batch, rows=slice(None)):
    return {k: torch.as_tensor(v[rows]) for k, v in batch.items()}


def _gga_step(inp, rows, draw):
    """The GGA step on ``rows``: (logs, the unclipped gradients, the
    buffers and the weights after the step)."""
    tcfg = tdet.GGAModelConfig.tiny()
    trainer = apis.init_trainer(tcfg, 100, inp['gga_sd'], device='cpu')
    grads = {}
    real = trainer.optimizer.step

    def step():
        grads.update({n: p.grad.clone() for n, p in
                      trainer.model.named_parameters() if p.grad is not None})
        return real()

    trainer.optimizer.step = step
    srl = None if draw is None else torch.from_numpy(draw[:, rows])
    logs = gga_train_step(trainer, _tensors(inp['gga_batch'], rows),
                          tcfg.head, srl_normal=srl)
    return dict(logs=logs, grads=grads, buffers=dict(
        trainer.model.named_buffers()), params=dict(
            trainer.model.named_parameters()),
        lr=trainer.optimizer.lr_schedule(0))


def _retrain_step(name, inp, rows, group_formulas=False):
    """The PGD or FCAF3D step on ``rows`` from the seeded weights; with
    ``group_formulas``, in one process through the code a group runs
    (``mesh.distributed()`` true, every collective the identity)."""
    if group_formulas:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mesh, 'distributed', lambda: True)
            mp.setattr(mesh, 'global_sum', lambda t: t)
            mp.setattr(mesh, 'all_reduce_grads', lambda params: None)
            mp.setattr(mesh, 'sum_over_ranks', lambda values: values)
            return _retrain_step(name, inp, rows)
    if name == 'pgd':
        trainer = apis.init_pgd_trainer(PGDModelConfig.tiny(), 1,
                                        device='cpu', seed=0)
        logs = apis.pgd_train_step(trainer, _tensors(inp['pgd'], rows))
    else:
        trainer = apis.init_fcaf3d_trainer(FCAF3DModelConfig.tiny(), 1,
                                           device='cpu', seed=0)
        logs = apis.fcaf3d_train_step(trainer,
                                      _tensors(inp['fcaf3d'], rows))
    m = trainer.model
    return dict(logs=logs, grads={n: p.grad for n, p in
                                  m.named_parameters()},
                buffers=dict(m.named_buffers()),
                params={n: p.detach() for n, p in m.named_parameters()})


def _stage3_argv(inp, out, extra=()):
    return [TINY, '--checkpoint', inp['ckpt'], '--device', 'cpu', '--out',
            out, '--batch-size', '2', '--cfg-options',
            f'data_root={inp["kitti"]}', *extra]


def _ddp_rank(rank, world, tmp):
    with open(os.path.join(tmp, 'inputs.pkl'), 'rb') as f:
        inp = pickle.load(f)
    b = B // world
    rows = slice(rank * b, (rank + 1) * b)
    out = dict(gga=_gga_step(inp, rows, inp['srl']),
               gga_gen=_gga_step(inp, rows, None),
               pgd=_retrain_step('pgd', inp, rows),
               fcaf3d=_retrain_step('fcaf3d', inp, rows))
    out['stage3'] = stage3.main(_stage3_argv(
        inp, os.path.join(tmp, 'pseudo_ranks.pkl'),
        ('--rank', str(rank), '--world', str(world), '--tmpdir',
         os.path.join(tmp, 'parts'))))
    torch.save(out, os.path.join(tmp, f'rank_{rank}.pt'))


def _mini_kitti(root):
    """4 scenes of tests/test_torch_workflow.py's mini KITTI, stage 1, and
    a checkpoint of the tiny config's seeded weights."""
    from gga_tpu_torch import tools_lib
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.tools import create_data_gga
    from gga_tpu_torch.train import checkpoints as ckpt

    from .test_data.fixtures import make_scene, write_kitti_scene

    rng = np.random.RandomState(0)
    boxes = np.array([[12.0, 2.0, -1.7, 3.9, 1.6, 1.55, 0.3],
                      [20.0, -4.0, -1.7, 0.8, 0.6, 1.75, -0.2],
                      [28.0, 6.0, -1.7, 1.76, 0.6, 1.73, 1.0]])
    names = ['Car', 'Pedestrian', 'Cyclist']
    for idx in range(4):
        shift = boxes + [0, idx, 0, 0, 0, 0, 0]
        pts = make_scene(rng, shift, names, n_ground=2000, n_clutter=200,
                         pts_per_box=200)
        write_kitti_scene(root, idx, pts, shift, names,
                          split='train' if idx < 3 else 'val')
    create_data_gga.main(['kitti', '--root-path', root, '--workers', '1'])
    mc = tools_lib.model_config_from_cfg(Config.fromfile(TINY))
    ckpt_dir = os.path.join(root, 'checkpoints')
    ckpt.save_checkpoint(ckpt_dir, apis.init_trainer(mc, 10, device='cpu'))
    return ckpt_dir


def _gga_inputs():
    """gga_tpu's tiny GGA model and drawn variables, the batch and the
    SRL draw of PRNGKey(7)."""
    import jax

    from gga_tpu.models.detectors import centerpoint_gga as jdet
    from gga_tpu_torch import convert

    from .test_torch_detector import _fill

    cfg = jdet.GGAModelConfig.tiny()
    model = jdet.GGADetector(cfg)
    pts, valid = entry._example_inputs(B=B, P=P)
    batch = dict(points=pts, points_valid=valid,
                 **entry._example_gga_targets(B, cfg.head.max_objs))
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), pts[:1], valid[:1], train=False))
    variables = _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                      np.random.RandomState(1))
    keys = jax.random.split(jax.random.PRNGKey(7),
                            len(cfg.head.task_num_classes))
    draw = np.stack([np.asarray(jax.random.normal(k, (B,))) for k in keys])
    sd = convert.from_jax_variables(variables, tdet.GGAModelConfig.tiny())
    return model, cfg, variables, batch, draw, sd


def _jax_mesh_grads(model, cfg, variables, batch):
    """gga_tpu's loss, gradients and batch-norm statistics on a 2-device
    mesh (tests/test_train/test_multichip.py's ``_grads``)."""
    import jax
    import jax.numpy as jnp

    from gga_tpu.models.dense_heads import centerpoint_head_gga as jgga
    from gga_tpu.parallel import mesh as jmesh

    m = jmesh.data_parallel_mesh(jax.devices()[:WORLD])

    def loss_fn(params, batch):
        preds, updates = model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch['points'], batch['points_valid'], train=True,
            mutable=['batch_stats', 'diagnostics'])
        targets = jgga.build_targets(
            cfg.head, jax.random.PRNGKey(7), batch['labels'],
            batch['obj_valid'], batch['init_pseudo'], batch['boxes_img'],
            batch['bdry_masks'], batch['lidar2img'])
        total, _ = jgga.loss(cfg.head, preds, targets, batch['ibp_xy'],
                             batch['ibp_valid'])
        return total, jax.tree_util.tree_map(jnp.asarray,
                                             updates['batch_stats'])

    with m:
        fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                     in_shardings=(jmesh.replicate(m),
                                   jmesh.batch_sharding(m)))
        (loss, bstats), grads = fn(variables['params'],
                                   jmesh.shard_batch(m, batch))
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(
        dict(grads=grads, bstats=bstats)))
    return float(loss), tree['grads'], tree['bstats']


def _retrain_inputs():
    from .test_torch_fcaf3d import clouds, objects
    from .test_torch_pgd import H, W, _objects

    objs = [_objects(seed) for seed in (1, 2)]
    pgd = {k: np.concatenate([o[k] for o in objs]) for k in objs[0]}
    pgd['image'] = np.random.RandomState(0).randn(B, H, W, 3).astype(
        np.float32)
    cl = [clouds(seed) for seed in (0, 1)]
    ob = objects(FCAF3DModelConfig.tiny())
    fcaf3d = dict(points=np.concatenate([c[0] for c in cl]),
                  colors=np.concatenate([c[1] for c in cl]),
                  points_valid=np.concatenate([c[2] for c in cl]),
                  gt_boxes=np.concatenate([ob[0]] * 2),
                  gt_labels=np.concatenate([ob[1]] * 2),
                  obj_valid=np.concatenate([ob[2]] * 2))
    return pgd, fcaf3d


@pytest.fixture(scope='module')
def ddp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('ddp_ranks')
    kitti = str(tmp / 'kitti')
    ckpt_dir = _mini_kitti(kitti)
    model, cfg, variables, batch, draw, sd = _gga_inputs()
    pgd, fcaf3d = _retrain_inputs()
    inp = dict(gga_sd=sd, gga_batch=batch, srl=draw, pgd=pgd, fcaf3d=fcaf3d,
               ckpt=ckpt_dir, kitti=kitti)
    with open(tmp / 'inputs.pkl', 'wb') as f:
        pickle.dump(inp, f)
    ctx = start_ranks(_ddp_rank, WORLD, tmp)
    ref = dict(jax=_jax_mesh_grads(model, cfg, variables, batch),
               gga_gen=_gga_step(inp, slice(None), None),
               pgd=_retrain_step('pgd', inp, slice(None)),
               fcaf3d=_retrain_step('fcaf3d', inp, slice(None)),
               pgd_group=_retrain_step('pgd', inp, slice(None), True),
               fcaf3d_group=_retrain_step('fcaf3d', inp, slice(None), True))
    ref['stage3'] = stage3.main(_stage3_argv(
        inp, str(tmp / 'pseudo_one.pkl')))
    join_ranks(ctx)
    ranks = [torch.load(tmp / f'rank_{r}.pt', weights_only=False)
             for r in range(WORLD)]
    return dict(tmp=tmp, variables=variables, ref=ref, ranks=ranks)


def _port_layout(tree):
    from .test_torch_train import _in_port_layout

    return _in_port_layout(tdet.GGAModelConfig.tiny(), tree)


def _close_like_gga_tpu_1_vs_n(got, ref, whole=1e-3):
    """tests/test_train/test_multichip.py's gradient gates: the whole
    gradient at relative L2 < ``whole`` (1e-3), each leaf at < 1e-2 of
    max(its norm, 1e-4 of the whole's)."""
    names = sorted(ref)
    assert names == sorted(got)
    a_all = [got[n].detach().numpy().astype(np.float64) for n in names]
    b_all = [ref[n].detach().numpy().astype(np.float64) for n in names]
    num = np.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(a_all, b_all)))
    den = np.sqrt(sum((b ** 2).sum() for b in b_all))
    assert num / den < whole, f'grad relative diff {num / den:.2e}'
    for n, a, b in zip(names, a_all, b_all):
        dl = np.sqrt(((a - b) ** 2).sum())
        nl = max(np.sqrt((b ** 2).sum()), 1e-4 * den)
        assert dl / nl < 1e-2, f'{n}: leaf rel-L2 diff {dl / nl:.2e}'


def test_gga_step_two_ranks_match_gga_tpu_mesh(ddp):
    loss, jgrads, jstats = ddp['ref']['jax']
    ranks = [r['gga'] for r in ddp['ranks']]
    for r in ranks:
        np.testing.assert_allclose(float(r['logs']['loss']), loss, rtol=1e-5)
    grads, _ = _port_layout(dict(params=jgrads,
                                 batch_stats=ddp['variables']['batch_stats']))
    for r in ranks:
        _close_like_gga_tpu_1_vs_n(r['grads'], grads)
    _, stats = _port_layout(dict(params=ddp['variables']['params'],
                                 batch_stats=jstats))
    for r in ranks:
        for n, buf in r['buffers'].items():
            np.testing.assert_allclose(buf.numpy(), stats[n].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=n)


def _sign_aware_close(name, got, want, grad, lr):
    """Weights after a first Adam step: within 1e-4 where |g| > 1e-3
    max|g| of the tensor, else within 2 lr (the step is about
    lr * sign(g), and the sign of a gradient near zero can flip under
    summation-order noise). A conv bias that feeds a train-mode batch norm
    has a gradient of zero up to that noise: every entry is within 2 lr
    (tests/test_torch_train.py's rule)."""
    from .test_torch_train import _before_bn

    g = np.abs(grad)
    big = (g > 1e-3 * g.max()) & (not _before_bn(name))
    np.testing.assert_allclose(got[big], want[big], rtol=1e-4, atol=1e-4)
    assert (np.abs(got - want)[~big] <= 2 * lr).all()


def test_gga_step_two_ranks_match_one_process(ddp):
    one = ddp['ref']['gga_gen']
    ranks = [r['gga_gen'] for r in ddp['ranks']]
    for r in ranks:
        assert set(r['logs']) == set(one['logs'])
        for k, v in one['logs'].items():
            np.testing.assert_allclose(
                float(r['logs'][k]), float(v),
                rtol=1e-4 if k == 'grad_norm' else 1e-5, err_msg=k)
    for n, p in ranks[0]['params'].items():
        assert torch.equal(p, ranks[1]['params'][n]), n
        _sign_aware_close(n, p.detach().numpy(),
                          one['params'][n].detach().numpy(),
                          one['grads'][n].numpy(), one['lr'])


@pytest.mark.parametrize('name', ['pgd', 'fcaf3d'])
def test_retrain_step_two_ranks_match_one_process(ddp, name):
    one, group = ddp['ref'][name], ddp['ref'][name + '_group']
    ranks = [r[name] for r in ddp['ranks']]
    assert float(one['logs']['num_pos']) > 0
    for r in ranks:
        assert set(r['logs']) == set(one['logs'])
        for k, v in one['logs'].items():
            np.testing.assert_allclose(float(r['logs'][k]), float(v),
                                       rtol=1e-5, err_msg=k)
        assert {n for n, g in r['grads'].items() if g is None} == {
            n for n, g in one['grads'].items() if g is None}
        live = {n: g for n, g in r['grads'].items() if g is not None}
        _close_like_gga_tpu_1_vs_n(
            live, {n: one['grads'][n] for n in live},
            whole=5e-3 if name == 'pgd' else 1e-3)
        for n, g in live.items():
            want = group['grads'][n]
            np.testing.assert_allclose(
                g.numpy(), want.numpy(), rtol=1e-4,
                atol=1e-5 * float(want.abs().max()), err_msg=n)
        for n, buf in one['buffers'].items():
            np.testing.assert_allclose(r['buffers'][n].numpy(), buf.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=n)
    for n, p in ranks[0]['params'].items():
        assert torch.equal(p, ranks[1]['params'][n]), n


def _assert_same(got, want, path=''):
    """Every key, value and array of two pickled pseudo-info lists
    equal."""
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f'{path}/{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f'{path}[{i}]')
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


def test_stage3_cli_world_2_merges_the_one_process_pkl(ddp):
    one, ranks = ddp['ref']['stage3'], [r['stage3'] for r in ddp['ranks']]
    assert ranks[1]['rank'] == 1 and ranks[1]['scenes'] == 2
    assert ranks[0]['infos'] == one['infos'] == 4
    with open(one['out'], 'rb') as f:
        want = pickle.load(f)
    with open(ranks[0]['out'], 'rb') as f:
        got = pickle.load(f)
    assert [i['image']['image_idx'] for i in got] == [
        i['image']['image_idx'] for i in want]
    _assert_same(got, want)
    assert sorted(os.listdir(ddp['tmp'] / 'parts')) == ['part_0.pkl',
                                                        'part_1.pkl']


def test_dryrun_multichip_two_ranks():
    res = entry.dryrun_multichip(2, device='cpu')
    assert np.isfinite(res['loss']) and np.isfinite(res['grad_norm'])
    assert not torch.distributed.is_initialized()
    assert mesh.world_size() == 1
