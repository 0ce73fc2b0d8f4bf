"""The port's dynamic-voxelization detectors against gga_tpu's, f32, CPU.

``DynamicVoxelNetConfig.tiny()`` and ``DVSECONDConfig.tiny()``, gga_tpu's
variables (shapes from its init, values drawn with numpy) reaching the
port through ``convert.from_jax_variables``: one train-mode pass of each
package on two synthetic scenes (ground, clutter, and a car, a
pedestrian and a cyclist on anchor centres near the sensor, where the
voxel budget keeps them). The dynamic voxel means (DVSECOND's encoder
input, DynamicVoxelNet's canvas) at rtol 1e-6 + atol 1e-6, the head's
maps at rtol 1e-4 + atol 1e-4, the four loss terms at rtol 1e-4
(``num_pos`` exactly), every parameter's gradient at cosine >= 0.9999 and
the BN statistics' updates at 1e-4; the conversion round trip exactly.
``dynamic_scatter_mean`` equals gga_tpu's exactly where most points lie
in no kept voxel (a budget's overflow), in as many ``index_add_`` passes
as the most points a kept voxel holds, each point added once.
The tiny CLI (``tools/train_supervised.py --device cpu``, DVSECOND, 2
steps of 2 scenes across an epoch boundary): each step's lr, both
checkpoints, and the first loss equal at rtol 1e-4 to gga_tpu's step
body on gga_tpu's first batch from the CLI's initial weights.

gga_tpu's step is jitted once per detector; the CLI's batches have the
synthetic batch's shapes, so they reuse its compilation. ``SASSD``
(``tests/test_torch_sassd.py``) and the bf16 SECOND
(``tests/test_torch_second_bf16.py``) use this file's helpers.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from gga_tpu import config as jconfig
from gga_tpu.data import kitti_det as jkd
from gga_tpu.models.dense_heads import anchor3d_head as jah
from gga_tpu.models.detectors import dynamic_voxelnet as jdv
from gga_tpu.models.detectors import sassd as jsassd
from gga_tpu.ops import scatter as jscatter
from gga_tpu_torch import apis, convert
from gga_tpu_torch import config as tconfig
from gga_tpu_torch.models.dense_heads import anchor3d_head as tah
from gga_tpu_torch.models.detectors import dynamic_voxelnet as tdv
from gga_tpu_torch.ops import scatter as tscatter
from gga_tpu_torch.tools import train_supervised
from gga_tpu_torch.train import loop
from gga_tpu_torch.train.optim import cyclic_cos_schedule

from .test_data.fixtures import make_scene
from .test_torch_supervised import kitti  # noqa: F401 (the mini KITTI)
from .test_torch_supervised import (_as_parameters, _fill, cosine,
                                    to_jax_variables)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, P, M = 2, 4000, 64            # the CLI's batch (the `kitti` fixture's)
TERMS = ('loss_cls', 'loss_bbox', 'loss_dir', 'loss', 'num_pos')
SIZES = ((0.8, 0.6, 1.73), (1.76, 0.6, 1.73), (3.9, 1.6, 1.56))


def anchor_batch(head, map_hw, cells, seed=0):
    """B scenes of P points on ``head``'s (H, W) anchor map: a pedestrian,
    a cyclist (yaw pi/2, the rotated anchor) and a car on the anchor
    centres of the given (h, w) cells (the car a cell further in the
    second scene), each with 250 points, over sparse ground and clutter;
    M object slots."""
    rng = np.random.RandomState(seed)
    anchors = tah.make_anchors(head, tuple(map_hw)).numpy().reshape(
        head.num_classes, *map_hw, len(head.rotations), 7)
    gt = np.zeros((B, M, 7), np.float32)
    labels = np.full((B, M), -1, np.int64)
    pts = []
    for b in range(B):
        for k, (label, yaw) in enumerate(((0, 0.0), (1, np.pi / 2),
                                          (2, 0.0))):
            h, w = cells[k]
            h += b * (label == 2)
            x, y = anchors[label, h, w, 0, :2]
            gt[b, k] = [x, y, -1.7, *SIZES[label], yaw]
            labels[b, k] = label
        cloud = make_scene(rng, gt[b, :3].astype(np.float64), None,
                           n_ground=P - 950, n_clutter=200, pts_per_box=250)
        pts.append(cloud[:P])
    return dict(points=np.stack(pts).astype(np.float32),
                points_valid=np.ones((B, P), bool), gt_boxes=gt,
                gt_labels=labels, gt_valid=labels >= 0)


def jax_step(model, mc, aux=False):
    """gga_tpu's ``tools/train_supervised.py`` step body (loss and
    gradients, no optimizer); with ``aux`` (SASSD) the train-mode tuple's
    ``sassd_aux_loss`` terms are added to the total, as the port's step
    adds them."""
    def loss_fn(params, batch_stats, batch):
        out, mut = model.apply(
            {'params': params, 'batch_stats': batch_stats},
            batch['points'], batch['points_valid'], train=True,
            mutable=['batch_stats', 'diagnostics'])
        preds, aux_t = out if aux else (out, None)
        H, W = preds['cls'].shape[1:3]
        anchors = jah.make_anchors(mc.head, (H, W))
        targets = jax.vmap(lambda gb, gl, gv: jah.assign_targets(
            mc.head, anchors, gb, gl, gv))(batch['gt_boxes'],
                                           batch['gt_labels'],
                                           batch['gt_valid'])
        total, logs = jah.loss(mc.head, preds, anchors, targets)
        if aux:
            al = jsassd.sassd_aux_loss(aux_t, batch['gt_boxes'],
                                       batch['gt_valid'])
            total = total + al['aux_loss_cls'] + al['aux_loss_reg']
            logs = dict(logs, loss=total, **al)
        return total, (logs, preds, aux_t, mut)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def jax_variables(model, batch, seed=1, train=False):
    """gga_tpu's variables of ``model``: shapes from its init (``train``:
    SASSD creates its aux branch only in train mode), numpy values."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), batch['points'][:1],
        batch['points_valid'][:1], train=train))
    return _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                 np.random.RandomState(seed))


def train_pass(tmc, variables, batch, step, capture='middle_encoder'):
    """One train-mode pass of each package from gga_tpu's variables: the
    port's loss (``loop.anchor_loss``), gradients and BN updates beside
    gga_tpu's, and the port's ``capture`` submodule's output."""
    (_, (jlogs, jpreds, jaux, mut)), jgrads = step(
        variables['params'], variables['batch_stats'], batch)
    trainer = apis.init_anchor_trainer(
        tmc, 1, convert.from_jax_variables(variables, tmc), device='cpu')
    det = trainer.model.train()
    sub = det.get_submodule(capture)
    captured = []
    real = sub.forward

    def keep(*a, **k):
        captured.append(real(*a, **k))
        return captured[-1]

    sub.forward = keep
    outs = []
    real_fwd = det.forward

    def keep_out(*a, **k):
        outs.append(real_fwd(*a, **k))
        return outs[-1]

    det.forward = keep_out
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, logs = loop.anchor_loss(det, t)
    del sub.forward, det.forward
    total.backward()
    preds, aux = outs[0] if isinstance(outs[0], tuple) else (outs[0], None)
    return dict(
        tmc=tmc, variables=variables, jlogs=jlogs, jpreds=jpreds, jaux=jaux,
        mut=mut, logs=logs, preds=preds, aux=aux, captured=captured[0],
        grads={k: p.grad for k, p in det.named_parameters()},
        ref_grads=_as_parameters(tmc, convert.from_jax_variables(
            {'params': jax.tree_util.tree_map(np.asarray, jgrads)}, tmc)),
        stats={k: b for k, b in det.state_dict().items()
               if k.endswith(('running_mean', 'running_var'))},
        ref_stats=convert.from_jax_variables(
            {'batch_stats': jax.tree_util.tree_map(np.asarray,
                                                   mut['batch_stats'])},
            tmc))


def check_head_maps(run, rtol=1e-4, atol=1e-4):
    for key in ('cls', 'reg', 'dir'):
        assert run['preds'][key].dtype == torch.float32
        np.testing.assert_allclose(run['preds'][key].detach().numpy(),
                                   np.asarray(run['jpreds'][key]),
                                   rtol=rtol, atol=atol, err_msg=key)


def check_gradients(run, floor=0.9999):
    grads, ref = run['grads'], run['ref_grads']
    assert set(grads) == set(ref)
    worst = min((cosine(grads[k], ref[k]), k) for k in grads)
    assert worst[0] >= floor, worst


def check_bn_updates(run, n_min, rtol=1e-4, atol=1e-4):
    ref, stats = run['ref_stats'], run['stats']
    assert set(ref) == set(stats) and len(ref) >= n_min
    for key, r in ref.items():
        np.testing.assert_allclose(stats[key].numpy(), r.numpy(), rtol=rtol,
                                   atol=atol, err_msg=key)


def check_round_trip(tmc, variables):
    sd = convert.from_jax_variables(variables, tmc)
    det = apis.init_anchor_detector(tmc, sd, device='cpu').model  # strict
    rules = convert.rules_of(tmc)
    assert len({r[2] for r in rules}) == len(rules) == len(sd)
    back = to_jax_variables(det.state_dict(), tmc)
    flat = jax.tree_util.tree_leaves_with_path(variables)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf, err_msg=str(path))


def write_config(root, name, base, model_cfg):
    """A config file: the shipped ``base`` with the model ``model_cfg``
    (a tiny one) spelled out, B = 2 scenes of P points, the `kitti`
    fixture's data root, a log line every step."""
    def plain(v):
        if isinstance(v, tuple):
            return [plain(x) for x in v]
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        return v
    model = plain(dataclasses.asdict(model_cfg))
    path = os.path.join(root, name)
    with open(path, 'w') as f:
        f.write(f'''_base_ = [{os.path.join(ROOT, 'configs', base)!r}]
model = {model!r}
data = dict(samples_per_gpu={B}, max_points={P})
data_root = {root + "/"!r}
log_interval = 1
''')
    return path


def cli_first_loss_matches(root, cfg_path, tmc, step, tmp_path,
                           extra_keys=()):
    """Two CLI steps of 2 scenes (one step an epoch): the log, the lr of
    each step, a checkpoint each epoch, and the first loss terms against
    gga_tpu's step on its first batch from the CLI's initial weights."""
    work = str(tmp_path / 'work')
    summ = train_supervised.main([cfg_path, '--work-dir', work,
                                  '--max-steps', '2', '--device', 'cpu'])
    assert summ['steps'] == 2 and summ['steps_per_epoch'] == 1
    with open(os.path.join(work, 'train_log.jsonl')) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln['step'] for ln in lines] == [1, 2]
    assert [ln['epoch'] for ln in lines] == [0, 1]
    assert set(TERMS) | set(extra_keys) <= set(lines[0]), set(lines[0])
    cfg = tconfig.Config.fromfile(cfg_path)
    sched = cyclic_cos_schedule(cfg.optimizer.lr, total_steps=2)
    assert [ln['lr'] for ln in lines] == [sched(0), sched(1)]
    assert all(np.isfinite(ln['loss']) for ln in lines)
    assert sorted(os.listdir(os.path.join(work, 'checkpoints'))) == [
        'step_1.pt', 'step_2.pt']

    init = apis.init_anchor_detector(tmc, device='cpu', seed=cfg.seed)
    jvars = to_jax_variables(init.model.state_dict(), tmc)
    d = cfg.data
    ds = jkd.KittiDetDataset(root, os.path.join(root, d.train_info),
                             pc_range=cfg.point_cloud_range,
                             pts_prefix=d.pts_prefix, max_points=d.max_points,
                             seed=cfg.seed)
    batch = next(ds.epoch_batches(B, seed=0))
    batch.pop('sample_idx')
    (_, (jlogs, *_)), _ = step(jvars['params'], jvars['batch_stats'], batch)
    for term in TERMS + tuple(extra_keys):
        np.testing.assert_allclose(lines[0][term], float(jlogs[term]),
                                   rtol=1e-4, err_msg=term)
    return lines


# per detector: gga_tpu's model and config, the port's config, the BEV
# map's (H, W) and the cells of the pedestrian, cyclist and car
KINDS = dict(
    dynamic_voxelnet=(jdv.DynamicVoxelNet, jdv.DynamicVoxelNetConfig,
                      tdv.DynamicVoxelNetConfig, (64, 56),
                      ((33, 8), (29, 10), (30, 5))),
    dvsecond=(jdv.DVSECONDDetector, jdv.DVSECONDConfig,
              tdv.DVSECONDConfig, (32, 28), ((16, 3), (14, 4), (17, 2))))


@pytest.fixture(scope='module')
def steps():
    out = {}
    for kind, (jmodel, jcfg, tcfg, hw, cells) in KINDS.items():
        mc = jcfg.tiny()
        model = jmodel(mc)
        out[kind] = (model, mc, tcfg.tiny(), jax_step(model, mc), hw, cells)
    return out


@pytest.fixture(scope='module', params=list(KINDS))
def detector(request, steps):
    model, mc, tmc, step, hw, cells = steps[request.param]
    batch = anchor_batch(tmc.head, hw, cells)
    variables = jax_variables(model, batch)
    run = train_pass(tmc, variables, batch, step)
    run.update(kind=request.param, batch=batch, mc=mc)
    return run


def test_dynamic_means_match_gga_tpu(detector):
    """DynamicVoxelNet's canvas (the scattered pillar means) and
    DVSECOND's encoder input (the voxel means; the port's conv_input sees
    them), against gga_tpu's own functions."""
    mc, batch = detector['mc'], detector['batch']
    grid = ((1, *mc.scatter_shape) if detector['kind'] == 'dynamic_voxelnet'
            else tuple(mc.sparse_shape))

    def vox(p, v):
        from gga_tpu.ops.scatter import (assign_point_voxel_ids,
                                         dynamic_scatter_mean)
        from gga_tpu.ops.voxelize import dynamic_voxelize, hard_voxelize
        vs, rng = tuple(mc.voxel_size), tuple(mc.point_cloud_range)
        out = hard_voxelize(p, v, voxel_size=vs, pc_range=rng, max_points=1,
                            max_voxels=mc.max_voxels)
        pc, ok = dynamic_voxelize(p, v, voxel_size=vs, pc_range=rng)
        ids = assign_point_voxel_ids(pc, out['coords'], ok,
                                     out['coords'][:, 0] >= 0, grid)
        return dynamic_scatter_mean(p, ids, ok, mc.max_voxels)[0]

    ref = np.asarray(jax.jit(jax.vmap(vox))(batch['points'],
                                            batch['points_valid']))
    means, _, valid = tdv.dynamic_voxel_means(
        mc, grid, torch.from_numpy(batch['points']),
        torch.from_numpy(batch['points_valid']))
    np.testing.assert_allclose(means.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert int(valid.sum()) > B * 100
    if detector['kind'] == 'dynamic_voxelnet':
        canvas = detector['captured']            # [B, 4, ny, nx]
        assert canvas.shape == (B, 4, *mc.scatter_shape)
        assert int((canvas.abs().sum(1) > 0).sum()) == int(valid.sum())


def test_head_maps_match_gga_tpu(detector):
    check_head_maps(detector)


@pytest.mark.parametrize('term', TERMS)
def test_loss_terms_match_gga_tpu(detector, term):
    assert float(detector['jlogs']['num_pos']) >= 3 * B
    np.testing.assert_allclose(float(detector['logs'][term].detach()),
                               float(detector['jlogs'][term]), rtol=1e-4)


def test_gradients_match_gga_tpu(detector):
    check_gradients(detector)


def test_bn_statistics_updates_match_gga_tpu(detector):
    check_bn_updates(detector, 18)


def test_conversion_round_trip(detector):
    check_round_trip(detector['tmc'], detector['variables'])


def test_dvsecond_cli_matches_gga_tpu(kitti, steps, tmp_path):  # noqa: F811
    root = kitti[0]
    model, mc, tmc, step, _, _ = steps['dvsecond']
    path = write_config(
        root, 'dv_second_tiny.py', 'dynamic_voxelization/'
        'dv_second_secfpn_2x8_cosine_80e_kitti-3d-3class.py',
        tmc)
    cfg = tconfig.Config.fromfile(path)
    # the cosine config trains on the cyclic schedule, as in gga_tpu
    assert cfg.optimizer.lr_policy == 'cosine'
    jcfg = jconfig.Config.fromfile(path)
    assert jcfg.model.type == 'DVSECONDDetector'
    cli_first_loss_matches(root, path, tmc, step, tmp_path)


def test_scatter_mean_passes_over_kept_voxels_only(monkeypatch):
    """Points of dropped voxels carry the id V: they are added nowhere and
    take no pass of their own."""
    rng = np.random.RandomState(3)
    B, P, V = 2, 600, 10
    ids = rng.randint(0, V, (B, P)).astype(np.int32)
    ids[:, ::3] = V                          # a third in no kept voxel
    ids[0, :400:7] = 4                       # one voxel holds many
    valid = rng.rand(B, P) < 0.9
    feats = rng.randn(B, P, 4).astype(np.float32)
    ref_mean, ref_cnt = jax.jit(jax.vmap(
        lambda f, i, v: jscatter.dynamic_scatter_mean(f, i, v, V)))(
            feats, ids, valid)
    adds = []
    real = torch.Tensor.index_add_

    def counted(self, dim, index, source, **kw):
        adds.append(index.numel())
        return real(self, dim, index, source, **kw)

    monkeypatch.setattr(torch.Tensor, 'index_add_', counted)
    mean, cnt = tscatter.dynamic_scatter_mean(
        torch.from_numpy(feats), torch.from_numpy(ids),
        torch.from_numpy(valid), V)
    monkeypatch.undo()
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_cnt))
    np.testing.assert_array_equal(mean.numpy(), np.asarray(ref_mean))
    assert len(adds) == int(cnt.max()) > 20
    assert sum(adds) == int(cnt.sum()) < int(valid.sum())
