"""The port's fully supervised KITTI path against gga_tpu's, f32, CPU.

- ``KittiDetDataset``: every sample and every batch of epochs 0-1 equal
  to gga_tpu's bit for bit, on a mini KITTI of 3 scenes
  (``tests/test_data/fixtures.py``), with fewer and with more points
  than ``max_points``.
- A reduced SECOND (the shipped structure on a 41 x 400 x 352 grid of
  0.2 m voxels, encoder widths 8 / 16 / 16 / 16, SECOND (16, 32), FPN
  (16, 16), the 3-class anchor head) and ``PointPillarsConfig.tiny()``,
  gga_tpu's variables (shapes from its init, values drawn with numpy)
  reaching the port through ``convert.from_jax_variables``: one
  train-mode pass on two synthetic scenes with a car, a pedestrian and a
  cyclist on anchor centres. The head's maps at rtol 1e-4 + atol 1e-4,
  the four loss terms at rtol 1e-4 (``num_pos`` exactly), every
  parameter's gradient at cosine >= 0.9999 and the BN statistics'
  updates at 1e-4; for SECOND also the conv_module ``SparseEncoder``'s
  BEV map at rtol 1e-4 + atol 1e-4, ``occupancy_out`` exactly and each
  sparse weight's gradient at cosine >= 0.9999; the conversion round
  trip exactly.
- The tiny CLI (``tools/train_supervised.py --device cpu``, the reduced
  SECOND, 2 steps of 2 scenes across an epoch boundary): the logged keys,
  each step's lr, both checkpoints, and the first loss equal at rtol 1e-4
  to gga_tpu's ``tools/train_supervised.py`` step body on gga_tpu's first
  batch with the CLI's initial weights.

gga_tpu's step is jitted once per detector (the CLI's batches have the
synthetic batch's shapes, so they reuse its compilation).
"""
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from gga_tpu import config as jconfig
from gga_tpu.data import kitti_det as jkd
from gga_tpu.models import builder as jbuilder
from gga_tpu.models.dense_heads import anchor3d_head as jah
from gga_tpu.models.detectors import voxelnet as jvn
from gga_tpu.models.middle_encoders import SparseEncoder as JSparseEncoder
from gga_tpu_torch import apis, convert
from gga_tpu_torch import config as tconfig
from gga_tpu_torch.data import kitti_det as tkd
from gga_tpu_torch.data.kitti import gt_database as tgt
from gga_tpu_torch.data.kitti import io as tio
from gga_tpu_torch.models import builder as tbuilder
from gga_tpu_torch.models.dense_heads import anchor3d_head as tah
from gga_tpu_torch.models.detectors import voxelnet as tvn
from gga_tpu_torch.models.layers import _SparseConv
from gga_tpu_torch.tools import train_supervised
from gga_tpu_torch.train.optim import cyclic_cos_schedule

from .test_data.fixtures import make_scene, write_kitti_scene

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECOND_CONFIG = os.path.join(
    ROOT, 'configs', 'second', 'hv_second_secfpn_6x8_80e_kitti-3d-3class.py')
B, P, M = 2, 4000, 64            # the CLI's batch: samples_per_gpu, points
N_SCENES = 3
BOXES = np.array([[12.0, 2.0, -1.7, 3.9, 1.6, 1.55, 0.3],
                  [20.0, -4.0, -1.7, 0.8, 0.6, 1.75, -0.2],
                  [28.0, 6.0, -1.7, 1.76, 0.6, 1.73, 1.0]])
NAMES = ['Car', 'Pedestrian', 'Cyclist']
TERMS = ('loss_cls', 'loss_bbox', 'loss_dir', 'loss', 'num_pos')


@pytest.fixture(scope='module')
def kitti(tmp_path_factory):
    """A mini KITTI (3 train scenes, reduced clouds, an info pkl) and a
    config file: the shipped SECOND with the reduced model and B = 2."""
    root = str(tmp_path_factory.mktemp('kitti_det'))
    rng = np.random.RandomState(0)
    infos = []
    for idx in range(N_SCENES):
        boxes = BOXES.copy()
        boxes[:, 1] += idx
        pts = make_scene(rng, boxes, NAMES, n_ground=3000, n_clutter=300,
                         pts_per_box=300)
        write_kitti_scene(root, idx, pts, boxes, NAMES)
        infos.append(tio.create_scene_info(root, 'train', idx))
    tgt.create_reduced_point_clouds(root, infos)
    with open(os.path.join(root, 'kitti_infos_train.pkl'), 'wb') as f:
        pickle.dump(infos, f)
    cfg_path = os.path.join(root, 'second_tiny.py')
    with open(cfg_path, 'w') as f:
        f.write(f'''_base_ = [{SECOND_CONFIG!r}]
model = dict(sparse_shape=[41, 400, 352], voxel_size=[0.2, 0.2, 0.1],
             max_voxels=2048,
             encoder_channels=[[8], [16, 16, 16], [16, 16, 16],
                               [16, 16, 16]],
             encoder_budgets=[2048, 2048, 2048], encoder_out_budget=2048,
             backbone_channels=[16, 32], backbone_layers=[1, 1],
             neck_channels=[16, 16])
data = dict(samples_per_gpu={B}, max_points={P})
data_root = {root + "/"!r}
log_interval = 1
''')
    return root, cfg_path


@pytest.mark.parametrize('max_points', [1000, 100000])
def test_dataset_equals_gga_tpu(kitti, max_points):
    root = kitti[0]
    pkl = os.path.join(root, 'kitti_infos_train.pkl')
    port = tkd.KittiDetDataset(root, pkl, max_points=max_points, seed=3)
    ref = jkd.KittiDetDataset(root, pkl, max_points=max_points, seed=3)
    n_valid = []
    for epoch in (0, 1):
        port.epoch = ref.epoch = epoch
        for idx in range(N_SCENES):
            a, b = port.get_sample(idx), ref.get_sample(idx)
            assert set(a) == set(b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
                assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype
            n_valid.append(int(a['points_valid'].sum()))
            assert a['gt_valid'].sum() > 0
        batches = [list(ds.epoch_batches(2, seed=epoch))
                   for ds in (port, ref)]
        assert len(batches[0]) == len(batches[1]) == 1
        for key in batches[0][0]:
            np.testing.assert_array_equal(batches[0][0][key],
                                          batches[1][0][key], err_msg=key)
    # the subsample (max_points 1000) and the padding (100 000) both ran
    assert (max(n_valid) == 1000) == (max_points == 1000)


def _fill(tree, rng, path=()):
    """Numpy values for a tree of shapes: kernels He-uniform (sparse
    [K, C, D], dense [kh, kw, I, O], linear [I, O]), BN scales and
    running variances near 1, the cls bias -2, small biases and means."""
    if hasattr(tree, 'items'):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == 'kernel':
        fan_in = int(np.prod(shape[:-1]))
        bound = np.sqrt(6.0 / fan_in)
        v = rng.uniform(-bound, bound, shape)
    elif name in ('scale', 'var'):
        v = rng.uniform(0.8, 1.2, shape)
    elif path[-2:] == ('conv_cls', 'bias'):
        v = np.full(shape, -2.0)
    else:                                   # bias, mean
        v = rng.uniform(-0.1, 0.1, shape)
    return np.asarray(v, np.float32)


def synthetic_batch(anchor_xy, seed=0):
    """B scenes of P points: ground, clutter and a car, a pedestrian and a
    cyclist on the given anchor centres (the cyclist at yaw pi/2, on the
    rotated anchor), each with a cluster of points; M object slots."""
    rng = np.random.RandomState(seed)
    sizes = ((3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73))
    gt = np.zeros((B, M, 7), np.float32)
    labels = np.full((B, M), -1, np.int64)
    pts = []
    for b in range(B):
        objs = []
        for k, (label, (x, y), yaw) in enumerate(
                zip((2, 0, 1), anchor_xy, (0.0, 0.0, np.pi / 2))):
            y = y + 1.6 * b * (k == 0)        # the car moves a cell
            gt[b, k] = [x, y, -1.7, *sizes[k], yaw]
            labels[b, k] = label
            objs.append(gt[b, k].astype(np.float64))
        pts.append(make_scene(rng, np.array(objs), None, n_ground=P - 900,
                              n_clutter=300, pts_per_box=200))
    return dict(points=np.stack(pts)[:, :P].astype(np.float32),
                points_valid=np.ones((B, P), bool), gt_boxes=gt,
                gt_labels=labels, gt_valid=labels >= 0)


def jax_step(model, mc):
    """gga_tpu's ``tools/train_supervised.py`` step body (loss and
    gradients; no optimizer), with the SparseEncoder's output captured."""
    def loss_fn(params, batch_stats, batch):
        preds, mut = model.apply(
            {'params': params, 'batch_stats': batch_stats},
            batch['points'], batch['points_valid'], train=True,
            mutable=['batch_stats', 'diagnostics', 'intermediates'],
            capture_intermediates=lambda mdl, _: isinstance(
                mdl, JSparseEncoder))
        H, W = preds['cls'].shape[1:3]
        anchors = jah.make_anchors(mc.head, (H, W))
        targets = jax.vmap(lambda gb, gl, gv: jah.assign_targets(
            mc.head, anchors, gb, gl, gv))(batch['gt_boxes'],
                                           batch['gt_labels'],
                                           batch['gt_valid'])
        total, logs = jah.loss(mc.head, preds, anchors, targets)
        return total, (logs, preds, mut)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.fixture(scope='module')
def models(kitti):
    """Per detector: gga_tpu's model and config, the port's config,
    gga_tpu's jitted step, and the anchor centres of its map."""
    path = kitti[1]
    model, mc = jbuilder.build_detector(jconfig.Config.fromfile(path))
    tmc = tbuilder.build_detector(tconfig.Config.fromfile(path))[1]
    pp = jvn.PointPillarsConfig.tiny()
    pp_model = jvn.PointPillars(pp)
    return dict(
        # the 50 x 44 map: 1.6 m cells from (0, -40)
        second=(model, mc, tmc, jax_step(model, mc),
                ((16.8, 0.8), (24.8, -7.2), (13.6, 8.8))),
        # the 64 x 56 map: 1.28 m cells from (0, -40.96)
        pointpillars=(pp_model, pp, tvn.PointPillarsConfig.tiny(),
                      jax_step(pp_model, pp),
                      ((16.0, 0.64), (23.68, -7.04), (13.44, 8.32))))


@pytest.fixture(scope='module', params=['second', 'pointpillars'])
def detector(request, models):
    """gga_tpu's drawn variables, the synthetic batch, and one train-mode
    pass of each package from the same weights."""
    model, mc, tmc, step, xy = models[request.param]
    batch = synthetic_batch(xy)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), batch['points'][:1],
        batch['points_valid'][:1], train=False))
    variables = _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                      np.random.RandomState(1))
    (_, (jlogs, jpreds, mut)), jgrads = step(variables['params'],
                                             variables['batch_stats'], batch)

    trainer = apis.init_anchor_trainer(
        tmc, 1, convert.from_jax_variables(variables, tmc), device='cpu')
    det = trainer.model.train()
    captured = []
    real = det.middle_encoder.forward

    def keep(*a, **k):
        captured.append(real(*a, **k))
        return captured[-1]

    det.middle_encoder.forward = keep
    diag = {}
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    preds = det(t['points'], t['points_valid'], diag)
    del det.middle_encoder.forward
    anchors = tah.make_anchors(tmc.head, tuple(preds['cls'].shape[1:3]))
    targets = tah.assign_targets(tmc.head, anchors, t['gt_boxes'],
                                 t['gt_labels'], t['gt_valid'])
    total, logs = tah.loss(tmc.head, preds, anchors, targets)
    total.backward()
    return dict(
        kind=request.param, tmc=tmc, variables=variables, jlogs=jlogs, jpreds=jpreds, mut=mut,
        logs=logs, preds=preds, bev=captured[0], diag=diag,
        grads={k: p.grad for k, p in det.named_parameters()},
        ref_grads=_as_parameters(tmc, convert.from_jax_variables(
            {'params': jax.tree_util.tree_map(np.asarray, jgrads)}, tmc)),
        stats={k: b for k, b in det.state_dict().items()
               if k.endswith(('running_mean', 'running_var'))},
        ref_stats=convert.from_jax_variables(
            {'batch_stats': jax.tree_util.tree_map(np.asarray,
                                                   mut['batch_stats'])},
            tmc),
        sparse={f'{n}.weight' for n, m in det.named_modules()
                if isinstance(m, _SparseConv)})


def _as_parameters(tmc, tensors):
    """State_dict-layout tensors (spconv2 sparse kernels) -> the
    parameters' layout ([K, C, D]), by loading them into a detector."""
    det = apis.init_anchor_detector(tmc, device='cpu').model
    missing, unexpected = det.load_state_dict(tensors, strict=False)
    assert not unexpected
    return {k: p.detach() for k, p in det.named_parameters()}


def cosine(a, b):
    return float(torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0))


def test_head_maps_match_gga_tpu(detector):
    for key in ('cls', 'reg', 'dir'):
        np.testing.assert_allclose(detector['preds'][key].detach().numpy(),
                                   np.asarray(detector['jpreds'][key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize('term', TERMS)
def test_loss_terms_match_gga_tpu(detector, term):
    assert float(detector['jlogs']['num_pos']) >= 3 * B
    np.testing.assert_allclose(float(detector['logs'][term].detach()),
                               float(detector['jlogs'][term]), rtol=1e-4)


def test_gradients_match_gga_tpu(detector):
    grads, ref = detector['grads'], detector['ref_grads']
    assert set(grads) == set(ref)
    worst = min((cosine(grads[k], ref[k]), k) for k in grads)
    assert worst[0] >= 0.9999, worst


def test_bn_statistics_updates_match_gga_tpu(detector):
    ref, stats = detector['ref_stats'], detector['stats']
    assert set(ref) == set(stats) and len(ref) >= 20
    for key, r in ref.items():
        np.testing.assert_allclose(stats[key].numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=key)


def test_sparse_encoder_matches_gga_tpu(detector):
    """SECOND's conv_module encoder: the BEV map, the occupancy and every
    sparse weight's gradient (12 convs)."""
    if detector['kind'] != 'second':
        assert not detector['sparse']           # PointPillars has none
        return
    ref = np.asarray(detector['mut']['intermediates']['SparseEncoder_0'][
        '__call__'][0])
    bev = detector['bev'].detach().permute(0, 2, 3, 1).numpy()
    assert bev.shape == ref.shape == (B, 50, 44, 256)
    np.testing.assert_allclose(bev, ref, rtol=1e-4, atol=1e-4)
    occ = detector['mut']['diagnostics']['SparseEncoder_0']
    assert set(occ) == {'occupancy_out'} and set(detector['diag']) == {
        'occupancy_out'}
    assert float(detector['diag']['occupancy_out']) == float(
        occ['occupancy_out'][0])
    assert len(detector['sparse']) == 12
    for key in detector['sparse']:
        c = cosine(detector['grads'][key], detector['ref_grads'][key])
        assert c >= 0.9999, (key, c)


def _from_torch_layout(tr, x):
    """Inverse of ``convert._to_torch_layout``."""
    if tr.startswith('sparse3d'):
        _, i_ch, o_ch = tr.split(':')
        return x.transpose(1, 2, 3, 4, 0).reshape(-1, int(i_ch), int(o_ch))
    if tr == 'conv2d':
        return x.transpose(2, 3, 1, 0)
    if tr == 'deconv2d':
        return x.transpose(2, 3, 0, 1)[::-1, ::-1]
    if tr == 'linear':
        return x.T
    return x


def to_jax_variables(state_dict, cfg):
    """The port's state_dict -> gga_tpu's variable trees."""
    out = {'params': {}, 'batch_stats': {}}
    for tk, coll, fp, tr in convert.rules_of(cfg):
        node = out[coll]
        *scopes, leaf = fp.split('/')
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = np.ascontiguousarray(
            _from_torch_layout(tr, state_dict[tk].numpy()))
    return out


def test_conversion_round_trip(detector):
    tmc, variables = detector['tmc'], detector['variables']
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


def test_tiny_cli_matches_gga_tpu(kitti, models, tmp_path):
    """Two CLI steps of 2 scenes (one step an epoch): the log, the lr of
    each step, a checkpoint each epoch, and the first loss against
    gga_tpu's step on its first batch from the CLI's initial weights."""
    root, cfg_path = kitti
    _, _, tmc, step, _ = models['second']
    work = str(tmp_path / 'work')
    summ = train_supervised.main([cfg_path, '--work-dir', work,
                                  '--max-steps', '2', '--device', 'cpu'])
    assert summ['steps'] == 2 and summ['steps_per_epoch'] == 1
    with open(os.path.join(work, 'train_log.jsonl')) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln['step'] for ln in lines] == [1, 2]
    assert [ln['epoch'] for ln in lines] == [0, 1]
    keys = {'loss', 'loss_cls', 'loss_bbox', 'loss_dir', 'num_pos', 'step',
            'epoch', 'scenes_per_sec'}
    assert keys <= set(lines[0]), set(lines[0])
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
    (_, (jlogs, _, _)), _ = step(jvars['params'], jvars['batch_stats'],
                                 batch)
    for term in TERMS:
        np.testing.assert_allclose(lines[0][term], float(jlogs[term]),
                                   rtol=1e-4, err_msg=term)
