"""The port's ImVoteNet against gga_tpu's, ``ImVoteNetConfig.tiny()``,
f32, CPU: VoteNet's test scene moved 5 m down the camera's axis (B = 2 x
1024 points with the height channel) with eight boxes on a grid, seeded
uint8 images of 96 x 128, a pinhole ``depth2img``, and as 2D boxes each
box's projection (confidence 1, its class) plus seeded distractors (one
of them invalid).

gga_tpu's variables (shapes from ``jax.eval_shape`` of its init, values
drawn with numpy) reach the port through ``convert.from_jax_variables``
(mmdet3d's names: ``pts_backbone``, ``img_mlp.mlp``,
``pts_bbox_head_{joint,pts,img}``). The seed sampling's draw is gga_tpu's
``jax.random.uniform`` of each scene's key, given to the port. Both
packages then run:

- ``vote_fusion`` on the scenes' points: the pixel each seed projects to
  exactly where the projection is at least 1e-3 of a pixel from a .5
  boundary (the rest, where the two packages' roundings of the same
  product may part, are counted and must be few), and on those seeds
  the masks exactly and the cues at 1e-5 of their largest entry;
  ``sample_valid_seeds`` on the result exactly;
- the eval-mode forward (the joint tower) and the train-mode forward
  (the three towers): the backbone's farthest point sampling, the
  sampled seeds and the towers' aggregations exactly, every output at
  1e-5 of its largest entry in eval mode, 1e-4 in train mode (batch
  statistics);
- each tower's ``build_targets`` on its predictions at 1e-5, every loss
  term at rtol 1e-4, ``decode_imvotenet`` at 1e-5 with some proposals
  suppressed;
- one ``imvotenet_train_step`` against ``value_and_grad`` of gga_tpu's
  loss with the 3x schedule's optimizer: the logs at rtol 1e-4, each
  gradient at 1e-4 of the model's largest gradient entry, the weights
  after the step as ``test_torch_groupfree3d.py`` holds them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gga_tpu.models.dense_heads import vote_head as jvh
from gga_tpu.models.detectors import imvotenet as jdet
from gga_tpu.models.fusion_layers import vote_fusion as jvf
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models.dense_heads import vote_head as tvh
from gga_tpu_torch.models.detectors import imvotenet as tdet
from gga_tpu_torch.models.fusion_layers import vote_fusion as tvf
from tests.test_torch_groupfree3d import (check_grads, fps_chain, optax_step,
                                          step_pass, update_within, walk)
from tests.test_torch_h3dnet import grid_objects
from tests.test_torch_ssd3d import close, fill, t
from tests.test_torch_votenet import B, scene

torch.set_num_threads(1)

OPTIMIZER = apis.VOTENET_OPTIMIZER
SPE = 10
H, W = 96, 128
DISTRACTORS = 4
TOWERS = ('joint', 'pts', 'img')


def depth2img(f=80.0, cx=64.0, cy=48.0):
    """A pinhole camera at the origin looking down +y (depth x right, z
    up): u = f x / y + cx, v = cy - f z / y."""
    k = np.zeros((4, 4), np.float32)
    k[0] = [f, cx, 0, 0]
    k[1] = [0, cy, -f, 0]
    k[2] = [0, 1, 0, 0]
    k[3] = [0, 0, 0, 1]
    return np.tile(k, (B, 1, 1))


def image_inputs(gt, labels, d2i, seed=4):
    """(images [B, H, W, 3] uint8, boxes_2d [B, M + DISTRACTORS, 6],
    boxes_valid): each box's projection (its corners' extent, confidence
    1, its class), then seeded distractors, the last one invalid."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    M = gt.shape[1]
    boxes = np.zeros((B, M + DISTRACTORS, 6), np.float32)
    for b in range(B):
        for i in range(M):
            x, y, z, dx, dy, dz = gt[b, i, :6]
            c = np.array([[x + sx * dx / 2, y + sy * dy / 2, z + h * dz, 1.0]
                          for sx in (-1, 1) for sy in (-1, 1)
                          for h in (0, 1)])
            uvz = c @ d2i[b].T
            uv = uvz[:, :2] / uvz[:, 2:3]
            boxes[b, i, :4] = [*uv.min(0), *uv.max(0)]
            boxes[b, i, 4:] = [1.0, labels[b, i]]
    lo = rng.uniform(0, [W - 30, H - 30], (B, DISTRACTORS, 2))
    boxes[:, M:, :2] = lo
    boxes[:, M:, 2:4] = lo + rng.uniform(10, 30, (B, DISTRACTORS, 2))
    boxes[:, M:, 4] = rng.uniform(0.2, 0.9, (B, DISTRACTORS))
    boxes[:, M:, 5] = rng.randint(0, 4, (B, DISTRACTORS))
    valid = np.ones((B, M + DISTRACTORS), bool)
    valid[:, -1] = False
    return img, boxes, valid


def inputs_of(cfg):
    pts, val = scene()
    pts[..., 1] += 5.0
    gt, labels, gv = grid_objects(cfg.head.max_objs)
    gt[..., 1] += 5.0
    d2i = depth2img()
    img, boxes, bv = image_inputs(gt, labels, d2i)
    return pts, val, img, boxes, bv, d2i, gt, labels, gv


@pytest.fixture(scope='module')
def setup():
    cfg = jdet.ImVoteNetConfig.tiny()
    model = jdet.ImVoteNet(cfg)
    inputs = inputs_of(cfg)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda *a: model.init(
        key, *a, rng=key, train=True), *inputs[:6])
    rng = np.random.RandomState(1)
    variables = {c: fill(shapes[c], rng) for c in ('params', 'batch_stats')}
    # gga_tpu's draw: jax.random.uniform of each scene's key
    n = cfg.num_points[1] * cfg.fusion.max_imvote_per_pixel
    u = np.stack([np.asarray(jax.random.uniform(k, (n,)))
                  for k in jax.random.split(key, B)])
    return cfg, model, variables, inputs, key, u, tdet.ImVoteNetConfig.tiny()


def _decode_cfg(cfg):
    """A slot for every proposal."""
    return dataclasses.replace(cfg, head=dataclasses.replace(
        cfg.head, max_out=cfg.head.agg_num_point))


@pytest.fixture(scope='module')
def train_pass(setup):
    """gga_tpu's fusion on the points, eval forward, sampling, targets,
    decode, train-mode loss, gradient and one optax step, in one jit; the
    port's ``imvotenet_train_step`` from the same weights and draw."""
    cfg, model, variables, inputs, key, u, tcfg = setup
    tx = optax_step(OPTIMIZER, SPE)

    def step(params, stats, pts, pv, img, boxes, bv, d2i, gt, gl, gv):
        def loss_fn(p):
            towers, upd = model.apply(
                {'params': p, 'batch_stats': stats}, pts, pv, img, boxes, bv,
                d2i, rng=key, train=True, mutable=['batch_stats'])
            total, logs = jdet.imvotenet_loss(cfg, towers, pts, pv, gt, gl,
                                              gv)
            return total, (logs, towers, upd['batch_stats'])

        (_, (logs, towers, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        logs['grad_norm'] = optax.global_norm(grads)
        joint, = model.apply({'params': params, 'batch_stats': stats}, pts,
                             pv, img, boxes, bv, d2i, rng=key, train=False)
        targets = [jax.vmap(lambda *a: jvh.build_targets(cfg.head, *a))(
            tw['seed_xyz'], tw['seed_valid'], tw['agg_xyz'], tw['agg_valid'],
            gt, gl, gv) for tw in towers]
        moved = dict(joint, center=joint['center'].at[:, 1::2].set(
            joint['center'][:, ::2] + 0.05))
        decoded = jdet.decode_imvotenet(_decode_cfg(cfg), moved)
        # the fusion on the points themselves, their projection, and the
        # seed sampling on its mask
        seeds = pts[:, :300, :3]
        cues, mask = jax.vmap(lambda *a: jvf.vote_fusion(cfg.fusion, *a))(
            img, boxes, bv, seeds, pv[:, :300], d2i)
        hom = jnp.concatenate([seeds, jnp.ones_like(seeds[..., :1])], -1)
        uvz = jnp.einsum('bij,bsj->bsi', d2i, hom)
        raw = uvz[..., :2] / jnp.maximum(uvz[..., 2:3], jvf.EPS) - 1
        picked = jax.vmap(lambda m, k: jvf.sample_valid_seeds(m, 200, k))(
            mask, jax.random.split(key, B))
        return (logs, towers, grads, optax.apply_updates(params, updates),
                new_stats, joint, targets, decoded,
                fps_chain(pts[..., :3], pv, cfg.num_points),
                (cues, mask, raw, picked))

    (jlogs, jtowers, jgrads, jparams, jstats, jeval, jtargets, jdecoded,
     jfps, jfusion) = jax.tree_util.tree_map(np.asarray, jax.jit(step)(
         variables['params'], variables['batch_stats'], *inputs))
    trainer = apis.init_imvotenet_trainer(
        tcfg, SPE, convert.from_jax_variables(variables, tcfg), device='cpu')
    batch = dict(zip(('points', 'points_valid', 'img', 'boxes_2d',
                      'boxes_valid', 'depth2img', 'gt_boxes', 'gt_labels',
                      'gt_valid'), inputs))
    logs, towers, grads = step_pass(
        trainer, lambda: apis.imvotenet_train_step(trainer, batch,
                                                   seed_u=t(u)))
    return dict(jlogs=jlogs, jtowers=jtowers, jeval=jeval, jtargets=jtargets,
                jdecoded=jdecoded, jfps=jfps, jfusion=jfusion, logs=logs,
                towers=towers, indices=trainer.model.sampled_indices(),
                grads=grads,
                ref_grads=convert.from_jax_variables({'params': jgrads},
                                                     tcfg),
                state=trainer.model.state_dict(),
                ref_state=convert.from_jax_variables(
                    {'params': jparams, 'batch_stats': jstats}, tcfg))


def test_conversion_loads_strictly(setup):
    variables, tcfg = setup[2], setup[-1]
    sd = convert.from_jax_variables(variables, tcfg)
    model = tdet.ImVoteNet(tcfg)
    assert set(model.state_dict()) == set(sd)
    n_flax = sum(v.size for c in variables.values()
                 for v in jax.tree_util.tree_leaves(c))
    assert sum(v.numel() for v in sd.values()) == n_flax
    model.load_state_dict(sd)
    # each tower's vote module takes its own width: 16 + 16, 16, 16
    assert [tuple(sd[f'pts_bbox_head_{n}.vote_module.conv_out.weight'].shape)
            for n in TOWERS] == [(35, 16, 1), (19, 16, 1), (19, 16, 1)]


def test_vote_fusion_matches_gga_tpu(setup, train_pass):
    cfg, _, _, inputs, _, u, tcfg = setup
    pts, pv, img, boxes, bv, d2i = inputs[:6]
    cues, mask, raw, picked = train_pass['jfusion']
    seeds = t(pts[:, :300, :3])
    uv, _ = tvf.project(seeds, t(d2i))
    away = (np.abs(np.abs(raw - np.floor(raw)) - 0.5) > 1e-3).all(-1)
    assert away.mean() > 0.99, away.mean()
    np.testing.assert_array_equal(uv.numpy()[away], np.round(raw)[away])
    got, got_mask = tvf.vote_fusion(tcfg.fusion, t(img), t(boxes), t(bv),
                                    seeds, t(pv[:, :300]), t(d2i))
    K = cfg.fusion.max_imvote_per_pixel
    rows = np.repeat(away, K, axis=1)
    np.testing.assert_array_equal(got_mask.numpy()[rows], mask[rows])
    close(got[torch.from_numpy(rows)], cues[rows], 1e-5, 'cues')
    assert 0 < mask.sum() < mask.size
    # the texture cue: the pixel under the seed, over 255
    px = np.clip(np.round(raw), 0, [W - 1, H - 1]).astype(int)
    b = np.arange(B)[:, None]
    np.testing.assert_array_equal(
        got.numpy().reshape(B, 300, K, -1)[:, :, 0, -3:][away],
        (img[b, px[..., 1], px[..., 0]] / np.float32(255.0))[away])
    draw = np.stack([np.asarray(jax.random.uniform(k, (300 * K,)))
                     for k in jax.random.split(setup[4], B)])
    np.testing.assert_array_equal(
        tvf.sample_valid_seeds(t(mask), 200, t(draw)).numpy(), picked)


def test_eval_forward_matches_gga_tpu(setup, train_pass):
    _, _, variables, inputs, _, u, tcfg = setup
    bundle = apis.init_imvotenet_detector(
        tcfg, convert.from_jax_variables(variables, tcfg), device='cpu')
    with torch.no_grad():
        got, = bundle.model(*map(t, inputs[:6]), t(u))
    walk(got, train_pass['jeval'], 1e-5)
    idx = bundle.model.sampled_indices()
    for g, r in zip(idx['backbone'], train_pass['jfps']):
        np.testing.assert_array_equal(g.numpy(), r)
    assert set(idx) == {'backbone', 'seeds', 'joint'}


def test_train_forward_matches_gga_tpu(train_pass):
    """At 1e-4 of each output's largest entry (batch statistics)."""
    walk(list(train_pass['towers']), list(train_pass['jtowers']), 1e-4)
    idx = train_pass['indices']
    for g, r in zip(idx['backbone'], train_pass['jfps']):
        np.testing.assert_array_equal(g.numpy(), r)
    assert set(idx) == {'backbone', 'seeds', *TOWERS}


def test_sampled_indices_are_given_back(setup):
    _, _, variables, inputs, _, u, tcfg = setup
    model = tdet.ImVoteNet(tcfg)
    model.load_state_dict(convert.from_jax_variables(variables, tcfg))
    model.eval()
    args = (*map(t, inputs[:6]), t(u))
    with torch.no_grad():
        first, = model(*args)
        idx = model.sampled_indices()
        again, = model(*args, sample_idx=idx)
        walk(again, first, 0.0)
        other, = model(*args, sample_idx=dict(
            idx, seeds=torch.flip(idx['seeds'], [-1])))
    assert not torch.equal(other['seed_xyz'], first['seed_xyz'])


@pytest.mark.parametrize('tower', range(3))
def test_targets_match_gga_tpu(setup, train_pass, tower):
    _, _, _, inputs, _, _, tcfg = setup
    tw = train_pass['jtowers'][tower]
    got = tvh.build_targets(tcfg.head, *(t(tw[k]) for k in (
        'seed_xyz', 'seed_valid', 'agg_xyz', 'agg_valid')),
        *map(t, inputs[6:]))
    walk(got, train_pass['jtargets'][tower], 1e-5)


def test_loss_terms_match_gga_tpu(setup, train_pass):
    _, _, _, inputs, _, _, tcfg = setup
    # the train step's logs are gga_tpu's loss of these towers
    ref = {k: v for k, v in train_pass['jlogs'].items() if k != 'grad_norm'}
    towers = [jax.tree_util.tree_map(t, tw) for tw in train_pass['jtowers']]
    _, got = tdet.imvotenet_loss(tcfg, towers, *map(t, inputs[6:]))
    assert set(got) == set(ref)
    assert float(got['num_pos']) > 0
    for term in ref:
        np.testing.assert_allclose(float(got[term]), float(ref[term]),
                                   rtol=1e-4, err_msg=term)


def test_decode_matches_gga_tpu(setup, train_pass):
    tcfg = setup[-1]
    joint = {k: np.array(v) for k, v in train_pass['jeval'].items()}
    joint['center'][:, 1::2] = joint['center'][:, ::2] + 0.05
    ref = train_pass['jdecoded']
    got = tdet.decode_imvotenet(_decode_cfg(tcfg),
                                {k: t(v) for k, v in joint.items()})
    for k in ('labels', 'valid'):
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    for k in ('boxes', 'scores'):
        close(got[k], ref[k], 1e-5, k)
    assert 0 < int(ref['valid'].sum()) < ref['valid'].size


def test_train_step_logs_match_gga_tpu(train_pass):
    ref, got = train_pass['jlogs'], train_pass['logs']
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)


def test_train_step_gradients_match_gga_tpu(train_pass):
    check_grads(train_pass['ref_grads'], train_pass['grads'])


def test_train_step_update_matches_gga_tpu(train_pass):
    update_within(train_pass['ref_state'], train_pass['state'],
                  train_pass['ref_grads'], OPTIMIZER['lr'],
                  OPTIMIZER['weight_decay'])
