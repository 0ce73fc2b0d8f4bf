"""GGA targets and losses of the port against gga_tpu, tiny head config,
on the CPU.

``build_targets`` is given gga_tpu's own SRL draw (the port takes the
standard-normal sample as an input); ``ind``, ``mask`` and
``boundary_mask`` must then be equal, and the heatmaps and the other
targets equal at atol 1e-6 (two exp implementations). ``loss`` on the
same prediction maps must give the total and every logged term at rtol
1e-5, and the same gradients with respect to the maps at rtol 1e-5 plus
1e-5 of the largest entry (f32 sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gga_tpu.models.dense_heads import centerpoint_head_gga as jgga
from gga_tpu.models.detectors.centerpoint_gga import GGAModelConfig
from gga_tpu_torch.models.dense_heads import centerpoint_head_gga as tgga

torch.set_num_threads(1)

B, M, PC = 2, 16, 32
MAP_KEYS = (('reg', 2), ('height', 1), ('dim', 3), ('rot', 2), ('heatmap', 1))


def _lidar2img():
    """KITTI-like camera: lidar (x fwd, y left, z up) -> camera axes, then
    the intrinsics."""
    axes = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                     [0, 0, 0, 1]], np.float32)
    k = np.array([[721.5, 0, 609.6, 0], [0, 721.5, 172.9, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    return k @ axes


def _batch(seed=0, edge_cases=True):
    """Objects of three tasks and padding. With ``edge_cases`` also a
    centre at x = -1 m that truncation (not floor) keeps in the map, one
    far outside it, and boxes behind the camera (depth clamp); without,
    every object lies 5-65 m ahead, where the projection is smooth."""
    rng = np.random.RandomState(seed)
    n = 12
    labels = np.full((B, M), -1, np.int32)
    labels[:, :n] = rng.randint(0, 3, (B, n))
    valid = np.zeros((B, M), bool)
    valid[:, :n] = rng.rand(B, n) < 0.9
    pseudo = np.zeros((B, M, 7), np.float32)
    pseudo[:, :n, 0] = rng.uniform(0.5 if edge_cases else 5, 70 if
                                   edge_cases else 65, (B, n))
    pseudo[:, :n, 1] = rng.uniform(-39, 39, (B, n))
    pseudo[:, :n, 2] = -1.0
    pseudo[:, :n, 3:5] = rng.uniform(0.5, 4.5, (B, n, 2))
    pseudo[:, :n, 5] = rng.uniform(1.2, 2.0, (B, n))
    pseudo[:, :n, 6] = rng.uniform(-np.pi, np.pi, (B, n))
    if edge_cases:
        pseudo[:, 0, 0] = -1.0                   # truncates into cell 0
        pseudo[:, 1, 0] = -30.0                  # outside the map
        valid[:, :2] = True
    boxes = np.zeros((B, M, 4), np.float32)
    boxes[..., 0] = rng.uniform(0, 600, (B, M))
    boxes[..., 1] = rng.uniform(100, 250, (B, M))
    boxes[..., 2] = boxes[..., 0] + rng.uniform(30, 400, (B, M))
    boxes[..., 3] = boxes[..., 1] + rng.uniform(20, 120, (B, M))
    bdry = rng.rand(B, M, 4) < 0.2
    l2i = np.broadcast_to(_lidar2img(), (B, M, 4, 4)).copy()
    ibp = (pseudo[:, :, None, :2]
           + rng.randn(B, M, PC, 2).astype(np.float32))
    ibp_valid = rng.rand(B, M, PC) < 0.7
    return dict(labels=labels, obj_valid=valid, init_pseudo=pseudo,
                boxes_img=boxes, bdry_masks=bdry, lidar2img=l2i,
                ibp_xy=ibp.astype(np.float32), ibp_valid=ibp_valid)


def _head_cfgs():
    """(gga_tpu config, port config) with the same fields."""
    jcfg = GGAModelConfig.tiny().head
    return jcfg, tgga.GGAHeadConfig(**dataclasses.asdict(jcfg))


_TARGET_KEYS = ('labels', 'obj_valid', 'init_pseudo', 'boxes_img',
                'bdry_masks', 'lidar2img')


def _targets(jcfg, tcfg, b, seed=1):
    key = jax.random.PRNGKey(seed)
    jt = jax.jit(lambda *a: jgga.build_targets(jcfg, key, *a))(
        *(jnp.asarray(b[k]) for k in _TARGET_KEYS))
    # gga_tpu's SRL draw: one normal per scene from each task's key
    draw = np.stack([np.asarray(jax.random.normal(k, (B,)))
                     for k in jax.random.split(key, len(jt))])
    tt = tgga.build_targets(tcfg, torch.from_numpy(draw),
                            *(torch.from_numpy(b[k]) for k in _TARGET_KEYS))
    return jt, tt


def test_build_targets_match_gga_tpu():
    jcfg, tcfg = _head_cfgs()
    b = _batch()
    jt, tt = _targets(jcfg, tcfg, b)
    assert len(jt) == len(tt) == 3
    for t, (j, p) in enumerate(zip(jt, tt)):
        for key in ('ind', 'mask', 'boundary_mask'):
            np.testing.assert_array_equal(p[key].numpy(), np.asarray(j[key]),
                                          err_msg=f'task{t}.{key}')
        for key in ('heatmap', 'anno_box', 'lidar2img', 'yaw'):
            np.testing.assert_allclose(p[key].numpy(), np.asarray(j[key]),
                                       rtol=0, atol=1e-6,
                                       err_msg=f'task{t}.{key}')
        hm = p['heatmap'].numpy()
        np.testing.assert_array_equal(hm == 1.0, np.asarray(j['heatmap'])
                                      == 1.0)
    masks = np.stack([np.asarray(j['mask']) for j in jt])
    assert masks[:, :, 0].any() and not masks[:, :, 1].any()


def _pred_maps(seed, tcfg):
    W, H = tcfg.feature_map_size
    rng = np.random.RandomState(seed)
    maps = []
    for t in range(3):
        m = {k: (rng.randn(B, H, W, c) * 0.5).astype(np.float32)
             for k, c in MAP_KEYS}
        if t == 1:
            m['rot'][:] = 0.0                    # (0, 0): the atan2 guard
        maps.append(m)
    return maps


@pytest.mark.parametrize('variant', ['default', 'pal_in_total', 'anchors'])
def test_loss_and_its_gradients_match_gga_tpu(variant):
    jcfg, tcfg = _head_cfgs()
    extra = dict(default={}, pal_in_total=dict(pal_in_total_loss=True),
                 anchors=dict(task_dim_priors=((0.8, 0.6, 1.73),
                                               (1.76, 0.6, 1.73),
                                               (3.9, 1.6, 1.56)),
                              loss_dim_prior_weight=0.2,
                              loss_yaw_prior_weight=0.3,
                              loss_containment_weight=0.4))[variant]
    jcfg = dataclasses.replace(jcfg, **extra)
    tcfg = dataclasses.replace(tcfg, **extra)
    b = _batch(seed=2)
    jt, tt = _targets(jcfg, tcfg, b)
    maps = _pred_maps(3, tcfg)
    ibp = (jnp.asarray(b['ibp_xy']), jnp.asarray(b['ibp_valid']))

    def jloss(preds):
        return jgga.loss(jcfg, preds, jt, *ibp)

    (jtotal, jlogs), jgrad = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))([{k: jnp.asarray(v) for k, v in m.items()}
                               for m in maps])
    preds = [{k: torch.from_numpy(v).requires_grad_() for k, v in m.items()}
             for m in maps]
    total, logs = tgga.loss(tcfg, preds, tt, torch.from_numpy(b['ibp_xy']),
                            torch.from_numpy(b['ibp_valid']))
    total.backward()
    assert set(logs) == set(jlogs)
    for key, ref in jlogs.items():
        np.testing.assert_allclose(float(logs[key].detach()), float(ref),
                                   rtol=1e-5, err_msg=key)
    # the total sums the 'loss_' terms, and PAL only when asked
    pal = sum(float(v) for k, v in jlogs.items() if '.distance' in k)
    terms = sum(float(v) for k, v in jlogs.items() if '.loss_' in k)
    assert pal > 0 and np.isfinite(float(jtotal))
    np.testing.assert_allclose(
        float(total.detach()),
        terms + (pal if variant == 'pal_in_total' else 0.0), rtol=1e-5)
    for t, (p, g) in enumerate(zip(preds, jgrad)):
        for key, _ in MAP_KEYS:
            ref = np.asarray(g[key])
            assert np.isfinite(p[key].grad.numpy()).all()
            np.testing.assert_allclose(p[key].grad.numpy(), ref, rtol=1e-5,
                                       atol=1e-5 * max(np.abs(ref).max(),
                                                       1e-30),
                                       err_msg=f'task{t}.{key}')
