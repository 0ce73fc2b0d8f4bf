"""The port's supervised CenterPoint detector against gga_tpu's, tiny
configs, f32, CPU.

gga_tpu's ``CenterPointDetector`` variables (shapes from its init, values
drawn with numpy, BN statistics and the DCN offset convs included, so the
deformable taps move off the grid and past the map's edges) reach the port
through ``convert.from_jax_variables``. For the voxel and the pillar
detector, each with and without the DCN head and with and without the
velocity outputs:

- every head output of an eval-mode forward on the same 5-channel clouds
  within rtol 1e-4 + atol 1e-4 (sparse convs, dense convs and their BNs
  summed in f32 in another order);
- the conversion round trip exactly: every tensor of gga_tpu's tree has
  one rule, and the port's state_dict maps back to the same bits.

``decode_centerpoint`` with rotated and with circle NMS on gga_tpu's head
outputs made tie-free by a seeded ramp: the same kept detections, boxes
within 1e-5. The entry points raise without a card unless given 'cpu'.
gga_tpu's forward is jitted once per variant.
"""
import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gga_tpu.models.detectors import centerpoint as jcp
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models.detectors import centerpoint as tcp

from .test_torch_detector import _fill

torch.set_num_threads(1)

B, P = 2, 1024
VARIANTS = list(itertools.product(('voxel', 'pillar'), (False, True),
                                  (False, True)))


def variant_ids(v):
    path, dcn, vel = v
    return f'{path}-{"dcn" if dcn else "sep"}-{"vel" if vel else "novel"}'


def configs(path, dcn, vel):
    """(gga_tpu config, port config) of a tiny variant: the pillar one on
    the tiny voxel config's 64 x 64 grid of 0.8 m pillars, three SECOND
    stages and the pillar configs' neck strides (0.5, 1, 2)."""
    kw = dict(dcn_head=dcn, with_velocity=vel)
    if not vel:
        kw['code_weights'] = (1.0,) * 8
    if path == 'pillar':
        kw.update(pillar=True, voxel_size=(0.8, 0.8, 8.0),
                  max_points_per_voxel=8, scatter_shape=(64, 64),
                  pfn_channels=(16,), backbone_channels=(8, 16, 16),
                  backbone_layers=(1, 1, 1), backbone_strides=(2, 2, 2),
                  neck_channels=(8, 8, 8), neck_strides=(0.5, 1, 2),
                  out_size_factor=4)
    return (dataclasses.replace(jcp.CenterPointConfig.tiny(), **kw),
            dataclasses.replace(tcp.CenterPointConfig.tiny(), **kw))


def clouds(seed=0):
    """B clouds of P (x, y, z, intensity, time lag) points: ground,
    clutter and four car-sized clusters."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-25, 25, (B, P, 2)),
                          rng.uniform(-4.5, 2.5, (B, P, 1)),
                          rng.rand(B, P, 1),
                          rng.choice(np.arange(10) * 0.05, (B, P, 1))],
                         -1).astype(np.float32)
    for b in range(B):
        for g in range(4):
            c = rng.uniform(-18, 18, 2)
            pts[b, g * 60:(g + 1) * 60, :2] = c + rng.uniform(-2, 2, (60, 2))
            pts[b, g * 60:(g + 1) * 60, 2] = rng.uniform(-1.8, -0.3, 60)
    return pts, np.ones((B, P), bool)


def jax_variables(jcfg, pts, valid, seed=0):
    model = jcp.CenterPointDetector(jcfg)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), pts, valid, train=False))
    return model, _fill({c: shapes[c] for c in ('params', 'batch_stats')},
                        np.random.RandomState(seed))


@functools.lru_cache(maxsize=None)
def run_variant(path, dcn, vel):
    """Both packages' eval-mode head outputs of a variant on the same
    clouds and weights."""
    jcfg, tcfg = configs(path, dcn, vel)
    pts, valid = clouds()
    model, variables = jax_variables(jcfg, pts, valid)
    ref = jax.jit(lambda v, p, m: model.apply(v, p, m, train=False))(
        variables, pts, valid)
    bundle = apis.init_centerpoint_detector(
        tcfg, convert.from_jax_variables(variables, tcfg), device='cpu')
    with torch.no_grad():
        out = bundle.model(torch.from_numpy(pts), torch.from_numpy(valid))
    return dict(jcfg=jcfg, tcfg=tcfg, variables=variables, bundle=bundle,
                ref=[{k: np.asarray(v) for k, v in tp.items()} for tp in ref],
                out=out, pts=pts, valid=valid)


@pytest.fixture(scope='module', params=VARIANTS, ids=variant_ids)
def variant(request):
    return run_variant(*request.param)


def test_head_outputs_match_gga_tpu(variant):
    ref, out = variant['ref'], variant['out']
    assert len(out) == len(ref) == 2
    for t, (tp, jp) in enumerate(zip(out, ref)):
        assert set(tp) == set(jp)
        assert ('vel' in tp) == variant['tcfg'].with_velocity
        for key, v in jp.items():
            np.testing.assert_allclose(tp[key].numpy(), v, rtol=1e-4,
                                       atol=1e-4, err_msg=f'task{t}.{key}')
    hm = ref[0]['heatmap']
    side = 16 if variant['tcfg'].pillar else 8
    assert hm.shape == (B, side, side, 1)
    assert np.abs(hm - hm.mean()).max() > 0.1       # the map varies


def _from_torch_layout(tr, x):
    """Inverse of ``convert._to_torch_layout``."""
    if tr.startswith('sparse3d'):
        _, i_ch, o_ch = tr.split(':')
        return x.transpose(1, 2, 3, 4, 0).reshape(-1, int(i_ch), int(o_ch))
    if tr == 'conv2d':
        return x.transpose(2, 3, 1, 0)
    if tr == 'deconv2d':
        return x.transpose(2, 3, 0, 1)[::-1, ::-1]
    if tr == 'deform2d':
        y = x.transpose(2, 3, 1, 0)
        return y.reshape(-1, *y.shape[2:])
    if tr == 'linear':
        return x.T
    return x


def test_conversion_round_trip(variant):
    tcfg, variables = variant['tcfg'], variant['variables']
    sd = convert.from_jax_variables(variables, tcfg)
    model = apis.init_centerpoint_detector(tcfg, sd, device='cpu').model
    rules = convert.rules_of(tcfg)
    assert len({r[2] for r in rules}) == len(rules) == len(sd)
    back = {'params': {}, 'batch_stats': {}}
    state = model.state_dict()
    for tk, coll, fp, tr in rules:
        node = back[coll]
        *scopes, leaf = fp.split('/')
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = _from_torch_layout(tr, state[tk].numpy())
    flat = jax.tree_util.tree_leaves_with_path(variables)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf, err_msg=str(path))


@pytest.mark.parametrize('nms_type', ['rotated', 'circle'])
def test_decode_matches_gga_tpu(nms_type):
    variant = run_variant('voxel', True, True)
    rng = np.random.RandomState(5)
    maps = []
    for tp in variant['ref']:
        hm = tp['heatmap']
        ramp = rng.permutation(hm.size).reshape(hm.shape) / hm.size * 4 - 2
        maps.append(dict(tp, heatmap=(hm + ramp).astype(np.float32)))
    # circle radii that suppress some of the tiny map's 3.2 m cells
    kw = dict(nms_type=nms_type, nms_min_radius=(12.0, 40.0))
    jcfg = dataclasses.replace(variant['jcfg'], **kw)
    tcfg = dataclasses.replace(variant['tcfg'], **kw)
    ref = jax.jit(lambda p: jcp.decode_centerpoint(jcfg, p))(
        [{k: jnp.asarray(v) for k, v in tp.items()} for tp in maps])
    out = tcp.decode_centerpoint(
        tcfg, [{k: torch.tensor(v) for k, v in tp.items()} for tp in maps])
    assert set(out) == set(ref)
    for key in ('labels', 'valid'):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    for key in ('boxes', 'scores', 'logits'):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    assert out['boxes'].shape[-1] == 9
    assert 0 < out['valid'].sum() < out['valid'].numel()


def test_infer_and_train_entry_points_run_on_cpu():
    _, tcfg = configs('voxel', True, True)
    pts, valid = clouds(1)
    bundle = apis.init_centerpoint_detector(tcfg, device='cpu', seed=2)
    heads = bundle.model.pts_bbox_head.task_heads
    assert all(torch.equal(h.feature_adapt_cls.conv_offset.weight,
                           torch.zeros_like(h.feature_adapt_cls.conv_offset
                                            .weight)) for h in heads)
    hm = heads[0].heatmap[-1].bias
    assert torch.equal(hm, torch.full_like(hm, -2.19))
    out = apis.infer_centerpoint(bundle, pts, valid)
    n = 2 * min(tcfg.post_max_size, tcfg.max_per_task)
    assert out['boxes'].shape == (B, n, 9)
    assert torch.isfinite(out['boxes']).all()


@pytest.mark.parametrize('entry', ['init_centerpoint_detector',
                                   'init_centerpoint_trainer'])
def test_cuda_entry_points_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    _, tcfg = configs('voxel', False, True)
    args = (tcfg,) if entry == 'init_centerpoint_detector' else (tcfg, 10)
    with pytest.raises(RuntimeError, match='CUDA'):
        getattr(apis, entry)(*args)
