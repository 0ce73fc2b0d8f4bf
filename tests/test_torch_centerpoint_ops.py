"""The parts of the port's supervised CenterPoint against gga_tpu's, f32,
CPU, on the same numpy inputs from a seed:

- ``circle_nms``: the keep mask and the ranked indices exactly, batched
  rows against gga_tpu's per row;
- ``deform_sample`` and ``deform_conv2d`` with groups 1 and 4, offsets
  that move taps past the map's edges: within 1e-5 (f32 sums of the same
  products in another order);
- ``centerpoint_targets`` (gga_tpu's ``centerpoint_targets_single``
  batched over scenes, every class map in one heatmap call): ``ind`` and
  ``mask`` exactly, ``anno_box`` within 1e-6, heatmaps within 1e-6 with
  exactly the same pixels at 1.0 (the loss counts positives there);
- ``centerpoint_loss`` and its gradients with respect to every head
  output: rtol 1e-5 plus 1e-5 of the largest entry;
- ``SECONDFPN`` at the pillar configs' upsample strides (0.5, 1, 2), its
  weights through the converter's rules: within 1e-5 of gga_tpu's.

Each gga_tpu function is jitted once.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gga_tpu.core import nms as jnms
from gga_tpu.models.dense_heads import centerpoint_head as jcp
from gga_tpu.models.necks.second_fpn import SECONDFPN as JSECONDFPN
from gga_tpu.ops import deform as jdeform
from gga_tpu_torch import convert
from gga_tpu_torch.core import nms as tnms
from gga_tpu_torch.models.dense_heads import centerpoint_head as tcp
from gga_tpu_torch.models.necks.second_fpn import SECONDFPN
from gga_tpu_torch.ops import deform as tdeform

torch.set_num_threads(1)

TASKS = (1, 2, 2, 1, 2, 2)
VOXEL = (0.1, 0.1, 0.2)
PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
FEAT_HW = (128, 128)          # the 0.1 m voxel configs' head map
CODE_WEIGHTS = (1.0,) * 8 + (0.2, 0.2)


@pytest.mark.parametrize('radius', [4.0, 0.85, 0.175])
def test_circle_nms_matches_gga_tpu(radius):
    rng = np.random.RandomState(int(radius * 100))
    B, N = 3, 64
    centers = rng.uniform(-6, 6, (B, N, 2)).astype(np.float32)
    scores = rng.permutation(B * N).reshape(B, N).astype(np.float32)
    valid = rng.rand(B, N) < 0.8
    ref = jax.jit(jax.vmap(lambda c, s, v: jnms.circle_nms(
        c, s, radius, post_max_size=40, valid=v)))(centers, scores, valid)
    idx, keep = tnms.circle_nms(torch.from_numpy(centers),
                                torch.from_numpy(scores), radius,
                                post_max_size=40,
                                valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[0]))
    assert 0 < keep.sum() < valid.sum()


def _deform_inputs(groups, seed=0):
    rng = np.random.RandomState(seed)
    B, H, W, C, cout = 2, 9, 11, 8, 8 if groups > 1 else 6
    x = rng.randn(B, H, W, C).astype(np.float32)
    # offsets up to 3 cells: many taps sample past the map's edge
    off = rng.uniform(-3, 3, (B, H, W, 18)).astype(np.float32)
    w = rng.randn(9, C // groups, cout).astype(np.float32) * 0.3
    return x, off, w


@pytest.mark.parametrize('groups', [1, 4])
def test_deform_conv2d_matches_gga_tpu(groups):
    x, off, w = _deform_inputs(groups)
    ref_s, ref = jax.jit(lambda a, o, k: (
        jdeform.deform_sample(a, o, 3),
        jdeform.deform_conv2d(a, o, k, 3, groups)))(x, off, w)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ot = torch.from_numpy(off).permute(0, 3, 1, 2)
    # tap-major [9, C / groups, Cout] -> mmcv [Cout, C / groups, 3, 3]
    wt = torch.from_numpy(w.reshape(3, 3, *w.shape[1:]).transpose(3, 2, 0, 1)
                          .copy())
    s = tdeform.deform_sample(xt, ot, 3)
    out = tdeform.deform_conv2d(xt, ot, wt, groups).permute(0, 2, 3, 1)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert (np.asarray(ref_s) == 0).any()    # corners outside read zero


def _gt(seed=0, B=3, M=24):
    """Boxes of the 10 classes at nuScenes sizes, some off the map or on
    its edge, some padding slots; 9-dim (velocity)."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((B, M, 9), np.float32)
    gt[..., 0] = rng.uniform(-56, 56, (B, M))
    gt[..., 1] = rng.uniform(-56, 56, (B, M))
    gt[0, 0, :2] = (-51.2, 51.1)             # first column, last row
    gt[0, 1, :2] = (51.15, -51.2)            # last column
    gt[0, 2, :2] = (51.3, 0.0)               # past it
    gt[..., 2] = rng.uniform(-2.5, 0.5, (B, M))
    gt[..., 3] = rng.uniform(0.4, 12.0, (B, M))
    gt[..., 4] = rng.uniform(0.4, 3.0, (B, M))
    gt[..., 5] = rng.uniform(0.8, 3.5, (B, M))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (B, M))
    gt[..., 7:9] = rng.uniform(-8, 8, (B, M, 2))
    labels = rng.randint(0, 10, (B, M)).astype(np.int64)
    valid = rng.rand(B, M) < 0.85
    return gt, labels, valid


def _targets_kwargs():
    return dict(task_classes=TASKS, feat_hw=FEAT_HW, voxel_size=VOXEL,
                pc_range=PC_RANGE, out_size_factor=8, gaussian_overlap=0.1,
                min_radius=2, with_velocity=True)


@pytest.fixture(scope='module')
def targets():
    gt, labels, valid = _gt()
    ref = jax.jit(jax.vmap(lambda b, l, v: jcp.centerpoint_targets_single(
        b, l, v, **_targets_kwargs())))(gt, labels.astype(np.int32), valid)
    out = tcp.centerpoint_targets(torch.from_numpy(gt),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(valid),
                                  **_targets_kwargs())
    return ([{k: np.asarray(v) for k, v in t.items()} for t in ref],
            [{k: v.numpy() for k, v in t.items()} for t in out])


@pytest.mark.parametrize('task', range(len(TASKS)))
def test_targets_match_gga_tpu(targets, task):
    ref, out = targets[0][task], targets[1][task]
    assert set(ref) == set(out)
    np.testing.assert_array_equal(out['mask'], ref['mask'])
    np.testing.assert_array_equal(out['ind'], ref['ind'])
    np.testing.assert_allclose(out['anno_box'], ref['anno_box'], rtol=0,
                               atol=1e-6)
    assert out['heatmap'].shape == ref['heatmap'].shape
    np.testing.assert_allclose(out['heatmap'], ref['heatmap'], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(out['heatmap'] == 1.0,
                                  ref['heatmap'] == 1.0)
    assert (ref['heatmap'] == 1.0).sum() == ref['mask'].sum() > 0


def _preds(seed=1, B=3):
    rng = np.random.RandomState(seed)
    H, W = FEAT_HW
    out = []
    for ncls in TASKS:
        tp = {k: rng.randn(B, H, W, c).astype(np.float32) * s
              for k, c, s in (('reg', 2, 0.5), ('height', 1, 1.0),
                              ('dim', 3, 0.5), ('rot', 2, 1.0),
                              ('vel', 2, 2.0))}
        tp['heatmap'] = (rng.randn(B, H, W, ncls) * 2 - 2).astype(np.float32)
        out.append(tp)
    return out


def test_loss_and_gradients_match_gga_tpu(targets):
    preds = _preds()
    jt = [{k: jnp.asarray(v) for k, v in t.items()} for t in targets[0]]

    def jloss(p):
        return jcp.centerpoint_loss(p, jt, code_weights=CODE_WEIGHTS,
                                    loss_bbox_weight=0.25)

    (ref_total, ref_logs), ref_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(
        [{k: jnp.asarray(v) for k, v in tp.items()} for tp in preds])
    tp_ = [{k: torch.tensor(v, requires_grad=True) for k, v in tp.items()}
           for tp in preds]
    tt = [{k: torch.from_numpy(v) for k, v in t.items()}
          for t in targets[1]]
    total, logs = tcp.centerpoint_loss(tp_, tt, code_weights=CODE_WEIGHTS,
                                       loss_bbox_weight=0.25)
    total.backward()
    assert set(logs) == set(ref_logs)
    for key, v in ref_logs.items():
        np.testing.assert_allclose(logs[key].item(), float(v), rtol=1e-5,
                                   atol=1e-5 * abs(float(ref_total)),
                                   err_msg=key)
    for t, (p, g) in enumerate(zip(tp_, ref_grads)):
        for key, ref in g.items():
            ref = np.asarray(ref)
            np.testing.assert_allclose(
                p[key].grad.numpy(), ref, rtol=1e-5,
                atol=1e-5 * np.abs(ref).max(), err_msg=f'task{t}.{key}')


def test_second_fpn_matches_gga_tpu_below_stride_one():
    """The pillar configs' neck: a 2x2 stride-2 conv at stride 0.5, a 1x1
    at 1, a deconv at 2; every level at the middle level's size."""
    rng = np.random.RandomState(3)
    chans, outs, strides = (8, 12, 16), (6, 6, 6), (0.5, 1, 2)
    xs = [rng.randn(2, 16 // s, 16 // s, c).astype(np.float32)
          for s, c in zip((1, 2, 4), chans)]
    neck = JSECONDFPN(in_channels=chans, out_channels=outs,
                      upsample_strides=strides)
    shapes = jax.eval_shape(lambda: neck.init(jax.random.PRNGKey(0), xs,
                                              train=False))

    def fill(tree):
        if hasattr(tree, 'items'):
            return {k: fill(v) for k, v in tree.items()}
        return rng.uniform(0.5, 1.0, tree.shape).astype(np.float32)

    variables = {c: {'SECONDFPN_0': fill(shapes[c])}
                 for c in ('params', 'batch_stats')}
    ref = jax.jit(lambda v, x: neck.apply(
        {c: v[c]['SECONDFPN_0'] for c in v}, x, train=False))(variables, xs)
    flat = {c: convert._flatten(variables[c]) for c in variables}
    cfg = types.SimpleNamespace(backbone_layers=(), neck_strides=strides)
    sd = {tk: torch.from_numpy(np.ascontiguousarray(
        convert._to_torch_layout(tr, flat[coll][fp])))
        for tk, coll, fp, tr in convert._second_fpn_rules(cfg, 'b', 'neck')}
    port = SECONDFPN(chans, outs, strides)
    port.load_state_dict({k[len('neck.'):]: v for k, v in sd.items()})
    with torch.no_grad():
        out = port.eval()([torch.from_numpy(x).permute(0, 3, 1, 2)
                           for x in xs])
    ref = np.asarray(ref)
    assert ref.shape == (2, 8, 8, 18)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-5, atol=1e-5 * np.abs(ref).max())
