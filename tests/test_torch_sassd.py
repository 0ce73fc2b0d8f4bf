"""The port's SASSD against gga_tpu's, f32, CPU.

``SASSDConfig.tiny()``, gga_tpu's variables (initialised at
``train=True``: its ``train=False`` init never creates the auxiliary
branch) reaching the port through ``convert.from_jax_variables``; one
train-mode pass of each package on the two synthetic scenes of
``tests/test_torch_dynamic_voxelnet.py`` (a car, a pedestrian and a
cyclist on anchor centres near the sensor):

- the auxiliary tuple: the voxel-mean xyz at rtol 1e-6 + atol 1e-6, the
  valid mask exactly, ``point_cls`` and ``point_reg`` at rtol 1e-4 +
  atol 1e-4 at 97 % of the points or more, and every point beyond that
  one that two ulps of rounding in the squared distances move as far in
  the port (they interpolate the first three encoder stages at the three
  nearest sites by inverse squared distance, and gga_tpu's distance
  formula cancels most of its digits, so the last bits of its sums,
  which XLA orders by the program around them, decide there;
  ``tests/test_torch_points.py`` holds the neighbours themselves
  exactly);
- ``sassd_aux_loss`` on gga_tpu's own tuple at rtol 1e-6, with boxes
  enlarged and not, and inside the step at rtol 1e-4;
- the head's maps at rtol 1e-4 + atol 1e-4, the loss terms (the anchor
  loss's, the two auxiliary ones and their sum) at rtol 1e-4,
  ``num_pos`` exactly, every parameter's gradient (point_fc, point_cls
  and point_reg included) at cosine >= 0.9999, the BN statistics'
  updates at 1e-4; the conversion round trip exactly;
- eval mode: the head's maps alone, equal to the train-mode weights'
  maps without the branch, and ``apis.infer_anchor`` decodes them;
- the tiny CLI (SASSD, 2 steps of 2 scenes across an epoch boundary):
  the auxiliary losses logged, each step's lr, both checkpoints, and the
  first loss terms equal at rtol 1e-4 to gga_tpu's step body (the anchor
  loss plus ``sassd_aux_loss``, as the port's step sums them) on
  gga_tpu's first batch from the CLI's initial weights.

gga_tpu's step is jitted once; the CLI's batch reuses its compilation.
"""
import jax
import numpy as np
import pytest
import torch

from gga_tpu.models.detectors import sassd as jsassd
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models.detectors import sassd as tsassd
from gga_tpu_torch.ops import points as tpoints

from .test_torch_dynamic_voxelnet import (B, TERMS, anchor_batch,
                                          check_bn_updates, check_gradients,
                                          check_head_maps, check_round_trip,
                                          cli_first_loss_matches, jax_step,
                                          jax_variables, train_pass,
                                          write_config)
from .test_torch_supervised import kitti  # noqa: F401 (the mini KITTI)

torch.set_num_threads(1)

AUX = ('aux_loss_cls', 'aux_loss_reg')


@pytest.fixture(scope='module')
def sassd():
    mc = jsassd.SASSDConfig.tiny()
    model = jsassd.SASSD(mc)
    tmc = tsassd.SASSDConfig.tiny()
    step = jax_step(model, mc, aux=True)
    batch = anchor_batch(tmc.head, (32, 28), ((16, 3), (14, 4), (17, 2)))
    variables = jax_variables(model, batch, train=True)
    run = train_pass(tmc, variables, batch, step)
    run.update(batch=batch, mc=mc, step=step)
    return run


def rounding_sensitive(run, monkeypatch, draws=2, gate=1e-4):
    """[B, V] bool: the points whose ``point_cls`` or ``point_reg`` move by
    more than ``gate`` (absolute, or relative to the value) when each
    squared distance of the three-NN moves by two f32 ulps of
    ``|q|^2 + |s|^2``, the size of the formula's rounding: the order in
    which XLA sums gga_tpu's ``|q|^2 + |s|^2 - 2 q.s`` depends on the
    program around it, and where the nearest site lies within that
    rounding of the point, or the third nearest of the fourth, the
    weights or the sites follow the last bits (gga_tpu itself gives other
    values there standalone than inside its model). A seeded sign per
    entry, ``draws`` draws."""
    tmc = run['tmc']
    det = apis.init_anchor_trainer(
        tmc, 1, convert.from_jax_variables(run['variables'], tmc),
        device='cpu').model.train()
    t = {k: torch.from_numpy(v) for k, v in run['batch'].items()}
    real = tpoints.square_distance

    def aux():
        with torch.no_grad():
            _, (_, _, cls, reg) = det(t['points'], t['points_valid'])
        return torch.cat([cls, reg], -1)

    base = aux()
    gen = torch.Generator().manual_seed(0)

    def noisy(a, b, *args):
        d = real(a, b, *args)
        mag = ((a ** 2).sum(-1)[..., :, None] + (b ** 2).sum(-1)[..., None, :])
        sign = torch.randint(0, 2, d.shape, generator=gen) * 2 - 1
        return torch.where(d < tpoints.BIG, (d + sign * 2.0 ** -22 * mag)
                           .clamp(min=0), d)

    monkeypatch.setattr(tpoints, 'square_distance', noisy)
    moved = torch.zeros(base.shape[:2], dtype=torch.bool)
    for _ in range(draws):
        err = (aux() - base).abs()
        moved |= (err > gate * (1 + base.abs())).any(-1)
    monkeypatch.setattr(tpoints, 'square_distance', real)
    return moved.numpy()


def test_aux_tuple_matches_gga_tpu(sassd, monkeypatch):
    """Point-wise outputs at rtol 1e-4 + atol 1e-4 at 97 % of the points
    or more; every point beyond that moves as far under two ulps of
    rounding in the squared distances (``rounding_sensitive``)."""
    (xyz, valid, cls, reg), ref = sassd['aux'], sassd['jaux']
    np.testing.assert_allclose(xyz.numpy(), np.asarray(ref[0]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref[1]))
    assert int(valid.sum()) > B * 300
    out = torch.cat([cls, reg], -1).detach().numpy()
    r = np.concatenate([np.asarray(ref[2]), np.asarray(ref[3])], -1)
    assert out.shape == r.shape
    apart = (np.abs(out - r) > 1e-4 * (1 + np.abs(r))).any(-1)
    assert apart.mean() <= 0.03, apart.mean()
    sensitive = rounding_sensitive(sassd, monkeypatch)
    assert not (apart & ~sensitive).any(), np.argwhere(apart & ~sensitive)


@pytest.mark.parametrize('enlarge', [1.0, 1.2])
def test_aux_loss_equals_gga_tpu(sassd, enlarge):
    """The port's ``sassd_aux_loss`` on gga_tpu's tuple and boxes."""
    ref_aux, batch = sassd['jaux'], sassd['batch']
    ref = jax.jit(jsassd.sassd_aux_loss, static_argnums=3)(
        ref_aux, batch['gt_boxes'], batch['gt_valid'], enlarge)
    out = tsassd.sassd_aux_loss(
        tuple(torch.from_numpy(np.array(a)) for a in ref_aux),
        torch.from_numpy(batch['gt_boxes']),
        torch.from_numpy(batch['gt_valid']), enlarge)
    # the points inside the boxes: both terms are live
    pts = np.asarray(ref_aux[0])
    inside = jax.vmap(lambda q, b: jsassd.points_in_rbbox(q, b))(
        pts, batch['gt_boxes'][:, :3])
    assert int(np.asarray(inside).any(-1).sum()) > 50
    for key in AUX:
        assert float(ref[key]) > 0
        np.testing.assert_allclose(float(out[key]), float(ref[key]),
                                   rtol=1e-6, err_msg=key)


def test_head_maps_match_gga_tpu(sassd):
    check_head_maps(sassd)


@pytest.mark.parametrize('term', TERMS + AUX)
def test_loss_terms_match_gga_tpu(sassd, term):
    assert float(sassd['jlogs']['num_pos']) >= 3 * B
    np.testing.assert_allclose(float(sassd['logs'][term].detach()),
                               float(sassd['jlogs'][term]), rtol=1e-4)


def test_gradients_match_gga_tpu(sassd):
    check_gradients(sassd)
    aux = [k for k in sassd['grads'] if k.startswith('middle_encoder.point')]
    assert sorted(aux) == ['middle_encoder.point_cls.weight',
                           'middle_encoder.point_fc.weight',
                           'middle_encoder.point_reg.weight']


def test_bn_statistics_updates_match_gga_tpu(sassd):
    check_bn_updates(sassd, 30)


def test_conversion_round_trip(sassd):
    check_round_trip(sassd['tmc'], sassd['variables'])


def test_eval_mode_drops_the_aux_branch(sassd):
    tmc, batch = sassd['tmc'], sassd['batch']
    bundle = apis.init_anchor_detector(
        tmc, convert.from_jax_variables(sassd['variables'], tmc),
        device='cpu')
    pts = torch.from_numpy(batch['points'])
    val = torch.from_numpy(batch['points_valid'])
    with torch.no_grad():
        preds = bundle.model(pts, val)
        bev = bundle.model.extract_bev(pts, val)
    assert isinstance(preds, dict) and isinstance(bev, torch.Tensor)
    # the same maps through SECOND's path, from the same weights
    with torch.no_grad():
        plain = bundle.model.head(bev)
    for key in ('cls', 'reg', 'dir'):
        assert torch.equal(preds[key], plain[key])
    out = apis.infer_anchor(bundle, batch['points'], batch['points_valid'])
    assert out['boxes'].shape == (B, 3 * tmc.head.max_num, 7)


def test_sassd_cli_matches_gga_tpu(kitti, sassd, tmp_path):  # noqa: F811
    root = kitti[0]
    path = write_config(root, 'sassd_tiny.py',
                        'sassd/sassd_6x8_80e_kitti-3d-3class.py',
                        sassd['tmc'])
    lines = cli_first_loss_matches(root, path, sassd['tmc'], sassd['step'],
                                   tmp_path, extra_keys=AUX)
    for ln in lines:
        assert np.isclose(ln['loss'], ln['loss_cls'] + ln['loss_bbox']
                          + ln['loss_dir'] + ln['aux_loss_cls']
                          + ln['aux_loss_reg'], rtol=1e-5)
