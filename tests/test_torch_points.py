"""The port's point ops, box membership and smooth-L1 against gga_tpu's,
on seeded numpy inputs, CPU:

- ``three_nn``: the squared distances and indices of the three nearest
  sites equal gga_tpu's exactly (``jax.lax.top_k`` keeps the lower index
  first among equal distances; the port's top-k of (distance, index)
  keys does the same), on voxel-mean-like queries against voxel centres,
  with a grid of supports that puts exact ties at every query, with
  invalid supports, with fewer than three valid supports, and with the
  queries taken in blocks of 64 rows;
- ``three_interpolate`` at rtol 1e-5 + atol 1e-6 on those neighbours, and
  its gradient with respect to the features (the only one that flows) at
  rtol 1e-5 + 1e-6 of its largest entry;
- ``points_in_rbbox`` exactly (faces included), on points on and about
  the faces of rotated boxes, against gga_tpu run op by op; jitted,
  gga_tpu's answer may differ only within 1e-5 m of a face (XLA fuses a
  product and a sum into one rounding);
- ``smooth_l1_loss`` at rtol 1e-6 on both sides of beta.

gga_tpu's functions are jitted once per case (vmapped over the batch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gga_tpu.core import geometry as jgeom
from gga_tpu.models import losses as jlosses
from gga_tpu.ops import points as jpoints
from gga_tpu_torch.core import geometry as tgeom
from gga_tpu_torch.models import losses as tlosses
from gga_tpu_torch.ops import points as tpoints

torch.set_num_threads(1)


def _clouds(kind, seed=0):
    """(queries [2, 300, 3], supports [2, 200, 3], support valid [2, 200]):
    queries spread over SECOND's range (voxel means), supports the
    centres of 0.05 m voxels near them."""
    rng = np.random.RandomState(seed)
    q = rng.uniform([0, -40, -3], [70.4, 40, 1], (2, 300, 3))
    near = q[:, rng.randint(0, 300, 200)]
    s = (np.floor(near / 0.05) + 0.5 + rng.randint(-2, 3, (2, 200, 3))) * 0.05
    sv = np.ones((2, 200), bool)
    if kind == 'ties':
        # a 5 x 5 x 2 grid of unit spacing, each query at the centre of a
        # cell of it: eight supports at one distance
        g = np.stack(np.meshgrid(np.arange(5), np.arange(5), np.arange(2),
                                 indexing='ij'), -1).reshape(-1, 3)
        s[:, :50] = g
        q[:, :16] = g[(g[:, 0] < 4) & (g[:, 1] < 4) & (g[:, 2] < 1)] + 0.5
    elif kind == 'invalid':
        sv = rng.rand(2, 200) < 0.6
    elif kind == 'few':
        sv[0, 2:] = False            # two valid sites: the third is BIG
        sv[1, 3:] = False
    return (q.astype(np.float32), s.astype(np.float32), sv)


@pytest.mark.parametrize('kind', ['spread', 'ties', 'invalid', 'few'])
@pytest.mark.parametrize('block', [tpoints.QUERY_BLOCK, 64])
def test_three_nn_equals_gga_tpu(kind, block, monkeypatch):
    q, s, sv = _clouds(kind)
    ref_d, ref_i = map(np.asarray, jax.jit(jax.vmap(
        lambda a, b, v: jpoints.three_nn(a, b, s_valid=v)))(q, s, sv))
    monkeypatch.setattr(tpoints, 'QUERY_BLOCK', block)
    d, i = tpoints.three_nn(torch.from_numpy(q), torch.from_numpy(s),
                            torch.from_numpy(sv))
    np.testing.assert_array_equal(i.numpy(), ref_i)
    np.testing.assert_array_equal(d.numpy(), ref_d)
    if kind == 'ties':
        # the eight equal distances: the three lowest indices, in order
        assert (ref_d[:, :16, 0] == ref_d[:, :16, 2]).all()
        assert (np.diff(ref_i[:, :16], axis=-1) > 0).all()


@pytest.mark.parametrize('kind', ['spread', 'ties', 'few'])
def test_three_interpolate_and_its_gradient_match_gga_tpu(kind):
    q, s, sv = _clouds(kind, seed=1)
    f = np.random.RandomState(2).randn(2, 200, 6).astype(np.float32)
    ct = np.random.RandomState(3).randn(2, 300, 6).astype(np.float32)
    ref_d, ref_i = jax.jit(jax.vmap(
        lambda a, b, v: jpoints.three_nn(a, b, s_valid=v)))(q, s, sv)

    def interp(feat):
        out = jax.vmap(jpoints.three_interpolate)(feat, ref_i, ref_d)
        return jnp.sum(out * ct), out

    (_, ref), ref_g = jax.jit(jax.value_and_grad(interp, has_aux=True))(f)
    d, i = tpoints.three_nn(torch.from_numpy(q), torch.from_numpy(s),
                            torch.from_numpy(sv))
    tf = torch.from_numpy(f).requires_grad_()
    out = tpoints.three_interpolate(tf, i, d)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    # a site's gradient sums over every query that reaches it, in another
    # order: within 1e-6 of the largest
    ref_g = np.asarray(ref_g)
    np.testing.assert_allclose(tf.grad.numpy(), ref_g, rtol=1e-5,
                               atol=1e-6 * np.abs(ref_g).max())


def test_points_in_rbbox_equals_gga_tpu():
    rng = np.random.RandomState(4)
    boxes = np.stack([rng.uniform(5, 40, 6), rng.uniform(-10, 10, 6),
                      rng.uniform(-2, -1, 6), rng.uniform(0.5, 4, 6),
                      rng.uniform(0.5, 2, 6), rng.uniform(1, 2, 6),
                      rng.uniform(-np.pi, np.pi, 6)], 1)
    boxes[0, 6] = 0.0                      # axis-aligned: points on faces
    # points about each box: its corners' neighbourhood and its faces
    local = rng.uniform(-0.7, 0.7, (6, 80, 3))
    local[:, :20, 0] = 0.5 * np.sign(local[:, :20, 0])
    c, s_ = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    x = local[..., 0] * boxes[:, None, 3]
    y = local[..., 1] * boxes[:, None, 4]
    pts = np.stack([x * c[:, None] - y * s_[:, None] + boxes[:, None, 0],
                    x * s_[:, None] + y * c[:, None] + boxes[:, None, 1],
                    (local[..., 2] + 0.5) * boxes[:, None, 5]
                    + boxes[:, None, 2]], -1).reshape(-1, 3)
    pts = np.concatenate([pts, rng.uniform(-1, 1, (480, 1))], -1)
    pts, boxes = pts.astype(np.float32), boxes.astype(np.float32)
    ref = np.asarray(jgeom.points_in_rbbox(pts, boxes))
    out = tgeom.points_in_rbbox(torch.from_numpy(pts), torch.from_numpy(boxes))
    assert 100 < ref.sum() < 400
    np.testing.assert_array_equal(out.numpy(), ref)
    # jitted, XLA may fuse a product and a sum into one rounding: then the
    # two disagree only on points within a few f32 ulps of a face
    jitted = np.asarray(jax.jit(jgeom.points_in_rbbox)(pts, boxes))
    p64, b64 = pts[:, None, :3].astype(np.float64), boxes.astype(np.float64)
    rel = p64 - (b64[:, :3] + b64[:, 3:6] * [0, 0, 0.5])
    co, si = np.cos(b64[:, 6]), np.sin(b64[:, 6])
    frame = np.stack([rel[..., 0] * co + rel[..., 1] * si,
                      -rel[..., 0] * si + rel[..., 1] * co, rel[..., 2]], -1)
    to_face = np.abs(np.abs(frame) - b64[:, 3:6] / 2).min(-1)
    assert (to_face[jitted != ref] < 1e-5).all()
    # batched as the aux loss calls it
    out2 = tgeom.points_in_rbbox(torch.from_numpy(pts).reshape(2, 240, 4),
                                 torch.from_numpy(boxes)[None].expand(2, 6, 7))
    np.testing.assert_array_equal(out2.reshape(480, 6).numpy(), ref)


@pytest.mark.parametrize('beta', [1 / 9., 1.0])
def test_smooth_l1_loss_equals_gga_tpu(beta):
    rng = np.random.RandomState(5)
    pred = rng.randn(400).astype(np.float32) * 0.5
    target = rng.randn(400).astype(np.float32) * 0.5
    ref = np.asarray(jax.jit(jlosses.smooth_l1_loss, static_argnums=2)(
        pred, target, beta))
    out = tlosses.smooth_l1_loss(torch.from_numpy(pred),
                                 torch.from_numpy(target), beta)
    d = np.abs(pred - target)
    assert (d < beta).any() and (d >= beta).any()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
