"""PartA2's ops in the port against gga_tpu's, f32, CPU.

The same numpy inputs go through gga_tpu's functions (each jitted once;
per scene under ``jax.vmap`` where gga_tpu vmaps them) and the port's
batched ones:

- ``rotated_iou_3d`` within atol 5e-5, rtol 1e-5: the tolerance of the
  BEV overlap it multiplies (``tests/test_torch_nms.py``: the shoelace
  area sums products of coordinates of size 10-100 with cancellation, in
  another order than XLA's);
- ``sparse_inverse_conv`` on ``downsample_rulebook_batched``'s maps (the
  same maps in both packages, exactly): the forward within 1e-5 of
  max|out|, both gradients (features, weights) within 2e-5 of their
  largest entry; a pre-downsample row that feeds no kept site through any
  offset comes out zero;
- ``roiaware_pool3d`` max and avg within 1e-6 on voxels that lie at
  least 1e-3 of a cell from every cell face (``floor`` of a coordinate
  within an ulp of a face may fall either way), RoIs that hold more
  voxels than the budget among them; the max mode's gradient where many
  voxels of a cell tie (features drawn from four values) against
  ``jax.vjp``;
- ``rpn_proposals`` on maps whose scores tie in groups: the same kept
  proposals, scores and labels;
- ``semantic_targets`` exactly, and ``assign_and_sample`` with gga_tpu's
  uniform draw: the same RoIs, masks and GT matches exactly, the IoUs
  within the overlap's 5e-5;
- ``canonical_targets`` (of gga_tpu's samples), ``decode_refined``, the
  corner loss and the RCNN loss within 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

from gga_tpu.core import rotated_iou as jiou
from gga_tpu.models.dense_heads import anchor3d_head as jah
from gga_tpu.models.dense_heads import parta2_rpn_head as jrpn
from gga_tpu.models.roi_heads import part_aggregation as jpa
from gga_tpu.models.roi_heads import parta2_bbox_head as jbh
from gga_tpu.models.roi_heads import semantic_head as jsem
from gga_tpu.ops import roiaware_pool as jpool
from gga_tpu.ops import sparse as jsp
from gga_tpu_torch.core import rotated_iou as tiou
from gga_tpu_torch.models.dense_heads import anchor3d_head as tah
from gga_tpu_torch.models.dense_heads import parta2_rpn_head as trpn
from gga_tpu_torch.models.roi_heads import part_aggregation as tpa
from gga_tpu_torch.models.roi_heads import parta2_bbox_head as tbh
from gga_tpu_torch.models.roi_heads import semantic_head as tsem
from gga_tpu_torch.ops import roiaware_pool as tpool
from gga_tpu_torch.ops import sparse as tsp

torch.set_num_threads(1)

B = 2


def _boxes(rng, n, xy=20.0):
    """[n, 7] bottom-centre boxes of car to pedestrian sizes."""
    return np.concatenate([
        rng.uniform(-xy, xy, (n, 2)), rng.uniform(-2.0, -1.0, (n, 1)),
        rng.uniform(0.6, 4.5, (n, 2)), rng.uniform(1.0, 2.0, (n, 1)),
        rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)


def _jittered(rng, gt, n, scale):
    """n boxes near the rows of gt: centres, sizes and yaws moved."""
    pick = gt[rng.randint(0, len(gt), n)]
    return np.concatenate([
        pick[:, :3] + rng.normal(0, scale, (n, 3)),
        pick[:, 3:6] * rng.uniform(1 - scale / 2, 1 + scale / 2, (n, 3)),
        pick[:, 6:] + rng.normal(0, scale, (n, 1))], 1).astype(np.float32)


def test_rotated_iou_3d_matches_gga_tpu():
    rng = np.random.RandomState(0)
    gt = _boxes(rng, 12, xy=8.0)
    a = np.concatenate([_jittered(rng, gt, 40, 0.3), _boxes(rng, 20, 8.0)])
    ref = np.asarray(jax.jit(jiou.rotated_iou_3d)(a, gt))
    out = tiou.rotated_iou_3d(torch.from_numpy(a), torch.from_numpy(gt))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=5e-5)
    assert (ref > 0.5).sum() > 5 and (ref == 0).sum() > 100
    # batched leading dims
    out_b = tiou.rotated_iou_3d(torch.from_numpy(a)[None].expand(2, -1, -1),
                                torch.from_numpy(gt)[None])
    np.testing.assert_array_equal(out_b[1].numpy(), out.numpy())


# --- the inverse sparse conv ------------------------------------------------
GRID = (41, 64, 64)


def _sites(rng, n=1500, n_valid=(1400, 1100)):
    """[B, n, 3] sorted unique (z, y, x) sites in GRID, padded with -1."""
    coords = np.full((B, n, 3), -1, np.int32)
    valid = np.zeros((B, n), bool)
    for b, m in enumerate(n_valid):
        lin = np.sort(rng.choice(np.prod(GRID), m, replace=False))
        coords[b, :m] = np.stack(np.unravel_index(lin, GRID), -1)
        valid[b, :m] = True
    return coords, valid


@pytest.fixture(scope='module')
def inverse_conv():
    rng = np.random.RandomState(1)
    coords, valid = _sites(rng)
    M = 600             # a budget that drops sites
    args = (GRID, (3, 3, 3), (2, 2, 2), (1, 1, 1), M)
    jmaps = jax.jit(lambda c, v: jsp.downsample_rulebook_batched(c, v, *args))(
        coords, valid)
    tmaps = tsp.downsample_rulebook_batched(torch.from_numpy(coords),
                                            torch.from_numpy(valid), *args)
    c_low, c_out = 24, 16
    x_low = rng.randn(B * M, c_low).astype(np.float32)
    w = (rng.randn(27, c_low, c_out) * 0.2).astype(np.float32)
    dout = rng.randn(B * coords.shape[1], c_out).astype(np.float32)
    fwd, bwd = np.asarray(jmaps[3]), np.asarray(jmaps[4])

    def f(x, w):
        return jsp.sparse_inverse_conv(x, w, fwd, bwd, valid.reshape(-1))

    ref, vjp = jax.vjp(jax.jit(f), x_low, w)
    ref_dx, ref_dw = vjp(dout)
    xt = torch.from_numpy(x_low).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tsp.sparse_inverse_conv(xt, wt, tmaps[3], tmaps[4],
                                  torch.from_numpy(valid).reshape(-1))
    out.backward(torch.from_numpy(dout))
    return dict(jmaps=jmaps, tmaps=tmaps, valid=valid, ref=np.asarray(ref),
                ref_dx=np.asarray(ref_dx), ref_dw=np.asarray(ref_dw),
                out=out.detach().numpy(), dx=xt.grad.numpy(),
                dw=wt.grad.numpy())


def test_inverse_conv_maps_match_gga_tpu(inverse_conv):
    jm, tm = inverse_conv['jmaps'], inverse_conv['tmaps']
    for i in (0, 1, 3, 4):
        np.testing.assert_array_equal(tm[i].numpy(), np.asarray(jm[i]))
    assert tm[2] == tuple(jm[2])
    assert int(tm[1].sum(-1).min()) == 600      # the budget binds


def test_inverse_conv_forward_matches_gga_tpu(inverse_conv):
    ref, out = inverse_conv['ref'], inverse_conv['out']
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    # invalid rows and rows that feed no kept site come out zero
    bwd = inverse_conv['tmaps'][4].numpy()
    cut = (bwd < 0).all(0) & inverse_conv['valid'].reshape(-1)
    assert cut.sum() > 10
    assert (out[cut] == 0).all() and (ref[cut] == 0).all()
    assert (out[~inverse_conv['valid'].reshape(-1)] == 0).all()


@pytest.mark.parametrize('grad', ['dx', 'dw'])
def test_inverse_conv_gradients_match_gga_tpu(inverse_conv, grad):
    ref, out = inverse_conv[f'ref_{grad}'], inverse_conv[grad]
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 2e-5 * np.abs(ref).max()


# --- RoI-aware pooling ------------------------------------------------------
S, N_VOX, R = 6, 1500, 10


def _pool_inputs(seed, ties):
    """Voxel centres around R RoIs (with the voxels within 1e-3 of a cell
    of a cell face marked invalid), features and the RoIs."""
    rng = np.random.RandomState(seed)
    rois = _boxes(rng, R, xy=6.0)
    rois[:, 3:6] *= 1.5
    pick = rois[rng.randint(0, R, (B, N_VOX))]
    local = rng.uniform(-0.6, 0.6, (B, N_VOX, 3)) * pick[..., 3:6]
    c, s = np.cos(pick[..., 6]), np.sin(pick[..., 6])
    centers = np.stack([pick[..., 0] + local[..., 0] * c - local[..., 1] * s,
                        pick[..., 1] + local[..., 0] * s + local[..., 1] * c,
                        pick[..., 2] + pick[..., 5] / 2 + local[..., 2]], -1)
    centers = centers.astype(np.float32)
    rois_b = np.stack([rois, rois[::-1].copy()])
    # each voxel's cell coordinates in each RoI, in f64
    d = centers[:, None].astype(np.float64) - rois_b[:, :, None, :3]
    cr, sr = np.cos(-rois_b[..., 6:7]), np.sin(-rois_b[..., 6:7])
    u = np.stack([(d[..., 0] * cr - d[..., 1] * sr) / rois_b[..., 3:4] + 0.5,
                  (d[..., 0] * sr + d[..., 1] * cr) / rois_b[..., 4:5] + 0.5,
                  d[..., 2] / rois_b[..., 5:6]], -1) * S
    near = (np.abs(u - np.round(u)) < 1e-3).any(-1).any(1)
    valid = (rng.rand(B, N_VOX) < 0.95) & ~near
    if ties:
        feats = rng.choice([0.0, 0.0, 0.5, 1.0], (B, N_VOX, 8))
    else:
        feats = rng.randn(B, N_VOX, 8)
    return (feats.astype(np.float32), centers, valid,
            rois_b.astype(np.float32))


def _jax_pool(mode, budget):
    def f(feats, centers, valid, rois):
        return jax.vmap(lambda *a: jpool.roiaware_pool3d(
            *a, out_size=S, mode=mode, pts_budget=budget))(
                feats, centers, valid, rois)
    return jax.jit(f)


@pytest.mark.parametrize('mode', ['max', 'avg'])
def test_roiaware_pool_matches_gga_tpu(mode):
    budget = 64
    feats, centers, valid, rois = _pool_inputs(2, ties=False)
    ref, ref_occ = _jax_pool(mode, budget)(feats, centers, valid, rois)
    out, occ = tpool.roiaware_pool3d(
        *map(torch.from_numpy, (feats, centers, valid, rois)), S, mode,
        budget)
    assert out.shape == (B, R, S, S, S, 8)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref_occ))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    counts = np.asarray(ref_occ).sum((2, 3, 4))
    assert counts.min() > 0
    # some RoIs hold more voxels than the budget: the cap binds
    _, all_occ = _jax_pool(mode, N_VOX)(feats, centers, valid, rois)
    assert (np.asarray(all_occ).sum((2, 3, 4)) > counts).any()


def test_roiaware_max_pool_gradient_with_ties_matches_jax_vjp():
    budget = 96
    feats, centers, valid, rois = _pool_inputs(3, ties=True)
    g = np.random.RandomState(4).randn(B, R, S, S, S, 8).astype(np.float32)
    pool = _jax_pool('max', budget)
    ref, vjp = jax.vjp(lambda f: pool(f, centers, valid, rois)[0], feats)
    (ref_grad,) = vjp(g)
    ft = torch.from_numpy(feats).requires_grad_()
    out, _ = tpool.roiaware_pool3d(
        ft, *map(torch.from_numpy, (centers, valid, rois)), S, 'max', budget)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-6)
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(ft.grad.numpy(), ref_grad, rtol=1e-5,
                               atol=1e-5)
    # ties split the cotangent: some voxels take a fraction of a cell's
    split = ref_grad != 0
    assert split.sum() > 100


# --- the RPN's proposals ----------------------------------------------------
def test_rpn_proposals_match_gga_tpu():
    from gga_tpu.models.detectors.parta2 import PartA2Config as JCfg
    cfg = JCfg.tiny().rpn
    H, W = 20, 22
    rng = np.random.RandomState(5)
    A = cfg.num_classes * len(cfg.rotations)
    # logits in steps of 0.25: many scores tie
    preds = dict(cls=np.round(rng.randn(B, H, W, A * cfg.num_classes) * 4)
                 / 4, reg=rng.randn(B, H, W, A * 7) * 0.3,
                 dir=rng.randn(B, H, W, A * 2))
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    janchors = jah.make_anchors(cfg, (H, W))
    tanchors = tah.make_anchors(cfg, (H, W))
    np.testing.assert_array_equal(tanchors.numpy(), np.asarray(janchors))
    kw = dict(nms_pre=96, nms_thr=0.3, num_proposals=32)
    ref = jax.jit(lambda p: jrpn.rpn_proposals(cfg, p, janchors, **kw))(preds)
    out = trpn.rpn_proposals(cfg, {k: torch.from_numpy(v)
                                   for k, v in preds.items()}, tanchors, **kw)
    np.testing.assert_array_equal(out['valid'].numpy(),
                                  np.asarray(ref['valid']))
    np.testing.assert_array_equal(out['labels'].numpy(),
                                  np.asarray(ref['labels']))
    np.testing.assert_allclose(out['scores'].numpy(),
                               np.asarray(ref['scores']), rtol=1e-6)
    np.testing.assert_allclose(out['boxes'].numpy(), np.asarray(ref['boxes']),
                               rtol=1e-6, atol=1e-5)
    assert out['valid'].sum() > 20


# --- targets and sampling ---------------------------------------------------
def _scene_gt(rng, G=6):
    gt = _boxes(rng, G, xy=12.0)
    labels = rng.randint(0, 3, G).astype(np.int32)
    valid = np.ones(G, bool)
    valid[-1] = False
    return gt, labels, valid


def test_semantic_targets_match_gga_tpu():
    rng = np.random.RandomState(6)
    gts = [_scene_gt(rng) for _ in range(B)]
    gt = np.stack([g[0] for g in gts])
    labels = np.stack([g[1] for g in gts])
    gvalid = np.stack([g[2] for g in gts])
    # voxel centres in, near and away from the boxes
    near = np.concatenate([_jittered(rng, gt[b], 800, 1.0)[:, :3]
                           for b in range(B)]).reshape(B, 800, 3)
    near[..., 2] += 0.8
    centers = np.concatenate([near, rng.uniform(-15, 15, (B, 400, 3))],
                             1).astype(np.float32)
    vvalid = rng.rand(B, 1200) < 0.9
    ref_seg, ref_part = jax.jit(jax.vmap(
        lambda *a: jsem.semantic_targets(3, 0.2, *a)))(
            centers, vvalid, gt, labels, gvalid)
    seg, part = tsem.semantic_targets(
        3, 0.2, *map(torch.from_numpy, (centers, vvalid, gt)),
        torch.from_numpy(labels).long(), torch.from_numpy(gvalid))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(ref_seg))
    np.testing.assert_allclose(part.numpy(), np.asarray(ref_part),
                               rtol=1e-6, atol=1e-6)
    seg = seg.numpy()
    assert (seg == -1).sum() > 50 and (seg == 3).sum() > 50
    assert ((seg >= 0) & (seg < 3)).sum() > 100


@pytest.fixture(scope='module')
def sampled():
    from gga_tpu.models.detectors.parta2 import PartA2Config as JCfg
    cfg = JCfg().roi
    rng = np.random.RandomState(7)
    P = 200
    gts = [_scene_gt(rng, 8) for _ in range(B)]
    gt = np.stack([g[0] for g in gts])
    labels = np.stack([g[1] for g in gts])
    gvalid = np.stack([g[2] for g in gts])
    props = np.stack([np.concatenate([
        _jittered(rng, gt[b], 90, 0.15), _jittered(rng, gt[b], 60, 0.8),
        _boxes(rng, P - 150, 12.0)]) for b in range(B)])
    pvalid = rng.rand(B, P) < 0.9
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    ref = jax.jit(jax.vmap(lambda *a: jpa.assign_and_sample(cfg, *a)))(
        keys, props, pvalid, gt, labels, gvalid)
    r = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (P,)))(keys))
    out = tpa.assign_and_sample(
        cfg, torch.from_numpy(r), *map(torch.from_numpy, (props, pvalid, gt)),
        torch.from_numpy(labels).long(), torch.from_numpy(gvalid))
    return cfg, ref, out


def test_assign_and_sample_matches_gga_tpu(sampled):
    cfg, ref, out = sampled
    for key in ('rois', 'roi_valid', 'pos_mask', 'gt_of_roi',
                'gt_label_of_roi'):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    np.testing.assert_allclose(out['ious'].numpy(), np.asarray(ref['ious']),
                               rtol=1e-5, atol=5e-5)
    pos = out['pos_mask'].numpy()
    # positives (at most round(128 * 0.55)), then negatives of both kinds
    assert (pos.sum(1) > 20).all()
    assert (pos.sum(1) <= round(cfg.num_rois * cfg.pos_fraction)).all()
    ious = out['ious'].numpy()
    assert ((ious > 0.1) & (ious < 0.55)).any() and (ious < 0.1).any()


def test_rcnn_targets_decode_and_corner_loss_match_gga_tpu(sampled):
    from gga_tpu.models.detectors.parta2 import PartA2Config as JCfg
    bcfg = JCfg().bbox
    # gga_tpu's samples in both (their IoUs are the overlap's, 5e-5)
    _, ref_s, _ = sampled
    ref_t = jax.jit(lambda s: jpa.build_rcnn_targets(bcfg, s))(ref_s)
    out_s = {k: torch.from_numpy(np.asarray(v)) for k, v in ref_s.items()}
    out_t = tpa.build_rcnn_targets(bcfg, out_s)
    for key in ('label', 'label_weights', 'bbox_targets', 'reg_mask'):
        np.testing.assert_allclose(out_t[key].numpy().astype(np.float32),
                                   np.asarray(ref_t[key], np.float32),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    rng = np.random.RandomState(8)
    pred = (rng.randn(*out_s['rois'].shape) * 0.2).astype(np.float32)
    rois = np.asarray(ref_s['rois'])
    ref_dec = jax.jit(jbh.decode_refined)(rois, pred)
    dec = tbh.decode_refined(torch.from_numpy(rois), torch.from_numpy(pred))
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref_dec), rtol=1e-6,
                               atol=1e-6)
    gt = np.asarray(ref_s['gt_of_roi'])
    ref_cl = jax.jit(jbh.corner_loss_lidar)(np.asarray(ref_dec), gt)
    cl = tbh.corner_loss_lidar(dec, torch.from_numpy(gt))
    np.testing.assert_allclose(cl.numpy(), np.asarray(ref_cl), rtol=1e-6,
                               atol=1e-6)
    # the whole RCNN loss on these targets
    cls = rng.randn(*pred.shape[:2], 1).astype(np.float32)
    ref_l, ref_logs = jax.jit(lambda c, p, r, t: jbh.bbox_head_loss(
        bcfg, c, p, r, t))(cls, pred, rois, ref_t)
    loss, logs = tbh.bbox_head_loss(bcfg, torch.from_numpy(cls),
                                    torch.from_numpy(pred),
                                    torch.from_numpy(rois), out_t)
    assert set(logs) == set(ref_logs)
    for k, v in ref_logs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=1e-6,
                                   err_msg=k)
    assert float(ref_logs['loss_rcnn_corner']) > 0
