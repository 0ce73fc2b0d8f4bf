"""The port's anchor head functions against gga_tpu's, f32, CPU.

The same seeded numpy inputs go through gga_tpu's
``models/dense_heads/anchor3d_head.py`` (jitted) and the port's:

- the anchors (``core/anchors.py``) exactly, at a small map and at
  PointPillars' 248 x 216;
- ``delta_encode`` / ``delta_decode`` within 1e-6;
- ``_nearest_bev`` exactly, yaws at +-pi/4 and +-pi/2 among them;
- ``assign_targets`` on three scenes built for the edge cases: a GT at an
  anchor's centre, a GT whose best IoU is below ``min_pos_iou``, two GTs
  with the same best anchor, a GT forced onto anchor 0 with padded slots
  after it (each of which also points at anchor 0), a class with no GT
  and a scene with none; labels, masks and direction targets exactly,
  box targets within 1e-5;
- ``loss``'s terms at rtol 1e-5 on random maps;
- ``decode`` as kept sets a scene, boxes within 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

from gga_tpu.core import anchors as janchors
from gga_tpu.core import coders as jcoders
from gga_tpu.models.dense_heads import anchor3d_head as jah
from gga_tpu_torch.core import anchors as tanchors
from gga_tpu_torch.core import coders as tcoders
from gga_tpu_torch.models.dense_heads import anchor3d_head as tah

torch.set_num_threads(1)

H, W = 8, 10          # a map over x 0..16 (1.6 m cells), y -8..8 (2 m)
RANGES = ((0, -8, -0.6, 16, 8, -0.6), (0, -8, -0.6, 16, 8, -0.6),
          (0, -8, -1.78, 16, 8, -1.78))
CFG = dict(anchor_ranges=RANGES, nms_pre=32, max_num=8)
JCFG, TCFG = jah.Anchor3DConfig(**CFG), tah.Anchor3DConfig(**CFG)
PED, CYC, CAR = 0, 1, 2
SIZES = {PED: (0.8, 0.6, 1.73), CYC: (1.76, 0.6, 1.73),
         CAR: (3.9, 1.6, 1.56)}


def centre(i, j):
    """The (x, y) of the anchors at column i, row j."""
    return 0.8 + 1.6 * i, -7.0 + 2.0 * j


def scenes():
    """Three scenes of six GT slots: (boxes, labels, valid)."""
    M = 6
    boxes = np.zeros((3, M, 7), np.float32)
    labels = np.full((3, M), -1, np.int64)

    def put(b, k, label, x, y, yaw):
        boxes[b, k] = [x, y, -1.7, *SIZES[label], yaw]
        labels[b, k] = label

    # scene 0: a car on an anchor's centre (IoU 1); a pedestrian midway
    # between four anchors (best IoU 0, below min_pos_iou: not forced); two
    # cyclists whose best anchor is the same one
    put(0, 0, CAR, *centre(3, 4), 0.0)
    put(0, 1, PED, centre(6, 2)[0] + 0.8, centre(6, 2)[1] + 1.0, 0.0)
    put(0, 2, CYC, centre(1, 6)[0] + 0.1, centre(1, 6)[1], 0.05)
    put(0, 3, CYC, centre(1, 6)[0] - 0.1, centre(1, 6)[1], -0.05)
    # scene 1: a car whose best anchor is anchor 0 at IoU 0.52 (forced
    # only; the padded slots after it point at anchor 0 as well); no
    # pedestrian; cyclists at yaw pi/2 and -2 (direction targets 0 and 1)
    put(1, 0, CAR, centre(0, 0)[0], centre(0, 0)[1] + 0.5, 0.0)
    put(1, 1, CYC, *centre(5, 3), np.pi / 2)
    put(1, 2, CYC, *centre(8, 6), -2.0)
    # scene 2: no object
    return boxes, labels, labels >= 0


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope='module')
def anchors():
    return (janchors.multiclass_anchors((H, W), RANGES, JCFG.anchor_sizes),
            tanchors.multiclass_anchors((H, W), RANGES, TCFG.anchor_sizes))


@pytest.mark.parametrize('size', [(H, W), (248, 216)])
def test_anchors_equal(size):
    for r, s in zip(RANGES, JCFG.anchor_sizes):
        np.testing.assert_array_equal(
            _np(tanchors.aligned_anchors_single_range(size, r, s)),
            np.asarray(janchors.aligned_anchors_single_range(size, r, s)))
    np.testing.assert_array_equal(
        _np(tah.make_anchors(TCFG, size)),
        np.asarray(jah.make_anchors(JCFG, size)))


def test_delta_coder_matches():
    rng = np.random.RandomState(0)
    n = 500
    anc = np.concatenate([rng.uniform(-40, 40, (n, 3)),
                          rng.uniform(0.5, 4, (n, 3)),
                          rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    boxes = anc + np.concatenate([rng.randn(n, 3), rng.randn(n, 3) * 0.2,
                                  rng.randn(n, 1)], 1)
    boxes[:, 3:6] = np.abs(boxes[:, 3:6])
    boxes[:5, 3:6] = 0.0                  # the 1e-6 floor of the log sizes
    anc, boxes = anc.astype(np.float32), boxes.astype(np.float32)
    enc = tcoders.delta_encode(torch.from_numpy(boxes), torch.from_numpy(anc))
    ref = jcoders.delta_encode(boxes, anc)
    np.testing.assert_allclose(_np(enc), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    deltas = (rng.randn(n, 7) * 0.5).astype(np.float32)
    dec = tcoders.delta_decode(torch.from_numpy(deltas),
                               torch.from_numpy(anc))
    np.testing.assert_allclose(_np(dec),
                               np.asarray(jcoders.delta_decode(deltas, anc)),
                               rtol=1e-6, atol=1e-6)
    back = tcoders.delta_decode(enc, torch.from_numpy(anc))
    np.testing.assert_allclose(_np(back[5:]), boxes[5:], rtol=1e-5,
                               atol=1e-5)


def test_nearest_bev_matches_at_the_swap_edges():
    yaws = np.array([0, np.pi / 4, -np.pi / 4, np.pi / 2, -np.pi / 2,
                     3 * np.pi / 4, np.pi, 0.7853, 0.7854, 2.0, -3.0],
                    np.float32)
    boxes = np.zeros((len(yaws), 7), np.float32)
    boxes[:, :6] = [1.0, -2.0, 0.0, 3.9, 1.6, 1.5]
    boxes[:, 6] = yaws
    got = _np(tah._nearest_bev(torch.from_numpy(boxes)))
    np.testing.assert_array_equal(got, np.asarray(jah._nearest_bev(boxes)))
    assert np.isclose(got[3, 2] - got[3, 0], 1.6)         # pi/2: swapped


@pytest.fixture(scope='module')
def assigned(anchors):
    ja, ta = anchors
    boxes, labels, valid = scenes()
    ref = jax.jit(jax.vmap(lambda b, l, v: jah.assign_targets(
        JCFG, ja, b, l, v)))(boxes, labels, valid)
    got = tah.assign_targets(TCFG, ta, torch.from_numpy(boxes),
                             torch.from_numpy(labels),
                             torch.from_numpy(valid))
    return ref, got


def test_assign_targets_matches(assigned):
    ref, got = assigned
    for key in ('labels', 'dir_targets', 'pos_mask', 'neg_mask'):
        np.testing.assert_array_equal(_np(got[key]), np.asarray(ref[key]),
                                      err_msg=key)
    np.testing.assert_allclose(_np(got['bbox_targets']),
                               np.asarray(ref['bbox_targets']), rtol=1e-5,
                               atol=1e-5)


def test_assign_targets_covers_the_edge_cases(assigned):
    _, got = assigned
    A = H * W * 2
    pos = _np(got['pos_mask']).reshape(3, 3, A)
    neg = _np(got['neg_mask']).reshape(3, 3, A)
    assert pos[0, CAR].sum() >= 1 and pos[0, PED].sum() == 0
    assert neg[0, PED].all()                  # IoU 0 everywhere: negatives
    assert pos[0, CYC].sum() == 1             # two GTs, one best anchor
    assert pos[1, CAR, 0] and pos[1, CAR].sum() == 1   # forced onto anchor 0
    assert not (pos[1, PED] | neg[1, PED]).any()       # no GT of the class
    assert not (pos[2] | neg[2]).any()
    dirs = _np(got['dir_targets']).reshape(3, 3, A)[1, CYC]
    assert set(dirs[pos[1, CYC]]) == {0, 1}


def random_maps(seed, B=2):
    rng = np.random.RandomState(seed)
    A = 3 * 2
    return dict(cls=(rng.randn(B, H, W, A * 3) * 2 - 1).astype(np.float32),
                reg=(rng.randn(B, H, W, A * 7) * 0.3).astype(np.float32),
                dir=rng.randn(B, H, W, A * 2).astype(np.float32))


def test_loss_terms_match(anchors, assigned):
    ja, ta = anchors
    ref_t, got_t = assigned
    maps = random_maps(1, B=3)
    _, ref = jax.jit(lambda p, t: jah.loss(JCFG, p, ja, t))(maps, ref_t)
    _, got = tah.loss(TCFG, {k: torch.from_numpy(v) for k, v in maps.items()},
                      ta, got_t)
    assert float(got['num_pos']) > 0
    for key in ('loss_cls', 'loss_bbox', 'loss_dir', 'loss', 'num_pos'):
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   rtol=1e-5, err_msg=key)


def kept(out, b):
    """Scene b's kept detections, by label then descending score:
    (labels, scores, boxes)."""
    v = np.asarray(out['valid'][b])
    lab = np.asarray(out['labels'][b])[v]
    sc = np.asarray(out['scores'][b])[v]
    order = np.lexsort((-sc, lab))
    return lab[order], sc[order], np.asarray(out['boxes'][b])[v][order]


def test_decode_matches_as_kept_sets(anchors):
    ja, ta = anchors
    maps = random_maps(2)
    ref = jax.jit(lambda p: jah.decode(JCFG, p, ja))(maps)
    got = tah.decode(TCFG, {k: torch.from_numpy(v) for k, v in maps.items()},
                     ta)
    assert got['boxes'].shape == (2, 3 * JCFG.max_num, 7)
    got = {k: _np(v) for k, v in got.items()}
    for b in range(2):
        (gl, gs, gb), (rl, rs, rb) = kept(got, b), kept(ref, b)
        assert len(gl) > 3
        np.testing.assert_array_equal(gl, rl)
        np.testing.assert_allclose(gs, rs, rtol=1e-6)
        np.testing.assert_allclose(gb, rb, rtol=1e-4, atol=1e-4)
