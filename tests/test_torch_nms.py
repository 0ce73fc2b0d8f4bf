"""gga_tpu_torch rotated IoU, NMS and box decode against gga_tpu.

IoUs agree to atol 5e-5: the shoelace area sums products of vertex
coordinates of size ~10-100 with cancellation, so one f32 rounding of a
term is ~1e-5, and XLA's fused f32 trigonometry differs from torch's in
the last bits. NMS keep masks and ranked indices, and the
decoded boxes of tie-free maps, agree exactly or to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gga_tpu.core import nms as jnms
from gga_tpu.core import rotated_iou as jiou
from gga_tpu.models.dense_heads import centerpoint_head as jcp
from gga_tpu_torch.core import nms as tnms
from gga_tpu_torch.core import rotated_iou as tiou
from gga_tpu_torch.models.dense_heads import centerpoint_head as tcp

torch.set_num_threads(1)

# gga_tpu's functions jitted: eager dispatch of the bitonic sort network
# costs seconds per call on the CPU
_jiou = jax.jit(jiou.rotated_iou_bev)
# the threshold traced, so one compile serves every case
_jnms = jax.jit(jnms.nms_bev, static_argnames=('post_max_size',))
_jdets = jax.jit(jcp.get_task_detections,
                 static_argnames=('nms_thr', 'post_max_size'))


def _boxes(seed, n=60, spread=12.0):
    """Random BEV boxes plus identical, touching and contained ones."""
    rng = np.random.RandomState(seed)
    b = np.concatenate([
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(0.5, 5, (n, 2)),
        rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    b[1] = b[0]                                        # identical
    b[3] = b[2]
    b[3, 0] += b[2, 2]                                 # touching along x
    b[3, 4] = b[2, 4] = 0.0
    b[5] = b[4]
    b[5, 2:4] *= 0.5                                   # contained
    b[7] = b[6]
    b[7, 4] += np.pi / 2                               # rotated 90 degrees
    return b.astype(np.float32)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_rotated_iou_matches_gga_tpu(seed):
    b1 = _boxes(seed)
    b2 = np.concatenate([b1[:20], _boxes(seed + 10, n=30)])
    ref = np.asarray(_jiou(jnp.asarray(b1), jnp.asarray(b2)))
    out = tiou.rotated_iou_bev(torch.from_numpy(b1), torch.from_numpy(b2))
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5, rtol=1e-5)
    assert abs(ref[0, 1] - 1.0) < 1e-5 and ref[2, 3] < 1e-5
    assert abs(ref[4, 5] - 0.25) < 1e-5


def test_rotated_iou_batched_rows_match_unbatched():
    b = np.stack([_boxes(3, n=20), _boxes(4, n=20)])
    out = tiou.rotated_iou_bev(torch.from_numpy(b), torch.from_numpy(b))
    for i in range(2):
        one = tiou.rotated_iou_bev(torch.from_numpy(b[i]),
                                   torch.from_numpy(b[i]))
        torch.testing.assert_close(out[i], one)


@pytest.mark.parametrize('seed,thresh', [(0, 0.2), (1, 0.1), (2, 0.5)])
def test_nms_bev_matches_gga_tpu(seed, thresh):
    rng = np.random.RandomState(seed)
    boxes = _boxes(seed, n=80, spread=6.0)
    scores = rng.permutation(80).astype(np.float32) / 10
    valid = rng.rand(80) < 0.85
    idx, keep = _jnms(jnp.asarray(boxes), jnp.asarray(scores), thresh,
                      post_max_size=50, valid=jnp.asarray(valid))
    tidx, tkeep = tnms.nms_bev(torch.from_numpy(boxes),
                               torch.from_numpy(scores), thresh,
                               post_max_size=50,
                               valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    assert 0 < np.asarray(keep).sum() < valid.sum()   # something suppressed


def _maps(seed, B=2, H=12, W=10, C=1):
    """Tie-free head maps: the heatmap logits are a seeded permutation."""
    rng = np.random.RandomState(seed)
    hm = (rng.permutation(B * H * W * C).reshape(B, H, W, C)
          / (B * H * W * C) * 6 - 4).astype(np.float32)
    return dict(heatmap=hm,
                reg=rng.rand(B, H, W, 2).astype(np.float32),
                height=rng.randn(B, H, W, 1).astype(np.float32),
                dim=(rng.randn(B, H, W, 3) * 0.3).astype(np.float32),
                rot=rng.randn(B, H, W, 2).astype(np.float32))


def _decode_kwargs():
    return dict(voxel_size=(0.32, 0.3125), pc_range=(0., -40., -3., 71.68,
                                                     40., 1.),
                out_size_factor=8, max_num=40, score_threshold=0.1,
                post_center_range=(0., -40., -3., 71.68, 40., 1.))


def _assert_dets_equal(out, ref):
    for key in ('boxes', 'scores', 'logits'):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    for key in ('labels', 'valid'):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)


@pytest.mark.parametrize('C', [1, 3])
def test_decode_task_matches_gga_tpu(C):
    maps = _maps(C, C=C)
    ref = jcp.decode_task({k: jnp.asarray(v) for k, v in maps.items()},
                          **_decode_kwargs())
    out = tcp.decode_task({k: torch.from_numpy(v) for k, v in maps.items()},
                          **_decode_kwargs())
    _assert_dets_equal(out, ref)


def test_task_detections_and_merge_match_gga_tpu():
    dets, tdets = [], []
    for t in range(3):
        maps = _maps(10 + t)
        d = jcp.decode_task({k: jnp.asarray(v) for k, v in maps.items()},
                            **_decode_kwargs())
        dets.append(_jdets(d, nms_thr=0.2, post_max_size=30))
        td = tcp.decode_task({k: torch.from_numpy(v) for k, v in maps.items()},
                             **_decode_kwargs())
        tdets.append(tcp.get_task_detections(td, nms_thr=0.2,
                                             post_max_size=30))
        _assert_dets_equal(tdets[-1], dets[-1])
    _assert_dets_equal(tcp.merge_task_detections(tdets, (1, 1, 1)),
                       jcp.merge_task_detections(dets, (1, 1, 1)))
