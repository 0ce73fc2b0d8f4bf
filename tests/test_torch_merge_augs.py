"""Test-time augmentation: the port's ``core/merge_augs.py`` against
``gga_tpu/core/merge_augs.py`` on the same numpy inputs (boxes within
1e-5, the same kept set)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gga_tpu.core import merge_augs as jm
from gga_tpu_torch.core import merge_augs as tm

torch.set_num_threads(1)

_TRANSFORMS = tm.tta_transforms(scales=(0.95, 1.05), flip=True,
                                pcd_vertical_flip=True)


@pytest.mark.parametrize('kw', [
    dict(), dict(scales=(0.95, 1.0, 1.05), flip=True),
    dict(scales=(0.9, 1.1), flip=True, pcd_vertical_flip=True),
    dict(scales=(1.0,), flip=True, pcd_horizontal_flip=False,
         pcd_vertical_flip=True)])
def test_tta_transforms_equal_gga_tpu(kw):
    assert tm.tta_transforms(**kw) == jm.tta_transforms(**kw)


@pytest.mark.parametrize('t', _TRANSFORMS,
                         ids=lambda t: f'{t["scale"]}-{t["h_flip"]:d}'
                                       f'{t["v_flip"]:d}')
def test_augment_and_map_back_equal_gga_tpu(t):
    rng = np.random.RandomState(0)
    pts = rng.uniform(-40, 40, (2, 50, 4)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-40, 40, (30, 3)),
                            rng.uniform(0.5, 4, (30, 3)),
                            rng.uniform(-np.pi, np.pi, (30, 1))],
                           1).astype(np.float32)
    np.testing.assert_allclose(
        tm.augment_points(torch.from_numpy(pts), t).numpy(),
        np.asarray(jm.augment_points(jnp.asarray(pts), t)), rtol=1e-6,
        atol=1e-5)
    back = tm.boxes_mapping_back(torch.from_numpy(boxes), t).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jm.boxes_mapping_back(jnp.asarray(boxes), t)),
        rtol=1e-6, atol=1e-5)


def _variant_dets(rng, transforms, n=40):
    """Each variant sees the same jittered objects in its own frame, with
    its own scores, some slots invalid: duplicates across variants that
    the merge has to suppress."""
    base = np.concatenate([rng.uniform([5, -30, -2], [60, 30, -1], (12, 3)),
                           rng.uniform(0.6, 4.0, (12, 3)),
                           rng.uniform(-np.pi, np.pi, (12, 1))], 1)
    labels = rng.randint(0, 3, 12)
    dets = []
    for t in transforms:
        b = base[rng.randint(0, 12, n)] + rng.randn(n, 7) * [0.2, 0.2, 0.05,
                                                            0.1, 0.1, 0.05,
                                                            0.1]
        b[:, :6] *= t['scale']
        if t['h_flip']:
            b[:, 1], b[:, 6] = -b[:, 1], -b[:, 6]
        if t['v_flip']:
            b[:, 0], b[:, 6] = -b[:, 0], -(b[:, 6] + np.pi)
        dets.append(dict(boxes=b.astype(np.float32),
                         scores=rng.rand(n).astype(np.float32),
                         labels=labels[rng.randint(0, 12, n)].astype(np.int32),
                         valid=rng.rand(n) < 0.8))
    return dets


@pytest.mark.parametrize('max_num', [512, 25])
def test_merge_aug_detections_equals_gga_tpu(max_num):
    rng = np.random.RandomState(3)
    transforms = tm.tta_transforms(scales=(0.95, 1.0, 1.05), flip=True)
    dets = _variant_dets(rng, transforms)
    got = tm.merge_aug_detections(
        [{k: torch.from_numpy(v) for k, v in d.items()} for d in dets],
        transforms, num_classes=3, nms_thr=0.2, max_num=max_num)
    want = jax.jit(lambda ds: jm.merge_aug_detections(
        ds, transforms, num_classes=3, nms_thr=0.2, max_num=max_num))(
            [{k: jnp.asarray(v) for k, v in d.items()} for d in dets])
    valid = np.asarray(want['valid'])
    assert 0 < valid.sum() < sum(d['valid'].sum() for d in dets)
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    np.testing.assert_array_equal(got['labels'].numpy(),
                                  np.asarray(want['labels']))
    np.testing.assert_allclose(got['boxes'].numpy(),
                               np.asarray(want['boxes']), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(want['scores']), rtol=1e-6)
