"""Test-time-augmentation merging for 3D detections (port of
``gga_tpu/core/merge_augs.py``, on tensors).

Augmented variants are (scale, horizontal-flip, vertical-flip) triples;
each variant's detections map back through the inverse transform (the
flips are involutive, then the inverse scale), are concatenated, and a
per-class rotated-BEV NMS keeps the best ``max_num``, all on static
padded shapes.
"""
from __future__ import annotations

import itertools
import math

import torch

from .nms import nms_bev


def tta_transforms(scales=(1.0,), flip=False, pcd_horizontal_flip=True,
                   pcd_vertical_flip=False):
    """The MultiScaleFlipAug3D variants: every scale, the identity always
    included, flips added when ``flip``.

    Returns a list of dict(scale, h_flip, v_flip)."""
    h_opts = [False, True] if flip and pcd_horizontal_flip else [False]
    v_opts = [False, True] if flip and pcd_vertical_flip else [False]
    return [dict(scale=float(s), h_flip=h, v_flip=v)
            for s, h, v in itertools.product(scales, h_opts, v_opts)]


def augment_points(points, transform):
    """Forward transform of lidar points [..., P, 3+]: scale, then flip
    (the GlobalRotScaleTrans + RandomFlip3D order of the TTA pipeline)."""
    xyz = points[..., :3] * transform['scale']
    if transform['h_flip']:
        xyz = xyz * xyz.new_tensor([1.0, -1.0, 1.0])
    if transform['v_flip']:
        xyz = xyz * xyz.new_tensor([-1.0, 1.0, 1.0])
    return torch.cat([xyz, points[..., 3:]], -1)


def boxes_mapping_back(boxes, transform):
    """Boxes [..., 7] (lidar bottom-centre) of an augmented frame back to
    the original: un-flip, then un-scale. The v-flip maps the yaw to
    ``-(yaw + pi)``."""
    x, y, z, dx, dy, dz, yaw = boxes.unbind(-1)
    if transform['h_flip']:
        y, yaw = -y, -yaw
    if transform['v_flip']:
        x, yaw = -x, -(yaw + math.pi)
    s = transform['scale']
    return torch.stack([x / s, y / s, z / s, dx / s, dy / s, dz / s, yaw],
                       -1)


def merge_aug_detections(aug_dets, transforms, num_classes, nms_thr=0.2,
                         max_num=512):
    """Merge the per-variant detections of ONE scene.

    Args:
        aug_dets: list (one per variant) of dicts with boxes [K, 7],
            scores [K], labels [K], valid [K], decoded in the augmented
            frame.
        transforms: the matching transform dicts.
    Returns:
        dict(boxes [max_num, 7], scores, labels, valid), kept detections
        first by score; scores 0 where not kept.
    """
    boxes = torch.cat([boxes_mapping_back(d['boxes'], t)
                       for d, t in zip(aug_dets, transforms)])
    scores = torch.cat([d['scores'] for d in aug_dets])
    labels = torch.cat([d['labels'] for d in aug_dets])
    valid = torch.cat([d['valid'] for d in aug_dets])

    # one NMS per class, batched over the classes (rows are independent)
    bev = boxes[:, [0, 1, 3, 4, 6]]
    cls = torch.arange(num_classes, device=labels.device)[:, None]
    sel = valid & (labels == cls)                          # [classes, N]
    _, keep = nms_bev(bev.expand(num_classes, -1, -1),
                      scores.expand(num_classes, -1), nms_thr, valid=sel)
    keep = (keep & sel).any(0)

    order = torch.sort(torch.where(keep, -scores, torch.inf),
                       stable=True).indices[:max_num]
    kept = keep[order]
    return dict(boxes=boxes[order],
                scores=torch.where(kept, scores[order], 0.0),
                labels=labels[order], valid=kept)
