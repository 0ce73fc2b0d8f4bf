"""Indoor AP evaluation, SUN RGB-D / ScanNet style (port of
``gga_tpu/eval/indoor_eval.py``; mmdet3d's indoor_eval): per-class
VOC-style AP at 3D-IoU thresholds (0.25, 0.5) of gravity-centered depth
boxes, the IoU through the port's numpy rotated overlap."""
from __future__ import annotations

import numpy as np

from ..core.np_rotated_iou import rotated_overlap


def iou_3d_depth(boxes1, boxes2):
    """[N, 7] x [M, 7] gravity-centered depth boxes -> IoU [N, M]."""
    if boxes1.shape[0] == 0 or boxes2.shape[0] == 0:
        return np.zeros((boxes1.shape[0], boxes2.shape[0]))
    inter_bev = rotated_overlap(boxes1[:, [0, 1, 3, 4, 6]],
                                boxes2[:, [0, 1, 3, 4, 6]])
    z1lo = boxes1[:, 2] - boxes1[:, 5] / 2
    z1hi = boxes1[:, 2] + boxes1[:, 5] / 2
    z2lo = boxes2[:, 2] - boxes2[:, 5] / 2
    z2hi = boxes2[:, 2] + boxes2[:, 5] / 2
    zov = np.maximum(np.minimum(z1hi[:, None], z2hi[None, :])
                     - np.maximum(z1lo[:, None], z2lo[None, :]), 0)
    inter = inter_bev * zov
    v1 = boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5]
    v2 = boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5]
    return inter / np.maximum(v1[:, None] + v2[None, :] - inter, 1e-8)


def _average_precision(rec, prec):
    """VOC AP, area mode (indoor_eval's average_precision)."""
    mrec = np.concatenate([[0], rec, [1]])
    mpre = np.concatenate([[0], prec, [0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())


def indoor_eval(gt_annos, dt_annos, iou_thresholds=(0.25, 0.5),
                classes=None):
    """AP per class per IoU threshold.

    Args:
        gt_annos: per-scene dicts with 'gt_boxes' [N, 7] and 'labels' [N].
        dt_annos: per-scene dicts with 'boxes' [N, 7], 'labels' [N],
            'scores' [N].
        classes: class names (index == label).
    Returns:
        (result string, dict like {'bed_AP_0.25': x, 'mAP_0.25': y, ...};
        APs in percent, a class with no ground truth counts 0 in the mAP
        and has no key of its own).
    """
    n_cls = len(classes)
    ret = {}
    for thr in iou_thresholds:
        aps = []
        for ci in range(n_cls):
            scores, tp, fp = [], [], []
            n_gt = 0
            for g, d in zip(gt_annos, dt_annos):
                gmask = np.asarray(g['labels']) == ci
                gboxes = np.asarray(g['gt_boxes'])[gmask]
                n_gt += len(gboxes)
                dmask = np.asarray(d['labels']) == ci
                dboxes = np.asarray(d['boxes'])[dmask]
                dscores = np.asarray(d['scores'])[dmask]
                order = np.argsort(-dscores)
                dboxes, dscores = dboxes[order], dscores[order]
                matched = np.zeros(len(gboxes), bool)
                iou = (iou_3d_depth(dboxes, gboxes) if len(gboxes)
                       else np.zeros((len(dboxes), 0)))
                for di in range(len(dboxes)):
                    scores.append(dscores[di])
                    if iou.shape[1]:
                        gi = int(np.argmax(iou[di]))
                        if iou[di, gi] >= thr and not matched[gi]:
                            matched[gi] = True
                            tp.append(1.0)
                            fp.append(0.0)
                            continue
                    tp.append(0.0)
                    fp.append(1.0)
            if n_gt == 0:
                aps.append(0.0)
                continue
            order = np.argsort(-np.asarray(scores))
            tp = np.cumsum(np.asarray(tp)[order])
            fp = np.cumsum(np.asarray(fp)[order])
            rec = tp / n_gt
            prec = tp / np.maximum(tp + fp, 1e-8)
            ap = _average_precision(rec, prec)
            aps.append(ap)
            ret[f'{classes[ci]}_AP_{thr:.2f}'] = ap * 100
        ret[f'mAP_{thr:.2f}'] = float(np.mean(aps)) * 100

    lines = ['\n--------- Indoor AP ---------']
    for thr in iou_thresholds:
        lines.append(f'mAP@{thr:.2f}: {ret[f"mAP_{thr:.2f}"]:.2f}')
        for c in classes:
            key = f'{c}_AP_{thr:.2f}'
            if key in ret:
                lines.append(f'  {c}: {ret[key]:.2f}')
    return '\n'.join(lines), ret
