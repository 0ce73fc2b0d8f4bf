"""Lyft detection metric without the devkit (port of
``gga_tpu/eval/lyft_eval.py``, numpy; mmdet3d's lyft_eval over the
lyft_dataset_sdk kaggle metric): per class, average precision at 3D-IoU
thresholds 0.5:0.95:0.05, predictions matched greedily by descending
score to the unmatched GT of highest IoU; the score is the mean over
classes and thresholds. The IoU is the exact rotated 3D IoU
(``core/np_rotated_iou.py rotated_iou_3d``).
"""
from __future__ import annotations

import numpy as np

from ..core.np_rotated_iou import rotated_iou_3d

IOU_THRESHOLDS = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))


def _class_ap(gts, preds, cls, thr):
    """AP of class ``cls`` at IoU ``thr`` over all samples (NaN without a
    GT of the class)."""
    npos = 0
    recs = []
    for g, p in zip(gts, preds):
        gm = np.asarray(g['names']) == cls
        gb = np.asarray(g['boxes'], np.float64)[gm]
        npos += len(gb)
        pm = np.asarray(p['names']) == cls
        if not pm.any():
            continue
        pb = np.asarray(p['boxes'], np.float64)[pm]
        ps = np.asarray(p['scores'], np.float64)[pm]
        iou = (rotated_iou_3d(pb, gb) if len(gb)
               else np.zeros((len(pb), 0)))
        taken = np.zeros(len(gb), bool)
        for i in np.argsort(-ps):
            tp = False
            if len(gb):
                cand = np.where(~taken, iou[i], -1.0)
                j = int(np.argmax(cand))
                if cand[j] >= thr:
                    taken[j] = True
                    tp = True
            recs.append((ps[i], tp))
    if npos == 0:
        return float('nan')
    if not recs:
        return 0.0
    recs.sort(key=lambda r: -r[0])
    tp = np.cumsum([r[1] for r in recs]).astype(np.float64)
    fp = np.cumsum([not r[1] for r in recs]).astype(np.float64)
    recall = tp / npos
    precision = tp / (tp + fp)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())


def lyft_eval(gts, preds, classes):
    """Per-sample GT dicts (boxes [N, 7], names) and prediction dicts
    (boxes, names, scores) -> dict of '<class>_AP' for each class with a
    GT, and the kaggle 'mAP', their mean (0.0 without one)."""
    metrics = {}
    class_means = []
    for cls in classes:
        aps = [_class_ap(gts, preds, cls, t) for t in IOU_THRESHOLDS]
        aps = [a for a in aps if not np.isnan(a)]
        if aps:
            m = float(np.mean(aps))
            metrics[f'{cls}_AP'] = m
            class_means.append(m)
    metrics['mAP'] = float(np.mean(class_means)) if class_means else 0.0
    return metrics
