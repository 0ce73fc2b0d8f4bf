"""Segmentation evaluation: semantic mIoU / accuracy and instance-mask AP
(the port's copy of ``gga_tpu/eval/seg_eval.py``, numpy on the host;
mmdet3d's seg_eval and instance_seg_eval): a confusion matrix over the
points whose label is not the ignore index, the per-class IoU (NaN for a
class absent from both labels and predictions, left out of the
``nanmean``), the overall and the class-mean accuracy; and the ScanNet
benchmark's instance AP at IoU 0.25, 0.50 and the mean over 0.50:0.95 by
greedy matching in order of confidence, one ground truth a prediction,
regions below ``min_region_size`` points (100 by default) dropped on both
sides.
"""
from __future__ import annotations

import numpy as np


def fast_hist(preds, labels, num_classes):
    """Confusion matrix over valid entries."""
    k = (labels >= 0) & (labels < num_classes)
    return np.bincount(
        num_classes * labels[k].astype(np.int64) + preds[k],
        minlength=num_classes ** 2)[:num_classes ** 2].reshape(
            num_classes, num_classes)


def seg_eval(gt_labels, seg_preds, label2cat, ignore_index):
    """Semantic segmentation metrics.

    Args:
        gt_labels / seg_preds: per-scene [N] int arrays.
        label2cat: {label: name}.
        ignore_index: GT value excluded from scoring.

    Returns dict: per-class IoU, 'miou', 'acc', 'acc_cls'.
    """
    assert len(seg_preds) == len(gt_labels)
    num_classes = len(label2cat)
    hist = np.zeros((num_classes, num_classes), np.int64)
    for gt, pred in zip(gt_labels, seg_preds):
        gt = np.asarray(gt).astype(np.int64).copy()
        pred = np.asarray(pred).astype(np.int64).copy()
        pred[gt == ignore_index] = -1
        gt[gt == ignore_index] = -1
        hist += fast_hist(pred, gt, num_classes)

    # 0/0 -> NaN for classes absent from both GT and preds, so nanmean
    # EXCLUDES them (reference per_class_iou / get_acc_cls semantics);
    # clamping the denominator would deflate miou/acc_cls instead
    with np.errstate(invalid='ignore', divide='ignore'):
        iou = np.diag(hist) / (
            hist.sum(1) + hist.sum(0) - np.diag(hist))
        acc_per_cls = np.diag(hist) / hist.sum(1)
    ret = {str(label2cat[i]): float(iou[i]) for i in range(num_classes)}
    ret['miou'] = float(np.nanmean(iou))
    ret['acc'] = float(np.diag(hist).sum() / max(hist.sum(), 1))
    ret['acc_cls'] = float(np.nanmean(acc_per_cls))
    return ret


def _instance_ap(records, npos):
    """Interpolated-precision AP from (score, tp) records."""
    if npos == 0:
        return float('nan')
    if not records:
        return 0.0
    records = sorted(records, key=lambda r: -r[0])
    tp = np.cumsum([r[1] for r in records]).astype(np.float64)
    fp = np.cumsum([not r[1] for r in records]).astype(np.float64)
    recall = tp / npos
    precision = tp / (tp + fp)
    # precision envelope + rectangle integration (VOC-style all-points)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())


def instance_seg_eval(gt_semantic_masks, gt_instance_masks,
                      pred_instance_masks, pred_instance_labels,
                      pred_instance_scores, valid_class_ids,
                      class_labels, min_region_size=100):
    """Instance segmentation AP (ScanNet protocol).

    Args (per scene lists):
        gt_semantic_masks: [N] semantic label per point (index into
            class_labels, or >= len(class_labels) for ignored).
        gt_instance_masks: [N] instance id per point.
        pred_instance_masks: [I, N] bool (or [N] id map like the
            reference's aggregate input — both accepted).
        pred_instance_labels / scores: [I].

    Returns dict with per-class 'AP_0.25'/'AP_0.50'/'AP' + overall means.
    """
    assert len(valid_class_ids) == len(class_labels)
    n_cls = len(class_labels)
    thr_50_95 = np.arange(0.5, 0.95, 0.05)
    all_thr = sorted(set([0.25, 0.5]) | set(np.round(thr_50_95, 2)))
    records = {c: {t: [] for t in all_thr} for c in range(n_cls)}
    npos = {c: 0 for c in range(n_cls)}

    for scene, (sem, inst) in enumerate(zip(gt_semantic_masks,
                                            gt_instance_masks)):
        sem = np.asarray(sem)
        inst = np.asarray(inst)
        pm = pred_instance_masks[scene]
        pm = np.asarray(pm)
        if pm.ndim == 1:            # id-map form -> [I, N] bool
            ids = np.arange(pm.max() + 1) if pm.size else np.arange(0)
            pm = pm[None, :] == ids[:, None]
        pl = np.asarray(pred_instance_labels[scene])
        ps = np.asarray(pred_instance_scores[scene])

        # GT instances per class (regions below min_region_size are
        # dropped, matching the ScanNet evaluator's min_region_sizes)
        gt_insts = {c: [] for c in range(n_cls)}
        for gi in np.unique(inst):
            m = inst == gi
            cls_vals = np.unique(sem[m])
            c = int(cls_vals[0])
            if c < n_cls and m.sum() >= min_region_size:
                gt_insts[c].append(m)
        for c in range(n_cls):
            npos[c] += len(gt_insts[c])

        for c in range(n_cls):
            sel = np.where(pl == c)[0]
            if len(sel) == 0:
                continue
            order = sel[np.argsort(-ps[sel])]
            gts = gt_insts[c]
            for thr in all_thr:
                taken = np.zeros(len(gts), bool)
                for i in order:
                    mask = pm[i]
                    if mask.sum() < min_region_size:
                        continue
                    best, best_j = 0.0, -1
                    for j, g in enumerate(gts):
                        if taken[j]:
                            continue
                        inter = (mask & g).sum()
                        union = (mask | g).sum()
                        iou = inter / max(union, 1)
                        if iou > best:
                            best, best_j = iou, j
                    tp = best >= thr
                    if tp:
                        taken[best_j] = True
                    records[c][thr].append((float(ps[i]), tp))

    ret = {}
    ap25, ap50, ap_all = [], [], []
    for c, name in enumerate(class_labels):
        a25 = _instance_ap(records[c][0.25], npos[c])
        a50 = _instance_ap(records[c][0.5], npos[c])
        a = np.nanmean([_instance_ap(records[c][round(t, 2)], npos[c])
                        for t in thr_50_95]) if npos[c] else float('nan')
        ret[f'{name}_AP_0.25'] = a25
        ret[f'{name}_AP_0.50'] = a50
        ret[f'{name}_AP'] = float(a)
        if npos[c]:
            ap25.append(a25)
            ap50.append(a50)
            ap_all.append(a)
    ret['all_ap_25%'] = float(np.mean(ap25)) if ap25 else 0.0
    ret['all_ap_50%'] = float(np.mean(ap50)) if ap50 else 0.0
    ret['all_ap'] = float(np.mean(ap_all)) if ap_all else 0.0
    return ret
