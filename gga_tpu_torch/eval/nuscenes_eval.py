"""nuScenes detection metrics (mAP, TP errors, NDS) without the devkit
(port of ``gga_tpu/eval/nuscenes_eval.py``, numpy):

- matching: greedy by descending confidence, a prediction matches the
  nearest unmatched GT of the same class within a BEV centre-distance
  threshold (0.5 / 1 / 2 / 4 m);
- AP: 101-point interpolated precision over recall, with the region
  below 0.1 recall and precision clipped away and the rest normalized by
  1 / 0.9;
- TP errors at the 2 m threshold over matched pairs: ATE (BEV centre
  distance), ASE (1 - IoU of aligned boxes), AOE (absolute yaw delta,
  wrapped; period pi for barriers), AVE (velocity L2, not for cones and
  barriers), AAE (1 - attribute accuracy, where attributes are given);
- NDS = (5 * mAP + sum_tp (1 - min(1, err))) / 10.
"""
from __future__ import annotations

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_METRICS = ('trans_err', 'scale_err', 'orient_err', 'vel_err',
              'attr_err')
NUS_CLASSES = ('car', 'truck', 'trailer', 'bus', 'construction_vehicle',
               'bicycle', 'motorcycle', 'pedestrian', 'traffic_cone',
               'barrier')
# classes where some TP metrics are undefined (official protocol)
NO_VEL = ('traffic_cone', 'barrier')
NO_ATTR = ('traffic_cone', 'barrier')
PERIOD_PI = ('barrier',)


def _aligned_iou_3d(dims_a, dims_b):
    """IoU of two boxes with identical center and yaw (size error)."""
    inter = np.prod(np.minimum(dims_a, dims_b), -1)
    union = np.prod(dims_a, -1) + np.prod(dims_b, -1) - inter
    return inter / np.maximum(union, 1e-9)


def _yaw_diff(a, b, period=2 * np.pi):
    d = np.abs(a - b) % period
    return np.minimum(d, period - d)


def _accumulate(gts, preds, cls, dist_th):
    """Match one class at one distance threshold.

    gts/preds: per-sample lists of dicts with keys
        'boxes' [N, 7(+2 vel)] (x, y, z, dx, dy, dz, yaw[, vx, vy]),
        'names' [N] str, preds also 'scores' [N]; optional 'attrs'.

    Returns dict with sorted match records + npos.
    """
    npos = sum(int((np.asarray(g['names']) == cls).sum()) for g in gts)
    recs = []
    for si, (g, p) in enumerate(zip(gts, preds)):
        pm = np.asarray(p['names']) == cls
        if pm.sum() == 0:
            continue
        pb = np.asarray(p['boxes'], np.float64)[pm]
        ps = np.asarray(p['scores'], np.float64)[pm]
        pa = (np.asarray(p['attrs'])[pm] if 'attrs' in p else
              np.array([''] * pm.sum()))
        gm = np.asarray(g['names']) == cls
        gb = np.asarray(g['boxes'], np.float64)[gm] if gm.any() else \
            np.zeros((0, 7))
        ga = (np.asarray(g['attrs'])[gm] if 'attrs' in g and gm.any()
              else np.array([''] * int(gm.sum())))
        taken = np.zeros(len(gb), bool)
        order = np.argsort(-ps)
        for i in order:
            rec = dict(score=ps[i], tp=False)
            if len(gb):
                d = np.linalg.norm(gb[:, :2] - pb[i, :2], axis=1)
                d = np.where(taken, np.inf, d)
                j = int(np.argmin(d))
                if d[j] < dist_th:
                    taken[j] = True
                    rec['tp'] = True
                    rec['trans_err'] = float(d[j])
                    rec['scale_err'] = float(
                        1 - _aligned_iou_3d(pb[i, 3:6], gb[j, 3:6]))
                    period = np.pi if cls in PERIOD_PI else 2 * np.pi
                    rec['orient_err'] = float(
                        _yaw_diff(pb[i, 6], gb[j, 6], period))
                    if pb.shape[1] >= 9 and gb.shape[1] >= 9 \
                            and cls not in NO_VEL:
                        rec['vel_err'] = float(np.linalg.norm(
                            pb[i, 7:9] - gb[j, 7:9]))
                    if 'attrs' in p and 'attrs' in g \
                            and cls not in NO_ATTR:
                        rec['attr_err'] = float(pa[i] != ga[j])
            recs.append(rec)
    recs.sort(key=lambda r: -r['score'])
    return dict(records=recs, npos=npos)


def _ap_from_records(acc, min_recall=0.1, min_precision=0.1):
    """101-point interpolated AP with the official clipping."""
    if acc['npos'] == 0:
        return float('nan')
    tp = np.cumsum([r['tp'] for r in acc['records']]).astype(np.float64)
    fp = np.cumsum([not r['tp'] for r in acc['records']]).astype(
        np.float64)
    if len(tp) == 0:
        return 0.0
    recall = tp / acc['npos']
    precision = tp / (tp + fp)
    rec_interp = np.linspace(0, 1, 101)
    prec = np.interp(rec_interp, recall, precision, right=0)
    prec = prec[rec_interp > min_recall]
    prec = np.maximum(prec - min_precision, 0) / (1 - min_precision)
    return float(prec.mean())


def _tp_errors(acc, metric):
    """Average TP error over matches ranked above max-recall, per the
    devkit's cumulative-mean-at-recall scheme simplified to the mean
    over all matches (documented simplification — the devkit averages
    the per-recall-bin cumulative means, which converges to the same
    value for smooth match distributions)."""
    vals = [r[metric] for r in acc['records']
            if r['tp'] and metric in r]
    if not vals:
        return float('nan')
    return float(np.mean(vals))


def nuscenes_eval(gts, preds, classes=NUS_CLASSES):
    """Full protocol over per-sample gt/pred dicts.

    Returns dict with per-class APs, mean TP errors, 'mAP' and 'NDS'.
    """
    metrics = {}
    aps = []
    tp_means = {m: [] for m in TP_METRICS}
    for cls in classes:
        cls_aps = []
        for th in DIST_THRESHOLDS:
            acc = _accumulate(gts, preds, cls, th)
            ap = _ap_from_records(acc)
            metrics[f'{cls}_AP_{th}'] = ap
            if not np.isnan(ap):
                cls_aps.append(ap)
        if cls_aps:
            aps.append(np.mean(cls_aps))
        acc2 = _accumulate(gts, preds, cls, 2.0)
        for m in TP_METRICS:
            e = _tp_errors(acc2, m)
            metrics[f'{cls}_{m}'] = e
            if not np.isnan(e):
                tp_means[m].append(e)
    mAP = float(np.mean(aps)) if aps else 0.0
    metrics['mAP'] = mAP
    # NDS = (5*mAP + sum_tp (1 - min(1, mTP))) / 10 with RAW mean TP
    # errors (ATE meters, ASE 1-IoU, AOE radians, AVE m/s, AAE 1-acc)
    nds_terms = [5.0 * mAP]
    for m in TP_METRICS:
        err = float(np.mean(tp_means[m])) if tp_means[m] else 1.0
        metrics[f'm{m}'] = err
        nds_terms.append(max(0.0, 1.0 - min(1.0, err)))
    metrics['NDS'] = float(sum(nds_terms) / 10.0)
    return metrics
