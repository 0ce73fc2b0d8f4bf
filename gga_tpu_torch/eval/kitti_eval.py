"""KITTI AP evaluation (AP11 / AP40, bbox / BEV / 3D / AOS); the port's
copy of ``gga_tpu/eval/kitti_eval.py``.

Numpy port of the reference's numba evaluator
(mmdet3d/core/evaluation/kitti_utils/eval.py): clean_data
(:30), get_thresholds (:10), compute_statistics_jit (:164), eval_class
(:452), do_eval (:596) and kitti_eval (:662). The numba-CUDA rotated IoU
(rotate_iou.py:337) is replaced by the vectorized polygon-clipping overlap
in ``core.np_rotated_iou`` — eval runs offline on host, no numba needed.
"""
from __future__ import annotations

import numpy as np

from ..core.np_rotated_iou import rotated_iou_camera_eval

CLASS_TO_NAME = {0: 'Car', 1: 'Pedestrian', 2: 'Cyclist', 3: 'Van',
                 4: 'Person_sitting'}
NAME_TO_CLASS = {v: k for k, v in CLASS_TO_NAME.items()}
N_SAMPLE_PTS = 41
NO_DETECTION = -10000000


def get_thresholds(scores, num_gt, num_sample_pts=41):
    """Score thresholds at ~uniform recall positions (eval.py:10)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if (((r_recall - current_recall) < (current_recall - l_recall))
                and (i < len(scores) - 1)):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return np.array(thresholds)


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    """Assign ignore levels per KITTI protocol (eval.py:30)."""
    CLASS_NAMES = ['car', 'pedestrian', 'cyclist']
    MIN_HEIGHT = [40, 25, 25]
    MAX_OCCLUSION = [0, 1, 2]
    MAX_TRUNCATION = [0.15, 0.3, 0.5]
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    cls_name = CLASS_NAMES[current_class]
    num_valid_gt = 0
    for i in range(len(gt_anno['name'])):
        gt_name = gt_anno['name'][i].lower()
        height = gt_anno['bbox'][i, 3] - gt_anno['bbox'][i, 1]
        if gt_name == cls_name:
            valid_class = 1
        elif cls_name == 'pedestrian' and gt_name == 'person_sitting':
            valid_class = 0
        elif cls_name == 'car' and gt_name == 'van':
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno['occluded'][i] > MAX_OCCLUSION[difficulty]
                  or gt_anno['truncated'][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno['name'][i] == 'DontCare':
            dc_bboxes.append(gt_anno['bbox'][i])
    for i in range(len(dt_anno['name'])):
        valid_class = 1 if dt_anno['name'][i].lower() == cls_name else -1
        height = abs(dt_anno['bbox'][i, 3] - dt_anno['bbox'][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """Vectorized 2D overlap matching eval.py:86 exactly (no eps)."""
    N, K = boxes.shape[0], query_boxes.shape[0]
    if N == 0 or K == 0:
        return np.zeros((N, K))
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area_b = ((boxes[:, 2] - boxes[:, 0])
              * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0])
              * (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    if criterion == -1:
        ua = area_b + area_q - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_b, inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area_q, inter.shape)
    else:
        ua = np.ones_like(inter)
    return np.where(inter > 0, inter / ua, 0.0)


def bev_box_overlap(boxes, qboxes, criterion=-1):
    """[N, 5] x [K, 5] camera (x, z, l, w, ry) rotated overlap."""
    if boxes.shape[0] == 0 or qboxes.shape[0] == 0:
        return np.zeros((boxes.shape[0], qboxes.shape[0]))
    return rotated_iou_camera_eval(boxes, qboxes, criterion)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """Camera-frame 3D overlap (eval.py:124): BEV rotated inter x height
    overlap along camera y (boxes are (x,y,z,l,h,w,ry), y points down,
    y is the bottom)."""
    N, K = boxes.shape[0], qboxes.shape[0]
    if N == 0 or K == 0:
        return np.zeros((N, K))
    rinc = rotated_iou_camera_eval(boxes[:, [0, 2, 3, 5, 6]],
                                   qboxes[:, [0, 2, 3, 5, 6]], 2)
    iw = (np.minimum(boxes[:, None, 1], qboxes[None, :, 1])
          - np.maximum(boxes[:, None, 1] - boxes[:, None, 4],
                       qboxes[None, :, 1] - qboxes[None, :, 4]))
    inc = np.where(iw > 0, iw * rinc, 0.0)
    a1 = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    a2 = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    if criterion == -1:
        ua = a1 + a2 - inc
    elif criterion == 0:
        ua = np.broadcast_to(a1, inc.shape)
    elif criterion == 1:
        ua = np.broadcast_to(a2, inc.shape)
    else:
        ua = inc
    return np.where((rinc > 0) & (iw > 0),
                    inc / np.where(ua == 0, 1, ua), 0.0)


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt,
                       ignored_det, dc_bboxes, metric, min_overlap,
                       thresh=0.0, compute_fp=False, compute_aos=False):
    """Faithful port of compute_statistics_jit (eval.py:164)."""
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [False] * det_size
    if compute_fp:
        for i in range(det_size):
            if dt_scores[i] < thresh:
                ignored_threshold[i] = True
    tp, fp, fn, similarity = 0, 0, 0, 0
    thresholds = np.zeros((gt_size,))
    thresh_idx = 0
    delta = np.zeros((gt_size,))
    delta_idx = 0
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0
        assigned_ignored_det = False
        for j in range(det_size):
            if (ignored_det[j] == -1 or assigned_detection[j]
                    or ignored_threshold[j]):
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if (not compute_fp and overlap > min_overlap
                    and dt_score > valid_detection):
                det_idx = j
                valid_detection = dt_score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == NO_DETECTION
                  and ignored_det[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif (valid_detection != NO_DETECTION
              and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1)):
            assigned_detection[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds[thresh_idx] = dt_scores[det_idx]
            thresh_idx += 1
            if compute_aos:
                delta[delta_idx] = gt_alphas[i] - dt_alphas[det_idx]
                delta_idx += 1
            assigned_detection[det_idx] = True
    if compute_fp:
        for i in range(det_size):
            if not (assigned_detection[i] or ignored_det[i] == -1
                    or ignored_det[i] == 1 or ignored_threshold[i]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            overlaps_dt_dc = image_box_overlap(
                dt_bboxes, np.asarray(dc_bboxes).reshape(-1, 4), 0)
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if (assigned_detection[j] or ignored_det[j] in (-1, 1)
                            or ignored_threshold[j]):
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned_detection[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = np.zeros((fp + delta_idx,))
            for i in range(delta_idx):
                tmp[i + fp] = (1.0 + np.cos(delta[i])) / 2.0
            similarity = np.sum(tmp) if (tp > 0 or fp > 0) else -1
    return tp, fp, fn, similarity, thresholds[:thresh_idx]


def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    gt_list, dt_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_num_valid_gt = 0
    for g, d in zip(gt_annos, dt_annos):
        num_valid_gt, ig, idt, dc = clean_data(g, d, current_class,
                                               difficulty)
        ignored_gts.append(np.array(ig, np.int64))
        ignored_dets.append(np.array(idt, np.int64))
        dontcares.append(np.stack(dc, 0).astype(np.float64)
                         if dc else np.zeros((0, 4)))
        total_num_valid_gt += num_valid_gt
        gt_list.append(np.concatenate(
            [g['bbox'], g['alpha'][..., None]], 1))
        dt_list.append(np.concatenate(
            [d['bbox'], d['alpha'][..., None], d['score'][..., None]], 1))
    return (gt_list, dt_list, ignored_gts, ignored_dets, dontcares,
            total_num_valid_gt)


def calculate_iou_partly(gt_annos, dt_annos, metric, num_parts=50):
    """Per-image overlap matrices (eval.py:343). num_parts kept for API
    parity; overlaps are computed per image here.

    NOTE (reference quirk kept): like the reference, callers pass
    (dt_annos, gt_annos) — the first argument indexes ROWS of each overlap
    matrix, so overlaps[i] is [num_first_i, num_second_i]."""
    assert len(gt_annos) == len(dt_annos)
    overlaps = []
    for g, d in zip(gt_annos, dt_annos):
        if metric == 0:
            o = image_box_overlap(np.asarray(g['bbox']).reshape(-1, 4),
                                  np.asarray(d['bbox']).reshape(-1, 4))
        elif metric == 1:
            gb = np.concatenate([g['location'][:, [0, 2]],
                                 g['dimensions'][:, [0, 2]],
                                 g['rotation_y'][..., None]], 1)
            db = np.concatenate([d['location'][:, [0, 2]],
                                 d['dimensions'][:, [0, 2]],
                                 d['rotation_y'][..., None]], 1)
            o = bev_box_overlap(gb, db).astype(np.float64)
        elif metric == 2:
            gb = np.concatenate([g['location'], g['dimensions'],
                                 g['rotation_y'][..., None]], 1)
            db = np.concatenate([d['location'], d['dimensions'],
                                 d['rotation_y'][..., None]], 1)
            o = d3_box_overlap(gb, db).astype(np.float64)
        else:
            raise ValueError('unknown metric')
        overlaps.append(o)
    total_gt = np.array([len(a['name']) for a in gt_annos])
    total_dt = np.array([len(a['name']) for a in dt_annos])
    return overlaps, overlaps, total_gt, total_dt


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False):
    """eval.py:452 — per (class, difficulty, min_overlap) PR curves."""
    assert len(gt_annos) == len(dt_annos)
    overlaps, _, _, _ = calculate_iou_partly(dt_annos, gt_annos, metric)
    num_minoverlap = len(min_overlaps)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap,
                          N_SAMPLE_PTS])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)
    for m, current_class in enumerate(current_classes):
        for ld, difficulty in enumerate(difficultys):
            (gt_list, dt_list, ignored_gts, ignored_dets, dontcares,
             total_num_valid_gt) = _prepare_data(
                 gt_annos, dt_annos, current_class, difficulty)
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                thresholdss = []
                for i in range(len(gt_annos)):
                    _, _, _, _, th = compute_statistics(
                        overlaps[i], gt_list[i], dt_list[i],
                        ignored_gts[i], ignored_dets[i], dontcares[i],
                        metric, min_overlap, 0.0, compute_fp=False)
                    thresholdss += th.tolist()
                if total_num_valid_gt == 0:
                    continue
                thresholds = get_thresholds(np.array(thresholdss),
                                            total_num_valid_gt)
                pr = np.zeros([len(thresholds), 4])
                for i in range(len(gt_annos)):
                    for t, th in enumerate(thresholds):
                        tp, fp, fn, sim, _ = compute_statistics(
                            overlaps[i], gt_list[i], dt_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i],
                            metric, min_overlap, th, compute_fp=True,
                            compute_aos=compute_aos)
                        pr[t, 0] += tp
                        pr[t, 1] += fp
                        pr[t, 2] += fn
                        if sim != -1:
                            pr[t, 3] += sim
                for i in range(len(thresholds)):
                    recall[m, ld, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, ld, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, ld, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                for i in range(len(thresholds)):
                    precision[m, ld, k, i] = np.max(
                        precision[m, ld, k, i:], axis=-1)
                    recall[m, ld, k, i] = np.max(recall[m, ld, k, i:],
                                                 axis=-1)
                    if compute_aos:
                        aos[m, ld, k, i] = np.max(aos[m, ld, k, i:],
                                                  axis=-1)
    return dict(recall=recall, precision=precision, orientation=aos)


def get_mAP11(prec):
    return sum(prec[..., i] for i in range(0, prec.shape[-1], 4)) / 11 * 100


def get_mAP40(prec):
    return sum(prec[..., i] for i in range(1, prec.shape[-1])) / 40 * 100


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
            eval_types=('bbox', 'bev', '3d')):
    difficultys = [0, 1, 2]
    out = [None] * 8
    if 'bbox' in eval_types:
        ret = eval_class(gt_annos, dt_annos, current_classes, difficultys,
                         0, min_overlaps, compute_aos='aos' in eval_types)
        out[0] = get_mAP11(ret['precision'])
        out[4] = get_mAP40(ret['precision'])
        if 'aos' in eval_types:
            out[3] = get_mAP11(ret['orientation'])
            out[7] = get_mAP40(ret['orientation'])
    if 'bev' in eval_types:
        ret = eval_class(gt_annos, dt_annos, current_classes, difficultys,
                         1, min_overlaps)
        out[1] = get_mAP11(ret['precision'])
        out[5] = get_mAP40(ret['precision'])
    if '3d' in eval_types:
        ret = eval_class(gt_annos, dt_annos, current_classes, difficultys,
                         2, min_overlaps)
        out[2] = get_mAP11(ret['precision'])
        out[6] = get_mAP40(ret['precision'])
    return tuple(out)


def kitti_eval(gt_annos, dt_annos, current_classes,
               eval_types=('bbox', 'bev', '3d')):
    """Full KITTI evaluation; returns (result string, metrics dict with
    'KITTI/{cls}_{3D,BEV,2D}_AP{11,40}_{difficulty}_{strict,loose}' keys
    — eval.py:662)."""
    eval_types = list(eval_types)
    assert eval_types, 'must contain at least one evaluation type'
    overlap_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5]] * 3)
    overlap_0_5 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25],
                            [0.5, 0.25, 0.25, 0.5, 0.25]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], 0)  # [2, 3, 5]
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    classes_int = [NAME_TO_CLASS[c] if isinstance(c, str) else c
                   for c in current_classes]
    min_overlaps = min_overlaps[:, :, classes_int]

    compute_aos = False
    pred_alpha = any((a['alpha'] != -10).any() for a in dt_annos
                     if len(a['alpha']))
    valid_alpha_gt = any(len(a['alpha']) and a['alpha'][0] != -10
                         for a in gt_annos)
    compute_aos = pred_alpha and valid_alpha_gt
    if compute_aos:
        eval_types.append('aos')

    (mAP11_bbox, mAP11_bev, mAP11_3d, mAP11_aos, mAP40_bbox, mAP40_bev,
     mAP40_3d, mAP40_aos) = do_eval(gt_annos, dt_annos, classes_int,
                                    min_overlaps, eval_types)
    ret = {}
    result = ''
    difficulty = ['easy', 'moderate', 'hard']
    for tag, m3d, mbev, mbbox, maos in (
            ('AP11', mAP11_3d, mAP11_bev, mAP11_bbox, mAP11_aos),
            ('AP40', mAP40_3d, mAP40_bev, mAP40_bbox, mAP40_aos)):
        result += f'\n----------- {tag} Results ------------\n\n'
        for j, curcls in enumerate(classes_int):
            name = CLASS_TO_NAME[curcls]
            for i in range(min_overlaps.shape[0]):
                result += ('{} {}@{:.2f}, {:.2f}, {:.2f}:\n'.format(
                    name, tag, *min_overlaps[i, :, j]))
                for label, arr in (('bbox', mbbox), ('bev ', mbev),
                                   ('3d  ', m3d), ('aos ', maos)):
                    if arr is not None:
                        result += '{} {}:{:.4f}, {:.4f}, {:.4f}\n'.format(
                            label, tag, *arr[j, :, i])
                for idx in range(3):
                    postfix = (f'{difficulty[idx]}_strict' if i == 0
                               else f'{difficulty[idx]}_loose')
                    prefix = f'KITTI/{name}'
                    if m3d is not None:
                        ret[f'{prefix}_3D_{tag}_{postfix}'] = m3d[j, idx, i]
                    if mbev is not None:
                        ret[f'{prefix}_BEV_{tag}_{postfix}'] = \
                            mbev[j, idx, i]
                    if mbbox is not None:
                        ret[f'{prefix}_2D_{tag}_{postfix}'] = \
                            mbbox[j, idx, i]
        if len(classes_int) > 1:
            # class-mean APs, strict-overlap column (eval.py:776-816)
            result += ('\nOverall {}@{}, {}, {}:\n'.format(
                tag, *difficulty))
            for label, arr in (('2D', mbbox), ('BEV', mbev), ('3D', m3d),
                               ('aos', maos)):
                if arr is None:
                    continue
                ov = arr.mean(axis=0)
                result += '{:4s} {}:{:.4f}, {:.4f}, {:.4f}\n'.format(
                    label.lower(), tag, *ov[:, 0])
                if label == 'aos':   # printed but not keyed (eval.py:797)
                    continue
                for idx in range(3):
                    ret[f'KITTI/Overall_{label}_{tag}_'
                        f'{difficulty[idx]}'] = ov[idx, 0]
    return result, ret
