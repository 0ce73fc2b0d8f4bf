"""FreeAnchor3DHead's loss (port of
``gga_tpu/models/dense_heads/free_anchor3d_head.py``): the network is
Anchor3DHead's; only the loss differs. Each GT owns a bag of its top-k
anchors by nearest-BEV IoU; the positive loss is a mean-max soft BCE over
the bag's cls x box likelihoods (box likelihood exp(-smooth-L1 - dir
CE)); the negative loss a focal BCE on cls_prob * (1 - P[the anchor
explains some object]), that probability a saturated-linear function of
the decoded boxes' IoU with the GTs.

gga_tpu vmaps a scene's [G, A] formulation over the batch and takes the
per-class probability as the max over G of a [G, A, C] product. At
nuScenes' width (G = 128, A = 800 000, C = 10) that product is 4.1 GB a
scene, so the port walks the batch scene by scene and takes the same max
as a per-class ``index_reduce_('amax')`` of the [G, A] probabilities into
[C, A]: exact, since a max does not round and every term is >= 0.

The bags keep ``jax.lax.top_k``'s order: IoU descending, the lower anchor
index first among equal IoUs (the rule on a regular anchor grid, where a
box centred between anchors meets several at the same IoU). The IoU is
>= 0, so its f32 bits order as integers, and ``torch.topk`` of the key
(bits << 32) | (2^32 - 1 - index) has no ties.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ...core.coders import delta_decode, delta_encode
from ...core.geometry import limit_period
from .anchor3d_head import Anchor3DConfig, _bev_iou, _flat, _nearest_bev


@dataclasses.dataclass(frozen=True)
class FreeAnchor3DConfig(Anchor3DConfig):
    pre_anchor_topk: int = 50
    bbox_thr: float = 0.6
    gamma: float = 2.0
    alpha: float = 0.5


def _flatten_preds(cfg, preds):
    """NHWC maps -> per-anchor rows in ``make_anchors``' class-major
    [C, H*W*R] order: cls [B, A, C], reg [B, A, 7], dir [B, A, 2]."""
    C, R = cfg.num_classes, len(cfg.rotations)
    B = preds['cls'].shape[0]
    return tuple(_flat(preds[k], C, R, ch).reshape(B, -1, ch)
                 for k, ch in (('cls', C), ('reg', 7), ('dir', 2)))


def top_k_first(values, k):
    """``jax.lax.top_k(values, k)``'s indices of non-negative f32
    ``values`` [..., N] (N < 2^32): descending, the lower index first among
    equal values."""
    n = values.shape[-1]
    idx = torch.arange(n, device=values.device)
    key = (values.contiguous().view(torch.int32).long() << 32) \
        | (0xFFFFFFFF - idx)
    return 0xFFFFFFFF - (key.topk(k, -1).values & 0xFFFFFFFF)


def class_max(obj, labels, valid, num_classes):
    """[C, A]: each class's max over its valid GTs' rows of ``obj`` [G, A]
    (values in [0, 1]; 0 for a class without one) = gga_tpu's max over G
    of ``obj[:, :, None] * (one_hot(labels, C) * valid)[:, None, :]``,
    bit for bit."""
    known = valid & (labels >= 0) & (labels < num_classes)
    obj = torch.where(known[:, None], obj, 0.0)
    return obj.new_zeros(num_classes, obj.shape[1]).index_reduce_(
        0, labels.clamp(0, num_classes - 1), obj, 'amax')


def _scene(cfg, anc, anc_bev, cls_s, reg_s, dir_s, gb, gl, gv):
    """One scene's (positive bag loss, negative bag loss) sums."""
    C, k = cfg.num_classes, cfg.pre_anchor_topk
    cls_prob = torch.sigmoid(cls_s)                        # [A, C]
    gb_bev = _nearest_bev(gb)
    with torch.no_grad():
        # anchor -> object probability from the decoded boxes' IoU
        pred_boxes = delta_decode(reg_s, anc)
        iou = _bev_iou(gb_bev, _nearest_bev(pred_boxes))   # [G, A]
        iou = torch.where(gv[:, None], iou, -1.0)
        t1 = cfg.bbox_thr
        t2 = iou.amax(1, keepdim=True).clamp(min=t1 + 1e-6)
        obj = ((iou - t1) / (t2 - t1)).clamp(0.0, 1.0)
        del iou
        image_box_prob = class_max(obj, gl, gv, C)
        del obj
        # bags: each GT's top-k anchors by anchor IoU
        matched = top_k_first(_bev_iou(gb_bev, anc_bev), k)  # [G, k]

    label = gl.clamp(0, C - 1)
    m_cls = cls_prob[matched, label[:, None].expand(-1, k)]   # [G, k]
    m_anc = anc[matched]                                      # [G, k, 7]
    m_targets = delta_encode(gb[:, None, :].expand(m_anc.shape), m_anc)
    m_reg = reg_s[matched]

    rot = limit_period(gb[:, None, 6].expand(-1, k) - cfg.dir_offset, 0,
                       2 * np.pi)
    # truncation toward zero, as gga_tpu's astype(int32); rot >= 0
    dir_t = (rot / np.pi).long().clamp(0, 1)
    dir_ce = -F.log_softmax(dir_s[matched], -1).gather(
        -1, dir_t[..., None])[..., 0]

    rs = torch.sin(m_reg[..., 6]) * torch.cos(m_targets[..., 6])
    rt = torch.cos(m_reg[..., 6]) * torch.sin(m_targets[..., 6])
    diff = torch.cat([m_reg[..., :6] - m_targets[..., :6],
                      (rs - rt)[..., None]], -1)
    beta = 1.0 / 9.0
    sl1 = torch.where(diff.abs() < beta, 0.5 * diff ** 2 / beta,
                      diff.abs() - 0.5 * beta)
    m_box_prob = torch.exp(-(sl1.sum(-1) * cfg.loss_bbox_weight + dir_ce))

    # positive bag loss: mean-max
    m_prob = m_cls * m_box_prob
    w = 1.0 / (1.0 - m_prob).clamp(min=1e-12)
    w = w / w.sum(1, keepdim=True)
    bag_prob = (w * m_prob).sum(1).clamp(0.0, 1.0)
    pos = -cfg.alpha * torch.log(bag_prob.clamp(1e-12, 1.0))
    pos = torch.where(gv, pos, 0.0).sum()

    # negative bag loss: focal BCE toward 0
    prob = (cls_prob * (1 - image_box_prob.T)).clamp(0.0, 1.0)
    neg = (prob ** cfg.gamma
           * -torch.log((1 - prob).clamp(1e-12, 1.0))).sum()
    return pos, neg


def free_anchor_loss(cfg: FreeAnchor3DConfig, preds, anchors, gt_boxes,
                     gt_labels, gt_valid):
    """The batch's FreeAnchor loss.

    Args:
        preds: Anchor3DHead's NHWC maps.
        anchors: [C, A, 7] from ``make_anchors``.
        gt_boxes [B, G, 7] bottom-centre lidar; gt_labels [B, G];
            gt_valid [B, G].
    Returns:
        (total, logs: 'positive_bag_loss', 'negative_bag_loss', 'loss' and
        'num_pos', the count of valid GTs that normalises them).
    """
    cls_map, reg_map, dir_map = _flatten_preds(cfg, preds)
    anc = anchors.reshape(-1, 7)
    anc_bev = _nearest_bev(anc)
    pos, neg = zip(*(
        _scene(cfg, anc, anc_bev, cls_map[b], reg_map[b], dir_map[b],
               gt_boxes[b], gt_labels[b], gt_valid[b])
        for b in range(cls_map.shape[0])))
    npos = gt_valid.sum()
    num_pos = npos.clamp(min=1)
    positive_bag_loss = torch.stack(pos).sum() / num_pos
    negative_bag_loss = (1 - cfg.alpha) * torch.stack(neg).sum() / (
        num_pos * cfg.pre_anchor_topk).clamp(min=1)
    total = positive_bag_loss + negative_bag_loss
    return total, dict(positive_bag_loss=positive_bag_loss,
                       negative_bag_loss=negative_bag_loss, loss=total,
                       num_pos=npos.float())
