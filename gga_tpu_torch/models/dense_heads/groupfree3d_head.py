"""GroupFree3D head: KPS candidate sampling and transformer decoding
(port of ``gga_tpu/models/dense_heads/groupfree3d_head.py``; mmdet3d's
GroupFree3DHead and GroupFree3DBBoxCoder), batched over scenes.

Each seed's objectness picks the ``num_proposal`` best seeds (KPS), an
initial head predicts their boxes, then ``num_decoder_layers`` decoder
layers refine them (self-attention with positional encodings of the
current boxes, which are detached, and cross-attention over every seed),
with a prediction head after each. The loss averages every stage's terms
and adds a focal loss on the seeds' objectness against each box's
``seed_points_obj_topk`` nearest (size-normalised) seeds inside it.

State_dict names are mmdet3d's: ``points_obj_cls.mlp.layer{0,1}`` (conv +
BN) and ``.layer2`` (conv with bias), ``conv_pred`` (the proposal head)
and ``prediction_heads.{i}`` (``shared_convs.layer{k}``, ``conv_cls``
[objectness | classes], ``conv_reg`` [centre 3 | dir class b | dir res
b | size class s | size res 3s]), ``decoder_query_proj``,
``decoder_key_proj``, ``decoder_self_posembeds.{i}``,
``decoder_cross_posembeds.{i}`` and ``decoder_layers.{i}``. gga_tpu's
shared convs have no conv bias (mmdet3d's do).

The candidates are the first ``num_proposal`` of a stable descending
sort of the score (-1 on invalid seeds, subnormal scores 0 as on XLA's
CPU, which flushes them), so equal scores keep ``jax.lax.top_k``'s
order: the lower index first. The sampling targets take each box's
nearest seeds the same way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.geometry import corners_3d, points_in_rbbox
from ...core.nms import aligned_3d_nms
from ..backbones.pointnet2 import PointConv, SharedMLP
from ..losses import smooth_l1_loss
from ..model_utils.transformer import GroupFree3DDecoderLayer, PositionalMLP
from .vote_head import SUNRGBD_MEAN_SIZES, _ce, _mod, _take

EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class GroupFree3DConfig:
    num_classes: int = 18
    in_channels: int = 288
    num_proposal: int = 256
    num_decoder_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 2048
    dropout: float = 0.1
    num_dir_bins: int = 1
    with_rot: bool = False
    size_cls_agnostic: bool = False
    mean_sizes: Tuple[Tuple[float, float, float], ...] = \
        SUNRGBD_MEAN_SIZES
    seed_points_obj_topk: int = 4
    # loss weights (configs/_base_/models/groupfree3d.py:40-63)
    sampling_obj_weight: float = 8.0
    obj_weight: float = 1.0
    center_weight: float = 10.0
    dir_class_weight: float = 1.0
    dir_res_weight: float = 10.0
    size_class_weight: float = 1.0
    size_res_weight: float = 10.0 / 3.0
    size_reg_weight: float = 10.0 / 3.0
    semantic_weight: float = 1.0
    # test cfg
    nms_thr: float = 0.25
    score_thr: float = 0.0
    max_out: int = 128

    @property
    def num_sizes(self):
        return len(self.mean_sizes)

    @property
    def n_reg(self):
        return 3 + 2 * self.num_dir_bins + (
            3 if self.size_cls_agnostic else 4 * self.num_sizes)


class PointsObjCls(nn.Module):
    """mmdet3d's PointsObjClsModule: two ConvBN layers and a conv to one
    logit a seed."""

    def __init__(self, channels):
        super().__init__()
        self.mlp = SharedMLP(channels, (channels, channels))
        self.mlp.add_module('layer2', PointConv(channels, 1, bias=True))

    def forward(self, x, valid):
        return self.mlp.layer2(self.mlp(x, valid))[..., 0]


class ConvBboxHead(nn.Module):
    """mmdet3d's BaseConvBboxHead: shared ConvBN layers, then the class
    and the box convs."""

    def __init__(self, cfg: GroupFree3DConfig):
        super().__init__()
        ch = cfg.in_channels
        self.shared_convs = SharedMLP(ch, (ch, ch))
        self.conv_cls = PointConv(ch, 1 + cfg.num_classes, bias=True)
        self.conv_reg = PointConv(ch, cfg.n_reg, bias=True)

    def forward(self, x, valid):
        y = self.shared_convs(x, valid)
        return self.conv_cls(y), self.conv_reg(y)


class GroupFree3DHead(nn.Module):
    def __init__(self, cfg: GroupFree3DConfig):
        super().__init__()
        self.cfg = cfg
        c, ch = cfg, cfg.in_channels
        self.points_obj_cls = PointsObjCls(ch)
        self.conv_pred = ConvBboxHead(cfg)
        self.decoder_query_proj = PointConv(ch, ch, bias=True)
        self.decoder_key_proj = PointConv(ch, ch, bias=True)
        self.decoder_self_posembeds = nn.ModuleList(
            [PositionalMLP(6, ch) for _ in range(c.num_decoder_layers)])
        self.decoder_cross_posembeds = nn.ModuleList(
            [PositionalMLP(3, ch) for _ in range(c.num_decoder_layers)])
        self.decoder_layers = nn.ModuleList(
            [GroupFree3DDecoderLayer(ch, c.num_heads, c.ffn_dim, c.dropout)
             for _ in range(c.num_decoder_layers)])
        self.prediction_heads = nn.ModuleList(
            [ConvBboxHead(cfg) for _ in range(c.num_decoder_layers)])

    def forward(self, feat_dict, cand_idx=None, keep=None):
        """feat_dict: ``PointNet2SASSG``'s (fp_xyz [B, N, 3], fp_features
        [B, N, C], fp_valid [B, N]); ``cand_idx`` [B, num_proposal] the KPS
        picks, chosen here when None; ``keep`` a list of each decoder
        layer's dropout keep masks (``groupfree3d_draws``), needed in
        train mode at a dropout above 0.

        Returns dict: seed_xyz, seed_valid, seeds_obj_cls_logits [B, N],
        cand_idx, cand_xyz, cand_valid and stages (the proposal head's,
        then each decoder layer's prediction dict)."""
        c = self.cfg
        if self.training and c.dropout > 0 and keep is None:
            raise ValueError('a train-mode GroupFree3D forward at dropout '
                             f'{c.dropout} takes its keep masks '
                             '(groupfree3d_draws)')
        seeds = feat_dict['fp_xyz']
        feats = feat_dict['fp_features']
        valid = feat_dict['fp_valid']

        obj_logits = self.points_obj_cls(feats, valid)
        if cand_idx is None:
            # subnormal scores flushed to 0, as XLA's CPU computes them
            # (at batch statistics most logits are far below 0 and tie)
            score = torch.sigmoid(obj_logits.detach())
            score = torch.where(score < torch.finfo(score.dtype).tiny, 0.0,
                                score)
            score = torch.where(valid, score, -1.0)
            cand_idx = torch.sort(score, dim=-1, descending=True,
                                  stable=True).indices[:, :c.num_proposal]
        cand_xyz = _take(seeds, cand_idx)
        cand_feat = _take(feats, cand_idx)
        cand_valid = valid.gather(1, cand_idx)

        stages = [self._split(*self.conv_pred(cand_feat, cand_valid),
                              cand_xyz)]
        query = self.decoder_query_proj(cand_feat)
        key = self.decoder_key_proj(feats)
        base_box6 = self._decode_box6(stages[-1]).detach()
        for i, layer in enumerate(self.decoder_layers):
            qpos = self.decoder_self_posembeds[i](base_box6)
            kpos = self.decoder_cross_posembeds[i](seeds)
            query = layer(query, qpos, key, kpos, valid,
                          None if keep is None else keep[i])
            stages.append(self._split(*self.prediction_heads[i](
                query, cand_valid), cand_xyz))
            base_box6 = self._decode_box6(stages[-1]).detach()
        return dict(seed_xyz=seeds, seed_valid=valid,
                    seeds_obj_cls_logits=obj_logits, cand_idx=cand_idx,
                    cand_xyz=cand_xyz, cand_valid=cand_valid, stages=stages)

    def _split(self, cls, reg, base_xyz):
        """GroupFree3DBBoxCoder.split_pred (groupfree3d_bbox_coder:123)."""
        c = self.cfg
        b = c.num_dir_bins
        out = dict(obj=cls[..., 0], sem=cls[..., 1:],
                   center=base_xyz + reg[..., :3],
                   dir_class=reg[..., 3:3 + b],
                   dir_res_norm=reg[..., 3 + b:3 + 2 * b])
        i = 3 + 2 * b
        if c.size_cls_agnostic:
            out['size'] = reg[..., i:i + 3]
        else:
            out['size_class'] = reg[..., i:i + c.num_sizes]
            out['size_res_norm'] = reg[..., i + c.num_sizes:].reshape(
                *reg.shape[:-1], c.num_sizes, 3)
        return out

    def _decode_box6(self, stage):
        return torch.cat([stage['center'], decode_dims(self.cfg, stage)], -1)


def groupfree3d_draws(cfg, batch_size, generator, device):
    """A train step's dropout keep masks from ``generator`` for the
    detector ``cfg`` describes (a ``GroupFree3DNetConfig``): for each
    decoder layer, dict('self' [M, M], 'cross' [M, N], 'ffn' [B, M,
    ffn_dim]) kept with probability 1 - dropout (M = num_proposal, N the
    seeds); None at a dropout of 0. Drawn on the host and copied from
    pinned memory, so that the copy does not wait for queued work."""
    c, num_seeds = cfg.head, cfg.num_seeds
    if c.dropout <= 0:
        return None
    M, p = c.num_proposal, 1.0 - c.dropout
    dev = torch.device(device)

    def draw(*shape):
        keep = torch.rand(shape, generator=generator) < p
        if dev.type == 'cuda':
            return keep.pin_memory().to(dev, non_blocking=True)
        return keep.to(dev)

    return [dict(self=draw(M, M), cross=draw(M, num_seeds),
                 ffn=draw(batch_size, M, c.ffn_dim))
            for _ in range(c.num_decoder_layers)]


def decode_dims(cfg: GroupFree3DConfig, stage):
    if cfg.size_cls_agnostic:
        return stage['size']
    mean = torch.tensor(cfg.mean_sizes, dtype=torch.float32,
                        device=stage['center'].device)
    scls = stage['size_class'].argmax(-1)
    res = stage['size_res_norm'].gather(
        -2, scls[..., None, None].expand(*scls.shape, 1, 3))[..., 0, :]
    return mean[scls] + res * mean[scls]


def decode_yaw(cfg: GroupFree3DConfig, stage):
    if not cfg.with_rot:
        return torch.zeros(stage['center'].shape[:-1],
                           device=stage['center'].device)
    dcls = stage['dir_class'].argmax(-1)
    res = stage['dir_res_norm'].gather(-1, dcls[..., None])[..., 0] \
        * (np.pi / cfg.num_dir_bins)
    ang = dcls.float() * (2 * np.pi / cfg.num_dir_bins) + res
    return torch.where(ang > np.pi, ang - 2 * np.pi, ang)


@torch.no_grad()
def groupfree3d_targets(cfg: GroupFree3DConfig, gt_boxes, gt_labels,
                        gt_valid, seeds, seed_valid, cand_idx):
    """Targets of a batch (gga_tpu ``groupfree3d_targets_single`` vmapped
    over scenes). gt_boxes [B, G, 7] bottom-centre depth boxes; seeds
    [B, S, 3]; cand_idx [B, M]. Returns the dict of target tensors
    (sampling_targets [B, S], the candidates' [B, M, ...])."""
    B, G = gt_boxes.shape[:2]
    dev = gt_boxes.device
    grav = torch.cat([gt_boxes[..., :2], (gt_boxes[..., 2]
                                          + gt_boxes[..., 5] / 2)[..., None]],
                     -1)
    mean = torch.tensor(cfg.mean_sizes, dtype=torch.float32, device=dev)
    labels = gt_labels.long()
    size_res = gt_boxes[..., 3:6] - mean[labels.clamp(0, cfg.num_sizes - 1)]
    if cfg.with_rot:
        bin_w = 2 * np.pi / cfg.num_dir_bins
        shifted = _mod(_mod(gt_boxes[..., 6], 2 * np.pi) + bin_w / 2,
                       2 * np.pi)
        dir_cls_t = torch.div(shifted, bin_w, rounding_mode='floor').to(
            torch.int32).clamp(0, cfg.num_dir_bins - 1).long()
        dir_res_t = shifted - (dir_cls_t.float() * bin_w + bin_w / 2)
    else:
        dir_cls_t = torch.zeros((B, G), dtype=torch.long, device=dev)
        dir_res_t = torch.zeros((B, G), device=dev)

    # seed instance labels (the first valid box that holds the seed)
    inbox = points_in_rbbox(seeds, gt_boxes) & gt_valid[:, None, :]
    seed_obj = inbox.any(-1) & seed_valid
    seed_inst = torch.where(seed_obj, inbox.to(torch.uint8).argmax(-1),
                            G - 1)

    # sampling targets: each valid box's k nearest seeds of its own
    delta = (seeds[:, :, None, :] - grav[:, None, :, :]) \
        / (gt_boxes[:, None, :, 3:6] + EPS)
    d = torch.sqrt((delta ** 2).sum(-1) + EPS)                 # [B, S, G]
    assigned = inbox & (seed_inst[..., None]
                        == torch.arange(G, device=dev))
    d = torch.where(assigned, d, 100.0).transpose(1, 2)       # [B, G, S]
    k = cfg.seed_points_obj_topk
    topk = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    samp = torch.zeros(seeds.shape[:2], dtype=torch.int32, device=dev)
    samp = samp.scatter_reduce(
        1, topk.reshape(B, G * k),
        gt_valid.to(torch.int32).repeat_interleave(k, dim=1), 'amax')
    samp = (samp > 0) & seed_obj

    cand_obj = seed_obj.gather(1, cand_idx)
    assign = seed_inst.gather(1, cand_idx).clamp(0, G - 1)
    cls_of = labels.gather(1, assign).clamp(0, cfg.num_sizes - 1)
    return dict(
        sampling_targets=samp,
        objectness_targets=cand_obj,
        center_targets=_take(grav, assign),
        size_targets=_take(gt_boxes[..., 3:6], assign),
        size_class_targets=cls_of,
        size_res_targets=_take(size_res, assign) / mean[cls_of],
        dir_class_targets=dir_cls_t.gather(1, assign),
        dir_res_targets=dir_res_t.gather(1, assign)
        / (np.pi / cfg.num_dir_bins),
        mask_targets=labels.gather(1, assign).clamp(0, cfg.num_classes - 1))


def _focal_binary(logits, target, gamma=2.0, alpha=0.25):
    p = torch.sigmoid(logits)
    t = target.float()
    pt = p * t + (1 - p) * (1 - t)
    w = alpha * t + (1 - alpha) * (1 - t)
    ce = -(t * F.logsigmoid(logits) + (1 - t) * F.logsigmoid(-logits))
    return w * (1 - pt) ** gamma * ce


def groupfree3d_loss(cfg: GroupFree3DConfig, preds, gt_boxes, gt_labels,
                     gt_valid):
    """The batch's multi-stage loss (gga_tpu ``groupfree3d_loss``,
    groupfree3d_head.py:394). Returns (total, logs):
    'sampling_objectness_loss', each stage's '{proposal|s<i>}.loss',
    'loss' and 'num_pos' (the candidates inside a box; the port's
    addition)."""
    t = groupfree3d_targets(cfg, gt_boxes, gt_labels, gt_valid,
                            preds['seed_xyz'], preds['seed_valid'],
                            preds['cand_idx'])
    B = preds['seeds_obj_cls_logits'].shape[0]
    sw = preds['seed_valid'].float()
    sw = sw / sw.sum(1, keepdim=True).clamp(min=1.0)
    samp_loss = (_focal_binary(preds['seeds_obj_cls_logits'],
                               t['sampling_targets']) * sw).sum() / B \
        * cfg.sampling_obj_weight
    logs = dict(sampling_objectness_loss=samp_loss)
    total = samp_loss

    stages = preds['stages']
    ow = preds['cand_valid'].float()
    ow = ow / ow.sum(1, keepdim=True).clamp(min=1.0)
    blw = t['objectness_targets'].float()
    blw = blw / (blw.sum() + EPS)
    onehot_dir = F.one_hot(t['dir_class_targets'], cfg.num_dir_bins).float()
    for si, st in enumerate(stages):
        pre = 'proposal' if si == 0 else f's{si - 1}'
        l_obj = (_focal_binary(st['obj'], t['objectness_targets'])
                 * ow).sum() / B * cfg.obj_weight
        l_center = (smooth_l1_loss(st['center'], t['center_targets'])
                    * blw[..., None]).sum() * cfg.center_weight
        l_dcls = (_ce(st['dir_class'], t['dir_class_targets'])
                  * blw).sum() * cfg.dir_class_weight
        dres = (st['dir_res_norm'] * onehot_dir).sum(-1)
        l_dres = (smooth_l1_loss(dres, t['dir_res_targets'])
                  * blw).sum() * cfg.dir_res_weight
        if cfg.size_cls_agnostic:
            l_size = (smooth_l1_loss(st['size'], t['size_targets'])
                      * blw[..., None]).sum() * cfg.size_reg_weight
            l_scls = 0.0
        else:
            l_scls = (_ce(st['size_class'], t['size_class_targets'])
                      * blw).sum() * cfg.size_class_weight
            onehot_s = F.one_hot(t['size_class_targets'],
                                 cfg.num_sizes).float()[..., None]
            sres = (st['size_res_norm'] * onehot_s).sum(-2)
            l_size = (smooth_l1_loss(sres, t['size_res_targets'])
                      * blw[..., None]).sum() * cfg.size_res_weight
        l_sem = (_ce(st['sem'], t['mask_targets'])
                 * blw).sum() * cfg.semantic_weight
        stage_total = (l_obj + l_center + l_dcls + l_dres + l_scls
                       + l_size + l_sem) / len(stages)
        logs[f'{pre}.loss'] = stage_total
        total = total + stage_total
    logs['loss'] = total
    logs['num_pos'] = t['objectness_targets'].float().sum()
    return total, logs


@torch.no_grad()
def decode_groupfree3d(cfg: GroupFree3DConfig, preds):
    """The last stage's boxes and a class-aware axis-aligned NMS (gga_tpu
    ``decode_groupfree3d``, get_bboxes:865). Returns dict: boxes [B, K, 7]
    bottom-centre depth boxes, scores, labels, valid, K = min(max_out,
    num_proposal): the kept boxes by score first, then the rest in order
    with score 0 and valid False."""
    st = preds['stages'][-1]
    scores = torch.sigmoid(st['obj'])[..., None] * torch.softmax(st['sem'],
                                                                 -1)
    score, labels = scores.amax(-1), scores.argmax(-1)
    dims = decode_dims(cfg, st).clamp(min=0.1)
    yaw = decode_yaw(cfg, st)
    center = st['center']
    bottom = torch.cat([center[..., :2],
                        (center[..., 2] - dims[..., 2] / 2)[..., None]], -1)
    boxes = torch.cat([bottom, dims, yaw[..., None]], -1)
    corners = corners_3d(boxes[..., :3], boxes[..., 3:6], boxes[..., 6])
    aligned = torch.cat([corners.amin(-2), corners.amax(-2)], -1)
    keep = aligned_3d_nms(aligned, score, labels, cfg.nms_thr,
                          valid=preds['cand_valid'] & (score > cfg.score_thr))
    order = torch.sort(torch.where(keep, -score, math.inf), dim=-1,
                       stable=True).indices[..., :cfg.max_out]
    kept = keep.gather(-1, order)
    return dict(boxes=_take(boxes, order),
                scores=torch.where(kept, score.gather(-1, order), 0.0),
                labels=labels.gather(-1, order), valid=kept)
