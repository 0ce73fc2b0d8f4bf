"""H3DNet, the hybrid geometric primitive detector (port of
``gga_tpu/models/detectors/h3dnet.py``; mmdet3d's H3DNet and H3DRoIHead
as gga_tpu rebuilt them): MultiBackbone (four PointNet2SASSG towers
fused into one seed feature) -> a VoteHead RPN -> three PrimitiveHeads
(z / xy / line) -> H3DBboxHead, which matches each proposal's face and
edge centres against the predicted primitives and refines the
proposals' features, then a second prediction in the VoteHead layout
(the refined, "optimized" stage). Plain PyTorch: it reaches none of the
port's CUDA kernels.

The loss is the RPN's VoteHead loss, each primitive's, the refined
stage's VoteHead loss (its vote offsets detached, so the RPN's vote
gradient is not doubled) and the two matching scores' binary CE toward
the proposals' objectness (gga_tpu's documented simplification of
mmdet3d's cue targets). The proposals are detached.

The input is ``points [B, P, in_channels]`` (xyz and the height in the
shipped ScanNet config) and ``valid [B, P]``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..backbones.multi_backbone import MultiBackbone, MultiBackboneConfig
from ..backbones.pointnet2 import PointConv, SharedMLP
from ..dense_heads import vote_head as vh
from ..dense_heads.vote_head import VoteHead, VoteHeadConfig
from ..roi_heads.h3d_head import (H3DBboxConfig, H3DBboxHead,
                                  PrimitiveConfig, PrimitiveHead,
                                  primitive_loss)


@dataclasses.dataclass(frozen=True)
class H3DNetConfig:
    backbone: MultiBackboneConfig = dataclasses.field(
        default_factory=MultiBackboneConfig)
    rpn: VoteHeadConfig = dataclasses.field(
        default_factory=lambda: VoteHeadConfig(
            num_classes=18, with_rot=False, num_dir_bins=1))
    primitives: Tuple[PrimitiveConfig, ...] = (
        PrimitiveConfig(mode='z'), PrimitiveConfig(mode='xy'),
        PrimitiveConfig(mode='line'))
    bbox: H3DBboxConfig = dataclasses.field(
        default_factory=H3DBboxConfig)
    matching_weight: float = 1.0

    @classmethod
    def tiny(cls):
        """gga_tpu's tiny config."""
        rpn = VoteHeadConfig(
            num_classes=4, mean_sizes=((1.0, 1.0, 1.0),) * 4,
            with_rot=False, num_dir_bins=1,
            in_channels=16, vote_conv_channels=(16,),
            agg_num_point=16, agg_mlp=(16, 16),
            pred_conv_channels=(16,), max_objs=8, max_out=8,
            pos_distance_thr=0.8, neg_distance_thr=1.2)

        def prim(mode):
            return PrimitiveConfig(
                mode=mode, num_classes=4, in_channels=16,
                vote_conv_channels=(16,), num_proposal=16,
                agg_mlp=(16, 16), feat_channels=(16,))
        return cls(
            backbone=MultiBackboneConfig(
                num_streams=2, num_points=(128, 64, 32, 16),
                sa_channels=((8, 8),) * 4, fp_channels=((16,), (16,)),
                agg_channels=16),
            rpn=rpn,
            primitives=(prim('z'), prim('xy'), prim('line')),
            bbox=H3DBboxConfig(num_classes=4, match_mlp=(16,),
                               agg_channels=(16,)))


class H3DNet(nn.Module):
    def __init__(self, cfg: H3DNetConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = MultiBackbone(cfg.backbone)
        if self.backbone.out_channels != cfg.rpn.in_channels:
            raise ValueError(
                f'the backbone gives {self.backbone.out_channels} channels, '
                f'the RPN takes {cfg.rpn.in_channels}')
        self.rpn_head = VoteHead(cfg.rpn)
        modes = [p.mode for p in cfg.primitives]
        if sorted(modes) != ['line', 'xy', 'z']:
            raise ValueError(f'primitive heads {modes}: H3DNet takes one '
                             "each of 'z', 'xy' and 'line'")
        prims = {p.mode: p for p in cfg.primitives}
        if prims['z'].agg_mlp[-1] != prims['xy'].agg_mlp[-1]:
            raise ValueError('the z and xy primitives are matched together '
                             'and need one width')
        h = cfg.rpn
        self.roi_head = nn.ModuleDict({
            **{f'primitive_{p.mode}': PrimitiveHead(p)
               for p in cfg.primitives},
            'bbox_head': H3DBboxHead(cfg.bbox, h.agg_mlp[-1],
                                     prims['z'].agg_mlp[-1],
                                     prims['line'].agg_mlp[-1]),
            'refine_shared': SharedMLP(h.agg_mlp[-1], h.pred_conv_channels),
            'refine_out': PointConv(h.pred_conv_channels[-1],
                                    2 + h.n_reg + h.num_classes, bias=True)})

    @torch.no_grad()
    def init_weights(self, generator):
        """gga_tpu's initializers, drawn from ``generator``: every 1x1 conv
        uniform in +-1/sqrt(fan_in), biases 0; norms at 1 and 0."""
        for m in self.modules():
            if isinstance(m, PointConv):
                m.init_weights(generator)

    def forward(self, points, valid, sample_idx=None):
        """points [B, P, C >= 3]; valid [B, P]; ``sample_idx`` dict of
        given picks (``sampled_indices``' layout), sampled when None.

        Returns dict: rpn (the VoteHead's proposals), primitives (each
        mode's dict), refined (the refined stage in the VoteHead layout),
        matching (the bbox head's dict), fp_xyz, fp_valid."""
        s = sample_idx or {}
        feat = self.backbone(points, valid, s.get('backbone'))
        rpn = self.rpn_head(feat, s.get('rpn'))
        roi = self.roi_head
        prims = {p.mode: roi[f'primitive_{p.mode}'](
            feat['fp_xyz'], feat['hd_feature'], feat['fp_valid'],
            s.get(p.mode)) for p in self.cfg.primitives}
        proposals = self._rpn_boxes(rpn).detach()

        def cat(key, *modes):
            return torch.cat([prims[m][key] for m in modes], 1)
        surface = dict(center=cat('matched_center', 'z', 'xy'),
                       feats=cat('agg_feats', 'z', 'xy'),
                       valid=cat('agg_valid', 'z', 'xy'))
        line = dict(center=prims['line']['matched_center'],
                    feats=prims['line']['agg_feats'],
                    valid=prims['line']['agg_valid'])
        refine = roi['bbox_head'](proposals, rpn['agg_feats'],
                                  rpn['agg_valid'], surface, line)

        h = self.cfg.rpn
        b, n_s = h.num_dir_bins, h.num_sizes
        pred = roi['refine_out'](roi['refine_shared'](
            refine['refined_feats'], rpn['agg_valid']))
        refined = dict(rpn)
        refined['vote_offset'] = rpn['vote_offset'].detach()
        refined.update(
            obj=pred[..., :2], center=rpn['agg_xyz'] + pred[..., 2:5],
            dir_cls=pred[..., 5:5 + b],
            dir_res_norm=pred[..., 5 + b:5 + 2 * b],
            size_cls=pred[..., 5 + 2 * b:5 + 2 * b + n_s],
            size_res_norm=pred[..., 5 + 2 * b + n_s:5 + 2 * b + 4 * n_s]
            .reshape(*pred.shape[:-1], n_s, 3),
            sem=pred[..., 5 + 2 * b + 4 * n_s:])
        return dict(rpn=rpn, primitives=prims, refined=refined,
                    matching=refine, fp_xyz=feat['fp_xyz'],
                    fp_valid=feat['fp_valid'])

    def sampled_indices(self, out=None):
        """The picks of the last forward, in the layout ``forward`` takes
        back: 'backbone' (each tower's list of level indices), 'rpn' and
        each primitive mode (their aggregations' indices)."""
        roi = self.roi_head
        return dict(
            backbone=[[sa.last_idx for sa in t.SA_modules]
                      for t in self.backbone.backbone_list],
            rpn=self.rpn_head.vote_aggregation.last_idx,
            **{p.mode: roi[f'primitive_{p.mode}'].vote_aggregation.last_idx
               for p in self.cfg.primitives})

    def _rpn_boxes(self, preds):
        dims = vh_decode_dims(self.cfg.rpn, preds)
        center = preds['center']
        return torch.cat([center[..., :2],
                          (center[..., 2] - dims[..., 2] / 2)[..., None],
                          dims, torch.zeros_like(dims[..., :1])], -1)


def vh_decode_dims(cfg: VoteHeadConfig, preds):
    """The proposals' sizes: the mean size of the size class, plus its
    residual times it, at least 0.1."""
    mean = torch.tensor(cfg.mean_sizes, dtype=torch.float32,
                        device=preds['center'].device)
    scls = preds['size_cls'].argmax(-1)
    res = preds['size_res_norm'].gather(
        -2, scls[..., None, None].expand(*scls.shape, 1, 3))[..., 0, :] \
        * mean[scls]
    return (mean[scls] + res).clamp(min=0.1)


def _stage_targets(cfg: H3DNetConfig, preds, gt_boxes, gt_labels, gt_valid):
    return vh.build_targets(cfg.rpn, preds['seed_xyz'], preds['seed_valid'],
                            preds['agg_xyz'], preds['agg_valid'], gt_boxes,
                            gt_labels, gt_valid)


def h3dnet_loss(cfg: H3DNetConfig, out, gt_boxes, gt_labels, gt_valid):
    """The batch's loss (gga_tpu ``h3dnet_loss``). Returns (total, logs):
    'loss_rpn', 'loss_refined' and the refined stage's terms as
    'refined.<term>', each primitive's five terms, 'loss_matching_score',
    'loss_semantic_matching_score' and 'loss'."""
    logs = {}
    total = 0.0
    rpn_t = None
    for stage in ('rpn', 'refined'):
        preds = out[stage]
        targets = _stage_targets(cfg, preds, gt_boxes, gt_labels, gt_valid)
        rpn_t = targets if stage == 'rpn' else rpn_t
        tot, stage_logs = vh.loss(cfg.rpn, preds, targets)
        total = total + tot
        logs[f'loss_{stage}'] = tot
        if stage == 'refined':
            logs.update({f'refined.{k}': v for k, v in stage_logs.items()
                         if k != 'loss'})

    for pc in cfg.primitives:
        ptot, plogs = primitive_loss(
            pc, out['primitives'][pc.mode], out['fp_xyz'], out['fp_valid'],
            gt_boxes, gt_labels, gt_valid)
        total = total + ptot
        logs.update(plogs)

    # the matching scores: binary CE of their mean toward the proposals'
    # objectness
    tgt = rpn_t['objectness_t'].float()
    m = out['rpn']['agg_valid'].float()
    for key in ('matching_score', 'semantic_matching_score'):
        logit = out['matching'][key].mean(-1)
        bce = (F.relu(logit) - logit * tgt
               + torch.log1p(torch.exp(-logit.abs())))
        loss = (bce * m).sum() / m.sum().clamp(min=1.0) * cfg.matching_weight
        logs[f'loss_{key}'] = loss
        total = total + loss
    logs['loss'] = total
    return total, logs


@torch.no_grad()
def decode_h3dnet(cfg: H3DNetConfig, out):
    """The refined stage's boxes through VoteHead's decode."""
    return vh.decode(cfg.rpn, out['refined'])
