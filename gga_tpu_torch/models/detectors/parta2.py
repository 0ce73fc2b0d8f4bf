"""PartA2, the two-stage LiDAR detector (port of
``gga_tpu/models/detectors/parta2.py``; mmdet3d's parta2.py and
configs/_base_/models/parta2.py): hard voxelization -> HardSimpleVFE ->
SparseUNet -> SECOND -> SECONDFPN -> the RPN (``rpn_head``), the
point-wise semantic head on the UNet's voxel features, then the
proposals, their assignment and sampling (train) or the test proposals,
RoI-aware pooling and the part-aggregation bbox head (``roi_head``).

In train mode (``model.train()``) every batch norm uses the batch's
statistics and updates its running ones, as gga_tpu's ``train=True``,
and the forward takes the GT boxes and the step's random draws
(``parta2_draws``: the sampler's uniform draw, where gga_tpu splits its
``rng`` a scene, and the dropout keep masks). ``parta2_loss`` sums the
RPN, semantic and RCNN losses; ``decode_parta2`` refines the RoIs and
runs the class-agnostic rotated NMS.

The detector computes in f32: gga_tpu's config has no compute dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn

from ...core.nms import nms_bev
from ..backbones.second import SECOND
from ..dense_heads import anchor3d_head as ah
from ..dense_heads.anchor3d_head import Anchor3DConfig, Anchor3DHead
from ..dense_heads.parta2_rpn_head import rpn_proposals
from ..layers import init_params
from ..middle_encoders import SparseUNet
from ..necks.second_fpn import SECONDFPN
from ..roi_heads.part_aggregation import (RoIHeadConfig, assign_and_sample,
                                          build_rcnn_targets,
                                          pool_roi_features)
from ..roi_heads.parta2_bbox_head import (PartA2BboxConfig, PartA2BboxHead,
                                          bbox_head_loss, decode_refined)
from ..roi_heads.semantic_head import (PointwiseSemanticHead, semantic_loss,
                                       semantic_targets)
from ..voxel_encoders import HardSimpleVFE
from .voxelnet import _voxelize


@dataclasses.dataclass(frozen=True)
class PartA2Config:
    """configs/_base_/models/parta2.py (copy of gga_tpu's config)."""
    voxel_size: Tuple[float, float, float] = (0.05, 0.05, 0.1)
    point_cloud_range: Tuple[float, ...] = (0, -40, -3, 70.4, 40, 1)
    max_points_per_voxel: int = 5
    max_voxels: int = 16000
    sparse_shape: Tuple[int, int, int] = (41, 1600, 1408)
    unet_channels: Sequence[Sequence[int]] = (
        (16,), (32, 32, 32), (64, 64, 64), (64, 64, 64))
    unet_decoder_channels: Sequence[Sequence[int]] = (
        (64, 64, 64), (64, 64, 32), (32, 32, 16), (16, 16, 16))
    unet_budgets: Tuple[int, ...] = (16000, 14000, 12000)
    unet_out_budget: int = 12000
    unet_out_channels: int = 128
    backbone_channels: Tuple[int, ...] = (128, 256)
    backbone_layers: Tuple[int, ...] = (5, 5)
    backbone_strides: Tuple[int, ...] = (1, 2)
    neck_channels: Tuple[int, ...] = (256, 256)
    neck_strides: Tuple[int, ...] = (1, 2)
    rpn: Anchor3DConfig = dataclasses.field(
        default_factory=lambda: Anchor3DConfig(
            feat_channels=512,
            anchor_ranges=((0, -40, -0.6, 70.4, 40, -0.6),
                           (0, -40, -0.6, 70.4, 40, -0.6),
                           (0, -40, -1.78, 70.4, 40, -1.78))))
    roi: RoIHeadConfig = dataclasses.field(default_factory=RoIHeadConfig)
    bbox: PartA2BboxConfig = dataclasses.field(
        default_factory=PartA2BboxConfig)
    # proposal cfg (train_cfg.rpn_proposal / test_cfg.rpn; gga_tpu's
    # static nms_pre of 1024 for the reference's 9000)
    train_nms_pre: int = 1024
    train_nms_thr: float = 0.8
    train_proposals: int = 512
    test_nms_pre: int = 1024
    test_nms_thr: float = 0.7
    test_proposals: int = 100

    @classmethod
    def tiny(cls):
        rpn = Anchor3DConfig(
            feat_channels=32, nms_pre=64, max_num=16,
            anchor_ranges=((0, -40, -0.6, 70.4, 40, -0.6),
                           (0, -40, -0.6, 70.4, 40, -0.6),
                           (0, -40, -1.78, 70.4, 40, -1.78)))
        return cls(
            voxel_size=(0.4, 0.5, 0.1), max_voxels=1024,
            sparse_shape=(41, 160, 176),
            unet_channels=((4,), (8, 8), (8, 8), (8, 8)),
            unet_decoder_channels=((8, 8, 8), (8, 8, 8), (8, 8, 4),
                                   (4, 4, 4)),
            unet_budgets=(1024, 1024, 1024), unet_out_budget=1024,
            unet_out_channels=8,
            backbone_channels=(16, 32), backbone_layers=(1, 1),
            neck_channels=(16, 16),
            rpn=rpn,
            roi=RoIHeadConfig(num_rois=16, roi_out_size=6,
                              roi_pts_budget=64),
            bbox=PartA2BboxConfig(
                seg_in_channels=4, seg_conv_channels=(8,),
                part_conv_channels=(8,), merge_conv_channels=(8,),
                down_conv_channels=(8,), shared_fc_channels=(8, 16),
                cls_channels=(8,), reg_channels=(8,), dropout_ratio=0.0),
            train_nms_pre=128, train_proposals=32,
            test_nms_pre=64, test_proposals=16)


def voxel_centers(cfg: PartA2Config, coords):
    """Lidar xyz of the voxels' centres from their (z, y, x) coords."""
    vs = torch.tensor(cfg.voxel_size, dtype=torch.float32,
                      device=coords.device)
    lo = torch.tensor(cfg.point_cloud_range[:3], dtype=torch.float32,
                      device=coords.device)
    return torch.stack([(coords[..., 2] + 0.5) * vs[0] + lo[0],
                        (coords[..., 1] + 0.5) * vs[1] + lo[1],
                        (coords[..., 0] + 0.5) * vs[2] + lo[2]], -1)


class PartA2Detector(nn.Module):
    def __init__(self, cfg: PartA2Config):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.voxel_encoder = HardSimpleVFE()
        self.middle_encoder = SparseUNet(
            in_channels=self.voxel_encoder.num_features,
            sparse_shape=c.sparse_shape, base_channels=c.unet_channels[0][0],
            output_channels=c.unet_out_channels,
            encoder_channels=c.unet_channels,
            decoder_channels=c.unet_decoder_channels,
            stage_budgets=c.unet_budgets, out_budget=c.unet_out_budget)
        self.backbone = SECOND(self.middle_encoder.bev_channels,
                               c.backbone_channels, c.backbone_layers,
                               c.backbone_strides)
        self.neck = SECONDFPN(c.backbone_channels, c.neck_channels,
                              c.neck_strides)
        self.rpn_head = Anchor3DHead(c.rpn, sum(c.neck_channels))
        self.roi_head = nn.ModuleDict(dict(
            semantic_head=PointwiseSemanticHead(
                self.middle_encoder.seg_channels),
            bbox_head=PartA2BboxHead(c.bbox, c.roi.roi_out_size)))

    def init_weights(self, generator):
        """Seeded weights: He-uniform sparse, dense 2-D and 3-D convs and
        linears (``layers.init_params``), zero biases; as mmdet3d's
        ``init_weights``, the RPN's three convs normal with std 0.01 (and
        the cls logits' prior bias) and the RCNN's last box layer with
        std 0.001, so that the proposals and the refined boxes start near
        the anchors and the RoIs (He-uniform RPN convs give deltas of tens,
        whose ``exp`` overflows the proposals' sizes)."""
        init_params(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Conv3d)):
                    bound = (6.0 / m.weight[0].numel()) ** 0.5
                    m.weight.uniform_(-bound, bound, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
            head = self.rpn_head
            for conv in (head.conv_cls, head.conv_reg, head.conv_dir_cls):
                conv.weight.normal_(0.0, 0.01, generator=generator)
            self.roi_head['bbox_head'].conv_reg[-1].weight.normal_(
                0.0, 0.001, generator=generator)
        self.rpn_head.init_biases()

    def encode(self, points, points_valid, diag=None):
        """Voxelize, VFE and the UNet: dict(bev NCHW, seg_feats [B, V, C],
        coords [B, V, 3], vvalid [B, V]). A dict ``diag`` receives the
        UNet's budget occupancy."""
        vox, vvalid = _voxelize(self.cfg, points, points_valid)
        feats = self.voxel_encoder(vox['voxels'], vox['num_points'])
        bev, seg = self.middle_encoder(feats, vox['coords'], vvalid, diag)
        return dict(bev=bev, seg_feats=seg, coords=vox['coords'],
                    vvalid=vvalid)

    def heads(self, enc, gt_boxes=None, gt_labels=None, gt_valid=None,
              draws=None):
        """The BEV stack, the RPN, the semantic head, the proposals (and in
        train mode their sampling against the GT, with ``draws``), the
        RoI-aware pooling and the bbox head."""
        c = self.cfg
        fused = self.neck(self.backbone(enc['bev']))
        rpn_preds = self.rpn_head(fused)
        sem = self.roi_head['semantic_head'](enc['seg_feats'])
        centers = voxel_centers(c, enc['coords'])
        H, W = fused.shape[2:]
        anchors = ah.make_anchors(c.rpn, (H, W), fused.device)
        keep = None
        if self.training:
            props = rpn_proposals(c.rpn, rpn_preds, anchors, c.train_nms_pre,
                                  c.train_nms_thr, c.train_proposals)
            samples = assign_and_sample(
                c.roi, draws['sample_u'], props['boxes'], props['valid'],
                gt_boxes, gt_labels, gt_valid)
            keep = draws.get('dropout')
        else:
            props = rpn_proposals(c.rpn, rpn_preds, anchors, c.test_nms_pre,
                                  c.test_nms_thr, c.test_proposals)
            samples = dict(rois=props['boxes'], roi_valid=props['valid'],
                           roi_scores=props['scores'],
                           roi_labels=props['labels'])
        rois = samples['rois']
        seg_grids, part_grids, occ = pool_roi_features(
            c.roi, enc['seg_feats'], sem['part_feats'], centers,
            enc['vvalid'], rois)
        B, R = rois.shape[:2]
        S = c.roi.roi_out_size
        cls_score, bbox_pred = self.roi_head['bbox_head'](
            seg_grids.reshape(B * R, S, S, S, -1),
            part_grids.reshape(B * R, S, S, S, -1),
            occ.reshape(B * R, S, S, S), keep)
        return dict(rpn=rpn_preds, sem=sem, samples=samples,
                    rcnn=dict(cls=cls_score.reshape(B, R, 1),
                              reg=bbox_pred.reshape(B, R, 7)),
                    centers=centers, vvalid=enc['vvalid'],
                    feature_map_size=(H, W))

    def forward(self, points, points_valid, gt_boxes=None, gt_labels=None,
                gt_valid=None, draws=None, diag=None):
        """points [B, P, 4] f32; points_valid [B, P]. Train mode also takes
        gt_boxes [B, M, 7] (bottom-centre lidar), gt_labels [B, M],
        gt_valid [B, M] and ``draws``. Returns gga_tpu's dict (``rpn``,
        ``sem``, ``samples``, ``rcnn``, ``centers``, ``vvalid``,
        ``feature_map_size``)."""
        return self.heads(self.encode(points, points_valid, diag), gt_boxes,
                          gt_labels, gt_valid, draws)


def parta2_draws(model: PartA2Detector, batch_size, generator, device):
    """A train step's random draws from ``generator``, moved to
    ``device``: ``sample_u`` [B, train_proposals], the uniform draw that
    orders each group of the RoI sampler, and ``dropout``, the bbox head's
    keep masks ([B * num_rois, width] each, kept with probability
    1 - dropout_ratio; none at ratio 0). Drawn on the host and copied from
    pinned memory, so that the copy does not wait for queued work."""
    c = model.cfg
    u = torch.rand((batch_size, c.train_proposals), generator=generator)
    n = batch_size * c.roi.num_rois
    keep = [torch.rand((n, w), generator=generator) < 1 - c.bbox.dropout_ratio
            for w in model.roi_head['bbox_head'].dropout_widths()]
    dev = torch.device(device)

    def move(t):
        if dev.type == 'cuda':
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)

    return dict(sample_u=move(u), dropout=[move(k) for k in keep])


def parta2_loss(cfg: PartA2Config, out, gt_boxes, gt_labels, gt_valid):
    """The two-stage loss of a train-mode forward: RPN + semantic (seg and
    part) + RCNN. Returns (total, logs): 'loss', 'loss_rpn' and the RPN's
    terms as 'rpn_<name>', 'loss_seg', 'loss_part', 'loss_rcnn' and its
    terms."""
    c = cfg
    H, W = out['feature_map_size']
    anchors = ah.make_anchors(c.rpn, (H, W), gt_boxes.device)
    rpn_t = ah.assign_targets(c.rpn, anchors, gt_boxes, gt_labels, gt_valid)
    loss_rpn, rpn_logs = ah.loss(c.rpn, out['rpn'], anchors, rpn_t)
    seg_t, part_t = semantic_targets(c.rpn.num_classes, 0.2, out['centers'],
                                     out['vvalid'], gt_boxes, gt_labels,
                                     gt_valid)
    loss_seg, loss_part = semantic_loss(
        c.rpn.num_classes, out['sem']['seg_preds'], out['sem']['part_preds'],
        seg_t, part_t)
    rcnn_t = build_rcnn_targets(c.bbox, out['samples'])
    loss_rcnn, rcnn_logs = bbox_head_loss(
        c.bbox, out['rcnn']['cls'], out['rcnn']['reg'],
        out['samples']['rois'], rcnn_t)
    total = loss_rpn + loss_seg + loss_part + loss_rcnn
    logs = dict(loss_seg=loss_seg, loss_part=loss_part,
                **{f'rpn_{k}': v for k, v in rpn_logs.items()}, **rcnn_logs)
    logs['loss_rpn'] = loss_rpn
    logs['loss'] = total
    return total, logs


@torch.no_grad()
def decode_parta2(cfg: PartA2Config, out):
    """The refined boxes of an eval-mode forward and a class-agnostic
    rotated BEV NMS among those above ``test_score_thr`` (test_cfg.rcnn,
    parta2_bbox_head.get_bboxes). Returns dict(boxes [B, R, 7]
    bottom-centre lidar, scores, labels, valid), kept boxes first by
    score."""
    samples = out['samples']
    boxes = decode_refined(samples['rois'], out['rcnn']['reg'])
    scores = torch.sigmoid(out['rcnn']['cls'][..., 0])
    idx, _ = nms_bev(boxes[..., [0, 1, 3, 4, 6]], scores,
                     cfg.roi.test_nms_thr, post_max_size=boxes.shape[1],
                     valid=samples['roi_valid']
                     & (scores > cfg.roi.test_score_thr))
    safe = idx.clamp(min=0)
    kept = idx >= 0
    return dict(boxes=boxes.gather(1, safe[..., None].expand(-1, -1, 7)),
                scores=torch.where(kept, scores.gather(1, safe), 0.0),
                labels=samples['roi_labels'].gather(1, safe), valid=kept)
