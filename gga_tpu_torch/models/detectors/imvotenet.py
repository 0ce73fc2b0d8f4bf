"""ImVoteNet: VoteNet with lifted 2D detections (port of
``gga_tpu/models/detectors/imvotenet.py``; mmdet3d's ImVoteNet, stage-2
joint training): PointNet2SASSG seeds and VoteFusion's image cues, an
``img_mlp`` over the cues of ``num_sampled_seed`` sampled (seed, box)
rows, then three VoteHead towers: joint ([point | image] features),
points only and image only, with loss weights (0.8, 0.1, 0.1);
inference uses the joint tower. Plain PyTorch: it reaches none of the
port's CUDA kernels.

As in gga_tpu, the 2D boxes are inputs (mmdet3d's ``bboxes_2d`` path,
imvotenet.py:440): no Faster R-CNN is ported. The seed sampling's draw
is an input too, ``seed_u`` [B, S * K] uniform (``imvotenet_draws``
draws it from the trainer's generator; gga_tpu's from
``jax.random.uniform``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..backbones.pointnet2 import PointConv, PointNet2SASSG, SharedMLP
from ..dense_heads import vote_head as vh
from ..dense_heads.vote_head import VoteHead, VoteHeadConfig, _take
from ..fusion_layers.vote_fusion import (VoteFusionConfig,
                                         sample_valid_seeds, vote_fusion)

TOWERS = ('joint', 'pts', 'img')


@dataclasses.dataclass(frozen=True)
class ImVoteNetConfig:
    in_channels: int = 4
    num_points: Tuple[int, ...] = (2048, 1024, 512, 256)
    radii: Tuple[float, ...] = (0.2, 0.4, 0.8, 1.2)
    num_samples: Tuple[int, ...] = (64, 32, 16, 16)
    sa_channels: Tuple = ((64, 64, 128), (128, 128, 256),
                          (128, 128, 256), (128, 128, 256))
    fp_channels: Tuple = ((256, 256), (256, 256))
    num_sampled_seed: int = 1024
    img_mlp_channels: Tuple[int, ...] = (256, 256)
    fusion: VoteFusionConfig = dataclasses.field(
        default_factory=VoteFusionConfig)
    head: VoteHeadConfig = dataclasses.field(
        default_factory=VoteHeadConfig)
    loss_weights: Tuple[float, float, float] = (0.8, 0.1, 0.1)

    @classmethod
    def tiny(cls):
        """gga_tpu's tiny config."""
        head = VoteHeadConfig(
            num_classes=4, mean_sizes=((1.0, 1.0, 1.0),) * 4,
            in_channels=16, vote_conv_channels=(16,),
            agg_num_point=16, agg_mlp=(16, 16),
            pred_conv_channels=(16,), max_objs=8, max_out=8,
            pos_distance_thr=0.8, neg_distance_thr=1.2)
        return cls(num_points=(256, 128, 64, 32),
                   sa_channels=((16, 16),) * 4,
                   fp_channels=((16,), (16,)),
                   num_sampled_seed=64, img_mlp_channels=(16,),
                   fusion=VoteFusionConfig(num_classes=4),
                   head=head)

    @property
    def num_seeds(self):
        """The seeds of the last feature propagation's level."""
        return self.num_points[len(self.num_points)
                               - len(self.fp_channels) - 1]


class ImVoteNet(nn.Module):
    def __init__(self, cfg: ImVoteNetConfig):
        super().__init__()
        self.cfg = cfg
        self.pts_backbone = PointNet2SASSG(
            in_channels=cfg.in_channels, num_points=tuple(cfg.num_points),
            radii=tuple(cfg.radii), num_samples=tuple(cfg.num_samples),
            sa_channels=tuple(tuple(x) for x in cfg.sa_channels),
            fp_channels=tuple(tuple(x) for x in cfg.fp_channels))
        self.img_mlp = nn.Module()
        self.img_mlp.mlp = SharedMLP(cfg.fusion.cue_channels,
                                     cfg.img_mlp_channels)
        pts, img = self.pts_backbone.out_channels, cfg.img_mlp_channels[-1]
        # each tower's vote module takes its own feature width
        for name, width in zip(TOWERS, (pts + img, pts, img)):
            self.add_module(f'pts_bbox_head_{name}', VoteHead(
                dataclasses.replace(cfg.head, in_channels=width)))

    @torch.no_grad()
    def init_weights(self, generator):
        """gga_tpu's initializers, drawn from ``generator``: every 1x1 conv
        uniform in +-1/sqrt(fan_in), biases 0; norms at 1 and 0."""
        for m in self.modules():
            if isinstance(m, PointConv):
                m.init_weights(generator)

    def forward(self, points, valid, img, boxes_2d, boxes_valid, depth2img,
                seed_u, sample_idx=None):
        """points [B, P, C]; valid [B, P]; img [B, H, W, 3]; boxes_2d
        [B, Kb, 6]; boxes_valid [B, Kb]; depth2img [B, 4, 4]; seed_u
        [B, S * K] the seed sampling's uniform draw; ``sample_idx`` dict
        of given picks (``sampled_indices``' layout), sampled when None.

        Returns the joint tower's VoteHead dict in eval mode, (joint, pts,
        img) in train mode."""
        c = self.cfg
        s = sample_idx or {}
        feat = self.pts_backbone(points, valid, s.get('backbone'))
        seeds, seed_feats = feat['fp_xyz'], feat['fp_features']
        seed_valid = feat['fp_valid']
        cues, mask = vote_fusion(c.fusion, img, boxes_2d, boxes_valid, seeds,
                                 seed_valid, depth2img)
        inds = s.get('seeds')
        if inds is None:
            inds = sample_valid_seeds(mask, c.num_sampled_seed, seed_u)
        self.last_seed_idx = inds
        cues = _take(cues, inds)
        sel_mask = mask.gather(1, inds)
        seed_idx = inds // c.fusion.max_imvote_per_pixel
        sel_seeds = _take(seeds, seed_idx)
        sel_feats = _take(seed_feats, seed_idx)
        sel_valid = seed_valid.gather(1, seed_idx)
        img_feats = self.img_mlp.mlp(cues, sel_valid) * sel_mask[..., None]

        def tower(name, feats):
            return getattr(self, f'pts_bbox_head_{name}')(
                dict(fp_xyz=sel_seeds, fp_features=feats,
                     fp_valid=sel_valid), s.get(name))

        joint = tower('joint', torch.cat([sel_feats, img_feats], -1))
        if not self.training:
            return (joint,)
        return joint, tower('pts', sel_feats), tower('img', img_feats)

    def sampled_indices(self, out=None):
        """The picks of the last forward, in the layout ``forward`` takes
        back: 'backbone' (each level's indices), 'seeds' (the sampled
        (seed, box) rows) and each tower's aggregation indices (the joint
        tower's alone after an eval forward)."""
        out = dict(backbone=[sa.last_idx
                             for sa in self.pts_backbone.SA_modules],
                   seeds=self.last_seed_idx)
        for name in TOWERS[:3 if self.training else 1]:
            out[name] = getattr(
                self, f'pts_bbox_head_{name}').vote_aggregation.last_idx
        return out


def imvotenet_draws(cfg: ImVoteNetConfig, batch_size, generator, device):
    """The seed sampling's uniform draw [B, S * K] from ``generator``, on
    ``device``."""
    u = torch.rand((batch_size,
                    cfg.num_seeds * cfg.fusion.max_imvote_per_pixel),
                   generator=generator)
    return u.to(device)


def imvotenet_loss(cfg: ImVoteNetConfig, towers, gt_boxes, gt_labels,
                   gt_valid):
    """The three towers' VoteHead losses, weighted (imvotenet.py:487-518;
    the vote targets on each tower's sampled seeds). Returns (total,
    logs): the joint tower's terms, 'loss_joint', 'loss_pts',
    'loss_img' and 'loss'."""
    total = 0.0
    logs = {}
    for preds, w, name in zip(towers, cfg.loss_weights, TOWERS):
        targets = vh.build_targets(
            cfg.head, preds['seed_xyz'], preds['seed_valid'],
            preds['agg_xyz'], preds['agg_valid'], gt_boxes, gt_labels,
            gt_valid)
        tot, tower_logs = vh.loss(cfg.head, preds, targets)
        total = total + w * tot
        if name == 'joint':
            logs.update({k: v for k, v in tower_logs.items() if k != 'loss'})
        logs[f'loss_{name}'] = tot
    logs['loss'] = total
    return total, logs


@torch.no_grad()
def decode_imvotenet(cfg: ImVoteNetConfig, joint_preds):
    """The joint tower's boxes through VoteHead's decode."""
    return vh.decode(cfg.head, joint_preds)
