"""3D semantic segmentation: the PointNet++ encoder-decoder (port of
``gga_tpu/models/segmentors/encoder_decoder.py``; mmdet3d's
EncoderDecoder3D with PointNet2SASSG or PointNet2SAMSG and PointNet2Head,
``configs/pointnet2/``) and the segmentors' loss, a masked cross-entropy
with optional class weights and ignore index.

Fixed-size point batches with validity masks replace mmdet3d's sliding
windows. The encoder is the port's ``PointNet2SASSG`` without feature
propagation, or, with ``msg``, ``PointNet2SAMSG`` with no aggregation
layer; the head (``PointNet2SegHead``) propagates its levels back to the
raw points. State_dict names are mmdet3d's: ``backbone.SA_modules.*`` and
``decode_head.*``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..backbones.pointnet2 import PointNet2SAMSG, PointNet2SASSG
from ..decode_heads.pointnet2_head import PointNet2SegHead
from .base import Segmentor


@dataclasses.dataclass(frozen=True)
class EncoderDecoder3DConfig:
    num_classes: int = 20
    in_channels: int = 6        # xyz + rgb (ScanNet seg config)
    num_points: Tuple[int, ...] = (1024, 256, 64, 16)
    radii: Tuple[float, ...] = (0.1, 0.2, 0.4, 0.8)
    num_samples: Tuple[int, ...] = (32, 32, 32, 32)
    sa_channels: Sequence[Tuple[int, ...]] = (
        (32, 32, 64), (64, 64, 128), (128, 128, 256), (256, 256, 512))
    fp_channels: Sequence[Tuple[int, ...]] = (
        (256, 256), (256, 256), (256, 128), (128, 128, 128))
    head_channels: int = 128
    dropout_ratio: float = 0.5
    # the multi-scale encoder (pointnet2_msg configs): per-level radius,
    # sample and channel tuples in place of the SSG scalars
    msg: bool = False
    msg_radii: Sequence = (
        (0.05, 0.1), (0.1, 0.2), (0.2, 0.4), (0.4, 0.8))
    msg_num_samples: Sequence = ((16, 32), (16, 32), (16, 32), (16, 32))
    msg_sa_channels: Sequence = (
        ((16, 16, 32), (32, 32, 64)),
        ((64, 64, 128), (64, 96, 128)),
        ((128, 196, 256), (128, 196, 256)),
        ((256, 256, 512), (256, 384, 512)))

    @classmethod
    def tiny(cls, num_classes=6):
        return cls(num_classes=num_classes, in_channels=6,
                   num_points=(256, 64, 16, 8),
                   radii=(0.2, 0.4, 0.8, 1.6),
                   num_samples=(16, 16, 8, 8),
                   sa_channels=((8, 8), (8, 16), (16, 16), (16, 16)),
                   fp_channels=((16,), (16,), (16,), (16, 16)),
                   head_channels=16)


class EncoderDecoder3D(Segmentor):
    """PointNet++ encoder + ``PointNet2SegHead``."""

    def __init__(self, cfg: EncoderDecoder3DConfig):
        super().__init__(cfg)
        c = cfg
        if c.msg:
            self.backbone = PointNet2SAMSG(
                c.in_channels, c.num_points, c.msg_radii, c.msg_num_samples,
                c.msg_sa_channels,
                aggregation_channels=(0,) * len(c.num_points))
            levels = self.backbone.level_channels
        else:
            self.backbone = PointNet2SASSG(
                c.in_channels, c.num_points, c.radii, c.num_samples,
                c.sa_channels, fp_channels=())
            levels = [c.in_channels - 3] + [s[-1] for s in c.sa_channels]
        self.decode_head = PointNet2SegHead(levels, c.num_classes,
                                            c.fp_channels, c.head_channels)

    def forward(self, points, valid, keep=None, picks=None):
        """points [B, P, in_channels]; valid [B, P]; ``keep`` the dropout's
        keep mask (train mode); ``picks`` each level's [B, S] sampled
        indices, sampled here when None (kept in ``last_picks``).

        Returns per-point class logits [B, P, num_classes], 0 at padding.
        """
        self.check_input(points)
        feat = self.backbone(points, valid, picks)
        self.last_picks = feat['sa_indices']
        return self.decode_head(feat['sa_xyz'], feat['sa_features'],
                                feat['sa_valid'],
                                lambda h: self.dropout(h, keep))


def segmentation_loss(logits, labels, valid, class_weights=None,
                      ignore_index: Optional[int] = None):
    """Masked cross-entropy (mmdet3d's Base3DDecodeHead.losses).

    Args:
        logits: [B, P, K]; labels: [B, P] int; valid: [B, P] bool.
        class_weights: optional [K] (a tensor or a sequence).
        ignore_index: a label value left out (ScanNet's unannotated
            points carry num_classes).
    Returns:
        the weighted mean of the kept points' negative log-likelihoods:
        their sum over the sum of their weights, at least 1.
    """
    K = logits.shape[-1]
    ok = valid
    if ignore_index is not None:
        ok = ok & (labels != ignore_index)
    lab = labels.long().clamp(0, K - 1)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, lab[..., None])[..., 0]
    if class_weights is None:
        w = torch.ones_like(nll)
    else:
        w = torch.as_tensor(class_weights, dtype=nll.dtype,
                            device=nll.device)[lab]
    nll = torch.where(ok, nll * w, 0.0)
    denom = torch.where(ok, w, 0.0).sum().clamp(min=1.0)
    return nll.sum() / denom
