"""What the port's three point-cloud segmentors share (``EncoderDecoder3D``,
``DGCNNSegmentor``, ``PAConvSegmentor``): the check of the input's width
against the config's ``in_channels`` (flax infers a layer's input width
from its first input; the port shapes its weights from the config, so a
cloud of another width is refused by name), the seeded init, and the
dropout before the class layer, whose keep masks are inputs drawn from
the trainer's generator (``segmentor_draws``), as flax's ``nn.Dropout``
applies them: the kept entries divided by the keep probability.
"""
from __future__ import annotations

import torch
from torch import nn

from ..backbones.pointnet2 import PointConv


def dropout_ratio(cfg):
    """The head's dropout ratio of a segmentor config (``dropout_ratio`` of
    ``EncoderDecoder3DConfig``, ``dropout`` of the DGCNN and PAConv
    configs)."""
    return cfg.dropout_ratio if hasattr(cfg, 'dropout_ratio') else cfg.dropout


def segmentor_draws(cfg, batch_size, num_points, generator, device):
    """A train step's dropout keep mask [B, P, head_channels] from
    ``generator``, each entry kept with probability 1 - the config's
    ratio; None at a ratio of 0. Drawn on the host and copied from pinned
    memory, so that the copy does not wait for queued work."""
    p = dropout_ratio(cfg)
    if p <= 0:
        return None
    keep = torch.rand((batch_size, num_points, cfg.head_channels),
                      generator=generator) < 1.0 - p
    dev = torch.device(device)
    if dev.type == 'cuda':
        return keep.pin_memory().to(dev, non_blocking=True)
    return keep.to(dev)


class Segmentor(nn.Module):
    """Base of the segmentors: ``self.cfg`` carries ``in_channels``,
    ``head_channels`` and the dropout ratio. A forward keeps the picks it
    made (farthest point sampling indices, or DGCNN's kNN graphs) in
    ``last_picks``; given back through ``picks``, they are used instead of
    being made again."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.last_picks = None

    def init_weights(self, generator):
        """gga_tpu's initializers, drawn from ``generator``: every 1x1 conv
        and weight bank uniform in +-1/sqrt(fan_in), biases 0; norms at 1
        and 0."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, PointConv):
                    m.init_weights(generator)
                bank = getattr(m, 'weight_bank', None)
                if isinstance(bank, nn.Parameter):
                    bound = (1.0 / bank.shape[0]) ** 0.5
                    bank.uniform_(-bound, bound, generator=generator)

    def check_input(self, points):
        if points.shape[-1] != self.cfg.in_channels:
            raise ValueError(
                f'{type(self).__name__}: the points have {points.shape[-1]} '
                f'channels, the config\'s in_channels is '
                f'{self.cfg.in_channels}')

    def dropout(self, h, keep):
        """The head's dropout in train mode at a ratio above 0: ``keep``
        [B, P, head_channels] (``segmentor_draws``) is required there."""
        p = dropout_ratio(self.cfg)
        if not self.training or p <= 0:
            return h
        if keep is None:
            raise ValueError(f'a train-mode {type(self).__name__} forward at '
                             f'dropout {p} takes its keep mask '
                             '(segmentor_draws)')
        return torch.where(keep, h / (1.0 - p), 0.0)
