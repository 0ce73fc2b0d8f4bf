"""VoteFusion: 2D detections lifted into image cues for each seed (port
of ``gga_tpu/models/fusion_layers/vote_fusion.py``; mmdet3d's VoteFusion
of ImVoteNet), batched over scenes.

Every (seed, 2D box) pair scores its in-box membership plus the box's
confidence; the best ``max_imvote_per_pixel`` boxes of a seed give it
cues:

- geometric (5): the 2D vote (box centre less the projected seed)
  lifted to a ray through the camera, as the xz displacement at the
  seed's y plus the ray's unit direction;
- semantic (num_classes): the box's one-hot class times its confidence;
- texture (3): the raw pixel under the projected seed, over 255.

The projection is gga_tpu's: ``round(uvz / z - 1)`` of the seed through
``depth2img`` (in float64, ``project``), and the ray through the inverse
of ``depth2img``'s transpose. The best boxes are the first of a stable
descending sort of the scores, so ties (many: the scores are 0, 1 or
1 + a confidence) keep ``jax.lax.top_k``'s order, the lower box first.
"""
from __future__ import annotations

import dataclasses

import torch

EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class VoteFusionConfig:
    num_classes: int = 10
    max_imvote_per_pixel: int = 3

    @property
    def cue_channels(self):
        return 5 + self.num_classes + 3


def project(seeds_depth, depth2img):
    """Seeds [B, S, 3] in depth coordinates -> (pixel (u, v) [B, S, 2],
    rounded as gga_tpu rounds them, and the depth z [B, S], at least
    EPS). The product and the division are in float64, so that the card
    and the CPU round a seed to the same pixel (gga_tpu's f32 product may
    part from them where a seed lies within an ulp of a .5 boundary)."""
    hom = torch.cat([seeds_depth, torch.ones_like(seeds_depth[..., :1])], -1)
    uvz = torch.matmul(hom.double(), depth2img.double().transpose(-1, -2))
    z = uvz[..., 2].clamp(min=EPS)
    uv = torch.round(uvz[..., :2] / z[..., None] - 1)
    return uv.to(seeds_depth.dtype), z.to(seeds_depth.dtype)


def vote_fusion(cfg: VoteFusionConfig, img, boxes_2d, boxes_valid,
                seeds_depth, seeds_valid, depth2img):
    """A batch's image cues (gga_tpu ``vote_fusion`` vmapped over scenes).

    Args:
        img: [B, H, W, 3] raw images (0-255, any dtype).
        boxes_2d: [B, Kb, 6] (x1, y1, x2, y2, confidence, class).
        boxes_valid: [B, Kb] bool.
        seeds_depth: [B, S, 3] seed xyz in depth coordinates.
        seeds_valid: [B, S] bool.
        depth2img: [B, 4, 4] projection.

    Returns:
        cues [B, S * K, 5 + C + 3], mask [B, S * K] bool: K rows a seed,
        seed-major (seed s at rows s * K to s * K + K - 1).
    """
    B, H, W = img.shape[:3]
    S = seeds_depth.shape[1]
    K = cfg.max_imvote_per_pixel
    uv, z = project(seeds_depth, depth2img)

    x1, y1, x2, y2, conf, cls = boxes_2d.unbind(-1)          # [B, Kb]
    mid = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2], -1)
    u, v = uv[..., 0, None], uv[..., 1, None]                # [B, S, 1]
    inbox = ((u > x1[:, None]) & (u < x2[:, None]) & (v > y1[:, None])
             & (v < y2[:, None]) & boxes_valid[:, None, :]
             & seeds_valid[..., None])                       # [B, S, Kb]

    # the 2D vote as a 3D ray (vote_fusion.py:105-133)
    delta = mid[:, None] - uv[:, :, None]                    # [B, S, Kb, 2]
    imvote_img = torch.cat([delta, torch.zeros_like(delta[..., :1])],
                           -1) * z[..., None, None]
    inv = torch.linalg.inv(depth2img.transpose(-1, -2))
    imvote = torch.einsum('bskj,bji->bski', imvote_img, inv[:, :3, :3])
    ray = seeds_depth[:, :, None] + imvote
    ray = ray / torch.sqrt((ray ** 2).sum(-1, keepdim=True) + EPS)
    sd = seeds_depth[:, :, None]
    xz = (ray[..., [0, 2]] / (ray[..., 1:2] + EPS) * sd[..., 1:2]
          - sd[..., [0, 2]])
    geo = torch.cat([xz, ray], -1)                           # [B, S, Kb, 5]
    # the one-hot class (zeros for a class outside 0..C-1, as jax's)
    sem = (cls.to(torch.int32)[..., None] == torch.arange(
        cfg.num_classes, device=cls.device)).float() * conf[..., None]
    cues = torch.cat([geo, sem[:, None].expand(B, S, *sem.shape[1:])], -1)
    cues = cues * inbox[..., None]

    # each seed's best K boxes by in-box + confidence
    pair = inbox.float() + torch.where(boxes_valid, conf, 0.0)[:, None]
    idx = torch.sort(pair, dim=-1, descending=True,
                     stable=True).indices[..., :K]           # [B, S, K]
    cues = cues.gather(2, idx[..., None].expand(*idx.shape, cues.shape[-1]))
    mask = inbox.gather(2, idx)

    # the texture cue: the pixel under the projected seed
    ui = uv[..., 0].clamp(0, W - 1).long()
    vi = uv[..., 1].clamp(0, H - 1).long()
    txt = img[torch.arange(B, device=img.device)[:, None], vi, ui].float() \
        / 255.0                                              # [B, S, 3]
    out = torch.cat([cues, txt[:, :, None].expand(B, S, K, 3)], -1)
    return out.reshape(B, S * K, -1), mask.reshape(B, S * K)


def sample_valid_seeds(mask, num_sampled, u):
    """``num_sampled`` of the [B, n] entries, valid ones first (gga_tpu
    ``sample_valid_seeds``, imvotenet.sample_valid_seeds:14): ranked by
    ``u`` (a uniform draw [B, n]) with the valid ones ahead, the slots
    past a scene's valid count cycling through its valid picks. Returns
    [B, num_sampled] int64 indices."""
    key = torch.where(mask, u, 1.0 + u)
    order = torch.sort(key, dim=-1, stable=True).indices
    n_valid = mask.sum(-1, keepdim=True).clamp(min=1)
    slots = torch.arange(num_sampled, device=mask.device)
    wrapped = torch.where(slots < n_valid, slots, slots % n_valid)
    return order.gather(1, wrapped)
