"""Box coder of the anchor heads (port of ``gga_tpu/core/coders.py``
``delta_encode`` / ``delta_decode``: mmdet3d's DeltaXYZWLHRBBoxCoder,
SECOND's residuals against anchors with the BEV diagonal as the x / y
scale). Boxes and anchors are bottom-centre (x, y, z, dx, dy, dz, yaw);
the z residual is taken between the gravity centres."""
from __future__ import annotations

import torch


def delta_encode(boxes, anchors):
    """[..., 7] GT boxes against [..., 7] anchors -> [..., 7] deltas."""
    xa, ya, za, wa, la, ha, ra = anchors.unbind(-1)
    xg, yg, zg, wg, lg, hg, rg = boxes.unbind(-1)
    za = za + ha / 2
    zg = zg + hg / 2
    diag = torch.sqrt(la ** 2 + wa ** 2)
    return torch.stack([
        (xg - xa) / diag, (yg - ya) / diag, (zg - za) / ha,
        torch.log(wg.clamp(min=1e-6) / wa), torch.log(lg.clamp(min=1e-6) / la),
        torch.log(hg.clamp(min=1e-6) / ha), rg - ra], -1)


def delta_decode(deltas, anchors):
    """Inverse of ``delta_encode``: [..., 7] boxes (bottom-centre z)."""
    xa, ya, za, wa, la, ha, ra = anchors.unbind(-1)
    xt, yt, zt, wt, lt, ht, rt = deltas.unbind(-1)
    za = za + ha / 2
    diag = torch.sqrt(la ** 2 + wa ** 2)
    hg = torch.exp(ht) * ha
    return torch.stack([
        xt * diag + xa, yt * diag + ya, zt * ha + za - hg / 2,
        torch.exp(wt) * wa, torch.exp(lt) * la, hg, rt + ra], -1)
