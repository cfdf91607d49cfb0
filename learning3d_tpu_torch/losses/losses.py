"""Loss functions, counterpart of ``learning3d_tpu/losses/losses.py``.
Ported so far: the classification loss, the Chamfer loss (over K12) and
the EMD loss (over K13)."""

from __future__ import annotations

import torch

from learning3d_tpu_torch.kernels.chamfer import chamfer_distance
from learning3d_tpu_torch.kernels.emd import emd_loss


def chamfer_distance_loss(template, source):
    """(mean sqrt d1 + mean sqrt d2) / 2 over the squared nearest-neighbour
    distances of both directions, each floored at 1e-12 (the reference's
    reduction)."""
    d1, d2 = chamfer_distance(template, source)
    c1 = torch.mean(torch.sqrt(torch.clamp(d1, min=1e-12)))
    c2 = torch.mean(torch.sqrt(torch.clamp(d2, min=1e-12)))
    return 0.5 * (c1 + c2)


def emd_loss_mean(template, source):
    """mean(EMD cost) / the number of template points."""
    return torch.mean(emd_loss(template, source)) / template.shape[1]


def classification_loss(log_probs, labels):
    """NLL over log-probabilities (the reference's F.nll_loss on
    log_softmax outputs): -mean_b log_probs[b, labels[b]]."""
    picked = torch.gather(log_probs, -1, labels.long()[:, None])[:, 0]
    return -picked.mean()
