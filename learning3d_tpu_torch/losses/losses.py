"""Loss functions, counterpart of ``learning3d_tpu/losses/losses.py``. Only
the classification loss is ported so far."""

from __future__ import annotations

import torch


def classification_loss(log_probs, labels):
    """NLL over log-probabilities (the reference's F.nll_loss on
    log_softmax outputs): -mean_b log_probs[b, labels[b]]."""
    picked = torch.gather(log_probs, -1, labels.long()[:, None])[:, 0]
    return -picked.mean()
