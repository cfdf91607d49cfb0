"""Per-task loss functions, counterpart of ``learning3d_tpu/train/tasks.py``.
Every loss_fn has the signature ``loss_fn(model, batch, generator) ->
(loss, aux_dict)``; ``generator`` is the Trainer's ``torch.Generator`` on
the training device, for tasks that draw random numbers. Only the
classification task is ported so far."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from learning3d_tpu_torch.losses import losses


def classification(model, batch, generator=None, smoothing: float = 0.0):
    """NLL on log-softmax logits, and the accuracy. ``smoothing`` is the
    label-smoothed cross entropy of the CurveNet/DGCNN recipe (cal_loss):
    the target class weighs 1 - smoothing, every other class smoothing /
    (n - 1). The log-softmax runs in the logits' dtype, as in the JAX
    package."""
    points, labels = batch
    logits = model(points)
    logp = torch.log_softmax(logits, dim=-1)
    if smoothing:
        n = logits.shape[-1]
        one_hot = F.one_hot(labels.long(), n).to(logp.dtype)
        one_hot = one_hot * (1.0 - smoothing) + (1.0 - one_hot) * smoothing / (n - 1)
        loss = -torch.mean(torch.sum(one_hot * logp, dim=-1))
    else:
        loss = losses.classification_loss(logp, labels)
    acc = (torch.argmax(logits, -1) == labels).float().mean()
    return loss, {"accuracy": acc}


TASKS = {"classification": classification}
