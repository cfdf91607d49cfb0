"""Per-task loss functions, counterpart of ``learning3d_tpu/train/tasks.py``.
Every loss_fn has the signature ``loss_fn(model, batch, generator) ->
(loss, aux_dict)``; ``generator`` is the Trainer's ``torch.Generator`` on
the training device, for tasks that draw random numbers. Ported so far:
classification, DCP, iPCRNet and PCN."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from learning3d_tpu_torch.losses import losses
from learning3d_tpu_torch.train.metrics import registration_errors


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


def _rt_mse(R_est, t_est, R, t):
    """MSE(R_est^T R, I) + MSE(t_est, t), the 3x3 products summed
    elementwise in the type of R (no TF32)."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    RtR = (R_est[..., :, :, None] * R[..., :, None, :]).sum(-3)  # sum_j R_est[j, i] R[j, k]
    return torch.mean((RtR - eye) ** 2) + torch.mean((t_est - t) ** 2)


def ipcrnet(model, batch, generator=None):
    """Chamfer(template, transformed_source), the reference's train_pcrnet
    loss (K12 on the card), with the registration metrics."""
    template, source, igt = batch
    out = model(template, source)
    loss = losses.chamfer_distance_loss(template[..., :3], out["transformed_source"])
    return loss, registration_errors(out["est_T"], igt)


def dcp(model, batch, generator=None):
    """MSE(est_R^T R_ab, I) + MSE(est_t, t_ab) + 0.1 * the same terms of the
    reverse direction (est_R_, est_t_ against R_ba, t_ba), the reference's
    train_dcp loss. igt maps template -> source, so source -> template is
    its inverse: R_ab = R^T, t_ab = -R^T t."""
    template, source, igt = batch
    out = model(template, source)
    R_ba, t_ba = igt[:, :3, :3], igt[:, :3, 3]
    R_ab = R_ba.transpose(-1, -2)
    t_ab = -(R_ab * t_ba[:, None, :]).sum(-1)
    loss = _rt_mse(out["est_R"], out["est_t"], R_ab, t_ab) + 0.1 * _rt_mse(out["est_R_"], out["est_t_"], R_ba, t_ba)
    return loss, registration_errors(out["est_T"], igt)


def pcn(model, batch, generator=None):
    """Chamfer(points, coarse_output), the reference's train_pcn loss; with
    the folding decoder (PCN(detailed_output=True)) the fine stage's Chamfer
    joins the loss. Aux: the per-stage Chamfer, coarse always and fine when
    the decoder is on. The batch is (points,) or (points, labels, ...)."""
    points = batch[0]
    out = model(points)
    coarse = losses.chamfer_distance_loss(points, out["coarse_output"])
    loss = coarse
    aux = {"chamfer_coarse": coarse}
    if "fine_output" in out:
        fine = losses.chamfer_distance_loss(points, out["fine_output"])
        aux["chamfer_fine"] = fine
        loss = coarse + fine
    return loss, aux


TASKS = {"classification": classification, "ipcrnet": ipcrnet, "dcp": dcp, "pcn": pcn}
