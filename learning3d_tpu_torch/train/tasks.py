"""Per-task loss functions, counterpart of ``learning3d_tpu/train/tasks.py``.
Every loss_fn has the signature ``loss_fn(model, batch, generator) ->
(loss, aux_dict)``; ``generator`` is the Trainer's ``torch.Generator`` on
the training device, for tasks that draw random numbers. Every task of the
JAX package's table is here: classification, PointNetLK, RPMNet, iPCRNet,
DCP, PRNet, DeepGMR, PCN, MaskNet (and MaskNet2), scene flow and
segmentation."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from learning3d_tpu_torch.losses import losses
from learning3d_tpu_torch.ops.so3 import matmul3
from learning3d_tpu_torch.train.metrics import mask_scores, registration_errors


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


def rpmnet(model, batch, generator=None):
    """frobenius_norm_loss(est_T, igt) + rmse_features_loss(r), the reference's
    train_rpmnet loss (PointNetLK's), with the registration metrics. The
    model's ``default_iterations`` sets the iterations; its forward cuts the
    gradient between them, so every iteration trains."""
    template, source, igt = batch
    out = model(template, source)
    loss = losses.frobenius_norm_loss(out["est_T"], igt) + losses.rmse_features_loss(out["r"])
    return loss, registration_errors(out["est_T"], igt)


def pointnetlk(model, batch, generator=None):
    """PointNetLK's loss, the reference's train_PointNetLK: the same as
    RPMNet's (frobenius_norm_loss(est_T, igt) + rmse_features_loss(r)),
    with the registration metrics."""
    return rpmnet(model, batch, generator)


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


def prnet(model, batch, generator=None):
    """PRNet's own discounted loss from its forward (given the ground truth,
    igt^-1: igt maps template -> source, PRNet estimates source ->
    template), with the registration metrics."""
    template, source, igt = batch
    out = model(source, template, igt=torch.linalg.inv(igt))
    return out["loss"], registration_errors(out["est_T"], igt)


def deepgmr(model, batch, generator=None):
    """MSE(est_T_inverse igt^-1, I) + MSE(est_T igt, I), the reference's
    train_deepgmr loss, with the registration metrics; the 4 x 4 products
    summed elementwise (no TF32), the inverse by ``torch.linalg.inv`` as
    the JAX package's ``jnp.linalg.inv``."""
    template, source, igt = batch
    out = model(template, source)
    eye = torch.eye(4, dtype=igt.dtype, device=igt.device)
    mse1 = torch.mean((matmul3(out["est_T_inverse"], torch.linalg.inv(igt)) - eye) ** 2)
    mse2 = torch.mean((matmul3(out["est_T"], igt) - eye) ** 2)
    return mse1 + mse2, registration_errors(out["est_T"], igt)


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


def flownet(model, batch, generator=None):
    """The reference's train_flownet loss, mean(mask1 * |pred - flow|^2 / 2),
    with the FlowNet3D benchmark metrics: EPE3D and Acc3D strict (error <
    0.05 or < 5% of the flow's norm) and relaxed (< 0.10 or < 10%)."""
    pos1, pos2, color1, color2, flow, mask1 = batch
    pred = model(pos1, pos2, color1, color2)
    loss = torch.mean(mask1 * torch.sum((pred - flow) ** 2, -1) / 2.0)
    err = torch.linalg.vector_norm(pred - flow, dim=-1)
    rel = err / (torch.linalg.vector_norm(flow, dim=-1) + 1e-12)
    acc_s = ((err < 0.05) | (rel < 0.05)).float().mean()
    acc_r = ((err < 0.10) | (rel < 0.10)).float().mean()
    return loss, {"epe": err.mean(), "acc3d_strict": acc_s, "acc3d_relax": acc_r}


def masknet(model, batch, generator=None, loss_fn="mse"):
    """MSE or BCE (``loss_fn`` "bce", the mask clipped to [1e-7, 1 - 1e-7])
    between the predicted template mask and the ground truth's, the
    reference's train_masknet loss, with ``mask_scores``. The batch is
    (template, source, igt, gt_mask); gt_mask marks the template points that
    survive in the partial source. MaskNet returns (masked_template,
    template_mask), MaskNet2 (template_mask, source_mask): the template mask
    either way."""
    template, source, igt, gt_mask = batch
    out = model(template, source)
    mask = out[0] if type(model).__name__ == "MaskNet2" else out[1]
    if loss_fn == "bce":
        m = torch.clamp(mask, 1e-7, 1 - 1e-7)
        loss = -torch.mean(gt_mask * torch.log(m) + (1 - gt_mask) * torch.log(1 - m))
    else:
        loss = torch.mean((mask - gt_mask) ** 2)
    return loss, mask_scores(mask, gt_mask)


def segmentation(model, batch, generator=None):
    """Per-point NLL of the log-softmax logits (B, N, C) at the labels
    (B, N), and the per-point accuracy."""
    points, labels = batch
    logits = model(points)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.gather(logp, -1, labels.long()[..., None])[..., 0])
    acc = (torch.argmax(logits, -1) == labels).float().mean()
    return loss, {"accuracy": acc}


TASKS = {"classification": classification, "pointnetlk": pointnetlk, "rpmnet": rpmnet, "ipcrnet": ipcrnet,
         "dcp": dcp, "prnet": prnet, "deepgmr": deepgmr, "pcn": pcn, "masknet": masknet, "flow": flownet,
         "segmentation": segmentation}
