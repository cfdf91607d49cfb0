"""Registration metrics of the training loop, counterpart of
``learning3d_tpu/train/metrics.py``: the geodesic rotation error in degrees
and the translation error, per pair, and MaskNet's mask scores. The epoch
summaries the evaluation CLI prints (``summarize_registration``,
``format_registration_summary``, ``point_rmse``) are not ported yet."""

from __future__ import annotations

import torch


def rotation_error_deg(R_pred, R_gt):
    """Geodesic rotation error in degrees, (B,): arccos((tr(R_pred R_gt^T) -
    1) / 2) with the cosine clamped to [-1, 1]. In f32, the product summed
    elementwise (no TF32 rounding, which arccos would amplify near 0)."""
    R_pred, R_gt = R_pred.float(), R_gt.float()
    tr = (R_pred * R_gt).sum(-1).sum(-1)  # the diagonal of R_pred R_gt^T, then its sum
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def translation_error(t_pred, t_gt):
    return torch.linalg.vector_norm(t_pred - t_gt, dim=-1)


def registration_errors(est_T, igt):
    """est_T maps source -> template, igt template -> source, so the ground
    truth of est_T is igt^-1. -> {"rot_deg": (B,), "trans": (B,)}."""
    R_gt = igt[..., :3, :3].transpose(-1, -2)
    t_gt = -(R_gt * igt[..., None, :3, 3]).sum(-1)
    return {"rot_deg": rotation_error_deg(est_T[..., :3, :3], R_gt),
            "trans": translation_error(est_T[..., :3, 3], t_gt)}


def mask_scores(pred_mask, gt_mask, threshold=0.5):
    """Accuracy, precision, recall and F1 of the predicted mask binarized at
    ``threshold`` against the ground truth's (> 0.5), over every point of
    the batch (the reference's test_masknet.py:45-77)."""
    p = (pred_mask > threshold).float()
    g = (gt_mask > 0.5).float()
    tp = torch.sum(p * g)
    fp = torch.sum(p * (1 - g))
    fn = torch.sum((1 - p) * g)
    tn = torch.sum((1 - p) * (1 - g))
    acc = (tp + tn) / torch.clamp(tp + tn + fp + fn, min=1.0)
    prec = tp / torch.clamp(tp + fp, min=1.0)
    rec = tp / torch.clamp(tp + fn, min=1.0)
    f1 = 2 * prec * rec / torch.clamp(prec + rec, min=1e-12)
    return {"accuracy": acc, "precision": prec, "recall": rec, "f1": f1}
