"""Registration metrics of the training loop, counterpart of
``learning3d_tpu/train/metrics.py``: the geodesic rotation error in degrees
and the translation error, per pair, MaskNet's mask scores, and the epoch
summary the evaluation CLI prints (``summarize_registration`` on host numpy,
``format_registration_summary``) with the per-item ``point_rmse``."""

from __future__ import annotations

import numpy as np
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


def summarize_registration(est_T, igt, template=None, n_rmse_points=100):
    """The whole eval set's registration summary, in the reference's metric
    names and units, from host arrays (float64 throughout, as the JAX
    package computes it): Euler-angle (zyx, degrees) Rot_MSE, Rot_RMSE,
    Rot_MAE and Rot_R2, component-wise Trans_*, the mean geodesic ``rot_deg``
    and translation error ``trans`` and, given the (B, N, 3) templates, the
    mean distance of their first ``n_rmse_points`` points under est_T and
    under the ground truth (``point_RMSE``).

    est_T: (B, 4, 4) source -> template; igt: (B, 4, 4) template -> source.
    Returns a dict of python floats."""
    from scipy.spatial.transform import Rotation

    est_T = np.asarray(est_T, np.float64).reshape(-1, 4, 4)
    igt = np.asarray(igt, np.float64).reshape(-1, 4, 4)
    R_pred, t_pred = est_T[:, :3, :3], est_T[:, :3, 3]
    R_gt = np.transpose(igt[:, :3, :3], (0, 2, 1))
    t_gt = -np.einsum("bij,bj->bi", R_gt, igt[:, :3, 3])
    e_pred = Rotation.from_matrix(R_pred).as_euler("zyx", degrees=True)
    e_gt = Rotation.from_matrix(R_gt).as_euler("zyx", degrees=True)

    def mse_rmse_mae_r2(pred, gt):
        err = pred - gt
        mse = float(np.mean(err**2))
        ss_res, ss_tot = float(np.sum(err**2)), float(np.sum((gt - gt.mean(0)) ** 2))
        return mse, float(np.sqrt(mse)), float(np.mean(np.abs(err))), 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0

    rot = mse_rmse_mae_r2(e_pred, e_gt)
    trans = mse_rmse_mae_r2(t_pred, t_gt)
    tr = np.einsum("bii->b", np.einsum("bij,bkj->bik", R_pred, R_gt))
    geo = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
    out = {f"Rot_{k}": v for k, v in zip(("MSE", "RMSE", "MAE", "R2"), rot)}
    out.update({f"Trans_{k}": v for k, v in zip(("MSE", "RMSE", "MAE", "R2"), trans)})
    out["rot_deg"] = float(np.mean(geo))
    out["trans"] = float(np.mean(np.linalg.norm(t_pred - t_gt, axis=-1)))
    if template is not None:
        pts = np.asarray(template, np.float64)[:, :n_rmse_points, :3]
        p_pred = np.einsum("bnj,bij->bni", pts, R_pred) + t_pred[:, None]
        p_gt = np.einsum("bnj,bij->bni", pts, R_gt) + t_gt[:, None]
        out["point_RMSE"] = float(np.mean(np.linalg.norm(p_pred - p_gt, axis=-1)))
    return out


def format_registration_summary(summary, stage="test"):
    """The one-line summary of the reference's PRNet log: "Stage: test,
    Rot_MSE: ..., ..." with six decimals, then rot_deg, trans, point_RMSE
    and the mask_* scores where present."""
    keys = ["Rot_MSE", "Rot_RMSE", "Rot_MAE", "Rot_R2", "Trans_MSE", "Trans_RMSE", "Trans_MAE", "Trans_R2"]
    body = ", ".join(f"{k}: {summary[k]:.6f}" for k in keys if k in summary)
    extra_keys = ("rot_deg", "trans", "point_RMSE") + tuple(k for k in sorted(summary) if k.startswith("mask_"))
    extra = ", ".join(f"{k}: {summary[k]:.6f}" for k in extra_keys if k in summary)
    return f"Stage: {stage}, {body}" + (f", {extra}" if extra else "")


def point_rmse(transformed_source, template):
    """Per-item RMSE between row-paired aligned clouds (..., N, 3) -> (...,)."""
    return torch.sqrt(torch.mean(torch.sum((transformed_source - template) ** 2, -1), -1))


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
