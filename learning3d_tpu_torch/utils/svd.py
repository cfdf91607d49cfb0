"""Soft-correspondence SVD Procrustes head, counterpart of
``learning3d_tpu/utils/svd.py``."""

from __future__ import annotations

import torch
from torch import nn

from learning3d_tpu_torch.kernels.attention import attention_fused, attention_pallas_ok
from learning3d_tpu_torch.utils.svd3 import kabsch_rotation_3x3


def procrustes_from_correspondence(src, src_corr):
    """Rigid (R, t) aligning src -> src_corr (both (B, N, 3), rows paired):
    batched Kabsch by the fixed-sweep Jacobi solver (utils.svd3). The
    cross-covariance is a sum of elementwise products in f32 (no TF32)."""
    src_centroid = torch.mean(src, dim=1, keepdim=True)
    corr_centroid = torch.mean(src_corr, dim=1, keepdim=True)
    src_c = src - src_centroid
    corr_c = src_corr - corr_centroid
    H = (src_c[..., :, None] * corr_c[..., None, :]).sum(1).float()  # (B, 3, 3)
    R = kabsch_rotation_3x3(H)
    t = corr_centroid[:, 0, :] - (R * src_centroid[:, 0, None, :]).sum(-1)
    return R, t


class SVDHead(nn.Module):
    """Attention-weighted soft correspondences + Kabsch:
    scores = softmax(src_emb tgt_emb^T / sqrt(d)); src_corr = scores @ tgt."""

    def __init__(self, emb_dims: int):
        super().__init__()
        self.emb_dims = emb_dims

    def forward(self, src_emb, tgt_emb, src, tgt):
        """src_emb/tgt_emb (B, N, E); src/tgt (B, N, 3) -> (R, t, src_corr)."""
        q, k = src_emb[:, None], tgt_emb[:, None]
        # the xyz values are rounded to the embedding's dtype before the
        # correspondence, as in the JAX package
        v = tgt[..., :3][:, None].to(src_emb.dtype)
        if attention_pallas_ok(q, k, v):
            # the soft correspondence is single-head attention onto xyz: K6
            src_corr = attention_fused(q, k, v)[:, 0]
        else:
            d_k = src_emb.shape[-1]
            scores = torch.matmul(src_emb, tgt_emb.transpose(-1, -2)) / torch.sqrt(
                torch.tensor(d_k, dtype=src_emb.dtype))
            scores = torch.softmax(scores, dim=-1)
            xyz = tgt[..., :3]
            dt = torch.promote_types(scores.dtype, xyz.dtype)
            src_corr = torch.matmul(scores.to(dt), xyz.to(dt))
        R, t = procrustes_from_correspondence(src.float(), src_corr.float())
        return R, t, src_corr
