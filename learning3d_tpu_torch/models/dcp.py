"""DCP, Deep Closest Point registration, counterpart of
``learning3d_tpu/models/dcp.py``: a shared encoder on both clouds, the
co-attention Transformer pointer (or identity) and the SVD head, returning
the result dict (est_R, est_t, est_R_, est_t_, est_T, r,
transformed_source). ``head="mlp"`` is the pooled-embedding pose regressor
``MLPHead`` in place of the SVD head.

In bf16 eval on the card a forward runs K5 twice (the template's and the
source's encoder) and K6 seven times (six in the pointer, one in the head);
in train mode or f32, K7 twice (the unfused encoder's edge features) in
place of K5. ``train.tasks.dcp`` trains it.
"""

from __future__ import annotations

import torch
from torch import nn

from learning3d_tpu_torch import DEFAULT_DEVICE
from learning3d_tpu_torch.ops import quaternion as quat
from learning3d_tpu_torch.ops import se3, transforms
from learning3d_tpu_torch.utils.layers import BatchNorm, Linear, to_bnc, validate_input_shape
from learning3d_tpu_torch.utils.svd import SVDHead
from learning3d_tpu_torch.utils.transformer import Identity, Transformer


class MLPHead(nn.Module):
    """Pose regression from the pooled embeddings: max over the points of
    concat(src_emb, tgt_emb) (B, 2E), three Linear + BatchNorm + ReLU layers
    (E / 2, E / 4, E / 8), then a unit quaternion (-> R) and a translation.
    Returns (R, t, None), the SVD head's contract without correspondences."""

    def __init__(self, emb_dims: int, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.emb_dims = emb_dims
        dims = [emb_dims * 2, emb_dims // 2, emb_dims // 4, emb_dims // 8]
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.layers = nn.ModuleList(Linear(i, o, **kw) for i, o in zip(dims[:-1], dims[1:]))
        self.bns = nn.ModuleList(BatchNorm(o, dtype=dtype, device=device) for o in dims[1:])
        self.proj_rot = Linear(emb_dims // 8, 4, **kw)
        self.proj_trans = Linear(emb_dims // 8, 3, **kw)

    def forward(self, src_emb, tgt_emb, src, tgt):
        x = torch.amax(torch.cat([src_emb, tgt_emb], dim=-1), dim=1)  # (B, 2E)
        for lin, bn in zip(self.layers, self.bns):
            x = torch.relu(bn(lin(x)))
        q = quat.qnormalize(self.proj_rot(x))
        return quat.quat2mat(q), self.proj_trans(x), None


class DCP(nn.Module):
    def __init__(self, feature_model: nn.Module, cycle: bool = False, pointer_: str = "transformer",
                 head: str = "svd", input_shape: str = "bnc", *, dtype=None,
                 generator: torch.Generator | None = None, device=DEFAULT_DEVICE):
        super().__init__()
        self.input_shape = validate_input_shape(input_shape)
        self.cycle = cycle
        self.emb_nn = feature_model
        if pointer_ == "identity":
            self.pointer = Identity()
        elif pointer_ == "transformer":
            self.pointer = Transformer(feature_model.emb_dims, n_blocks=1, dropout=0.0, ff_dims=1024,
                                       n_heads=4, dtype=dtype, generator=generator, device=device)
        else:
            raise ValueError(pointer_)
        if head == "mlp":
            self.head = MLPHead(feature_model.emb_dims, dtype=dtype, generator=generator, device=device)
        elif head == "svd":
            self.head = SVDHead(feature_model.emb_dims)
        else:
            raise ValueError(head)

    def forward(self, template, source):
        """template/source (B, N, 3) -> result dict; est_* maps source -> template."""
        template = to_bnc(template, self.input_shape)
        source = to_bnc(source, self.input_shape)
        return self._register(template, self.emb_nn(template), source)

    def encode(self, x):
        """Encoder features of one cloud, to cache for a fixed template."""
        return self.emb_nn(to_bnc(x, self.input_shape))

    def register_encoded(self, template, tgt_emb, source):
        """Like ``forward`` with the template's encoder features precomputed
        by :meth:`encode`."""
        return self._register(to_bnc(template, self.input_shape), tgt_emb,
                              to_bnc(source, self.input_shape))

    def _register(self, template, tgt_emb, source):
        src_emb = self.emb_nn(source)
        src_p, tgt_p = self.pointer(src_emb, tgt_emb)
        src_emb = src_emb + src_p
        tgt_emb = tgt_emb + tgt_p

        R_ab, t_ab, _ = self.head(src_emb, tgt_emb, source, template)
        if self.cycle:
            R_ba, t_ba, _ = self.head(tgt_emb, src_emb, template, source)
        else:
            R_ba = R_ab.transpose(-1, -2)
            t_ba = -(R_ba * t_ab[:, None, :]).sum(-1)
        return {
            "est_R": R_ab,
            "est_t": t_ab,
            "est_R_": R_ba,
            "est_t_": t_ba,
            "est_T": se3.from_rt(R_ab, t_ab),
            "r": tgt_emb - src_emb,
            "transformed_source": transforms.transform_point_cloud(source, R_ab, t_ab),
        }
