"""DCP, Deep Closest Point registration, counterpart of
``learning3d_tpu/models/dcp.py``: a shared encoder on both clouds, the
co-attention Transformer pointer (or identity) and the SVD head, returning
the result dict (est_R, est_t, est_R_, est_t_, est_T, r,
transformed_source). The MLP head is not ported yet.

In bf16 eval on the card a forward runs K5 twice (the template's and the
source's encoder) and K6 seven times (six in the pointer, one in the head);
in train mode or f32, K7 twice (the unfused encoder's edge features) in
place of K5. ``train.tasks.dcp`` trains it.
"""

from __future__ import annotations

import torch
from torch import nn

from learning3d_tpu_torch import DEFAULT_DEVICE
from learning3d_tpu_torch.ops import se3, transforms
from learning3d_tpu_torch.utils.layers import to_bnc, validate_input_shape
from learning3d_tpu_torch.utils.svd import SVDHead
from learning3d_tpu_torch.utils.transformer import Identity, Transformer


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
            raise NotImplementedError("DCP's MLP head (and ops/quaternion) is not ported yet")
        if head != "svd":
            raise ValueError(head)
        self.head = SVDHead(feature_model.emb_dims)

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
