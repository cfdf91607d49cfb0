"""Co-attention Transformer pointer for DCP, counterpart of
``learning3d_tpu/utils/transformer.py``: a pre-norm encoder/decoder pair
run twice with swapped roles to produce co-attended residual embeddings.
Channel-last (B, N, E); dropout is 0 in the DCP configuration.

Attention at the pointer's shapes runs the CUDA kernel K6
(``kernels.attention``), whose scores are scaled by the float 1/sqrt(d_k);
elsewhere it is the plain chain, which divides by sqrt(d_k) taken in the
stream's dtype, as the JAX package does (in bf16, sqrt(128) is 11.3125).
"""

from __future__ import annotations

import torch
from torch import nn

from learning3d_tpu_torch import DEFAULT_DEVICE, resolve_device
from learning3d_tpu_torch.kernels.attention import attention_fused, attention_pallas_ok, check_value_width
from learning3d_tpu_torch.utils.layers import Linear


def _attention(q, k, v):
    if attention_pallas_ok(q, k, v):
        check_value_width(q, v)
        return attention_fused(q, k, v)
    d_k = q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2)) / torch.sqrt(torch.tensor(d_k, dtype=q.dtype))
    return torch.matmul(torch.softmax(scores, dim=-1), v)


class AnnotatedLayerNorm(nn.Module):
    """The Annotated-Transformer LayerNorm: a * (x - mean) / (std + eps) + b
    with the UNBIASED std and eps added to the std (not nn.LayerNorm);
    statistics in f32, the result cast back to the stream's dtype."""

    def __init__(self, features, eps=1e-6, *, device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        self.a = nn.Parameter(torch.ones(features, device=device))
        self.b = nn.Parameter(torch.zeros(features, device=device))
        self.eps = eps

    def forward(self, x):
        n = x.shape[-1]
        xf = x.float()
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False) * (n / (n - 1))
        std = torch.sqrt(var)
        return (self.a * (xf - mean) / (std + self.eps) + self.b).to(x.dtype)


class MultiHeadedAttention(nn.Module):
    def __init__(self, n_heads, d_model, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of n_heads {n_heads}")
        self.h = n_heads
        self.d_k = d_model // n_heads
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.wq = Linear(d_model, d_model, **kw)
        self.wk = Linear(d_model, d_model, **kw)
        self.wv = Linear(d_model, d_model, **kw)
        self.wo = Linear(d_model, d_model, **kw)

    def forward(self, query, key, value):
        B, N, _ = query.shape

        def split(x):
            return x.reshape(B, x.shape[1], self.h, self.d_k).transpose(1, 2)

        out = _attention(split(self.wq(query)), split(self.wk(key)), split(self.wv(value)))
        return self.wo(out.transpose(1, 2).reshape(B, N, self.h * self.d_k))


class FeedForward(nn.Module):
    def __init__(self, d_model, d_ff, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.w1 = Linear(d_model, d_ff, dtype=dtype, generator=generator, device=device)
        self.w2 = Linear(d_ff, d_model, dtype=dtype, generator=generator, device=device)

    def forward(self, x):
        return self.w2(torch.relu(self.w1(x)))


class _EncoderLayer(nn.Module):
    def __init__(self, d_model, n_heads, d_ff, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.self_attn = MultiHeadedAttention(n_heads, d_model, **kw)
        self.ff = FeedForward(d_model, d_ff, **kw)
        self.norm1 = AnnotatedLayerNorm(d_model, device=device)
        self.norm2 = AnnotatedLayerNorm(d_model, device=device)

    def forward(self, x):
        y = self.norm1(x)
        x = x + self.self_attn(y, y, y)
        return x + self.ff(self.norm2(x))


class _DecoderLayer(nn.Module):
    def __init__(self, d_model, n_heads, d_ff, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.self_attn = MultiHeadedAttention(n_heads, d_model, **kw)
        self.cross_attn = MultiHeadedAttention(n_heads, d_model, **kw)
        self.ff = FeedForward(d_model, d_ff, **kw)
        self.norm1 = AnnotatedLayerNorm(d_model, device=device)
        self.norm2 = AnnotatedLayerNorm(d_model, device=device)
        self.norm3 = AnnotatedLayerNorm(d_model, device=device)

    def forward(self, x, memory):
        y = self.norm1(x)
        x = x + self.self_attn(y, y, y)
        y = self.norm2(x)
        x = x + self.cross_attn(y, memory, memory)
        return x + self.ff(self.norm3(x))


class Transformer(nn.Module):
    """Run encoder(src) -> decoder(tgt) and the swapped pair, producing
    co-attended residuals. The two passes stay sequential, as in the JAX
    package: they are not stacked into one 2B batch."""

    def __init__(self, emb_dims: int = 512, n_blocks: int = 1, dropout: float = 0.0,
                 ff_dims: int = 1024, n_heads: int = 4, *, dtype=None, generator=None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        if dropout != 0.0:
            raise NotImplementedError("dropout in the pointer is not ported (DCP uses 0)")
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.emb_dims = emb_dims
        self.enc_layers = nn.ModuleList(_EncoderLayer(emb_dims, n_heads, ff_dims, **kw) for _ in range(n_blocks))
        self.dec_layers = nn.ModuleList(_DecoderLayer(emb_dims, n_heads, ff_dims, **kw) for _ in range(n_blocks))
        self.enc_norm = AnnotatedLayerNorm(emb_dims, device=device)
        self.dec_norm = AnnotatedLayerNorm(emb_dims, device=device)

    def _encode(self, x):
        for layer in self.enc_layers:
            x = layer(x)
        return self.enc_norm(x)

    def _decode(self, x, memory):
        for layer in self.dec_layers:
            x = layer(x, memory)
        return self.dec_norm(x)

    def forward(self, src_emb, tgt_emb):
        """(B, N, E) x 2 -> (src_residual, tgt_residual)."""
        tgt_residual = self._decode(tgt_emb, self._encode(src_emb))
        src_residual = self._decode(src_emb, self._encode(tgt_emb))
        return src_residual, tgt_residual


class Identity(nn.Module):
    """Pass-through pointer."""

    def forward(self, *args):
        return args
