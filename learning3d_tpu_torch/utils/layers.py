"""Shared-MLP stacks, BatchNorm and pooling: counterpart of
``learning3d_tpu/utils/layers.py``, eval branch only.

The reference's Conv1d(kernel=1) stacks are per-point Linear layers over
channel-last (B, N, C) inputs. Parameters are kept in float32 and the
arithmetic runs in the module's ``dtype`` (e.g. bf16), as flax nnx does
with ``param_dtype`` and ``dtype``. Train-mode BatchNorm statistics are
not ported yet: a BatchNorm in training mode raises.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from learning3d_tpu_torch import DEFAULT_DEVICE, resolve_device


def _compute_dtype(dtype, *tensors):
    if dtype is not None:
        return dtype
    out = tensors[0].dtype
    for t in tensors[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


def validate_input_shape(input_shape: str) -> str:
    """Every model accepts input_shape='bnc'|'bcn' and rejects anything else."""
    if input_shape not in ("bnc", "bcn"):
        raise ValueError("Allowed shapes are 'bcn' and 'bnc'.")
    return input_shape


def to_bnc(x, input_shape: str):
    """A point cloud or feature tensor in the channel-last (B, N, C) layout."""
    return x.transpose(1, 2) if input_shape == "bcn" else x


class Linear(nn.Linear):
    """``nnx.Linear``: float32 parameters, arithmetic in ``dtype``. The
    weight has torch's (out, in) layout; ``utils.jax_import`` transposes
    nnx's (in, out) kernel into it. ``use_bias=False`` leaves ``bias``
    None, as nnx has no bias entry then."""

    def __init__(self, in_features, out_features, *, use_bias=True, dtype=None, generator=None,
                 device=DEFAULT_DEVICE):
        super().__init__(in_features, out_features, bias=use_bias, device="cpu")
        self.dtype = dtype
        with torch.no_grad():
            self.weight.normal_(0.0, in_features**-0.5, generator=generator)
            if self.bias is not None:
                self.bias.zero_()
        self.to(resolve_device(device))

    def forward(self, x):
        dt = _compute_dtype(self.dtype, x, self.weight)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class BatchNorm(nn.Module):
    """``nnx.BatchNorm`` over the last axis, eval mode: running ``mean`` and
    ``var``, eps 1e-5, arithmetic in the module's ``dtype``:
    y = (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, num_features, *, eps=1e-5, dtype=None, device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        self.num_features = num_features
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))

    def _stats(self, dtype):
        if self.training:
            raise NotImplementedError("train-mode BatchNorm statistics are not ported yet")
        return (t.to(dtype) for t in (self.running_mean, self.running_var, self.weight, self.bias))

    def affine(self, dtype):
        """(s, b) with bn(x) == x * s + b, both in ``dtype``."""
        mean, var, scale, bias = self._stats(dtype)
        s = scale * torch.rsqrt(var + self.eps)
        return s, bias - mean * s

    def forward(self, x):
        dt = _compute_dtype(self.dtype, x, self.weight)
        mean, var, scale, bias = self._stats(dt)
        return (x.to(dt) - mean) * (torch.rsqrt(var + self.eps) * scale) + bias


def fused_bn_relu_maxpool(z, bn):
    """Max over the points axis of ``relu(bn(z))`` for (B, N, C) inputs
    under running statistics, without materializing the normalized tensor.

    BatchNorm here is a per-channel affine s*z + b and relu is monotone, so
    max_n relu(s*z_n + b) = relu(s*sel + b) with sel the per-channel max of
    z where s >= 0 and its min where s < 0.
    """
    dt = _compute_dtype(bn.dtype, z, bn.weight)
    z = z.to(dt)
    s, b = bn.affine(dt)
    sel = torch.where(s >= 0, torch.amax(z, dim=-2), torch.amin(z, dim=-2))
    return torch.relu(s * sel + b)


class MLP1d(nn.Module):
    """Stack of per-point Linear(+BatchNorm)(+activation) over (..., C)
    inputs. norm: None | 'batch'."""

    def __init__(
        self,
        dims: Sequence[int],
        *,
        norm: str | None = "batch",
        act: Callable = torch.relu,
        act_last: bool = True,
        norm_last: bool = True,
        dtype=None,
        generator=None,
        device=DEFAULT_DEVICE,
    ):
        super().__init__()
        if norm not in (None, "batch"):
            raise ValueError(f"norm {norm!r} is not ported yet")
        self.act = act
        self.act_last = act_last
        n = len(dims) - 1
        self.layers = nn.ModuleList(
            Linear(i, o, dtype=dtype, generator=generator, device=device)
            for i, o in zip(dims[:-1], dims[1:])
        )
        # nn.Identity where nnx keeps None, so state_dict keys follow nnx's paths
        self.norms = nn.ModuleList(
            nn.Identity() if norm is None or (k == n - 1 and not norm_last)
            else BatchNorm(o, dtype=dtype, device=device)
            for k, o in enumerate(dims[1:])
        )

    def forward(self, x):
        n = len(self.layers)
        for i, (lin, nrm) in enumerate(zip(self.layers, self.norms)):
            x = nrm(lin(x))
            if i < n - 1 or self.act_last:
                x = self.act(x)
        return x


class Pooling(nn.Module):
    """Max or mean pool over the point axis: (B, N, C) -> (B, C)."""

    def __init__(self, pool_type: str = "max"):
        super().__init__()
        self.pool_type = pool_type

    def forward(self, x, axis=-2):
        if self.pool_type == "max":
            return torch.amax(x, dim=axis)
        if self.pool_type in ("avg", "average", "mean"):
            return torch.mean(x, dim=axis)
        raise ValueError(self.pool_type)
