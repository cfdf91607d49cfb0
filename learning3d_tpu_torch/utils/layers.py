"""Shared-MLP stacks, BatchNorm, dropout and pooling: counterpart of
``learning3d_tpu/utils/layers.py``.

The reference's Conv1d(kernel=1) stacks are per-point Linear layers over
channel-last (B, N, C) inputs. Parameters are kept in float32 and the
arithmetic runs in the module's ``dtype`` (e.g. bf16), as flax nnx does
with ``param_dtype`` and ``dtype``. BatchNorm follows ``nnx.BatchNorm``
(``momentum=0.9``, fast variance, biased running variance), GroupNorm
``nnx.GroupNorm`` (eps 1e-6, fast variance, channel-last groups), dropout
``nnx.Dropout`` with an explicit ``torch.Generator``. The train-mode fused
PointNet tail ``linear_bn_relu_maxpool`` is a ``torch.autograd.Function``
over K3 and K4 (``kernels/poolgrad.py``).
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from learning3d_tpu_torch import DEFAULT_DEVICE, resolve_device
from learning3d_tpu_torch.kernels.poolgrad import pool_bwd, pool_bwd_ok, pool_stats, pool_stats_ok

BN_MOMENTUM = 0.9  # flax's BatchNorm momentum: the EMA keeps 0.9 of the old statistics (torch's momentum 0.1)


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
    """``nnx.BatchNorm(momentum=0.9)`` over the last axis, eps 1e-5.

    Eval (``use_running_average``): the running ``mean`` and ``var``, the
    arithmetic in the module's ``dtype``: y = (x - mean) * (rsqrt(var + eps)
    * scale) + bias.

    Train: the batch statistics over every axis but the last, in at least
    f32, with the fast variance E[x^2] - E[x]^2 clipped at 0; y is computed
    in that type and rounded to ``dtype``. The running statistics become
    0.9 * old + 0.1 * batch (flax's momentum 0.9 is torch's 0.1), with the
    *biased* fast variance (torch's own BatchNorm keeps the unbiased one),
    under ``no_grad``. ``use_running_average`` on a call overrides the mode
    (``self.training``)."""

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

    def use_running(self, use_running_average=None) -> bool:
        return not self.training if use_running_average is None else bool(use_running_average)

    def affine(self, dtype):
        """(s, b) with bn(x) == x * s + b under the running statistics, both
        in ``dtype``."""
        mean, var, scale, bias = (t.to(dtype) for t in (self.running_mean, self.running_var, self.weight,
                                                        self.bias))
        s = scale * torch.rsqrt(var + self.eps)
        return s, bias - mean * s

    @torch.no_grad()
    def update_running(self, mean, var):
        """The EMA of the running statistics: 0.9 * old + 0.1 * batch."""
        m = BN_MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean.to(self.running_mean.dtype))
        self.running_var.copy_(m * self.running_var + (1 - m) * var.to(self.running_var.dtype))

    def forward(self, x, use_running_average=None):
        dt = _compute_dtype(self.dtype, x, self.weight)
        if self.use_running(use_running_average):
            mean, var, scale, bias = (t.to(dt) for t in (self.running_mean, self.running_var, self.weight,
                                                         self.bias))
            return (x.to(dt) - mean) * (torch.rsqrt(var + self.eps) * scale) + bias
        st = torch.promote_types(dt, torch.float32)
        xs = x.to(dt).to(st)
        red = tuple(range(x.ndim - 1))
        mean = xs.mean(red)
        var = torch.clamp((xs * xs).mean(red) - mean * mean, min=0.0)
        self.update_running(mean.detach(), var.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight.to(dt).to(st)
        return ((xs - mean) * mul + self.bias.to(dt).to(st)).to(dt)


class GroupNorm(nn.Module):
    """``nnx.GroupNorm(num_features, num_groups)`` with flax's defaults, on
    channel-last input (B, ..., C): the C channels split into ``num_groups``
    groups of consecutive channels, and each (batch item, group) normalised
    by the statistics over every axis but the first, within the group's
    channels. The statistics are in at least f32 with the fast variance,
    var = max(0, E[x^2] - E[x]^2), and y = (x - mean) * (rsqrt(var + eps) *
    weight) + bias, rounded to ``dtype``; eps is flax's 1e-6. (torch's
    ``nn.GroupNorm`` is channel-first, takes eps 1e-5 and the two-pass
    variance.) ``weight`` and ``bias`` are nnx's ``scale`` and ``bias``. No
    running statistics: train and eval mode are the same."""

    def __init__(self, num_features, num_groups=32, *, eps=1e-6, dtype=None, device=DEFAULT_DEVICE):
        super().__init__()
        if num_features % num_groups:
            raise ValueError(f"num_features {num_features} is not a multiple of num_groups {num_groups}")
        device = resolve_device(device)
        self.num_features = num_features
        self.num_groups = num_groups
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))

    def forward(self, x):
        dt = _compute_dtype(self.dtype, x, self.weight)
        st = torch.promote_types(dt, torch.float32)
        xs = x.to(dt).to(st)
        B, C, G = x.shape[0], x.shape[-1], self.num_groups
        g = xs.reshape(B, -1, G, C // G)
        mean = g.mean((1, 3))
        var = torch.clamp((g * g).mean((1, 3)) - mean * mean, min=0.0)
        shape = (B,) + (1,) * (x.ndim - 2) + (C,)
        mean = mean.repeat_interleave(C // G, dim=-1).reshape(shape)
        var = var.repeat_interleave(C // G, dim=-1).reshape(shape)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(dt).to(st)
        return ((xs - mean) * mul + self.bias.to(dt).to(st)).to(dt)


class Dropout(nn.Module):
    """``nnx.Dropout``: in training, keep each value with probability
    1 - rate and scale the kept ones by 1 / (1 - rate); identity in eval or
    at rate 0. The mask is drawn from ``generator``, a ``torch.Generator`` on
    the inputs' device (one generator for the model, so that a run replays
    from its seed; a new one seeded with 0 by default), never from the
    global RNG."""

    def __init__(self, rate: float, *, generator: torch.Generator | None = None, device=DEFAULT_DEVICE):
        super().__init__()
        self.rate = float(rate)
        if generator is None:
            generator = torch.Generator(device=resolve_device(device)).manual_seed(0)
        self.generator = generator

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


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


class _LinearBnReluMaxpoolTrain(torch.autograd.Function):
    """relu(bn(x @ W + c)) max-pooled over the points, with train-mode batch
    statistics; ``learning3d_tpu/utils/layers.py``'s
    ``_linear_bn_relu_maxpool_train`` formula for formula.

    Forward (M = B*N rows, z = x W + c): the statistics come from the K x K
    Gram matrix G = sum_bn x x^T instead of a pass over the (M, E) z:
      mean = colmean(x) W + c,  E[z^2] = diag(W^T G W)/M + 2 c mean - c^2,
      var = max(E[z^2] - mean^2, 0),  s = gamma rsqrt(var + eps),
      b = beta - mean s,  out = relu(s sel + b),
    with sel the max of z over the points where s >= 0, else the min.
    Backward: dz is onehot(argsel) dsel + dmean/M + (2/M) dE2 z, so every
    dense term collapses onto G and only the one-hot part is a scatter
    (K4) and a gather.

    Where JAX's gate holds (f32 statistics, K and E multiples of 128) the
    max/min/argmax/argmin, G and colsum come from K3 and the scatter and
    gather from K4, on every device (their plain versions on the CPU);
    elsewhere the XLA branch's math runs in plain torch. The dense K x K
    terms are plain torch, as they are XLA in JAX. Returns (out, batch mean,
    batch var); the caller applies the running-statistics EMA."""

    @staticmethod
    def forward(ctx, x, W, c, gamma, beta, eps):
        B, N, K = x.shape
        E = W.shape[1]
        M = B * N
        st = torch.promote_types(x.dtype, torch.float32)  # statistics in at least f32
        Wf, cf = W.to(st), c.to(st)
        kernels = st == torch.float32 and pool_stats_ok(N, E, K)
        if kernels:
            mx, mn, amax, amin, G, colsum = pool_stats(x, W, c)
            out_dtype = x.dtype
            colmean_x = colsum / M
        else:
            z = x @ W + c  # compute dtype; consumed only by the four reductions
            out_dtype = z.dtype
            mx, amax = z.amax(1), z.argmax(1).to(torch.int32)
            mn, amin = z.amin(1), z.argmin(1).to(torch.int32)
            xs = x.to(st)
            colmean_x = xs.mean((0, 1))
            G = torch.einsum("bnk,bnl->kl", xs, xs)
        T = G @ Wf  # (K, E), reused in the backward
        mean = colmean_x @ Wf + cf
        e2 = (Wf * T).sum(0) / M + 2.0 * cf * mean - cf * cf
        var = torch.clamp(e2 - mean * mean, min=0.0)
        s = gamma.to(st) * torch.rsqrt(var + eps)
        b = beta.to(st) - mean * s
        spos = s >= 0
        sel = torch.where(spos, mx, mn).to(st)
        idx = torch.where(spos[None, :], amax, amin)
        a = s * sel + b
        ctx.eps, ctx.kernels = eps, kernels and pool_bwd_ok(N, E, K)
        ctx.save_for_backward(x, W, c, gamma, beta, mean, var, e2, s, sel, idx, a > 0, colmean_x, T)
        return torch.relu(a).to(out_dtype), mean, var

    @staticmethod
    def backward(ctx, dout, dmean_out, dvar_out):
        x, W, c, gamma, beta, mean, var, e2, s, sel, idx, pos, colmean_x, T = ctx.saved_tensors
        st = torch.promote_types(x.dtype, torch.float32)
        Wf, cf = W.to(st), c.to(st)
        B, N, K = x.shape
        M = B * N

        da = dout.to(st) * pos  # (B, E)
        dsel = da * s
        db2 = da.sum(0)
        ds = (da * sel).sum(0) - mean * db2
        rstd = torch.rsqrt(var + ctx.eps)
        dgamma = ds * rstd
        dvar = -0.5 * ds * gamma.to(st) * rstd / (var + ctx.eps) + dvar_out.to(st)
        # var = max(e2 - mean^2, 0): the clip only bites in degenerate cases
        dd = torch.where(e2 - mean * mean > 0, dvar, torch.zeros_like(dvar))
        dmean = -s * db2 - 2.0 * mean * dd + dmean_out.to(st)
        dE2 = dd

        if ctx.kernels:
            dx, dW_sel = pool_bwd(idx, dsel, W, x)
        else:
            E = idx.shape[1]
            il = idx.long()
            x_sel = torch.gather(x, 1, il[:, :, None].expand(B, E, K)).to(st)  # (B, E, K)
            dW_sel = torch.einsum("bek,be->ke", x_sel, dsel)
            vals = dsel[:, :, None] * Wf.t()[None]  # (B, E, K)
            rows = (il + N * torch.arange(B, device=x.device)[:, None]).reshape(-1)
            dx = torch.zeros(M, K, device=x.device, dtype=st).index_add_(0, rows, vals.reshape(B * E, K))
            dx = dx.view(B, N, K)
        dW = (dW_sel + torch.outer(colmean_x, dmean) + (2.0 / M) * T * dE2[None, :]
              + 2.0 * torch.outer(colmean_x, cf * dE2))
        dc = dsel.sum(0) + dmean + 2.0 * dE2 * mean
        P = (Wf * (2.0 * dE2 / M)[None, :]) @ Wf.t()  # (K, K)
        row = Wf @ (dmean / M) + (2.0 / M) * (Wf @ (cf * dE2))  # (K,)
        dx = dx.reshape(M, K).addmm(x.reshape(M, K).to(st), P.to(x.dtype).to(st)) + row[None, :]
        return (dx.view(B, N, K).to(x.dtype), dW.to(W.dtype), dc.to(c.dtype), dgamma.to(gamma.dtype),
                db2.to(beta.dtype), None)


def linear_bn_relu_maxpool(x, linear, bn, use_running_average=None):
    """``max over points of relu(bn(linear(x)))`` for (B, N, K) inputs, the
    whole encoder tail as one fused stage. Train mode runs the Gram-matrix
    autograd Function (K3 and K4 where JAX's gate holds) and applies the
    running-statistics EMA outside it; eval mode the affine selection of
    ``fused_bn_relu_maxpool``.

    As ``nnx.Linear`` promotes, the Function receives x, the weight and the
    bias in the linear's compute dtype (bf16 for a bf16 model) and returns
    dW in that dtype: a bf16 model's weight gradient is rounded to bf16
    before it reaches the f32 parameter, as in JAX."""
    if bn.use_running(use_running_average):
        return fused_bn_relu_maxpool(linear(x), bn)
    dt = _compute_dtype(linear.dtype, x, linear.weight)
    W = linear.weight.to(dt).t()  # (K, E), a view of the (E, K) weight
    c = linear.bias.to(dt) if linear.bias is not None else torch.zeros(W.shape[1], device=x.device, dtype=dt)
    out, mean, var = _LinearBnReluMaxpoolTrain.apply(x.to(dt), W, c, bn.weight, bn.bias, bn.eps)
    bn.update_running(mean.detach(), var.detach())
    return out


def set_bn_mode(model: nn.Module, use_running_average: bool):
    """Flip every BatchNorm between train and eval statistics (the
    PointNetLK warm-then-freeze trick); like the JAX package, this sets the
    mode of the whole model."""
    if use_running_average:
        model.eval()
    else:
        model.train()


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


MLP2d = MLP1d  # the JAX package's name for the same stack (channel-last either way)


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
