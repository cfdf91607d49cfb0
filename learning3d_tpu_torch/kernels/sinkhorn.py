"""Slack log-domain Sinkhorn (K17): a CUDA kernel (``csrc/sinkhorn.cu``),
counterpart of ``learning3d_tpu/kernels/sinkhorn.py::sinkhorn_log_pallas``.

``sinkhorn_log_pallas(log_alpha, n_iters=5)``: log_alpha (B, J, K) -> (B,
J, K) f32, RPMNet's Sinkhorn: a zero slack row and column are appended;
each iteration normalises the first J rows over all K+1 columns, then the
first K columns over all J+1 rows, each logsumexp ``m + log(sum(exp(x -
m)))``; the slack row and column are cut off at the end.

A CUDA tensor launches the kernel (past ``sinkhorn_kernel_limit``
NotImplementedError): every shape whose offsets fit int32, where the JAX
package sends to its TPU kernel only what fits VMEM ((J+1)(K+1)·4 <= 5
MiB). A CPU tensor runs the plain version ``sinkhorn_slack_reference``,
the twin of the JAX package's XLA oracle ``utils/rigid._sinkhorn_slack_xla``
(the matrix rewritten pass after pass). The kernel keeps row and column
potentials instead, in f64, and rounds its output once; the two agree to a
few 1e-6 (absolute, on log values of -10 and below) at RPMNet's shapes. An
iteration is one sweep over the matrix (each block of ``SWEEP_ROWS`` rows
forms its rows' u from the last v, then each column's partial (m, s) over
those rows) and a merge of the partials into v, so a call reads the matrix
n_iters + 1 times (``tests/test_torch_k17_layout.py`` states that schedule
in torch).

The gradient, on the card as in the JAX package's custom VJP
(``learning3d_tpu/utils/rigid.py:34-54``), recomputes the forward through
the plain version under autograd and returns its VJP: the kernel has no
backward of its own.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import _build

INT32_MAX = 2**31 - 1
SWEEP_ROWS = 16  # rows a sweep block takes (csrc/sinkhorn.cu's kRows; the C entry checks it)


def sinkhorn_kernel_limit(b, j, k):
    """The limit of K17 that the shape breaks, as a message, or None: J, K,
    the B J rows and the B ceil(K / 32) column tiles are int32 in the
    kernel."""
    if j > INT32_MAX or k > INT32_MAX or b * j > INT32_MAX or b * -(-k // 32) > INT32_MAX:
        return f"K17 (sinkhorn_log_pallas) takes B J <= 2**31 - 1 and B ceil(K / 32) <= 2**31 - 1, got {(b, j, k)}"
    return None


def sinkhorn_slack_reference(log_alpha, n_iters: int = 5):
    """The plain version, the JAX package's ``_sinkhorn_slack_xla`` in
    torch: (B, J, K) in the input's floating type (at least f32), the padded
    matrix rewritten by each pass, differentiable."""
    la = log_alpha if log_alpha.dtype in (torch.float32, torch.float64) else log_alpha.float()
    padded = F.pad(la, (0, 1, 0, 1))
    for _ in range(n_iters):
        rows = padded[:, :-1, :] - torch.logsumexp(padded[:, :-1, :], dim=2, keepdim=True)
        padded = torch.cat([rows, padded[:, -1:, :]], dim=1)
        cols = padded[:, :, :-1] - torch.logsumexp(padded[:, :, :-1], dim=1, keepdim=True)
        padded = torch.cat([cols, padded[:, :, -1:]], dim=2)
    return padded[:, :-1, :-1]


def _launch(log_alpha, n_iters):
    a = log_alpha.detach().float().contiguous()
    B, J, K = a.shape
    out = torch.empty_like(a)
    if B == 0 or J == 0 or K == 0:
        return out
    u = torch.empty((B, J), device=a.device, dtype=torch.float64)  # the potentials, kept in f64
    v = torch.empty((B, K), device=a.device, dtype=torch.float64)
    part = torch.empty((2, B, -(-J // SWEEP_ROWS), K), device=a.device, dtype=torch.float64)  # the sweeps' (m, s)
    _build.launch("sinkhorn_slack", a.device, a.data_ptr(), out.data_ptr(), u.data_ptr(), v.data_ptr(),
                  part.data_ptr(), B, J, K, n_iters, SWEEP_ROWS)
    LAUNCHES["sinkhorn_log_pallas"] += 1
    return out


class _SinkhornSlack(torch.autograd.Function):
    """K17 forward; the backward recomputes through the plain version."""

    @staticmethod
    def forward(ctx, log_alpha, n_iters):
        ctx.save_for_backward(log_alpha)
        ctx.n_iters = n_iters
        return _launch(log_alpha, n_iters)

    @staticmethod
    def backward(ctx, grad):
        (log_alpha,) = ctx.saved_tensors
        with torch.enable_grad():
            x = log_alpha.detach().float().requires_grad_(True)
            (gx,) = torch.autograd.grad(sinkhorn_slack_reference(x, ctx.n_iters), x, grad)
        return gx.to(log_alpha.dtype), None


def sinkhorn_log_pallas(log_alpha, n_iters: int = 5):
    """log_alpha (B, J, K) -> (B, J, K) log of the slack-normalised matrix.
    One kernel call on a CUDA tensor (f32 out; differentiable through the
    plain version's recompute), the plain version on a CPU one."""
    if log_alpha.ndim != 3:
        raise ValueError(f"log_alpha must be (B, J, K), got {tuple(log_alpha.shape)}")
    if n_iters < 0:
        raise ValueError(f"n_iters must be >= 0, got {n_iters}")
    if log_alpha.device.type == "cpu":
        return sinkhorn_slack_reference(log_alpha, n_iters)
    if log_alpha.device.type != "cuda":
        raise ValueError(f"no kernel for device {log_alpha.device}")
    limit = sinkhorn_kernel_limit(*log_alpha.shape)
    if limit is not None:
        raise NotImplementedError(limit)
    if torch.is_grad_enabled() and log_alpha.requires_grad:
        return _SinkhornSlack.apply(log_alpha, int(n_iters))
    return _launch(log_alpha, int(n_iters))
