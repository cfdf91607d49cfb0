"""The sinc family of the SO(3)/SE(3) exponential maps, counterpart of
``learning3d_tpu/ops/sinc.py``.

    sinc1(t) = sin(t) / t
    sinc2(t) = (1 - cos(t)) / t^2
    sinc3(t) = (t - sin(t)) / t^3
    sinc4(t) = (t^2/2 + cos(t) - 1) / t^4

Each ``*_sq`` form takes s = t^2, so that a caller can feed sum(w * w) and
keep every autodiff order finite at w = 0 (the gradient of ||w|| is NaN
there). Below a switch point (s < 0.09, 0.25, 0.64, 1.0) a nested
four-term Taylor polynomial replaces the closed form, whose cancellation
grows with the function's order. The closed form is evaluated on
``_safe(s)``, which is 1 below the switch point: a ``torch.where`` routes
no gradient into its untaken branch, but a NaN or inf computed there would
still poison it, so that branch must stay finite (the double ``where``).
"""

from __future__ import annotations

import torch

# Squared switch points per function (s = t^2).
_S1, _S2, _S3, _S4 = 0.09, 0.25, 0.64, 1.0


def _safe(s, lim):
    return torch.where(s < lim, torch.ones_like(s), s)


def _taylor1(s):
    return 1.0 - s / 6.0 * (1.0 - s / 20.0 * (1.0 - s / 42.0 * (1.0 - s / 72.0)))


def _taylor2(s):
    return 0.5 * (1.0 - s / 12.0 * (1.0 - s / 30.0 * (1.0 - s / 56.0 * (1.0 - s / 90.0))))


def _taylor3(s):
    return (1.0 / 6.0) * (1.0 - s / 20.0 * (1.0 - s / 42.0 * (1.0 - s / 72.0 * (1.0 - s / 110.0))))


def _taylor4(s):
    return (1.0 / 24.0) * (1.0 - s / 30.0 * (1.0 - s / 56.0 * (1.0 - s / 90.0 * (1.0 - s / 132.0))))


def sinc1_sq(s):
    """sinc1(sqrt(s)) as a smooth function of s = t^2."""
    r = torch.sqrt(_safe(s, _S1))
    return torch.where(s < _S1, _taylor1(s), torch.sin(r) / r)


def sinc2_sq(s):
    """sinc2(sqrt(s)) as a smooth function of s = t^2."""
    r = torch.sqrt(_safe(s, _S2))
    return torch.where(s < _S2, _taylor2(s), (1.0 - torch.cos(r)) / _safe(s, _S2))


def sinc3_sq(s):
    """sinc3(sqrt(s)) as a smooth function of s = t^2."""
    r = torch.sqrt(_safe(s, _S3))
    return torch.where(s < _S3, _taylor3(s), (r - torch.sin(r)) / (_safe(s, _S3) * r))


def sinc4_sq(s):
    """sinc4(sqrt(s)) as a smooth function of s = t^2."""
    ss = _safe(s, _S4)
    r = torch.sqrt(ss)
    return torch.where(s < _S4, _taylor4(s), (0.5 * ss + torch.cos(r) - 1.0) / (ss * ss))


def sinc1(t):
    """sin(t)/t, exact and differentiable at t=0."""
    return sinc1_sq(t * t)


def sinc2(t):
    """(1-cos(t))/t^2, exact and differentiable at t=0 (value 1/2)."""
    return sinc2_sq(t * t)


def sinc3(t):
    """(t-sin(t))/t^3, exact and differentiable at t=0 (value 1/6)."""
    return sinc3_sq(t * t)


def sinc4(t):
    """(t^2/2+cos(t)-1)/t^4, exact and differentiable at t=0 (value 1/24)."""
    return sinc4_sq(t * t)
