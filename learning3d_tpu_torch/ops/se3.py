"""SE(3) helpers, counterpart of ``learning3d_tpu/ops/se3.py``. Ported so
far: what DCP needs."""

from __future__ import annotations

import torch


def from_rt(R, t):
    """(..., 3, 3) + (..., 3) -> homogeneous (..., 4, 4)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)
