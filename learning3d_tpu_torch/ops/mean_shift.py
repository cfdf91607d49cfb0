"""Zero-mean pre- and post-processing of PointNetLK, counterpart of
``learning3d_tpu/ops/mean_shift.py``: both clouds are centred before the
registration, and the means are folded back into the estimated transform
afterwards. The math is the JAX package's, which corrects the
reference's (its data_utils.py:19 takes the template's mean in the
source's branch)."""

from __future__ import annotations

import torch

from learning3d_tpu_torch.ops import se3


def mean_shift(template, source):
    """Zero-mean both clouds -> (template0, source0, a0, a1), a0 and a1 the
    (B, 4, 4) translations by -mean(template) and -mean(source): if est_T0
    registers source0 -> template0, then a0^-1 est_T0 a1 registers source ->
    template."""
    p0_m = template.mean(-2)  # (B, 3)
    p1_m = source.mean(-2)
    eye = torch.eye(3, dtype=template.dtype, device=template.device).expand(template.shape[:-2] + (3, 3))
    return template - p0_m[..., None, :], source - p1_m[..., None, :], se3.from_rt(eye, -p0_m), \
        se3.from_rt(eye, -p1_m)


def postprocess(est_T0, a0, a1):
    """est_T = a0^-1 est_T0 a1: the transform of the zero-meaned clouds as
    one of the original clouds. est_T0 may carry leading axes before a0's
    (PointNetLK's (iterations, B, 4, 4) series)."""
    return se3.compose(se3.compose(se3.inverse(a0), est_T0), a1)
