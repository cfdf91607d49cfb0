"""Training harness of the port: the config dataclass, the task losses and
the generic ``Trainer`` (optimizers, gradient guard and accumulation,
checkpoints with best/latest and feature-model export)."""

from learning3d_tpu_torch.train.config import TrainConfig  # noqa: F401
from learning3d_tpu_torch.train.metrics import (  # noqa: F401
    mask_scores,
    registration_errors,
    rotation_error_deg,
    translation_error,
)
from learning3d_tpu_torch.train.trainer import Trainer  # noqa: F401
