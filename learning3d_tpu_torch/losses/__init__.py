"""Loss library of the port (what is ported of ``learning3d_tpu.losses``)."""

from learning3d_tpu_torch.losses.losses import (  # noqa: F401
    chamfer_distance_loss,
    classification_loss,
    emd_loss_mean,
)

# Reference-style aliases.
ChamferDistanceLoss = chamfer_distance_loss
EMDLoss = emd_loss_mean
ClassificationLoss = classification_loss
