"""Loss library of the port (what is ported of ``learning3d_tpu.losses``)."""

from learning3d_tpu_torch.losses.losses import (  # noqa: F401
    chamfer_distance_loss,
    classification_loss,
    emd_loss_mean,
    frobenius_norm_loss,
    rmse_features_loss,
)

# Reference-style aliases.
ChamferDistanceLoss = chamfer_distance_loss
EMDLoss = emd_loss_mean
FrobeniusNormLoss = frobenius_norm_loss
RMSEFeaturesLoss = rmse_features_loss
ClassificationLoss = classification_loss
