"""Loss library of the port (what is ported of ``learning3d_tpu.losses``)."""

from learning3d_tpu_torch.losses.losses import classification_loss  # noqa: F401

# Reference-style alias.
ClassificationLoss = classification_loss
