"""Model zoo of the port. Ported so far: the PointNet encoder and the
classification head; the other models of ``learning3d_tpu.models`` follow
slice by slice (ROADMAP.md)."""

from learning3d_tpu_torch.models.classifier import Classifier  # noqa: F401
from learning3d_tpu_torch.models.pointnet import PointNet  # noqa: F401
from learning3d_tpu_torch.models.pooling import Pooling  # noqa: F401

__all__ = ["Classifier", "PointNet", "Pooling"]
