"""Model zoo of the port. Ported so far: the PointNet and DGCNN encoders,
the classification head, DCP and iPCRNet registration and PCN completion;
the other models of ``learning3d_tpu.models`` follow slice by slice
(ROADMAP.md)."""

from learning3d_tpu_torch.models.classifier import Classifier  # noqa: F401
from learning3d_tpu_torch.models.dcp import DCP  # noqa: F401
from learning3d_tpu_torch.models.dgcnn import DGCNN  # noqa: F401
from learning3d_tpu_torch.models.pcn import PCN  # noqa: F401
from learning3d_tpu_torch.models.pcrnet import iPCRNet  # noqa: F401
from learning3d_tpu_torch.models.pointnet import PointNet  # noqa: F401
from learning3d_tpu_torch.models.pooling import Pooling  # noqa: F401

__all__ = ["Classifier", "DCP", "DGCNN", "PCN", "PointNet", "Pooling", "iPCRNet"]
