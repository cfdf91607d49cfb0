"""Model zoo of the port. Ported so far: the PointNet and DGCNN encoders,
the classification head, DCP, PRNet, iPCRNet and RPMNet (with PPFNet)
registration, PCN completion and FlowNet3D scene flow;
the other models of ``learning3d_tpu.models`` follow slice by slice
(ROADMAP.md)."""

from learning3d_tpu_torch.models.classifier import Classifier  # noqa: F401
from learning3d_tpu_torch.models.dcp import DCP  # noqa: F401
from learning3d_tpu_torch.models.dgcnn import DGCNN  # noqa: F401
from learning3d_tpu_torch.models.flownet3d import FlowNet3D  # noqa: F401
from learning3d_tpu_torch.models.pcn import PCN  # noqa: F401
from learning3d_tpu_torch.models.pcrnet import iPCRNet  # noqa: F401
from learning3d_tpu_torch.models.pointnet import PointNet  # noqa: F401
from learning3d_tpu_torch.models.ppfnet import PPFNet  # noqa: F401
from learning3d_tpu_torch.models.prnet import PRNet  # noqa: F401
from learning3d_tpu_torch.models.pooling import Pooling  # noqa: F401
from learning3d_tpu_torch.models.rpmnet import RPMNet  # noqa: F401

__all__ = ["Classifier", "DCP", "DGCNN", "FlowNet3D", "PCN", "PPFNet", "PRNet", "PointNet", "Pooling", "RPMNet",
           "iPCRNet"]
