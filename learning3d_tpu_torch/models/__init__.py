"""Model zoo of the port. Ported so far: the PointNet and DGCNN encoders,
the classification and part-segmentation heads, PointConv and CurveNet
classification, DCP, PRNet, iPCRNet, PointNetLK and RPMNet (with PPFNet)
registration, MaskNet (with PointNetMask) inlier masks, PCN completion and
FlowNet3D scene flow; the other models of ``learning3d_tpu.models``
(DeepGMR, MaskNet2) follow slice by slice (ROADMAP.md)."""

from learning3d_tpu_torch.models.classifier import Classifier  # noqa: F401
from learning3d_tpu_torch.models.curvenet import CurveNet  # noqa: F401
from learning3d_tpu_torch.models.dcp import DCP  # noqa: F401
from learning3d_tpu_torch.models.dgcnn import DGCNN  # noqa: F401
from learning3d_tpu_torch.models.flownet3d import FlowNet3D  # noqa: F401
from learning3d_tpu_torch.models.masknet import MaskNet, PointNetMask  # noqa: F401
from learning3d_tpu_torch.models.pcn import PCN  # noqa: F401
from learning3d_tpu_torch.models.pcrnet import iPCRNet  # noqa: F401
from learning3d_tpu_torch.models.pointconv import PointConvDensityClsSsg, create_pointconv  # noqa: F401
from learning3d_tpu_torch.models.pointnet import PointNet  # noqa: F401
from learning3d_tpu_torch.models.pointnetlk import PointNetLK  # noqa: F401
from learning3d_tpu_torch.models.ppfnet import PPFNet  # noqa: F401
from learning3d_tpu_torch.models.prnet import PRNet  # noqa: F401
from learning3d_tpu_torch.models.pooling import Pooling  # noqa: F401
from learning3d_tpu_torch.models.rpmnet import RPMNet  # noqa: F401
from learning3d_tpu_torch.models.segmentation import Segmentation  # noqa: F401

__all__ = ["Classifier", "CurveNet", "DCP", "DGCNN", "FlowNet3D", "MaskNet", "PCN", "PPFNet", "PRNet",
           "PointConvDensityClsSsg", "PointNet", "PointNetLK", "PointNetMask", "Pooling", "RPMNet", "Segmentation",
           "create_pointconv", "iPCRNet"]
