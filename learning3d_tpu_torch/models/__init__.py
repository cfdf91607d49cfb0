"""Model zoo of the port, every model family of ``learning3d_tpu.models``:
the PointNet and DGCNN encoders, the classification and part-segmentation
heads, PointConv and CurveNet classification, DCP, PRNet, iPCRNet,
PointNetLK, RPMNet (with PPFNet) and DeepGMR registration, MaskNet (with
PointNetMask) and MaskNet2 inlier masks, PCN completion and FlowNet3D scene
flow."""

from learning3d_tpu_torch.models.classifier import Classifier  # noqa: F401
from learning3d_tpu_torch.models.curvenet import CurveNet  # noqa: F401
from learning3d_tpu_torch.models.dcp import DCP  # noqa: F401
from learning3d_tpu_torch.models.deepgmr import DeepGMR  # noqa: F401
from learning3d_tpu_torch.models.dgcnn import DGCNN  # noqa: F401
from learning3d_tpu_torch.models.flownet3d import FlowNet3D  # noqa: F401
from learning3d_tpu_torch.models.masknet import MaskNet, PointNetMask  # noqa: F401
from learning3d_tpu_torch.models.masknet2 import MaskNet2  # noqa: F401
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

__all__ = ["Classifier", "CurveNet", "DCP", "DGCNN", "DeepGMR", "FlowNet3D", "MaskNet", "MaskNet2", "PCN", "PPFNet",
           "PRNet",
           "PointConvDensityClsSsg", "PointNet", "PointNetLK", "PointNetMask", "Pooling", "RPMNet", "Segmentation",
           "create_pointconv", "iPCRNet"]
