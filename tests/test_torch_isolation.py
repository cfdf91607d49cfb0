"""The port (learning3d_tpu_torch), chip_smoke.py and the port's profiling
script stand alone: they import nothing of JAX, flax or the JAX package,
build no PyTorch extension, read nothing under releases/, and run on the
card unless told otherwise."""

import ast
import inspect
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "learning3d_tpu_torch"
FORBIDDEN = ("jax", "flax", "learning3d_tpu")


def port_files(*suffixes):
    files = [p for p in sorted(PORT.rglob("*")) if p.suffix in suffixes and ".build" not in p.parts]
    if ".py" in suffixes:
        files += [ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_serve.py",
                  ROOT / "tools" / "sweep_torch_kernels.py", ROOT / "tools" / "time_kernel_build.py",
                  ROOT / "tools" / "profile_torch_train.py", ROOT / "tools" / "torch_dcp_step_gaps.py",
                  ROOT / "tools" / "torch_cls_step_gaps.py", ROOT / "tools" / "torch_prnet_step_gaps.py",
                  ROOT / "tools" / "torch_flownet_step_gaps.py", ROOT / "tools" / "torch_square_distance_ab.py",
                  ROOT / "tools" / "torch_rpmnet_step_gaps.py", ROOT / "tools" / "torch_attention_ab.py",
                  ROOT / "tools" / "torch_kernel_ab.py", ROOT / "tools" / "torch_lk_step_gaps.py",
                  ROOT / "tools" / "smoke_phases.py"]
    return files


def test_imports_without_jax():
    """Every port module and chip_smoke import with jax, flax and the JAX
    package made unimportable."""
    code = "\n".join([
        "import importlib, pkgutil, sys",
        *(f"sys.modules[{name!r}] = None" for name in FORBIDDEN),
        f"sys.path.insert(0, {str(ROOT)!r})",
        "import learning3d_tpu_torch, chip_smoke",
        "for m in pkgutil.walk_packages(learning3d_tpu_torch.__path__, 'learning3d_tpu_torch.'):",
        "    importlib.import_module(m.name)",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", port_files(".py"), ids=lambda p: p.name)
def test_source_names_no_jax(path):
    """No import, and no string that could feed a dynamic import, names
    jax, flax or the JAX package."""
    tree = ast.parse(path.read_text())
    named = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            named += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            named.append(node.module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            if node.value.split(".")[0] in FORBIDDEN:
                named.append(node.value)
    assert not [n for n in named if n.split(".")[0] in FORBIDDEN], named


def test_no_torch_extension_build_and_no_releases():
    for path in port_files(".py", ".cu", ".cuh", ".h"):
        text = path.read_text()
        for banned in ("cpp_extension", "torch/extension.h", "cutlass", "releases/"):
            assert banned not in text, (path, banned)


def test_entry_points_default_to_cuda():
    from learning3d_tpu_torch import DEFAULT_DEVICE, resolve_device
    from learning3d_tpu_torch.models import (
        DCP, DGCNN, PCN, MaskNet, PointNetLK, PointNetMask, PPFNet, RPMNet, Classifier, PointNet, PRNet, Segmentation,
        iPCRNet,
    )
    from learning3d_tpu_torch.models import CurveNet, DeepGMR, MaskNet2, PointConvDensityClsSsg
    from learning3d_tpu_torch.models.deepgmr import ClusterNet, Conv1dBNReLU, TNet
    from learning3d_tpu_torch.models.masknet2 import (
        AttnPointNet, BasicConv1D, PointNetMask2, SelfAttentionFC, SelfAttn,
    )
    from learning3d_tpu_torch.models.dcp import MLPHead
    from learning3d_tpu_torch.models.pointconv import DensityNet, PointConvDensitySetAbstraction, WeightNet
    from learning3d_tpu_torch.models.prnet import PRDGCNN, PRPointNet, PRSVDHead, TemperatureNet
    from learning3d_tpu_torch.models.rpmnet import ParameterPredictionNet
    from learning3d_tpu_torch.serve import InferenceEngine, TemplateRegistrar
    from learning3d_tpu_torch.utils.jax_import import load_quant_pointnet
    from learning3d_tpu_torch.train import Trainer
    from learning3d_tpu_torch.utils.curvenet_blocks import (
        CIC, LPFA, AttentionBlock, CurveAggregation, CurveGrouping, PointNetFeaturePropagation, Walk,
    )
    from learning3d_tpu_torch.utils.layers import MLP1d, BatchNorm, Dropout, GroupNorm, Linear
    from learning3d_tpu_torch.utils.transformer import (
        AnnotatedLayerNorm, FeedForward, MultiHeadedAttention, Transformer,
    )

    assert DEFAULT_DEVICE == "cuda"
    for entry in (PointNet, Classifier, DGCNN, DCP, Transformer, MultiHeadedAttention, FeedForward,
                  AnnotatedLayerNorm, InferenceEngine, MLP1d, BatchNorm, Linear, resolve_device,
                  load_quant_pointnet, Trainer, Dropout, iPCRNet, PCN, PRNet, PRDGCNN, PRPointNet, PRSVDHead,
                  TemperatureNet, MLPHead, TemplateRegistrar, PPFNet, RPMNet, ParameterPredictionNet, GroupNorm,
                  PointNetLK, MaskNet, PointNetMask, Segmentation, PointConvDensityClsSsg, DensityNet, WeightNet,
                  PointConvDensitySetAbstraction, CurveNet, CIC, LPFA, AttentionBlock, CurveAggregation, CurveGrouping,
                  PointNetFeaturePropagation, Walk, DeepGMR, ClusterNet, Conv1dBNReLU, TNet, MaskNet2, AttnPointNet,
                  BasicConv1D, PointNetMask2, SelfAttentionFC, SelfAttn):
        assert inspect.signature(entry).parameters["device"].default == "cuda", entry


def test_training_subpackages_are_covered():
    """The training slices' subpackages (train, data, losses) and kernel
    modules are among the modules the checks above import and read."""
    import pkgutil

    import learning3d_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(learning3d_tpu_torch.__path__, "learning3d_tpu_torch.")}
    for sub in ("train", "train.trainer", "train.tasks", "train.config", "train.metrics", "data", "data.dataloaders",
                "data.device_pipeline", "losses", "losses.losses", "kernels.poolgrad", "kernels.edgeconv",
                "kernels.chamfer", "kernels.emd", "kernels.knn", "models.pcrnet", "models.pcn", "models.prnet",
                "ops.quaternion", "ops.geometry", "ops.grouping", "kernels.sampling", "kernels.sinkhorn",
                "models.ppfnet", "models.rpmnet", "utils.rigid", "ops.sinc", "ops.so3", "ops.se3", "ops.invmat",
                "ops.mean_shift", "models.pointnetlk", "models.masknet", "models.segmentation", "models.pointconv",
                "models.curvenet", "utils.curvenet_blocks", "models.deepgmr", "models.masknet2"):
        assert f"learning3d_tpu_torch.{sub}" in names
    files = {p.relative_to(PORT).as_posix() for p in port_files(".py", ".cu") if PORT in p.parents}
    for f in ("train/trainer.py", "train/metrics.py", "data/dataloaders.py", "losses/losses.py",
              "kernels/csrc/poolgrad.cu", "kernels/edgeconv.py", "kernels/csrc/dgcnn_select.cu",
              "kernels/chamfer.py", "kernels/csrc/chamfer.cu", "kernels/emd.py", "kernels/csrc/emd.cu",
              "kernels/knn.py", "kernels/csrc/knn.cu", "models/prnet.py", "kernels/csrc/ball_group.cu",
              "kernels/sinkhorn.py", "kernels/csrc/sinkhorn.cu", "models/rpmnet.py", "ops/sinc.py", "ops/so3.py",
              "ops/invmat.py", "ops/mean_shift.py", "models/pointnetlk.py", "models/masknet.py",
              "models/segmentation.py", "models/pointconv.py", "models/curvenet.py", "utils/curvenet_blocks.py",
              "ops/grouping.py", "models/deepgmr.py", "models/masknet2.py"):
        assert f in files


def test_no_silent_cpu_fallback():
    """Asking for the card where there is none raises."""
    import torch

    from learning3d_tpu_torch import resolve_device
    from learning3d_tpu_torch.models import DGCNN, PointNet

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        PointNet(emb_dims=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        DGCNN(emb_dims=64)
    from learning3d_tpu_torch.utils.layers import Dropout

    with pytest.raises(RuntimeError, match="CUDA"):
        Dropout(0.5)


def test_chip_smoke_fails_without_card(tmp_path):
    """Without a card, and in a directory with nothing else of the repo,
    chip_smoke.py exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                              cwd=script.parent, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
