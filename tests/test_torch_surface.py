"""The port's public surface against the JAX package's: every name that one
of the JAX package's seven ``__init__`` files exports (the root's also
names its subpackages) is importable from the same place in the port, or
stands on NOT_YET_PORTED with the ROADMAP Queue 1 item that brings it. A
name on the map that resolves fails too, so the map shrinks as the port
grows. The files are read as text (``ast``): no JAX is imported here."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "learning3d_tpu"
PACKAGES = ("", "data", "losses", "models", "ops", "train", "utils")

# (package, name) -> the ROADMAP Queue 1 item that ports it
NOT_YET_PORTED = {
    ("", "parallel"): "Queue 1 item 7 (parallel/ -> torch.distributed)",
    ("data", "UserData"): "Queue 1 item 4 (host data)",
    ("data", "make_registration_batch"): "Queue 1 item 2 (device_pipeline.make_registration_batch)",
    ("losses", "correspondence_loss"): "Queue 1 item 2 (losses.correspondence_loss)",
    ("losses", "CorrespondenceLoss"): "Queue 1 item 2 (losses.correspondence_loss)",
    **{("utils", name): "Queue 1 item 3 (utils/pointnet2_modules.py)" for name in (
        "SharedMLP", "QueryAndGroup", "GroupAll", "PointnetSAModuleMSG", "PointnetSAModule", "PointnetFPModule")},
    ("utils", "import_torch_state_dict"): "Queue 1 item 5 (utils/torch_import.py)",
    ("utils", "load_torch_checkpoint"): "Queue 1 item 5 (utils/torch_import.py)",
}


def exported(package: str) -> list[str]:
    """The names a JAX ``__init__`` file binds: its imports and its
    top-level assignments (not ``__all__``); for the root also the
    subpackages (directories with an ``__init__.py``)."""
    path = JAX_PKG / package / "__init__.py"
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Import):
            names += [(a.asname or a.name).rsplit(".", 1)[-1] for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name) and t.id != "__all__"]
    if not package:
        names += [d.name for d in JAX_PKG.iterdir() if (d / "__init__.py").is_file()]
    return sorted(set(names))


def port_module(package: str) -> str:
    return "learning3d_tpu_torch" + (f".{package}" if package else "")


def resolves(package: str, name: str) -> bool:
    """``from <port package> import <name>`` works: an attribute, or a
    submodule."""
    mod = importlib.import_module(port_module(package))
    if hasattr(mod, name):
        return True
    try:
        importlib.import_module(f"{mod.__name__}.{name}")
    except ModuleNotFoundError:
        return False
    return True


CASES = [(p, n) for p in PACKAGES for n in exported(p)]


def test_every_package_exports_something():
    """The seven files are read and name what the ROADMAP counted (the
    root's eight subpackages among them)."""
    counts = {p or "root": len(exported(p)) for p in PACKAGES}
    assert all(counts.values()), counts
    assert {"data", "kernels", "losses", "models", "ops", "parallel", "train", "utils"} <= set(exported(""))
    assert set(NOT_YET_PORTED) <= set(CASES)


@pytest.mark.parametrize("package", PACKAGES, ids=lambda p: p or "root")
def test_jax_exports_resolve_in_the_port(package):
    missing = [n for n in exported(package) if (package, n) not in NOT_YET_PORTED and not resolves(package, n)]
    assert not missing, f"{port_module(package)} lacks {missing}"


@pytest.mark.parametrize("package", PACKAGES, ids=lambda p: p or "root")
def test_not_yet_ported_names_are_absent(package):
    """A name on the map that the port now has must leave the map."""
    listed = [n for (p, n) in NOT_YET_PORTED if p == package]
    assert not [n for n in listed if resolves(package, n)]


def test_named_examples():
    from learning3d_tpu_torch.losses import FrobeniusNormLoss, RMSEFeaturesLoss, frobenius_norm_loss
    from learning3d_tpu_torch.models import MLPHead
    from learning3d_tpu_torch.models.dcp import MLPHead as MLPHead_
    from learning3d_tpu_torch.utils import MLP1d, MLP2d, SVDHead
    from learning3d_tpu_torch.utils.svd import SVDHead as SVDHead_

    assert FrobeniusNormLoss is frobenius_norm_loss and RMSEFeaturesLoss.__name__ == "rmse_features_loss"
    assert SVDHead is SVDHead_ and MLPHead is MLPHead_ and MLP2d is MLP1d


def test_importing_ops_loads_no_kernel_library():
    """The exports keep the kernels lazy: importing ``ops``, ``utils`` and
    ``models`` neither builds nor loads the kernel library."""
    code = "\n".join([
        f"import sys; sys.path.insert(0, {str(ROOT)!r})",
        "import learning3d_tpu_torch.ops, learning3d_tpu_torch.utils, learning3d_tpu_torch.models",
        "from learning3d_tpu_torch.kernels import _build",
        "assert _build.library.cache_info().currsize == 0",
        "assert not any(name.endswith('libl3d_kernels.so') for name in open('/proc/self/maps').read().split())",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
