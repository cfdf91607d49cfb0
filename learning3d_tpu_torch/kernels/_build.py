"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ONE ``nvcc`` call into one shared library
with a plain C interface, loaded with ``ctypes``. No PyTorch headers are
compiled: a source that includes them takes minutes to build, a plain one
seconds, and every fresh checkout builds anew.

The library goes to ``.build/<hash of the sources and flags>/`` beside this
file (listed in ``.gitignore``), at first use, so importing a kernel module
never builds or needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / ".build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# The C entries: (argtypes, restype). A kernel entry returns the launch's
# cudaGetLastError().
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "pointnet_pooled_bf16": ([_P] * 12 + [_I, _I, _I, _P], ctypes.c_int),
    "l3d_error_string": ([_I], ctypes.c_char_p),
}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found in $CUDA_HOME/bin, /usr/local/cuda/bin or PATH")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(build_root: Path = BUILD_ROOT) -> Path:
    """Compile every source into ``<build_root>/<hash>/libl3d_kernels.so``
    unless it is there already; return its path. The compiler's output,
    ptxas's register report included, goes to ``build.log`` beside it."""
    out_dir = build_root / source_hash()
    lib = out_dir / "libl3d_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libl3d_kernels.so.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        msg = library().l3d_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
