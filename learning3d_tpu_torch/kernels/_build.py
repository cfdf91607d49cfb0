"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and one more ``nvcc`` call links the objects into one shared
library with a plain C interface, loaded with ``ctypes``. No PyTorch headers
are compiled: a source that includes them takes minutes to build, a plain
one seconds, and every fresh checkout builds anew.

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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / ".build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-c")
LINK_FLAGS = (*ARCH, "-shared")

# The C entries: (argtypes, restype). A kernel entry returns the launch's
# cudaGetLastError().
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "pointnet_pooled_bf16": ([_P] * 13 + [_I, _I, _I, _P], ctypes.c_int),
    "pointnet_pack_bf16": ([_P] * 4 + [_I, _P, _P], ctypes.c_int),
    "dgcnn_encode_bf16": ([_P] * 13 + [_I] * 5 + [_P], ctypes.c_int),
    "dgcnn_knn_scale": ([_P] * 2 + [_I] * 3 + [_F, _P], ctypes.c_int),
    "attention_bf16": ([_P] * 4 + [_I] * 6 + [ctypes.c_float, _P], ctypes.c_int),
    "pointnet_pooled_int8": ([_P] * 8 + [_F] * 4 + [_P, _I, _I, _I, _P], ctypes.c_int),
    "pointnet_int8_group": ([_I] * 3, ctypes.c_int),
    "dgcnn_encode_int8": ([_P] * 12 + [_F] * 4 + [_P] * 3 + [_I] * 5 + [_P], ctypes.c_int),
    "dgcnn_quant_xw1": ([_P] * 4 + [ctypes.c_longlong, _P], ctypes.c_int),
    "attention_int8": ([_P] * 4 + [_I] * 5 + [_F, _F, _I, _P], ctypes.c_int),
    "attention_int8_values": ([_P, _P] + [_I] * 5 + [_P], ctypes.c_int),
    "attention_bf16_instance": ([_I, _I], ctypes.c_char_p),
    "layer_ln_quant": ([_P] * 4 + [_I] * 4 + [_F] * 3 + [_P], ctypes.c_int),
    "layer_gemm_s8": ([_P] * 8 + [_I] * 6 + [_P], ctypes.c_int),
    "layer_attention_s8": ([_P] * 5 + [_I] * 9 + [_F] * 3 + [_I, _P], ctypes.c_int),
    "layer_attention_instance": ([_I, _I], ctypes.c_char_p),
    "layer_head_map": ([_I] * 6 + [_P], ctypes.c_int),
    "pool_stats": ([_P] * 3 + [_I] + [_P] * 10 + [_I] * 3 + [_P], ctypes.c_int),
    "pool_stats_pack": ([_P, _I, _I, _P, _P], ctypes.c_int),
    "pool_bwd": ([_P] * 4 + [_I] + [_P] * 2 + [_I] * 3 + [_P], ctypes.c_int),
    "pool_bwd_schedule": ([_I], ctypes.c_int),
    "knn_neighbors": ([_P] * 2 + [_I] * 3 + [_P], ctypes.c_int),
    "nn_oneway": ([_P] * 4 + [_I] * 3 + [_P], ctypes.c_int),
    "emd_fwd": ([_P] * 6 + [_I] * 3 + [_F] * 2 + [_P], ctypes.c_int),
    "knn_select": ([_P] * 4 + [_I] * 5 + [_P], ctypes.c_int),
    "fps_default_threads": ([_I], ctypes.c_int),
    "fps_scratch_needed": ([_I], ctypes.c_int),
    "fps_sample": ([_P] * 4 + [_I] * 3 + [_P], ctypes.c_int),
    "fps_chain_floor": ([_P] + [_I] * 3 + [_P], ctypes.c_int),
    "ball_query": ([_P] * 3 + [_I] * 5 + [_F, _P], ctypes.c_int),
    "ball_query_rounds": ([], ctypes.c_int),
    "ball_group": ([_P] * 5 + [_I] * 5 + [_F, _P], ctypes.c_int),
    "ball_group_chunk": ([_I, _I], ctypes.c_int),
    "ball_group_queries": ([_I] * 3, ctypes.c_int),
    "sinkhorn_slack": ([_P] * 5 + [_I] * 5 + [_P], ctypes.c_int),
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
    """A hash of the flags and of every source and header."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted([*sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(build_root: Path = BUILD_ROOT) -> Path:
    """Compile every source into ``<build_root>/<hash>/libl3d_kernels.so``
    unless it is there already; return its path. One nvcc process a source,
    all running at once, then one link. The compilers' output, ptxas's
    register report included, goes to ``build.log`` beside it."""
    out_dir = build_root / source_hash()
    lib = out_dir / "libl3d_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = find_nvcc(), os.getpid()
    jobs = []
    for src in sources():
        obj = out_dir / f"{src.stem}.{pid}.o"  # nvcc tells inputs apart by their suffix
        cmd = [nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        log.append(" ".join(cmd) + "\n" + proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(cmd[-1])
    if not failed:
        tmp = out_dir / f"libl3d_kernels.{pid}.so"
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append("link")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n" + "\n".join(log))
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


def launch(name: str, device, *args) -> None:
    """Call C entry ``name`` with ``args`` and the current stream of
    ``device`` (a CUDA device with its index) on that device, and raise on a
    CUDA error. Every kernel wrapper launches through here. The stream's
    handle comes from PyTorch's raw getter (a few tenths of a microsecond on
    the host, where ``torch.cuda.current_stream`` builds a Stream object in
    several), and the device is entered only where it is not the current
    one already (entering costs the host more than the launch)."""
    fn = getattr(library(), name)
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    check(err, name)


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        msg = library().l3d_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
