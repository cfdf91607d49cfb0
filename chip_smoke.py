#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (learning3d_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the port's main path, bf16 eval serving of the PointNet-1024
classifier, at full width, and holds every CUDA kernel of that path against
its plain PyTorch version. Phases, one JSON line each with the seconds
since start:

1. device: the card, and its name and power limit from nvidia-smi;
2. build: every kernel compiled from the checkout's sources by one nvcc
   call into a fresh build directory (seconds, ptxas register report);
3. kernel: K1 against its plain version at B=256, N=1024, emb=1024 and on a
   ragged B=3, N=1000 cloud; times of the kernel, the plain version, the
   eager bf16 cuBLAS chain (the yardstick, as ``library_ms``) and the bound;
4. serve: Classifier(PointNet(1024, use_bn=True)) in bf16 eval with
   numpy-seeded weights loaded through load_nnx_state, served through
   InferenceEngine(batch_size=256) on requests of 256, 100 and 600 clouds;
   K1's launch count must equal the number of chunks, every logit must be
   finite, and the argmax must agree with the same model on the plain chain
   for >= 99% of clouds;

then the ``kernels`` line and, last, ``{"ok": true, "device": ...}``. Any
failed check raises, so the script exits non-zero and prints no result. It
needs a CUDA card and the repository's checkout around it; it reads no
release checkpoint and writes only into the kernels' build directory.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

T0 = time.perf_counter()
SEED = 0
B, N, EMB, CLASSES = 256, 1024, 1024, 40
REQUESTS = (256, 100, 600)
TOL = 2e-2  # max |kernel - plain| <= TOL * max |plain|: same bf16 operands, other sum order
AGREE = 0.99
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - T0, 3), **fields}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def random_nnx_state(rng, emb: int, num_classes: int) -> dict:
    """A flat nnx state of Classifier(PointNet(emb, use_bn=True)) with
    numpy-seeded weights and non-trivial BatchNorm statistics."""
    flat = {}

    def linear(prefix, i, o):
        flat[f"{prefix}.kernel"] = rng.normal(0.0, i**-0.5, (i, o)).astype(np.float32)
        flat[f"{prefix}.bias"] = rng.normal(0.0, 0.1, (o,)).astype(np.float32)

    def bn(prefix, c):
        flat[f"{prefix}.scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        flat[f"{prefix}.bias"] = rng.normal(0.0, 0.1, c).astype(np.float32)
        flat[f"{prefix}.mean"] = rng.normal(0.0, 0.2, c).astype(np.float32)
        flat[f"{prefix}.var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)

    dims = [3, 64, 64, 64, 128, emb]
    for k, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
        linear(f"feature_model.convs.{k}", i, o)
        bn(f"feature_model.bns.{k}", o)
    linear("linear1", emb, 512)
    bn("bn1", 512)
    linear("linear2", 512, 256)
    bn("bn2", 256)
    linear("linear3", 256, num_classes)
    return flat


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` single-call times from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def library_chain(x, ws, bs):
    """Yardstick only, never used by the port: the unfused eager chain of
    bf16 torch.matmul (cuBLAS) calls, bias, ReLU and max over points."""
    h = x.to(torch.bfloat16)
    for w, b in zip(ws[:-1], bs[:-1]):
        h = torch.relu(torch.matmul(h, w.to(torch.bfloat16)) + b.to(torch.bfloat16))
    z = torch.matmul(h, ws[-1].to(torch.bfloat16)) + bs[-1].to(torch.bfloat16)
    return torch.relu(torch.amax(z, dim=-2))


def k1_bound(batch: int, n_pts: int, ws, bs) -> tuple[float, str]:
    """Least time (ms) for K1's work and what sets it: the larger of its
    operations over the bf16 peak and its bytes (x read once, weights and
    biases read once as f32, output written once as bf16) over the memory
    rate."""
    macs = sum(w.shape[0] * w.shape[1] for w in ws)
    ops_s = 2.0 * batch * n_pts * macs / PEAK_BF16_FLOPS
    nbytes = 4 * batch * n_pts * 3 + 4 * (macs + sum(b.numel() for b in bs)) + 2 * batch * ws[-1].shape[1]
    bytes_s = nbytes / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, torch_name=kind, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())
    return kind


def phase_build() -> None:
    from learning3d_tpu_torch.kernels import _build

    shutil.rmtree(_build.BUILD_ROOT / _build.source_hash(), ignore_errors=True)
    t0 = time.perf_counter()
    lib = _build.build()
    seconds = time.perf_counter() - t0
    _build.library()
    log = (lib.parent / "build.log").read_text().splitlines()
    ptxas = [line.strip() for line in log if "registers" in line or "spill" in line]
    emit("build", seconds=round(seconds, 3), sources=[p.name for p in _build.sources()], ptxas=ptxas)


def folded_chain(model):
    """The BN-folded (weights, biases) of the model's PointNet chain."""
    from learning3d_tpu_torch.kernels.pointnet_fused import fold_conv_bn

    pn = model.feature_model
    with torch.inference_mode():
        folded = [fold_conv_bn(c, bn) for c, bn in zip(pn.convs, pn.bns)]
    return [w for w, _ in folded], [b for _, b in folded]


def phase_kernel(model, rng) -> dict:
    from learning3d_tpu_torch.kernels.pointnet_fused import oracle_chain, pointnet_pooled_kernel

    ws, bs = folded_chain(model)
    errs = {}
    for name, shape in (("full", (B, N, 3)), ("ragged", (3, 1000, 3))):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
        with torch.inference_mode():
            got = pointnet_pooled_kernel(x, ws, bs).float()
            want = oracle_chain(x, ws, bs).float()
        torch.cuda.synchronize()
        require(got.shape == want.shape == (shape[0], EMB), f"K1 output shape {name}")
        abs_err = (got - want).abs().max().item()
        rel_err = abs_err / want.abs().max().item()
        require(bool(torch.isfinite(got).all()), f"K1 output finite ({name})")
        require(rel_err <= TOL, f"K1 vs plain ({name}): rel err {rel_err} > {TOL}")
        errs[name] = (abs_err, rel_err)
        if name == "full":
            x_full = x
    with torch.inference_mode():
        k_ms = cuda_ms(lambda: pointnet_pooled_kernel(x_full, ws, bs))
        p_ms = cuda_ms(lambda: oracle_chain(x_full, ws, bs))
        l_ms = cuda_ms(lambda: library_chain(x_full, ws, bs))
    bound, bound_by = k1_bound(B, N, ws, bs)
    result = {
        "max_abs_err": max(a for a, _ in errs.values()),
        "max_rel_err": max(r for _, r in errs.values()),
        "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
        "bound_ms": bound, "bound_by": bound_by,
    }
    emit("kernel", name="pointnet_pooled_kernel", tolerance=f"max|k-p| <= {TOL}*max|p|",
         errors={k: {"abs": a, "rel": r} for k, (a, r) in errs.items()},
         library="eager bf16 torch.matmul chain (cuBLAS), yardstick only", **result)
    return result


def phase_serve(model, rng) -> int:
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.kernels.pointnet_fused import oracle_chain
    from learning3d_tpu_torch.serve import InferenceEngine

    engine = InferenceEngine(model, batch_size=B)
    requests = [rng.normal(size=(n, N, 3)).astype(np.float32) for n in REQUESTS]
    chunks = sum(-(-n // B) for n in REQUESTS)
    reset_launches()
    outs = [engine(x) for x in requests]
    torch.cuda.synchronize()
    launches = LAUNCHES["pointnet_pooled_kernel"]
    require(launches == chunks, f"K1 launched {launches} times for {chunks} chunks")
    for x, out in zip(requests, outs):
        require(out.shape == (x.shape[0], CLASSES), f"logits shape {out.shape}")
        require(bool(np.isfinite(out).all()), "every logit finite")

    ws, bs = folded_chain(model)
    agree = total = 0
    with torch.inference_mode():
        for x, out in zip(requests, outs):
            plain = model.head(oracle_chain(torch.from_numpy(x).cuda(), ws, bs)).float().cpu().numpy()
            agree += int((plain.argmax(-1) == out.argmax(-1)).sum())
            total += x.shape[0]
    require(agree / total >= AGREE, f"argmax agreement {agree}/{total} < {AGREE}")

    x256 = requests[0]
    engine(x256)
    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine(x256)
    host_s = (time.perf_counter() - t0) / reps
    x_dev = torch.from_numpy(x256).cuda()
    with torch.inference_mode():
        model_ms = cuda_ms(lambda: model(x_dev))
    emit("serve", requests=list(REQUESTS), chunks=chunks, launches=launches,
         argmax_agree=agree / total, clouds_per_s=B / host_s, engine_ms=1e3 * host_s,
         model_ms=model_ms, model_clouds_per_s=B / (model_ms * 1e-3))
    return launches


def main() -> None:
    # No card, or no checkout around the script, fails here before
    # anything is printed.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from learning3d_tpu_torch.models import Classifier, PointNet
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version sums in full f32
    torch.backends.cudnn.allow_tf32 = False
    kind = phase_device()
    phase_build()

    rng = np.random.default_rng(SEED)
    bf16 = torch.bfloat16
    model = Classifier(PointNet(emb_dims=EMB, use_bn=True, dtype=bf16), CLASSES, dtype=bf16)
    load_nnx_state(model, random_nnx_state(rng, EMB, CLASSES))
    model.eval()
    k1 = phase_kernel(model, rng)
    launches = phase_serve(model, rng)

    print(json.dumps({"kernels": [{
        "name": "pointnet_pooled_kernel",
        "route": "cuda",
        "source": "learning3d_tpu_torch/kernels/csrc/pointnet_fused.cu",
        "replaces": "learning3d_tpu/kernels/pointnet_fused.py:205",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "max_rel_err": k1["max_rel_err"],
        "ms": k1["kernel_ms"],
        "kernel_ms": k1["kernel_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
