#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (learning3d_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the port's two main paths at full width, bf16 eval serving of the
PointNet-1024 classifier and of DCP registration (DGCNN-512, the
co-attention pointer and the SVD head), and holds every CUDA kernel of
those paths against its plain PyTorch version. Phases, one JSON line each
with the seconds since start:

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
5. kernel (K5, dgcnn_encode_fused): against its plain version at B=32,
   N=1024, k=20, emb=512, on a ragged B=3, N=1000 cloud and on a lattice
   cloud whose 20th neighbors are decided by exact distance ties; times of
   the kernel, the plain version, an eager chain of cuBLAS bf16 matmuls,
   torch.topk and a gather (``library_ms``), and the bound;
6. kernel (K6, attention_pallas): against its plain version at the
   pointer's shape (B=32, H=4, N=M=1024, D=Dv=128), the head's (H=1,
   D=512, Dv=3) and a ragged N=M=1000; times, with
   scaled_dot_product_attention as ``library_ms``;
7. serve_dcp: DCP(DGCNN(512, k=20)) in bf16 eval with numpy-seeded weights
   loaded through load_nnx_state, served through
   InferenceEngine(batch_size=32) on 32, 10 and 70 (template, source)
   pairs (5 chunks); K5 must launch 2 and K6 7 times a chunk, every output
   must be finite, every est_R a rotation, and r and est_t must agree with
   the same model run on the plain versions;

then the ``kernels`` line and, last, ``{"ok": true, "device": ...}``. Any
failed check raises, so the script exits non-zero and prints no result. It
needs a CUDA card and the repository's checkout around it; it reads no
release checkpoint and writes only into the kernels' build directory.
"""

from __future__ import annotations

import contextlib
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
DCP_B, DCP_N, DCP_EMB, DCP_K = 32, 1024, 512, 20
DCP_REQUESTS = (32, 10, 70)
# r and est_t of the kernel path against the plain path, max |k - p| <=
# DCP_TOL * max |p|: an f32 sum in another order can round an activation
# to the neighbouring bf16 value (2^-8 of it), and the encoder, the pointer
# and the head carry such steps on; a kernel that computed something else
# would be off by the order of the values themselves.
DCP_TOL = 5e-2
ROT_TOL = 1e-3  # max |R R^T - I| and |det R - 1| of every est_R
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - T0, 3), **fields}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def check_close(got, want, what: str, tol: float = TOL) -> tuple[float, float]:
    """(max abs error, that over max |want|); raises past ``tol``."""
    got, want = got.float(), want.float()
    require(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{what}: output finite")
    abs_err = (got - want).abs().max().item()
    rel_err = abs_err / max(want.abs().max().item(), 1e-30)
    require(rel_err <= tol, f"{what}: rel err {rel_err} > {tol}")
    return abs_err, rel_err


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) and what sets it: operations over the bf16 peak or
    bytes over the memory rate."""
    ops_s, bytes_s = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


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


def cuda_ms(fn, reps: int = 20, warmup: int = 3, runs: int = 3) -> float:
    """Time of one call: CUDA events around ``reps`` back-to-back calls,
    divided by ``reps``; the median of ``runs`` such runs, after warm-up.
    Back to back, the host enqueues the next call while the card runs this
    one, so a call's host overhead shows only where it exceeds its device
    time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
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
    """K1's bound: its operations, and its bytes (x read once, weights and
    biases read once as f32, output written once as bf16)."""
    macs = sum(w.shape[0] * w.shape[1] for w in ws)
    nbytes = 4 * batch * n_pts * 3 + 4 * (macs + sum(b.numel() for b in bs)) + 2 * batch * ws[-1].shape[1]
    return bound(2.0 * batch * n_pts * macs, nbytes)


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
            got = pointnet_pooled_kernel(x, ws, bs)
            want = oracle_chain(x, ws, bs)
        torch.cuda.synchronize()
        require(got.shape == (shape[0], EMB), f"K1 output shape {name}")
        errs[name] = check_close(got, want, f"K1 vs plain ({name})")
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


def random_dcp_state(rng, emb: int, ff: int = 1024) -> dict:
    """A flat nnx state of DCP(DGCNN(emb)) with the transformer pointer, with
    numpy-seeded weights and non-trivial BatchNorm statistics."""
    flat = {}

    def linear(prefix, i, o, bias=True):
        flat[f"{prefix}.kernel"] = rng.normal(0.0, i**-0.5, (i, o)).astype(np.float32)
        if bias:
            flat[f"{prefix}.bias"] = rng.normal(0.0, 0.1, (o,)).astype(np.float32)

    def bn(prefix, c):
        flat[f"{prefix}.scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        flat[f"{prefix}.bias"] = rng.normal(0.0, 0.1, c).astype(np.float32)
        flat[f"{prefix}.mean"] = rng.normal(0.0, 0.2, c).astype(np.float32)
        flat[f"{prefix}.var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)

    def norm(prefix, c):
        flat[f"{prefix}.a"] = rng.normal(1.0, 0.1, c).astype(np.float32)
        flat[f"{prefix}.b"] = rng.normal(0.0, 0.1, c).astype(np.float32)

    def attn(prefix):
        for w in ("wq", "wk", "wv", "wo"):
            linear(f"{prefix}.{w}", emb, emb)

    for k, (i, o) in enumerate([(6, 64), (64, 64), (64, 128), (128, 256), (512, emb)]):
        linear(f"emb_nn.convs.{k}", i, o, bias=False)
        bn(f"emb_nn.bns.{k}", o)
    enc, dec = "pointer.enc_layers.0", "pointer.dec_layers.0"
    attn(f"{enc}.self_attn")
    attn(f"{dec}.self_attn")
    attn(f"{dec}.cross_attn")
    for layer in (enc, dec):
        linear(f"{layer}.ff.w1", emb, ff)
        linear(f"{layer}.ff.w2", ff, emb)
    for name in (f"{enc}.norm1", f"{enc}.norm2", f"{dec}.norm1", f"{dec}.norm2", f"{dec}.norm3",
                 "pointer.enc_norm", "pointer.dec_norm"):
        norm(name, emb)
    return flat
def lattice_cloud(rng, batch: int, n_pts: int) -> np.ndarray:
    """Points of a 10 x 10 x 10 integer lattice scaled by 0.25 (every
    coordinate and squared distance exact in f32) in a random order. An
    inner point has 1 + 6 + 12 neighbors within distance^2 2/16 and 8 at
    3/16, so exact ties decide its 20th neighbor."""
    grid = np.stack(np.meshgrid(*[np.arange(10)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return np.stack([0.25 * grid[rng.permutation(len(grid))[:n_pts]] for _ in range(batch)]).astype(np.float32)


def library_dgcnn(x, ws, bs, k):
    """Yardstick only, never used by the port: the eager encoder as cuBLAS
    bf16 matmuls, torch.topk over matmul-expanded distances and a gather."""
    bf = torch.bfloat16
    sq = (x * x).sum(-1)
    d = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(x, x.transpose(1, 2))
    idx = torch.topk(d, k, dim=-1, largest=False).indices
    xb = x.to(bf)
    xw1, c1 = xb @ ws[0][:3].to(bf), xb @ ws[0][3:].to(bf) + bs[0].to(bf)
    B, N, C = xw1.shape
    nbr = torch.gather(xw1, 1, idx.reshape(B, -1, 1).expand(-1, -1, C)).reshape(B, N, k, C)
    e = torch.relu(nbr + c1[:, :, None])
    pooled = [e.amax(2)]
    for w, b in zip(ws[1:4], bs[1:4]):
        e = torch.relu(e @ w.to(bf) + b.to(bf))
        pooled.append(e.amax(2))
    return torch.relu(torch.cat(pooled, -1) @ ws[4].to(bf) + bs[4].to(bf))


def folded_dgcnn(model):
    """The BN-folded (weights, biases) of the model's DGCNN encoder."""
    from learning3d_tpu_torch.kernels.dgcnn_fused import fold_bn

    enc = model.emb_nn
    with torch.inference_mode():
        folded = [fold_bn(c, bn) for c, bn in zip(enc.convs, enc.bns)]
    return [w for w, _ in folded], [b for _, b in folded]


def phase_kernel_k5(model, rng) -> dict:
    from learning3d_tpu_torch.kernels.dgcnn_fused import dgcnn_encode_kernel, dgcnn_encode_reference

    ws, bs = folded_dgcnn(model)
    cases = {
        "full": rng.normal(size=(DCP_B, DCP_N, 3)).astype(np.float32),
        "ragged": rng.normal(size=(3, 1000, 3)).astype(np.float32),
        "ties": lattice_cloud(rng, 2, 1000),
    }
    errs = {}
    with torch.inference_mode():
        for name, x_np in cases.items():
            x = torch.from_numpy(x_np).cuda()
            got = dgcnn_encode_kernel(x, ws, bs, DCP_K)
            want = dgcnn_encode_reference(x, ws, bs, DCP_K)
            torch.cuda.synchronize()
            errs[name] = check_close(got, want, f"K5 vs plain ({name})")
        x = torch.from_numpy(cases["full"]).cuda()
        k_ms = cuda_ms(lambda: dgcnn_encode_kernel(x, ws, bs, DCP_K))
        p_ms = cuda_ms(lambda: dgcnn_encode_reference(x, ws, bs, DCP_K), reps=3, warmup=1)
        l_ms = cuda_ms(lambda: library_dgcnn(x, ws, bs, DCP_K))
    macs = DCP_K * (64 * 64 + 64 * 128 + 128 * 256) + 512 * DCP_EMB + 2 * 3 * 64  # a point
    nbytes = 4 * DCP_B * DCP_N * 3 + 4 * sum(w.numel() + b.numel() for w, b in zip(ws, bs)) \
        + 2 * DCP_B * DCP_N * DCP_EMB
    bound_ms, bound_by = bound(2.0 * DCP_B * DCP_N * macs, nbytes)
    result = {
        "max_abs_err": max(a for a, _ in errs.values()),
        "max_rel_err": max(r for _, r in errs.values()),
        "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit("kernel", name="dgcnn_encode_fused", tolerance=f"max|k-p| <= {TOL}*max|p|",
         shape={"B": DCP_B, "N": DCP_N, "k": DCP_K, "emb": DCP_EMB},
         errors={k: {"abs": a, "rel": r} for k, (a, r) in errs.items()},
         library="eager cuBLAS bf16 matmuls + torch.topk + gather, yardstick only", **result)
    return result


def attention_bound(q, k, v) -> tuple[float, str]:
    B, H, N, D = q.shape
    M, Dv = v.shape[2], v.shape[3]
    flops = 2.0 * B * H * N * M * (D + Dv)
    nbytes = 2 * B * H * (N * D + M * D + M * Dv + N * Dv)
    return bound(flops, nbytes)


def phase_kernel_k6(rng) -> dict:
    from learning3d_tpu_torch.kernels.attention import attention_pallas, attention_reference

    def qkv(b, h, n, m, d, dv):
        return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(torch.bfloat16)
                for shape in ((b, h, n, d), (b, h, m, d), (b, h, m, dv))]

    cases = {
        "pointer": qkv(DCP_B, 4, DCP_N, DCP_N, 128, 128),
        "head": qkv(DCP_B, 1, DCP_N, DCP_N, DCP_EMB, 3),
        "ragged": qkv(4, 4, 1000, 1000, 128, 128),
    }
    errs, times = {}, {}
    with torch.inference_mode():
        for name, (q, k, v) in cases.items():
            got = attention_pallas(q, k, v)
            want = attention_reference(q, k, v)
            torch.cuda.synchronize()
            errs[name] = check_close(got, want, f"K6 vs plain ({name})")
        for name in ("pointer", "head"):
            q, k, v = cases[name]
            times[name] = {
                "kernel_ms": cuda_ms(lambda: attention_pallas(q, k, v)),
                "plain_ms": cuda_ms(lambda: attention_reference(q, k, v), reps=3, warmup=1),
                "bound_ms": attention_bound(q, k, v)[0],
            }
        q, k, v = cases["pointer"]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        l_ms = cuda_ms(lambda: sdpa(q, k, v))
    bound_ms, bound_by = attention_bound(*cases["pointer"])
    result = {
        "max_abs_err": max(a for a, _ in errs.values()),
        "max_rel_err": max(r for _, r in errs.values()),
        "kernel_ms": times["pointer"]["kernel_ms"], "plain_ms": times["pointer"]["plain_ms"],
        "library_ms": l_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit("kernel", name="attention_pallas", tolerance=f"max|k-p| <= {TOL}*max|p|",
         shapes={"pointer": [DCP_B, 4, DCP_N, DCP_N, 128, 128], "head": [DCP_B, 1, DCP_N, DCP_N, DCP_EMB, 3]},
         errors={k: {"abs": a, "rel": r} for k, (a, r) in errs.items()}, times=times,
         library="torch scaled_dot_product_attention at the pointer's shape, yardstick only", **result)
    return result


@contextlib.contextmanager
def plain_versions():
    """Route the DCP modules' kernel entries to the kernels' plain versions
    (on the same card) for the reference run; restored on exit."""
    from learning3d_tpu_torch.kernels import attention, dgcnn_fused
    from learning3d_tpu_torch.models import dgcnn
    from learning3d_tpu_torch.utils import svd, transformer

    def encoder(x, convs, bns, k):
        folded = [dgcnn_fused.fold_bn(c, bn) for c, bn in zip(convs, bns)]
        return dgcnn_fused.dgcnn_encode_reference(x.float(), [w for w, _ in folded], [b for _, b in folded], k)

    patches = [(dgcnn, "dgcnn_encode_fused", encoder), (transformer, "attention_fused", attention.attention_reference),
               (svd, "attention_fused", attention.attention_reference)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_serve_dcp(model, rng) -> dict:
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.serve import InferenceEngine

    engine = InferenceEngine(model, batch_size=DCP_B)
    requests = [(rng.normal(size=(n, DCP_N, 3)).astype(np.float32), rng.normal(size=(n, DCP_N, 3)).astype(np.float32))
                for n in DCP_REQUESTS]
    chunks = sum(-(-n // DCP_B) for n in DCP_REQUESTS)
    reset_launches()
    outs = [engine(t, s) for t, s in requests]
    torch.cuda.synchronize()
    launches = {name: LAUNCHES[name] for name in ("dgcnn_encode_fused", "attention_pallas")}
    require(launches["dgcnn_encode_fused"] == 2 * chunks,
            f"K5 launched {launches['dgcnn_encode_fused']} times for {chunks} chunks (want 2 a chunk)")
    require(launches["attention_pallas"] == 7 * chunks,
            f"K6 launched {launches['attention_pallas']} times for {chunks} chunks (want 7 a chunk)")
    rot_err = det_err = 0.0
    for (t, _), out in zip(requests, outs):
        n = t.shape[0]
        require(out["est_R"].shape == (n, 3, 3) and out["r"].shape == (n, DCP_N, DCP_EMB), "result shapes")
        for key, val in out.items():
            require(bool(np.isfinite(val).all()), f"every {key} finite")
        R = out["est_R"].astype(np.float64)
        rot_err = max(rot_err, float(np.abs(R @ np.swapaxes(R, -1, -2) - np.eye(3)).max()))
        det_err = max(det_err, float(np.abs(np.linalg.det(R) - 1.0).max()))
    require(rot_err <= ROT_TOL and det_err <= ROT_TOL, f"est_R not a rotation: {rot_err}, {det_err}")

    with plain_versions():
        plain = [engine(t, s) for t, s in requests]
    agree, angles = {}, []
    for key in ("r", "est_t"):
        got = torch.from_numpy(np.concatenate([o[key] for o in outs]))
        want = torch.from_numpy(np.concatenate([p[key] for p in plain]))
        agree[key] = check_close(got, want, f"DCP {key}, kernels vs plain", DCP_TOL)
    for out, ref in zip(outs, plain):
        # the angle of R_k^T R_p from the chord |R_k - R_p|_F = 2 sqrt(2) sin(angle / 2)
        chord = np.linalg.norm((out["est_R"] - ref["est_R"]).astype(np.float64), axis=(-2, -1))
        angles.extend(np.degrees(2.0 * np.arcsin(np.clip(chord / (2.0 * np.sqrt(2.0)), 0.0, 1.0))).tolist())

    template, source = requests[0]
    engine(template, source)
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine(template, source)
    host_s = (time.perf_counter() - t0) / reps
    t_dev, s_dev = torch.from_numpy(template).cuda(), torch.from_numpy(source).cuda()
    with torch.inference_mode():
        model_ms = cuda_ms(lambda: model(t_dev, s_dev), reps=5)
        with plain_versions():
            plain_model_ms = cuda_ms(lambda: model(t_dev, s_dev), reps=2, warmup=1)
    emit("serve_dcp", requests=list(DCP_REQUESTS), chunks=chunks, launches=launches,
         tolerance=f"max|k-p| <= {DCP_TOL}*max|p| for r and est_t",
         agree={k: {"abs": a, "rel": r} for k, (a, r) in agree.items()},
         rotation={"max_RRt_minus_I": rot_err, "max_det_minus_1": det_err},
         angle_vs_plain_deg={"median": float(np.median(angles)), "max": float(np.max(angles))},
         pairs_per_s=DCP_B / host_s, engine_ms=1e3 * host_s, model_ms=model_ms,
         plain_model_ms=plain_model_ms, model_pairs_per_s=DCP_B / (model_ms * 1e-3))
    return launches


def kernel_entry(name, source, replaces, launches, res) -> dict:
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
        "max_abs_err": res["max_abs_err"], "max_rel_err": res["max_rel_err"],
        "ms": res["kernel_ms"], "kernel_ms": res["kernel_ms"], "plain_ms": res["plain_ms"],
        "bound_ms": res["bound_ms"], "bound_by": res["bound_by"], "library_ms": res["library_ms"],
    }


def main() -> None:
    # No card, or no checkout around the script, fails here before
    # anything is printed.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from learning3d_tpu_torch.models import DCP, DGCNN, Classifier, PointNet
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
    del model

    dcp = DCP(DGCNN(emb_dims=DCP_EMB, k=DCP_K, dtype=bf16), dtype=bf16)
    load_nnx_state(dcp, random_dcp_state(rng, DCP_EMB))
    dcp.eval()
    k5 = phase_kernel_k5(dcp, rng)
    k6 = phase_kernel_k6(rng)
    dcp_launches = phase_serve_dcp(dcp, rng)

    csrc = "learning3d_tpu_torch/kernels/csrc/"
    print(json.dumps({"kernels": [
        kernel_entry("pointnet_pooled_kernel", csrc + "pointnet_fused.cu",
                     "learning3d_tpu/kernels/pointnet_fused.py:205", launches, k1),
        kernel_entry("dgcnn_encode_fused", csrc + "dgcnn_fused.cu",
                     "learning3d_tpu/kernels/dgcnn_fused.py:205", dcp_launches["dgcnn_encode_fused"], k5),
        kernel_entry("attention_pallas", csrc + "attention.cu",
                     "learning3d_tpu/kernels/attention.py:61", dcp_launches["attention_pallas"], k6),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
