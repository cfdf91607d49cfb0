#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (learning3d_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the port's main paths at full width, bf16 and int8 (post-training
quantized) eval serving of the PointNet-1024 classifier and of DCP
registration (DGCNN-512, the co-attention pointer and the SVD head), bf16
serving of iPCRNet with multi-start registration, and training of the
PointNet-1024 classifier, DCP, iPCRNet and PCN through the Trainer, and
holds every CUDA kernel of those paths against its plain PyTorch
version. Phases, one JSON line each with the seconds since start:

1. device: the card, and its name and power limit from nvidia-smi;
2. build: every kernel compiled from the checkout's sources, one nvcc
   process a source, all at once, and one link, into a fresh build
   directory (seconds, ptxas register report);
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
   D=512, Dv=3), a ragged N=M=1000 and DCP(DGCNN(emb 1024))'s pointer
   (D=Dv=256: two 128-wide slabs of output columns), and the pointer's and
   head's shapes in f32 (f32 DCP's calls), whose output must be f32, not
   rounded to bf16, within K6_F32_TOL of the plain version; times, with
   scaled_dot_product_attention as ``library_ms`` (at the head's shape with
   the first backend, in PyTorch's order, that takes it, named);
7. serve_dcp: DCP(DGCNN(512, k=20)) in bf16 eval with numpy-seeded weights
   loaded through load_nnx_state, served through
   InferenceEngine(batch_size=32) on 32, 10 and 70 (template, source)
   pairs (5 chunks); K5 must launch 2 and K6 7 times a chunk, every output
   must be finite, every est_R a rotation, and r and est_t must agree with
   the same model run on the plain versions;

8. kernel (K2, pointnet_pooled_int8) and serve_int8: the classifier
   quantized as bench.py does (quantize_pointnet_classifier on 64 clouds,
   make_fused_quant_forward); K2 against its plain version at B=256,
   N=1024 and on a ragged B=3, N=1000 cloud, with the unfused int8 encoder
   (torch._int_mm) as ``library_ms``; served through InferenceEngine on the
   same requests as phase 4: K2 launched once a chunk, every logit finite,
   argmax agreement with the plain version >= 99%, agreement with the plain
   int8 forward and with the bf16 model reported;
9. kernel (K9, dgcnn_encode_fused_int8) and kernel (K10, attention_int8):
   DCP quantized as bench.py does (quantize_dcp on 8 + 8 clouds, int8_pv,
   fused_layers=False); K9 against its plain version on the full, ragged and
   lattice clouds, with an eager topk + torch._int_mm chain as
   ``library_ms``; K10 in both modes (int8 and bf16 P V) at the pointer's
   shape and a ragged N=M=1000, with scaled_dot_product_attention on the
   dequantized q, k, v as ``library_ms``;
10. serve_dcp_int8: the int8 clone through InferenceEngine on the DCP
   requests: K9 launched 2, K10 6 and K6 1 times a chunk, every output
   finite, every est_R a rotation, r and est_t within DCP_TOL of the same
   clone on the plain versions;
11. kernel (K11a encoder_layer_int8, K11b decoder_layer_int8): the fused
   int8 pointer layers of quantize_dcp(..., fused_layers=True) in both P.V
   modes at the DCP shape (B=32, N=1024, d=512, 4 heads, ff 1024) and at
   N=512, on the encoder's features, against their plain versions with the
   JAX package's tie-flip profile (max |diff| < 0.08, under 1% of the
   elements above 2e-4); the unfused int8 layer (QuantMHA + QuantFF on K10
   and torch._int_mm) as ``library_ms``;
12. serve_dcp_int8_fused, serve_dcp_int8_hybrid_fused and
   serve_dcp_int8_hybrid_fused_approx: bench.py's fused int8 DCP
   configurations (int8 P.V; hybrid P.V; hybrid with DGCNN(approx_knn=True))
   through InferenceEngine on 5 requests: K9 2, K11a 2, K11b 2, K6 1 and
   K10 (attention_int8) 0 launches a chunk, so that no layer took the module
   path; the DCP gates of phase 10; the approx phase also reports the share
   of (query, neighbor) picks that differ from exact kNN (information only);
   K5 and K9 with approx_knn=True against their plain versions first;
13. serve_template: TemplateRegistrar over the hybrid fused clone (bench.py's
   dcp_template_cached) on 5 requests: K9 1, K11a 2, K11b 2, K6 1, K10 0
   launches a chunk, and the DCP gates against the same model on the plain
   versions;
14. kernel (K3, pool_stats_pallas): against its plain version at the train
   step's shape (B=256, N=1024, K=128, E=1024) in bf16 and in f32 and on a
   ragged B=3, N=1000 cloud: max/min within TOL of the largest value, G and
   the column sum within POOL_SUM_TOL, z at the kernel's argmax/argmin
   within TOL of the plain max/min (the share of indices that differ is
   reported); times of the kernel, the plain version, an eager chain
   (torch.matmul materializing z, torch.max/min with indices, x^T x) as
   ``library_ms``, and the bound;
15. kernel (K4, pool_bwd_pallas): against its plain version with the
   indices of the K3 run (bf16 and f32, main shape; the ragged cloud) and
   with every channel on one point; dense dx_sp and dW_sel within
   POOL_SUM_TOL; index_add_ plus a gathered einsum as ``library_ms``;
16. train: bench.py's training configuration (Classifier(PointNet(1024,
   use_bn=True)) in bf16, B=256, N=1024, Adam 1e-3, augmentation on) through
   Trainer.fit for one epoch of SyntheticModelNet40 (6 steps) in a temporary
   directory: K3 and K4 launched once a step, the epoch's loss finite, no
   step skipped, parameters and BN running statistics changed; one step on
   the kernels against the same step on their plain versions (same weights,
   batch and dropout generator) in bf16 and f32: loss, every gradient and
   the running statistics; a save -> load round trip that restores the
   parameters and the optimizer state exactly; the step's forward, backward
   and optimizer times (CUDA events) and clouds/s;
17. kernel (K7, knn_neighbors_pallas): the edge features against the plain
   version, bit for bit (on clouds of distinct points, so the neighbor
   indices are the same too), at B=32, N=1024, k=20,
   on a lattice cloud (exact ties at the 20th neighbor), on a ragged B=3,
   N=1000 cloud and at k=40 (past K5's k <= 32); times of the kernel, the
   plain version, an eager chain of torch.cdist, torch.topk and a gather
   (``library_ms``), and the bound;
18. train_dcp: examples/train.py's DCP configuration (DCP(DGCNN(512, k=20))
   in f32, B=32, N=1024, Adam 1e-3) through Trainer.fit on
   RegistrationData("DCP", SyntheticModelNet40) for one epoch of
   TRAIN_DCP_STEPS steps and an eval pass (f32 DCP in eval mode): K7
   launched twice and K6 seven times a forward, K5 never; the loss finite,
   no step skipped, parameters and BN running statistics changed, the eval
   pass's rot_deg and trans finite; one step on the kernels against the same
   step on their plain versions (loss, every gradient, the running
   statistics); a save -> load round trip; the step's parts (CUDA events)
   and pairs/s;

19. kernel_k12 (_nn_oneway_pallas): K12 against its plain version, distances
   bit-equal and indices equal, at multistart's shape (B=256, N=M=1024),
   at detailed PCN's fine Chamfer (32 x 1024 points against 16,384, both
   directions), on a ragged pair and on lattice clouds with tied nearest
   points; times of the kernel, the plain version, torch.cdist + min
   (``library_ms``) and the bound;
20. kernel_k13 (_emd_fwd_pallas): K13 against its plain version at PCN's
   coarse EMD (B=32, N=M=1024) and at N > M and N < M: the cost to
   EMD_COST_TOL, g1 and g2 to a mean relative error below EMD_GRAD_TOL;
   times and the bound (no PyTorch call computes approxmatch:
   ``library_ms`` null);
21. serve_ipcrnet: iPCRNet(PointNet(1024, use_bn=False)) in bf16 eval (8
   steps) with numpy-seeded weights through InferenceEngine(batch_size=32)
   on 32, 10 and 70 pairs: K1 nine times a chunk, every output finite,
   est_R a rotation to the bf16 rounding of its steps; then
   multistart_register with rotation_starts(8) at B=32: one forward at
   batch 256 (K1 nine times) and K12 twice; its result its best start's,
   the candidates rescored on K12's plain version bit for bit, and the
   one-step model against the plain versions (ipcrnet_agreement); pairs/s;
22. train_ipcrnet: examples/train.py's iPCRNet configuration in f32, B=20,
   N=1024, Adam 1e-3 through Trainer.fit on RegistrationData("iPCRNet",
   SyntheticModelNet40) for IPC_TRAIN_STEPS steps: K12 twice a step, K1
   never; loss finite, no step skipped, every weight changed, f32 est_R a
   rotation; one step against the plain versions (CHAMFER_STEP_TOL); the
   step's parts and pairs/s;
23. train_pcn: PCN(1024, num_coarse=1024) in f32, B=32, N=1024, coarse only,
   through Trainer.fit on ClassificationData(SyntheticModelNet40) for
   PCN_TRAIN_STEPS steps (K12 twice a step), then one step with
   detailed_output=True (K12 four times, the fine Chamfer against 16,384
   points), each against the plain versions; emd_loss_mean(points,
   coarse_output) forward and backward on K13 (one launch) against its
   plain version; the steps' parts and the EMD loss's time;

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
# K6 on f32 q, k, v writes f32: only the sum order differs from the plain
# version (a probability now and then rounds to the neighbouring bf16
# value): 4.5e-4 and 5.9e-4 of max at the pointer's and head's shapes on
# the H100. An output rounded to bf16 moves each value by up to 2^-9 of
# it; the check also rejects it outright (an f32 output is not all bf16
# values)
K6_F32_TOL = 1e-3
AGREE = 0.99
DCP_B, DCP_N, DCP_EMB, DCP_K = 32, 1024, 512, 20
DCP_REQUESTS = (32, 10, 70)
FUSED_REQUESTS = (32, 10, 70, 32, 20)  # 5 requests, 7 chunks of 32
# r and est_t of the kernel path against the plain path, max |k - p| <=
# DCP_TOL * max |p|: an f32 sum in another order can round an activation
# to the neighbouring bf16 value (2^-8 of it), and the encoder, the pointer
# and the head carry such steps on; a kernel that computed something else
# would be off by the order of the values themselves.
DCP_TOL = 5e-2
ROT_TOL = 1e-3  # max |R R^T - I| and |det R - 1| of every est_R
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core peak
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SFU_EXP_PER_S = 16 * 132 * 1.98e9  # H100 SXM: 16 exponentials a clock on each of 132 SMs at 1.98 GHz
CALIB_CLOUDS, DCP_CALIB_PAIRS = 64, 8  # bench.py's calibration batches
K_TAIL = 128  # the input width of PointNet's fused last stage (conv5)
# G and the column sum are sums over all B*N = 262,144 rows: the kernel sums
# per cloud and then over the clouds, the plain version in cuBLAS's order
# (and for f32 the kernel's hi/lo bf16 split is about 2^-16 of a product)
POOL_SUM_TOL = 1e-4
TRAIN_STEPS, TRAIN_LR = 6, 1e-3
# one train step on the kernels against the same step on the plain
# versions, per-tensor relative error: in bf16 an f32 sum in another order
# can move an activation to the neighbouring bf16 value (2^-8) and the
# head's BatchNorm, the log-softmax and the backward carry it on. In f32,
# K3 multiplies through a bf16 hi/lo split (about 2^-16 of a product, as the
# TPU kernel does) where the plain version multiplies in f32, so a channel
# whose two largest values lie that close picks another critical point
# (1e-5 of the picks in phase 14); each such pick moves that channel's
# gradient to another point, some 0.5% of an encoder gradient's norm
STEP_TOL = {"bf16": 3e-2, "f32": 2e-2}
# biases whose exact gradient is 0: those of the Linears that feed a
# train-mode BatchNorm (the batch mean takes them out), and the last encoder
# BatchNorm's (it shifts every cloud's pooled feature alike, which the
# head's train-mode bn1 takes out again while the ReLU passes every cloud).
# What is computed is rounding noise (in bf16 a few % of the layer's weight
# gradient, in the JAX package's bf16 step as in the port's): it is held to
# NOISE_TOL of the layer's weight gradient instead
ZERO_GRADIENT_BIASES = tuple(f"feature_model.convs.{i}.bias" for i in range(5)) + (
    "feature_model.bns.4.bias", "linear1.bias", "linear2.bias")
NOISE_TOL = 5e-2
TRAIN_DCP_STEPS = 4
# one DCP train step on K7 and K6 against the same step on their plain
# versions, per-tensor relative error. K7 is exact (the same neighbors, the
# coordinates copied), and both steps take the attention's backward through
# the oracle. K6 and its plain version round the same bf16 operands and P
# and both write f32, but sum in another order, so a probability can round
# to the neighbouring bf16 value (2^-8 of it); the soft correspondences
# carry that through the Kabsch solver and the backward into every
# gradient: 6.1e-4 to 2.6e-3 on the H100 over this phase's weights and
# those of tools/torch_dcp_step_gaps.py. K6's output rounded to bf16 (the
# control, k6_bf16_output) gives 5.3e-3 to 1.7e-2 there, and must fail
DCP_STEP_TOL = 4e-3
# the key projections' biases have no gradient in exact arithmetic (a bias
# on every key shifts a query's scores by one constant, which the softmax
# takes out): what is computed is rounding noise, held to DCP_NOISE_TOL of
# the projection's weight gradient
DCP_ZERO_GRADIENT_BIASES = tuple(f"pointer.{layer}.{attn}.wk.bias" for layer, attn in (
    ("enc_layers.0", "self_attn"), ("dec_layers.0", "self_attn"), ("dec_layers.0", "cross_attn")))
DCP_NOISE_TOL = 1e-3


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


def bound(flops: float, nbytes: float, *, int8_ops: float = 0.0, f32_flops: float = 0.0) -> tuple[float, str]:
    """Least time (ms) and what sets it: the operations or the bytes over the
    memory rate. The tensor cores run the bf16 ``flops`` and the
    ``int8_ops`` one after the other, each type at its peak; the ``f32_flops``
    run on the CUDA cores beside them, so the operations take the longer of
    the two."""
    ops_s = max(flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS, f32_flops / PEAK_F32_FLOPS)
    bytes_s = nbytes / PEAK_BYTES
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


def head_library_ms(q, k, v) -> tuple[float, str]:
    """SDPA at the SVD head's shape (D=512, Dv=3) with the first backend,
    in PyTorch's order of preference, that takes it; its time and name."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                sdpa(q, k, v)
                torch.cuda.synchronize()
                return cuda_ms(lambda: sdpa(q, k, v)), f"scaled_dot_product_attention ({backend.name})"
        except RuntimeError:
            continue
    raise RuntimeError("no SDPA backend takes the head's shape")


def phase_kernel_k6(rng) -> dict:
    from learning3d_tpu_torch.kernels.attention import attention_pallas, attention_reference

    def qkv(b, h, n, m, d, dv, dtype=torch.bfloat16):
        return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(dtype)
                for shape in ((b, h, n, d), (b, h, m, d), (b, h, m, dv))]

    cases = {
        "pointer": qkv(DCP_B, 4, DCP_N, DCP_N, 128, 128),
        "head": qkv(DCP_B, 1, DCP_N, DCP_N, DCP_EMB, 3),
        "ragged": qkv(4, 4, 1000, 1000, 128, 128),
        "dv256": qkv(DCP_B, 4, DCP_N, DCP_N, 256, 256),
        # f32 DCP's calls (training, its eval pass, f32 serving)
        "pointer_f32": qkv(DCP_B, 4, DCP_N, DCP_N, 128, 128, torch.float32),
        "head_f32": qkv(DCP_B, 1, DCP_N, DCP_N, DCP_EMB, 3, torch.float32),
    }
    errs, times = {}, {}
    with torch.inference_mode():
        for name, (q, k, v) in cases.items():
            got = attention_pallas(q, k, v)
            want = attention_reference(q, k, v)
            torch.cuda.synchronize()
            require(got.dtype == q.dtype, f"K6 ({name}): output {got.dtype} for q {q.dtype}")
            if q.dtype == torch.float32:
                require(bool((got != got.to(torch.bfloat16).float()).any()), f"K6 ({name}): output rounded to bf16")
            errs[name] = check_close(got, want, f"K6 vs plain ({name})",
                                     K6_F32_TOL if q.dtype == torch.float32 else TOL)
        for name in ("pointer", "head", "dv256"):
            q, k, v = cases[name]
            times[name] = {
                "kernel_ms": cuda_ms(lambda: attention_pallas(q, k, v)),
                "plain_ms": cuda_ms(lambda: attention_reference(q, k, v), reps=3, warmup=1),
                "bound_ms": attention_bound(q, k, v)[0],
            }
        q, k, v = cases["pointer"]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        l_ms = cuda_ms(lambda: sdpa(q, k, v))
        times["pointer"]["library_ms"] = l_ms
        times["head"]["library_ms"], times["head"]["library"] = head_library_ms(*cases["head"])
        times["dv256"]["library_ms"] = cuda_ms(lambda: sdpa(*cases["dv256"]))
    bound_ms, bound_by = attention_bound(*cases["pointer"])
    result = {
        "max_abs_err": max(a for a, _ in errs.values()),
        "max_rel_err": max(r for _, r in errs.values()),
        "kernel_ms": times["pointer"]["kernel_ms"], "plain_ms": times["pointer"]["plain_ms"],
        "library_ms": l_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit("kernel", name="attention_pallas",
         tolerance=f"max|k-p| <= {TOL}*max|p| in bf16, {K6_F32_TOL}*max|p| in f32 (an f32 output)",
         shapes={"pointer": [DCP_B, 4, DCP_N, DCP_N, 128, 128], "head": [DCP_B, 1, DCP_N, DCP_N, DCP_EMB, 3],
                 "dv256": [DCP_B, 4, DCP_N, DCP_N, 256, 256], "pointer_f32": "pointer in f32",
                 "head_f32": "head in f32"},
         errors={k: {"abs": a, "rel": r} for k, (a, r) in errs.items()}, times=times,
         library="torch scaled_dot_product_attention at the pointer's shape, yardstick only", **result)
    return result


@contextlib.contextmanager
def plain_versions():
    """Route the kernel entries of the DCP, iPCRNet and PCN paths (K5, K6,
    K7, K9, K10, K11a/b; K1, K12, K13) to the kernels' plain versions (on
    the same card) for the reference run; restored on exit."""
    from learning3d_tpu_torch import quant
    from learning3d_tpu_torch.kernels import attention, chamfer, dgcnn_fused, edgeconv, emd, pointnet_fused
    from learning3d_tpu_torch.kernels import transformer_int8
    from learning3d_tpu_torch.models import dgcnn

    def encoder(x, convs, bns, k, approx_knn=False):
        folded = [dgcnn_fused.fold_bn(c, bn) for c, bn in zip(convs, bns)]
        return dgcnn_fused.dgcnn_encode_reference(x.float(), [w for w, _ in folded], [b for _, b in folded], k,
                                                  approx_knn=approx_knn)

    def fused_layer(layer, x, *memory):
        if not (layer._on_gate(x) and all(m.shape[1] == x.shape[1] for m in memory)):
            return layer.inner(x, *memory)
        ref = transformer_int8.decoder_layer_int8_reference if memory else transformer_int8.encoder_layer_int8_reference
        return ref(x, *memory, layer.weights(), layer.scales, n_heads=layer.n_heads, int8_pv=layer.int8_pv)

    # K6's plain version goes inside attention_fused's autograd Function, so
    # that a train step on the plain versions keeps the kernel path's
    # backward (the oracle's)
    patches = [(dgcnn, "dgcnn_encode_fused", encoder), (edgeconv, "edge_features", edgeconv.edge_features_reference),
               (attention, "attention_pallas", attention.attention_reference),
               (dgcnn, "dgcnn_encode_int8_kernel", dgcnn_fused.dgcnn_int8_reference),
               (quant, "attention_int8", attention.attention_int8_reference),
               (quant.QuantEncoderLayerFused, "forward", fused_layer),
               (quant.QuantDecoderLayerFused, "forward", fused_layer),
               (pointnet_fused, "pointnet_pooled_kernel", pointnet_fused.oracle_chain),
               (chamfer, "nn_oneway", chamfer._nn_oneway_reference), (emd, "emd_kernel", emd._emd_fwd_reference)]
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


def library_pn_int8(x, qm):
    """Yardstick only, never used by the port: the unfused int8 encoder of
    QuantPointNetClassifier (torch._int_mm products, eager epilogues) and the
    pool."""
    from learning3d_tpu_torch.quant import _bf16_linear

    h = torch.relu(_bf16_linear(x, qm.w1, qm.b1))
    for i, q in enumerate(qm.enc):
        h = q(h, relu=i < len(qm.enc) - 1)
    return torch.relu(torch.amax(h, dim=1))


def phase_kernel_k2(fused, rng) -> dict:
    from learning3d_tpu_torch.kernels.pointnet_fused import pn_int8_reference, pointnet_pooled_int8_kernel

    pack = fused.pack
    errs = {}
    with torch.inference_mode():
        for name, shape in (("full", (B, N, 3)), ("ragged", (3, 1000, 3))):
            x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
            got = pointnet_pooled_int8_kernel(x, pack)
            want = pn_int8_reference(x, pack)
            torch.cuda.synchronize()
            require(got.shape == (shape[0], EMB) and got.dtype == torch.float32, f"K2 output {name}")
            errs[name] = check_close(got, want, f"K2 vs plain ({name})")
            if name == "full":
                x_full = x
        k_ms = cuda_ms(lambda: pointnet_pooled_int8_kernel(x_full, pack))
        p_ms = cuda_ms(lambda: pn_int8_reference(x_full, pack), reps=5)
        l_ms = cuda_ms(lambda: library_pn_int8(x_full, fused.qm), reps=5)
    stages = pack.stages()
    macs = sum(wt.numel() for wt, _ in stages)
    nbytes = 4 * B * N * 3 + 4 * (pack.w1.numel() + pack.b1.numel()) \
        + sum(wt.numel() + 4 * swb.numel() for wt, swb in stages) + 4 * B * EMB
    bound_ms, bound_by = bound(0.0, nbytes, int8_ops=2.0 * B * N * macs, f32_flops=2.0 * B * N * pack.w1.numel())
    result = {
        "max_abs_err": max(a for a, _ in errs.values()), "max_rel_err": max(r for _, r in errs.values()),
        "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit("kernel", name="pointnet_pooled_int8", tolerance=f"max|k-p| <= {TOL}*max|p|",
         errors={k: {"abs": a, "rel": r} for k, (a, r) in errs.items()},
         library="QuantPointNetClassifier's unfused int8 encoder (torch._int_mm), yardstick only", **result)
    return result


def phase_serve_int8(model, fused, rng) -> int:
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.kernels.pointnet_fused import pn_int8_reference
    from learning3d_tpu_torch.serve import InferenceEngine

    engine = InferenceEngine(fused, batch_size=B)
    requests = [rng.normal(size=(n, N, 3)).astype(np.float32) for n in REQUESTS]
    chunks = sum(-(-n // B) for n in REQUESTS)
    reset_launches()
    outs = [engine(x) for x in requests]
    torch.cuda.synchronize()
    launches = LAUNCHES["pointnet_pooled_int8"]
    require(launches == chunks, f"K2 launched {launches} times for {chunks} chunks")
    for x, out in zip(requests, outs):
        require(out.shape == (x.shape[0], CLASSES), f"int8 logits shape {out.shape}")
        require(bool(np.isfinite(out).all()), "every int8 logit finite")

    agree = {"plain": 0, "quant_forward": 0, "bf16": 0}
    total = 0
    with torch.inference_mode():
        for x, out in zip(requests, outs):
            xd = torch.from_numpy(x).cuda()
            refs = {"plain": fused.qm.logits(pn_int8_reference(xd, fused.pack)), "quant_forward": fused.qm(xd),
                    "bf16": model(xd)}
            for key, ref in refs.items():
                agree[key] += int((ref.float().cpu().numpy().argmax(-1) == out.argmax(-1)).sum())
            total += x.shape[0]
    agree = {key: val / total for key, val in agree.items()}
    require(agree["plain"] >= AGREE, f"int8 argmax agreement with the plain version {agree['plain']} < {AGREE}")

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
        model_ms = cuda_ms(lambda: fused(x_dev))
        plain_int8_ms = cuda_ms(lambda: fused.qm(x_dev))
    emit("serve_int8", requests=list(REQUESTS), chunks=chunks, launches=launches,
         argmax_agree_plain=agree["plain"], argmax_agree_quant_forward=agree["quant_forward"],
         argmax_agree_bf16=agree["bf16"], clouds_per_s=B / host_s, engine_ms=1e3 * host_s, model_ms=model_ms,
         model_clouds_per_s=B / (model_ms * 1e-3), quant_forward_ms=plain_int8_ms)
    return launches


def library_dgcnn_int8(x, pack, k):
    """Yardstick only, never used by the port: K9's function as an eager
    chain of cuBLAS distances, torch.topk, a gather and torch._int_mm
    products."""
    from learning3d_tpu_torch.kernels.dgcnn_fused import _xw1_int8
    from learning3d_tpu_torch.ops.int8 import int8_matmul, to_int8

    f32, bf = torch.float32, torch.bfloat16
    sq = (x * x).sum(-1)
    d = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(x, x.transpose(1, 2))
    idx = torch.topk(d, k, dim=-1, largest=False).indices
    xw1q, s_xw1 = _xw1_int8(x, pack.wn1)
    c1 = x.to(bf).to(f32) @ pack.wc1.to(bf).to(f32) + pack.b1
    Bc, Nc, C = xw1q.shape
    nbr = torch.gather(xw1q, 1, idx.reshape(Bc, -1, 1).expand(-1, -1, C)).reshape(Bc, Nc, k, C)
    e = to_int8(torch.relu(nbr.to(f32) * s_xw1 + c1[:, :, None]) * pack.inv_s[0])
    pooled = [e.amax(2)]
    stages = pack.stages()
    for (wt, swb), inv in zip(stages[:3], pack.inv_s[1:]):
        e = to_int8(torch.relu(int8_matmul(e, wt.t()).to(f32) * swb[0] + swb[1]) * inv)
        pooled.append(e.amax(2))
    wt, swb = stages[3]
    return torch.relu(int8_matmul(torch.cat(pooled, -1), wt.t()).to(f32) * swb[0] + swb[1]).to(bf)


def phase_kernel_k9(qdcp, rng) -> dict:
    from learning3d_tpu_torch.kernels.dgcnn_fused import dgcnn_encode_int8_kernel, dgcnn_int8_reference

    pack = qdcp.emb_nn.int8_weights
    cases = {
        "full": rng.normal(size=(DCP_B, DCP_N, 3)).astype(np.float32),
        "ragged": rng.normal(size=(3, 1000, 3)).astype(np.float32),
        "ties": lattice_cloud(rng, 2, 1000),
    }
    errs = {}
    with torch.inference_mode():
        for name, x_np in cases.items():
            x = torch.from_numpy(x_np).cuda()
            got = dgcnn_encode_int8_kernel(x, pack, DCP_K)
            want = dgcnn_int8_reference(x, pack, DCP_K)
            torch.cuda.synchronize()
            errs[name] = check_close(got, want, f"K9 vs plain ({name})")
        x = torch.from_numpy(cases["full"]).cuda()
        k_ms = cuda_ms(lambda: dgcnn_encode_int8_kernel(x, pack, DCP_K))
        p_ms = cuda_ms(lambda: dgcnn_int8_reference(x, pack, DCP_K), reps=3, warmup=1)
        l_ms = cuda_ms(lambda: library_dgcnn_int8(x, pack, DCP_K), reps=5)
    stages = pack.stages()
    macs = DCP_K * sum(wt.numel() for wt, _ in stages[:3]) + stages[3][0].numel()  # a point
    # x and xw1q read once, the weights once, the output written once
    nbytes = 4 * DCP_B * DCP_N * 3 + DCP_B * DCP_N * 64 + sum(wt.numel() + 4 * swb.numel() for wt, swb in stages) \
        + 2 * DCP_B * DCP_N * DCP_EMB
    # distances: 3 differences, 3 products and 2 sums a pair; the center half of stage 1
    f32_flops = 8.0 * DCP_B * DCP_N * DCP_N + 2.0 * DCP_B * DCP_N * 3 * 64
    bound_ms, bound_by = bound(0.0, nbytes, int8_ops=2.0 * DCP_B * DCP_N * macs, f32_flops=f32_flops)
    result = {
        "max_abs_err": max(a for a, _ in errs.values()), "max_rel_err": max(r for _, r in errs.values()),
        "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit("kernel", name="dgcnn_encode_fused_int8", tolerance=f"max|k-p| <= {TOL}*max|p|",
         shape={"B": DCP_B, "N": DCP_N, "k": DCP_K, "emb": DCP_EMB},
         errors={k: {"abs": a, "rel": r} for k, (a, r) in errs.items()},
         library="eager cuBLAS distances + torch.topk + gather + torch._int_mm chain, yardstick only", **result)
    return result


def attention_int8_bound(b, h, n, m, d, int8_pv) -> tuple[float, str]:
    ops = 2.0 * b * h * n * m * d
    nbytes = b * h * (n + 2 * m) * d + 2 * b * h * n * d
    return bound(0.0 if int8_pv else ops, nbytes, int8_ops=2 * ops if int8_pv else ops)


def phase_kernel_k10(rng) -> dict:
    from learning3d_tpu_torch.kernels.attention import attention_int8_kernel, attention_int8_reference

    def qkv(b, h, n, m, d):
        return [torch.from_numpy(rng.integers(-127, 128, (b, h, s, d)).astype(np.int8)).cuda() for s in (n, m, m)]

    s_q, s_k, s_v = 0.004, 0.005, 0.03
    cases = {"pointer": qkv(DCP_B, 4, DCP_N, DCP_N, 128), "ragged": qkv(4, 4, 1000, 1000, 128)}
    errs, times = {}, {}
    with torch.inference_mode():
        for int8_pv in (True, False):
            mode = "int8_pv" if int8_pv else "hybrid"
            for name, (q, k, v) in cases.items():
                got = attention_int8_kernel(q, k, v, s_q, s_k, s_v, int8_pv)
                want = attention_int8_reference(q, k, v, s_q, s_k, s_v, int8_pv)
                torch.cuda.synchronize()
                errs[f"{mode}/{name}"] = check_close(got, want, f"K10 vs plain ({mode}, {name})")
            q, k, v = cases["pointer"]
            times[mode] = {
                "kernel_ms": cuda_ms(lambda: attention_int8_kernel(q, k, v, s_q, s_k, s_v, int8_pv)),
                "plain_ms": cuda_ms(lambda: attention_int8_reference(q, k, v, s_q, s_k, s_v, int8_pv),
                                    reps=3, warmup=1),
            }
            times[mode]["bound_ms"], times[mode]["bound_by"] = attention_int8_bound(DCP_B, 4, DCP_N, DCP_N, 128,
                                                                                    int8_pv)
        q, k, v = cases["pointer"]
        deq = [(t.float() * s).to(torch.bfloat16) for t, s in ((q, s_q), (k, s_k), (v, s_v))]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        l_ms = cuda_ms(lambda: sdpa(*deq))
    exp_sfu_ms = 1e3 * DCP_B * 4 * DCP_N * DCP_N / SFU_EXP_PER_S
    served = times["int8_pv"]
    result = {
        "max_abs_err": max(a for a, _ in errs.values()), "max_rel_err": max(r for _, r in errs.values()),
        "kernel_ms": served["kernel_ms"], "plain_ms": served["plain_ms"], "library_ms": l_ms,
        "bound_ms": served["bound_ms"], "bound_by": served["bound_by"], "hybrid": times["hybrid"],
    }
    emit("kernel", name="attention_int8", tolerance=f"max|k-p| <= {TOL}*max|p|",
         shape=[DCP_B, 4, DCP_N, DCP_N, 128], errors={k: {"abs": a, "rel": r} for k, (a, r) in errs.items()},
         times=times, exp_sfu_ms=exp_sfu_ms,
         library="torch scaled_dot_product_attention on the dequantized bf16 q, k, v, yardstick only", **result)
    return result


def dcp_gates(outs, plain, what) -> dict:
    """The DCP output gates: shapes, every output finite, every est_R a
    rotation, r and est_t within DCP_TOL of the plain versions' run."""
    rot_err = det_err = 0.0
    for out in outs:
        n = out["est_R"].shape[0]
        require(out["r"].shape == (n, DCP_N, DCP_EMB), f"{what} result shapes")
        for key, val in out.items():
            require(bool(np.isfinite(val).all()), f"every {what} {key} finite")
        R = out["est_R"].astype(np.float64)
        rot_err = max(rot_err, float(np.abs(R @ np.swapaxes(R, -1, -2) - np.eye(3)).max()))
        det_err = max(det_err, float(np.abs(np.linalg.det(R) - 1.0).max()))
    require(rot_err <= ROT_TOL and det_err <= ROT_TOL, f"{what} est_R not a rotation: {rot_err}, {det_err}")
    agree = {}
    for key in ("r", "est_t"):
        got = torch.from_numpy(np.concatenate([o[key] for o in outs]))
        want = torch.from_numpy(np.concatenate([p[key] for p in plain]))
        a, r = check_close(got, want, f"{what} {key}, kernels vs plain", DCP_TOL)
        agree[key] = {"abs": a, "rel": r}
    return {"tolerance": f"max|k-p| <= {DCP_TOL}*max|p| for r and est_t", "agree": agree,
            "rotation": {"max_RRt_minus_I": rot_err, "max_det_minus_1": det_err}}


def phase_serve_dcp_variant(phase, model, rng, per_chunk, requests=DCP_REQUESTS, template=False, **extra) -> dict:
    """Serve an int8 DCP clone through InferenceEngine (or, with
    ``template``, TemplateRegistrar against one template), hold the launch
    counts of the kernels a chunk (``per_chunk``; every other kernel of
    LAUNCHES 0, unless listed) and the DCP gates against the same model on
    the plain versions; time a 32-pair request."""
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.serve import InferenceEngine, TemplateRegistrar

    cloud = lambda n: rng.normal(size=(n, DCP_N, 3)).astype(np.float32)  # noqa: E731
    if template:
        tmpl = cloud(1)[0]
        sources = [cloud(n) for n in requests]
        engine = TemplateRegistrar(model, tmpl, batch_size=DCP_B)
        calls = [(s,) for s in sources]
    else:
        engine = InferenceEngine(model, batch_size=DCP_B)
        calls = [(cloud(n), cloud(n)) for n in requests]
    chunks = sum(-(-n // DCP_B) for n in requests)
    reset_launches()
    outs = [engine(*c) for c in calls]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for name, count in launches.items():
        want = per_chunk.get(name, 0) * chunks
        require(count == want, f"{phase}: {name} launched {count} times for {chunks} chunks (want {want})")
    with plain_versions():
        plain_engine = TemplateRegistrar(model, tmpl, batch_size=DCP_B) if template else engine
        plain = [plain_engine(*c) for c in calls]
    gates = dcp_gates(outs, plain, phase)

    first = calls[0]
    engine(*first)
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine(*first)
    host_s = (time.perf_counter() - t0) / reps
    dev = [torch.from_numpy(a).cuda() for a in first]
    with torch.inference_mode():
        if template:
            temb = engine._temb.expand(DCP_B, -1, -1)
            tdev = engine._template.expand(DCP_B, -1, -1)
            model_ms = cuda_ms(lambda: model.register_encoded(tdev, temb, dev[0]), reps=5)
        else:
            model_ms = cuda_ms(lambda: model(*dev), reps=5)
    emit(phase, requests=list(requests), chunks=chunks,
         launches={k: v for k, v in launches.items() if v}, **gates, pairs_per_s=DCP_B / host_s,
         engine_ms=1e3 * host_s, model_ms=model_ms, model_pairs_per_s=DCP_B / (model_ms * 1e-3), **extra)
    return launches


LAYER_TOL = {"max_abs": 0.08, "atol": 2e-4, "frac": 0.01}  # the JAX package's K11 test


def tie_flip_profile(got, want, what) -> dict:
    """K11 against its plain version: max |diff| < 0.08 and under 1% of the
    elements above 2e-4 (an f32 sum in another order flips round(x / s) at
    a .5 tie, rarely; a wrong kernel moves every element)."""
    require(got.shape == want.shape and bool(torch.isfinite(got).all()), f"{what}: shape and finite")
    d = (got.float() - want.float()).abs()
    max_abs, frac = d.max().item(), (d > LAYER_TOL["atol"]).float().mean().item()
    require(max_abs < LAYER_TOL["max_abs"] and frac < LAYER_TOL["frac"],
            f"{what}: max |diff| {max_abs}, share above {LAYER_TOL['atol']} {frac}")
    return {"max_abs": max_abs, "share_above_atol": frac}


def k11_bound(batch, n, d, d_ff, heads, decoder, int8_pv) -> tuple[float, str]:
    """K11's bound: its int8 GEMMs and attention products (the hybrid P.V at
    the bf16 rate); its bytes: x (and the memory) read once as bf16, the
    int8 weights and their f32 vectors once, the output written once."""
    rows = batch * n
    gemm = 2.0 * rows * d * (3 * d + d + 2 * d_ff) + (2.0 * rows * d * 4 * d if decoder else 0.0)
    att = 2.0 * batch * heads * n * n * (d // heads) * (2 if decoder else 1)  # Q K^T, and as much for P V
    weights = d * (4 * d + 2 * d_ff) * (2 if decoder else 1)
    vectors = 4 * 3 * (4 * d + 2 * d_ff) * (2 if decoder else 1)
    nbytes = 2 * rows * d * (3 if decoder else 2) + weights + vectors
    return bound(0.0 if int8_pv else att, nbytes, int8_ops=gemm + (2 * att if int8_pv else att))


def phase_kernel_k11(layers, inputs) -> dict:
    """``layers``: {int8_pv: (QuantEncoderLayerFused, QuantDecoderLayerFused)}
    of the served clones; ``inputs``: bf16 encoder features x, memory."""
    from learning3d_tpu_torch.kernels import transformer_int8 as k11

    x_full, mem_full = inputs
    d, heads = x_full.shape[-1], layers[True][0].n_heads
    d_ff = layers[True][0].inner.ff.w1_q.shape[1]
    results, errs = {}, {}
    with torch.inference_mode():
        for int8_pv, (enc, dec) in layers.items():
            mode = "int8_pv" if int8_pv else "hybrid"
            for kind, layer in (("encoder", enc), ("decoder", dec)):
                ref = k11.decoder_layer_int8_reference if kind == "decoder" else k11.encoder_layer_int8_reference
                entry = k11.decoder_layer_int8 if kind == "decoder" else k11.encoder_layer_int8
                for n in (DCP_N, 512):
                    args = (x_full[:, :n].contiguous(),) + ((mem_full[:, :n].contiguous(),) if kind == "decoder" else ())
                    require(k11.fused_layer_ok(n, d, heads), f"K11 gate at N={n}")
                    got = entry(*args, layer.pack, int8_pv=int8_pv)
                    want = ref(*args, layer.weights(), layer.scales, n_heads=heads, int8_pv=int8_pv)
                    torch.cuda.synchronize()
                    errs[f"{kind}/{mode}/N{n}"] = tie_flip_profile(got, want, f"K11 {kind} {mode} N={n}")
                args = (x_full,) + ((mem_full,) if kind == "decoder" else ())
                res = {
                    "kernel_ms": cuda_ms(lambda: entry(*args, layer.pack, int8_pv=int8_pv)),
                    "plain_ms": cuda_ms(lambda: ref(*args, layer.weights(), layer.scales, n_heads=heads,
                                                    int8_pv=int8_pv), reps=3, warmup=1),
                    "library_ms": cuda_ms(lambda: layer.inner(*args), reps=5),
                }
                res["bound_ms"], res["bound_by"] = k11_bound(DCP_B, DCP_N, d, d_ff, heads, kind == "decoder", int8_pv)
                results[f"{kind}/{mode}"] = res
    out = {}
    for kind in ("encoder", "decoder"):
        served = results[f"{kind}/int8_pv"]
        kerrs = {k: v for k, v in errs.items() if k.startswith(kind)}
        out[kind] = {
            **served, "max_abs_err": max(e["max_abs"] for e in kerrs.values()),
            "max_rel_err": max(e["max_abs"] for e in kerrs.values()) / max(x_full.float().abs().max().item(), 1e-30),
            "hybrid": results[f"{kind}/hybrid"],
        }
        emit("kernel", name=f"{kind}_layer_int8",
             tolerance=f"max|k-p| < {LAYER_TOL['max_abs']}, under {LAYER_TOL['frac']} of elements above "
                       f"{LAYER_TOL['atol']}",
             shape={"B": DCP_B, "N": [DCP_N, 512], "d": d, "heads": heads, "ff": d_ff}, errors=kerrs,
             library="the unfused int8 layer (QuantMHA + QuantFF: K10 and torch._int_mm), yardstick only",
             **out[kind])
    return out


def approx_pick_share(x, k) -> float:
    """The share of (query, neighbor) picks of approx kNN that exact kNN
    does not make."""
    from learning3d_tpu_torch.kernels.dgcnn_fused import approx_knn_indices, exact_knn

    a, e = approx_knn_indices(x, k), exact_knn(x, k)
    same = (a[..., :, None] == e[..., None, :]).any(-1)
    return 1.0 - same.float().mean().item()


def phase_approx_kernels(dcp, qdcp, rng) -> dict:
    """K5 and K9 with approx_knn=True against their plain versions on the
    full and a two-tile (N=320) cloud."""
    from learning3d_tpu_torch.kernels.dgcnn_fused import (
        dgcnn_encode_int8_kernel, dgcnn_encode_kernel, dgcnn_encode_reference, dgcnn_int8_reference)

    ws, bs = folded_dgcnn(dcp)
    pack = qdcp.emb_nn.int8_weights
    errs = {}
    with torch.inference_mode():
        for name, shape in (("full", (DCP_B, DCP_N, 3)), ("two_tiles", (3, 320, 3))):
            x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
            for kname, got, want in (
                    ("K5", dgcnn_encode_kernel(x, ws, bs, DCP_K, approx_knn=True),
                     dgcnn_encode_reference(x, ws, bs, DCP_K, approx_knn=True)),
                    ("K9", dgcnn_encode_int8_kernel(x, pack, DCP_K, approx_knn=True),
                     dgcnn_int8_reference(x, pack, DCP_K, approx_knn=True))):
                torch.cuda.synchronize()
                a, r = check_close(got, want, f"{kname} approx vs plain ({name})")
                errs[f"{kname}/{name}"] = {"abs": a, "rel": r}
            if name == "full":
                share = approx_pick_share(x, DCP_K)
                k5_ms = cuda_ms(lambda: dgcnn_encode_kernel(x, ws, bs, DCP_K, approx_knn=True))
                k9_ms = cuda_ms(lambda: dgcnn_encode_int8_kernel(x, pack, DCP_K, approx_knn=True))
    emit("kernel_approx_knn", tolerance=f"max|k-p| <= {TOL}*max|p|", errors=errs, k5_ms=k5_ms, k9_ms=k9_ms,
         picks_differing_from_exact=share)
    return {"share": share}


def pool_tail_inputs(rng, batch: int, n_pts: int, emb: int, dtype):
    """The fused tail's operands as the train step hands them over: ReLU'd
    activations (many zeros, so a few critical points win many channels),
    conv5's W (K, E) and c, on the card in ``dtype``."""
    x = np.maximum(rng.normal(size=(batch, n_pts, K_TAIL)), 0.0).astype(np.float32)
    w = rng.normal(0.0, K_TAIL**-0.5, (K_TAIL, emb)).astype(np.float32)
    c = rng.normal(0.0, 0.1, emb).astype(np.float32)
    return [torch.from_numpy(a).cuda().to(dtype) for a in (x, w, c)]


def library_pool_stats(x, w, c):
    """Yardstick only, never used by the port: z materialized by
    torch.matmul, torch.max/min with indices, x^T x and the column sum,
    eagerly in x's dtype."""
    z = torch.matmul(x, w) + c
    mx, amax = torch.max(z, dim=1)
    mn, amin = torch.min(z, dim=1)
    flat = x.reshape(-1, x.shape[-1])
    return mx, mn, amax, amin, flat.t() @ flat, flat.sum(0)


def k3_bound(x, w) -> tuple[float, str]:
    """K3's bound: z's and G's multiply-adds (for f32 operands the three
    bf16 products of each hi/lo split, as the kernel computes them); x, W
    and c read once, the four (B, E) outputs, G and the column sum written
    once."""
    B, N, K = x.shape
    E = w.shape[1]
    flops = 2.0 * B * N * K * (E + K) * (3 if x.dtype == torch.float32 else 1)
    nbytes = (x.numel() + w.numel()) * x.element_size() + 4 * E + 4 * 4 * B * E + 4 * (K * K + K)
    return bound(flops, nbytes)


def pool_stats_errors(got, want, x, w, c, what) -> dict:
    mx, mn, amax, amin, G, cs = got
    scale = max(want[0].abs().max().item(), want[1].abs().max().item())
    abs_err = max((mx - want[0]).abs().max().item(), (mn - want[1]).abs().max().item())
    require(abs_err <= TOL * scale, f"K3 {what}: max/min err {abs_err} > {TOL} * {scale}")
    sums = {}
    for key, g, r in (("G", G, want[4]), ("colsum", cs, want[5])):
        sums[key] = (g - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
        require(sums[key] <= POOL_SUM_TOL, f"K3 {what}: {key} rel err {sums[key]}")
    n_pts = x.shape[1]
    z = torch.matmul(x.float(), w.float()) + c.float()
    at_err = 0.0
    for ai, ref in ((amax, want[0]), (amin, want[1])):
        require(ai.dtype == torch.int32 and int(ai.min()) >= 0 and int(ai.max()) < n_pts, f"K3 {what}: index range")
        at = torch.gather(z, 1, ai.long()[:, None, :])[:, 0]
        at_err = max(at_err, (at - ref).abs().max().item())
    require(at_err <= TOL * scale, f"K3 {what}: z at the kernel's argmax/argmin off the plain max/min by {at_err}")
    differ = 0.5 * ((amax != want[2]).float().mean().item() + (amin != want[3]).float().mean().item())
    return {"abs": abs_err, "rel": abs_err / scale, "G_rel": sums["G"], "colsum_rel": sums["colsum"],
            "z_at_index_rel": at_err / scale, "indices_differing": differ}


def phase_kernel_k3(rng) -> tuple[dict, dict]:
    """K3 against its plain version; returns the result and, per case, the
    inputs and the kernel's outputs (K4 takes its indices from them)."""
    from learning3d_tpu_torch.kernels.poolgrad import pool_stats, pool_stats_reference

    shapes = {"full": (B, N, torch.bfloat16), "f32": (B, N, torch.float32), "ragged": (3, 1000, torch.bfloat16)}
    errs, cases = {}, {}
    with torch.inference_mode():
        for name, (b, n, dt) in shapes.items():
            x, w, c = pool_tail_inputs(rng, b, n, EMB, dt)
            got = pool_stats(x, w, c)
            want = pool_stats_reference(x, w, c)
            torch.cuda.synchronize()
            errs[name] = pool_stats_errors(got, want, x, w, c, name)
            cases[name] = ((x, w, c), got)
            del want
        x, w, c = cases["full"][0]
        k_ms = cuda_ms(lambda: pool_stats(x, w, c))
        p_ms = cuda_ms(lambda: pool_stats_reference(x, w, c), reps=3, warmup=1)
        l_ms = cuda_ms(lambda: library_pool_stats(x, w, c))
        xf, wf, cf = cases["f32"][0]
        f32_ms = cuda_ms(lambda: pool_stats(xf, wf, cf))
        f32_plain_ms = cuda_ms(lambda: pool_stats_reference(xf, wf, cf), reps=3, warmup=1)
        f32_library_ms = cuda_ms(lambda: library_pool_stats(xf, wf, cf))
    bound_ms, bound_by = k3_bound(x, w)
    f32_bound = k3_bound(xf, wf)[0]
    result = {
        "max_abs_err": max(e["abs"] for e in errs.values()), "max_rel_err": max(e["rel"] for e in errs.values()),
        "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit("kernel", name="pool_stats_pallas",
         tolerance=f"max/min and z at the indices <= {TOL}*max|plain|; G, colsum <= {POOL_SUM_TOL}*max|plain|",
         shape={"B": B, "N": N, "K": K_TAIL, "E": EMB}, errors=errs, f32_kernel_ms=f32_ms, f32_bound_ms=f32_bound,
         f32_plain_ms=f32_plain_ms, f32_library_ms=f32_library_ms,
         library="eager torch.matmul (z materialized) + torch.max/min with indices + x^T x, yardstick only",
         **result)
    return result, cases


def library_pool_bwd(idx, dsel, w, x):
    """Yardstick only, never used by the port: index_add_ of the dsel-scaled
    weight columns and a gathered einsum."""
    Bq, Nq, K = x.shape
    E = idx.shape[1]
    il = idx.long()
    rows = (il + Nq * torch.arange(Bq, device=x.device)[:, None]).reshape(-1)
    vals = (dsel[:, :, None] * w.t()[None].float()).reshape(Bq * E, K)
    dx = torch.zeros(Bq * Nq, K, device=x.device).index_add_(0, rows, vals)
    x_sel = torch.gather(x, 1, il[:, :, None].expand(Bq, E, K))
    return dx.view(Bq, Nq, K), torch.einsum("bek,be->ke", x_sel.float(), dsel)


def k4_bound(idx, w, x) -> tuple[float, str]:
    """K4's bound: dx_sp and dW_sel written once, idx, dsel and W read
    once, and the x rows this run's indices pick (each distinct row once);
    2 * B * E * K f32 multiply-adds on the CUDA cores."""
    Bq, Nq, K = x.shape
    E = idx.shape[1]
    rows = (idx.long() + Nq * torch.arange(Bq, device=x.device)[:, None]).unique().numel()
    nbytes = 4 * Bq * Nq * K + 4 * K * E + 8 * Bq * E + w.numel() * w.element_size() + rows * K * x.element_size()
    return bound(0.0, nbytes, f32_flops=4.0 * Bq * E * K)


def phase_kernel_k4(rng, k3_cases) -> dict:
    from learning3d_tpu_torch.kernels.poolgrad import pool_bwd, pool_bwd_reference

    cases = {name: (inp[0], inp[1], out[2]) for name, (inp, out) in k3_cases.items()}
    x, w, _ = k3_cases["full"][0]
    cases["one_point"] = (x, w, torch.full((B, EMB), 17, dtype=torch.int32, device="cuda"))
    errs = {}
    with torch.inference_mode():
        for name, (x, w, idx) in cases.items():
            dsel = torch.from_numpy(rng.normal(size=idx.shape).astype(np.float32)).cuda()
            dx, dw = pool_bwd(idx, dsel, w, x)
            want_dx, want_dw = pool_bwd_reference(idx, dsel, w, x)
            torch.cuda.synchronize()
            a1, r1 = check_close(dx, want_dx, f"K4 dx_sp ({name})", POOL_SUM_TOL)
            a2, r2 = check_close(dw, want_dw, f"K4 dW_sel ({name})", POOL_SUM_TOL)
            touched = torch.zeros(x.shape[:2], dtype=torch.bool, device="cuda").scatter_(1, idx.long(), True)
            require(bool((dx[~touched] == 0).all()), f"K4 ({name}): untouched rows of dx_sp are 0")
            errs[name] = {"abs": max(a1, a2), "rel": max(r1, r2), "dx_rel": r1, "dW_rel": r2}
            if name == "full":
                full = (idx, dsel, w, x)
        k_ms = cuda_ms(lambda: pool_bwd(*full))
        p_ms = cuda_ms(lambda: pool_bwd_reference(*full), reps=5)
        l_ms = cuda_ms(lambda: library_pool_bwd(*full), reps=5)
    bound_ms, bound_by = k4_bound(full[0], full[2], full[3])
    result = {
        "max_abs_err": max(e["abs"] for e in errs.values()), "max_rel_err": max(e["rel"] for e in errs.values()),
        "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit("kernel", name="pool_bwd_pallas", tolerance=f"dx_sp, dW_sel <= {POOL_SUM_TOL}*max|plain|",
         shape={"B": B, "N": N, "K": K_TAIL, "E": EMB}, errors=errs,
         distinct_rows_picked=int((full[0].long() + N * torch.arange(B, device="cuda")[:, None]).unique().numel()),
         library="index_add_ + gathered einsum (f32), yardstick only", **result)
    return result


@contextlib.contextmanager
def plain_poolgrad():
    """Route the train-mode fused tail to K3's and K4's plain versions (on
    the same card); restored on exit."""
    from learning3d_tpu_torch.kernels import poolgrad
    from learning3d_tpu_torch.utils import layers

    saved = layers.pool_stats, layers.pool_bwd
    layers.pool_stats, layers.pool_bwd = poolgrad.pool_stats_reference, poolgrad.pool_bwd_reference
    try:
        yield
    finally:
        layers.pool_stats, layers.pool_bwd = saved


@contextlib.contextmanager
def k6_bf16_output():
    """The control of the DCP step's check: K6 with its f32 output rounded
    to bf16, the value a bf16 store in the kernel would give, as if the
    kernel computed below the configuration's f32."""
    from learning3d_tpu_torch.kernels import attention

    kernel = attention.attention_pallas
    attention.attention_pallas = lambda q, k, v: kernel(q, k, v).to(torch.bfloat16).to(q.dtype)
    try:
        yield
    finally:
        attention.attention_pallas = kernel


def step_runs(make_trainer, batch, contexts) -> list:
    """(loss, gradients, buffers) of one forward and backward through a
    fresh trainer inside each context."""
    runs = []
    for ctx in contexts:
        trainer = make_trainer()
        with ctx():
            loss, _ = trainer.forward_backward(batch)
        torch.cuda.synchronize()
        trainer.close()
        grads = {n: p.grad for n, p in trainer.model.named_parameters()}
        runs.append((loss.float().item(), grads, dict(trainer.model.named_buffers())))
    return runs


def step_differences(run, ref, tol, zero_gradient, noise_tol) -> tuple[dict, dict]:
    """Per-tensor relative errors of one (loss, gradients, buffers) run
    against a reference run: (the worst of each kind, the tensors past
    their limit)."""
    (lk, gk, bk), (lp, gp, bp) = run, ref
    worst = {"loss": abs(lk - lp) / abs(lp), "grad": 0.0, "zero_gradient_bias": 0.0, "running": 0.0}
    failed = {}
    for name, g in gk.items():
        err = (g - gp[name]).norm().item()
        if name in zero_gradient:
            rel = err / gp[name.rsplit(".", 1)[0] + ".weight"].norm().item()
            key, limit = "zero_gradient_bias", noise_tol
        else:
            rel, key, limit = err / gp[name].norm().item(), "grad", tol
        if rel >= worst[key]:
            worst[key], worst[f"{key}_tensor"] = rel, name
        if not rel <= limit:
            failed[name] = rel
    for name, b in bk.items():
        rel = (b - bp[name]).abs().max().item() / max(bp[name].abs().max().item(), 1e-30)
        worst["running"] = max(worst["running"], rel)
        if not rel <= tol:
            failed[name] = rel
    return worst, failed


def step_agreement(make_trainer, batch, tol, plain, zero_gradient=ZERO_GRADIENT_BIASES, noise_tol=NOISE_TOL,
                   what="train step", control=None) -> dict:
    """One forward and backward through the Trainer on the kernels against
    the same on their plain versions (the context ``plain``; fresh trainers:
    same weights, the same augmentation and dropout generators): loss, every
    gradient and the BN running statistics, per-tensor relative error; the
    ``zero_gradient`` biases against their layer's weight gradient. A
    ``control`` context, if given, is a known departure from the plain
    versions that the tolerance must catch: its step is run as well and
    must fail the comparison."""
    runs = step_runs(make_trainer, batch, (contextlib.nullcontext, plain) + ((control,) if control else ()))
    worst, failed = step_differences(runs[0], runs[1], tol, zero_gradient, noise_tol)
    require(np.isfinite(runs[0][0]) and worst["loss"] <= tol, f"{what}: loss {runs[0][0]} vs plain {runs[1][0]}")
    require(not failed, f"{what}: kernels vs plain versions {failed}")
    if control:
        caught, failed = step_differences(runs[2], runs[1], tol, zero_gradient, noise_tol)
        require(bool(failed) or caught["loss"] > tol, f"{what}: the control passed the tolerance {tol}: {caught}")
        worst["control"] = {"loss": caught["loss"], "grad": caught["grad"], "grad_tensor": caught["grad_tensor"],
                            "tensors_failed": len(failed)}
    return worst


def time_train_step(trainer, batch, reps: int = 5, unit: str = "clouds") -> dict:
    """The step's parts on one device batch, CUDA events: forward
    (augmentation, if any, and loss), backward (with the gradient guard),
    optimizer; and the whole step on the host clock, with its rate in
    ``unit`` (batch items) a second."""
    params = [p for p in trainer.model.parameters() if p.requires_grad]
    parts = {"forward_ms": [], "backward_ms": [], "optimizer_ms": []}
    trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for p in params:
            p.grad = None
        ev[0].record()
        b = batch if trainer.augment_fn is None else trainer.augment_fn(trainer.generator, batch)
        loss, _ = trainer.loss_fn(trainer.model, b, trainer.generator)
        ev[1].record()
        loss.backward()
        trainer.guard_grads([p.grad for p in params])
        ev[2].record()
        trainer.update()
        ev[3].record()
        ev[3].synchronize()
        for key, (a, z) in zip(parts, zip(ev, ev[1:])):
            parts[key].append(a.elapsed_time(z))
    step_s = (time.perf_counter() - t0) / reps
    out = {k: statistics.median(v) for k, v in parts.items()}
    out["step_ms"] = 1e3 * step_s
    out[f"{unit}_per_s"] = batch[0].shape[0] / step_s
    return out


def check_trained(trainer, before) -> tuple[int, dict]:
    """After ``Trainer.fit``: the last epoch's loss finite, no step skipped
    by the non-finite guard, every weight and running statistic changed.
    -> (skipped steps, {tensor: changed})."""
    loss = trainer.history[-1]["train_loss"]
    require(np.isfinite(loss), f"train loss {loss}")
    skipped = int(trainer.skipped_steps)
    require(skipped == 0, f"{skipped} steps skipped as non-finite")
    after = trainer.model.state_dict()
    changed = {k: not torch.equal(before[k], after[k]) for k in before}
    require(all(v for k, v in changed.items() if k.endswith("weight") or "running" in k),
            f"unchanged after training: {[k for k, v in changed.items() if not v]}")
    return skipped, changed


def check_round_trip(trainer, make_resumed, data) -> None:
    """Save ``trainer`` as "latest" and restore it into a fresh Trainer made
    with resume="latest": the parameters, the buffers and the optimizer
    state come back exactly."""
    trainer.save("latest")
    again = make_resumed()
    with contextlib.redirect_stdout(sys.stderr):
        again.fit(data, epochs=0)  # makes the optimizer and restores the checkpoint; runs no epoch
    for k, v in trainer.model.state_dict().items():
        require(torch.equal(v, again.model.state_dict()[k]), f"round trip: {k}")
    saved, loaded = trainer.optimizer.state_dict(), again.optimizer.state_dict()
    for i, st in saved["state"].items():
        for key, v in st.items():
            require(torch.equal(v.cpu(), loaded["state"][i][key].cpu()), f"round trip: optimizer state {i}.{key}")
    again.close()


def phase_train(rng) -> dict:
    import dataclasses
    import tempfile

    from learning3d_tpu_torch.data import ClassificationData, SyntheticModelNet40, batch_iterator, to_device
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.models import Classifier, PointNet
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    state = random_nnx_state(rng, EMB, CLASSES)

    def build(dtype):
        model = Classifier(PointNet(emb_dims=EMB, use_bn=True, dtype=dtype), CLASSES, dtype=dtype,
                           dropout_generator=torch.Generator(device="cuda").manual_seed(SEED))
        return load_nnx_state(model, state)

    data = ClassificationData(SyntheticModelNet40(num_points=N, size=TRAIN_STEPS * B))
    kinds = {"bf16": torch.bfloat16, "f32": None}
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(exp_name="chip_smoke_train", batch_size=B, num_points=N, optimizer="adam", lr=TRAIN_LR,
                          epochs=1, augment=True, ckpt_dir=ckpt)
        trainer = Trainer(cfg, build(torch.bfloat16))
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # the Trainer's epoch line
            trainer.fit(data)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {k: LAUNCHES[k] for k in ("pool_stats_pallas", "pool_bwd_pallas")}
        require(all(v == TRAIN_STEPS for v in launches.values()), f"K3/K4 launches {launches} for {TRAIN_STEPS} steps")
        epoch = trainer.history[-1]
        skipped, changed = check_trained(trainer, before)

        batch = to_device(next(batch_iterator(data, B, seed=SEED)), "cuda")
        agreement = {}
        for kind, dtype in kinds.items():
            agreement[kind] = step_agreement(lambda: Trainer(cfg, build(dtype)), batch, STEP_TOL[kind], plain_poolgrad,
                                             what=f"train step {kind}")

        check_round_trip(trainer, lambda: Trainer(dataclasses.replace(cfg, resume="latest"), build(torch.bfloat16)),
                         data)
        timing = time_train_step(trainer, batch)
        trainer.close()
    # fit_s includes set-up (torch.optim imports torch._dynamo when the first
    # optimizer is built); the epoch's clouds/s includes the host's making of
    # the synthetic clouds, which the prefetch thread overlaps with the steps
    result = {"launches": launches, "train_loss": epoch["train_loss"], "train_accuracy": epoch["train_accuracy"],
              "fit_s": fit_s, "epoch_s": epoch["seconds"], "epoch_clouds_per_s": TRAIN_STEPS * B / epoch["seconds"],
              **timing}
    emit("train", config={"model": "Classifier(PointNet(1024, use_bn=True)) bf16", "B": B, "N": N, "optimizer": "adam",
                          "lr": TRAIN_LR, "augment": True, "steps": TRAIN_STEPS},
         dataset=data.data_class.version_tag(), skipped_steps=skipped, tensors_changed=sum(changed.values()),
         tensors=len(changed), step_vs_plain={k: {"tolerance": STEP_TOL[k], **v} for k, v in agreement.items()},
         roundtrip="exact", **result)
    return result


def library_edges(x, k):
    """Yardstick only, never used by the port: the edge features by an eager
    chain of torch.cdist, torch.topk over the distances and a gather, with
    the center beside each neighbor."""
    idx = torch.topk(torch.cdist(x, x), k, dim=-1, largest=False).indices
    B, n, _ = x.shape
    nbr = torch.gather(x, 1, idx.reshape(B, -1, 1).expand(-1, -1, 3)).reshape(B, n, k, 3)
    return torch.cat([nbr, x[:, :, None].expand(nbr.shape)], dim=-1)


def k7_bound(x, k) -> tuple[float, str]:
    """K7's bound: B N^2 distances of 8 f32 operations each and one
    comparison a distance to select (on the CUDA cores); x read once, the
    (B, N, k, 6) edge tensor written once."""
    B, n, _ = x.shape
    return bound(0.0, 4 * B * n * 3 + 4 * B * n * k * 6, f32_flops=9.0 * B * n * n)


def phase_kernel_k7(rng) -> dict:
    from learning3d_tpu_torch.kernels.edgeconv import edge_features, edge_features_reference

    cases = {
        "full": (rng.normal(size=(DCP_B, DCP_N, 3)).astype(np.float32), DCP_K),
        "ties": (lattice_cloud(rng, 2, 1000), DCP_K),
        "ragged": (rng.normal(size=(3, 1000, 3)).astype(np.float32), DCP_K),
        "k40": (rng.normal(size=(4, DCP_N, 3)).astype(np.float32), 40),
    }
    checked = {}
    with torch.inference_mode():
        for name, (x_np, k) in cases.items():
            x = torch.from_numpy(x_np).cuda()
            # distinct points: equal neighbor coordinates are equal indices
            require(all(torch.unique(c, dim=0).shape[0] == x.shape[1] for c in x), f"K7 ({name}): repeated points")
            edges = edge_features(x, k)
            want_edges = edge_features_reference(x, k)
            torch.cuda.synchronize()
            require(torch.equal(edges, want_edges), f"K7 vs plain ({name}): edge features differ")
            checked[name] = {"B": x.shape[0], "N": x.shape[1], "k": k}
        x = torch.from_numpy(cases["full"][0]).cuda()
        k_ms = cuda_ms(lambda: edge_features(x, DCP_K))
        p_ms = cuda_ms(lambda: edge_features_reference(x, DCP_K), reps=3, warmup=1)
        l_ms = cuda_ms(lambda: library_edges(x, DCP_K))
    bound_ms, bound_by = k7_bound(x, DCP_K)
    result = {"max_abs_err": 0.0, "max_rel_err": 0.0, "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
              "bound_ms": bound_ms, "bound_by": bound_by}
    emit("kernel", name="knn_neighbors_pallas", tolerance="edge features bit-equal (distinct points, so the same neighbor indices)",
         cases=checked, shape={"B": DCP_B, "N": DCP_N, "k": DCP_K, "out": "(B, N, k, 6) edge features"},
         library="eager torch.cdist + torch.topk + gather, yardstick only", **result)
    return result


def phase_train_dcp(rng) -> dict:
    import dataclasses
    import tempfile

    from learning3d_tpu_torch.data import RegistrationData, SyntheticModelNet40, batch_iterator, to_device
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.models import DCP, DGCNN
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    state = random_dcp_state(rng, DCP_EMB)

    def build():
        return load_nnx_state(DCP(DGCNN(emb_dims=DCP_EMB, k=DCP_K)), state)

    data = RegistrationData("DCP", SyntheticModelNet40(num_points=DCP_N, size=TRAIN_DCP_STEPS * DCP_B))
    test_data = RegistrationData("DCP", SyntheticModelNet40(num_points=DCP_N, size=DCP_B, train=False))
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(exp_name="chip_smoke_train_dcp", task="dcp", batch_size=DCP_B, num_points=DCP_N,
                          optimizer="adam", lr=TRAIN_LR, epochs=1, best_metric="rot_deg", ckpt_dir=ckpt)
        trainer = Trainer(cfg, build())
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # the Trainer's epoch line
            trainer.fit(data, test_data)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        forwards = TRAIN_DCP_STEPS + len(test_data) // DCP_B
        require(launches["knn_neighbors_pallas"] == 2 * forwards,
                f"K7 launched {launches['knn_neighbors_pallas']} times in {forwards} forwards (want 2 each)")
        require(launches["attention_pallas"] == 7 * forwards,
                f"K6 launched {launches['attention_pallas']} times in {forwards} forwards (want 7 each)")
        require(launches["dgcnn_encode_fused"] == 0, "K5 launched on the f32 path")
        epoch = trainer.history[-1]
        skipped, changed = check_trained(trainer, before)
        require(all(np.isfinite(epoch[k]) for k in ("test_loss", "test_rot_deg", "test_trans")),
                f"eval pass: {epoch}")

        batch = to_device(next(batch_iterator(data, DCP_B, seed=SEED)), "cuda")
        agreement = step_agreement(lambda: Trainer(cfg, build()), batch, DCP_STEP_TOL, plain_versions,
                                   DCP_ZERO_GRADIENT_BIASES, DCP_NOISE_TOL, what="DCP train step",
                                   control=k6_bf16_output)
        check_round_trip(trainer, lambda: Trainer(dataclasses.replace(cfg, resume="latest"), build()), data)
        trainer.model.train()  # fit ended on the eval pass
        torch.cuda.reset_peak_memory_stats()
        timing = time_train_step(trainer, batch, unit="pairs")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        trainer.close()
    # fit_s includes the eval pass and the best checkpoint's save; the
    # epoch's pairs/s includes the host's making of the synthetic clouds and
    # pairs, which the prefetch thread overlaps with the steps
    result = {"launches": {k: launches[k] for k in ("knn_neighbors_pallas", "attention_pallas")},
              "train_loss": epoch["train_loss"], "train_rot_deg": epoch["train_rot_deg"],
              "test_rot_deg": epoch["test_rot_deg"], "test_trans": epoch["test_trans"], "fit_s": fit_s,
              "epoch_s": epoch["seconds"], "epoch_pairs_per_s": TRAIN_DCP_STEPS * DCP_B / epoch["seconds"],
              "peak_memory_gib": peak_gib, **timing}
    emit("train_dcp", config={"model": "DCP(DGCNN(512, k=20)) f32, transformer pointer, SVD head", "B": DCP_B,
                              "N": DCP_N, "optimizer": "adam", "lr": TRAIN_LR, "steps": TRAIN_DCP_STEPS,
                              "eval_pairs": len(test_data)},
         dataset=f"RegistrationData(DCP) over {data.data_class.version_tag()}", skipped_steps=skipped,
         tensors_changed=sum(changed.values()), tensors=len(changed),
         step_vs_plain={"tolerance": DCP_STEP_TOL, "zero_gradient_bias_tolerance": DCP_NOISE_TOL, **agreement},
         roundtrip="exact", **result)
    return result


IPC_B, IPC_N, IPC_EMB, IPC_STARTS = 32, 1024, 1024, 8
IPC_REQUESTS = (32, 10, 70)
IPC_TRAIN_B, IPC_TRAIN_STEPS = 20, 4  # examples/train_pcrnet.py's batch
PCN_B, PCN_N, PCN_EMB, PCN_COARSE, PCN_TRAIN_STEPS = 32, 1024, 1024, 1024, 4
SFU_BOUND_EXPS_PER_PAIR_LEVEL = 2  # the TPU kernel's two passes a level, one exponential a pair each
EMD_F32_OPS_PER_PAIR_LEVEL = 43  # 11 in phase A, 32 in phase B/C (csrc/emd.cu's note)
EMD_LEVELS = 10
# bf16 iPCRNet on the kernels against the same model on the plain versions
# (K1's oracle, K12's plain version) at one refinement step, where K1 runs
# for the template and the source: max |k - p| <= IPCRNET_TOL * max |p| for
# est_T and per item |k - p| <= IPCRNET_TOL * p for the Chamfer score of
# every start. K1 and its plain version sum in another order, so a pooled
# feature can round to the neighbouring bf16 value (2^-8 of it), which the
# MLP carries into the pose. Past one step the random-weight model is
# chaotic (each step's pose is a random rotation, and K1 rounds the moved
# source to bf16 again: one f32 ulp of the source moved est_R by up to 11%
# after 8 steps on the CPU, tests/test_torch_pcrnet.py), so there the gate
# is K12 inside the selection: the 8-step candidates scored again on K12's
# plain version give the same scores bit for bit, so the same starts
IPCRNET_TOL = 5e-2
# bf16 iPCRNet builds each step's rotation in bf16 (qnormalize, quat2mat, as
# the JAX package does), so a step is a rotation only to bf16 rounding: an
# entry near 1 rounds by up to 2^-8, a row's norm by a few of those; allowing
# 2^-6 a step, the composed est_R of n steps has |R R^T - I| <=
# (1 + 2^-6)^(2n) - 1 (0.28 at n = 8). f32 est_R is held to ROT_TOL
IPC_BF16_STEP_ROT = 2.0**-6


def bf16_rotation_tol(steps: int) -> float:
    return (1.0 + IPC_BF16_STEP_ROT) ** (2 * steps) - 1.0


def rotation_error(R) -> float:
    """max |R R^T - I| and |det R - 1| over a batch of 3x3 matrices."""
    R = np.asarray(R, np.float64)
    return max(float(np.abs(R @ np.swapaxes(R, -1, -2) - np.eye(3)).max()),
               float(np.abs(np.linalg.det(R) - 1.0).max()))
# one f32 train step of iPCRNet or PCN on K12 against the same step on its
# plain version, per-tensor relative error: K12 is bit-equal, so the
# forward is the same; the Chamfer backward's scatter-adds add with atomics
# in another order on each run (f32 rounding, ~1e-7 of a value)
CHAMFER_STEP_TOL = 1e-4
# K13 against its plain version: the cost per item to rtol EMD_COST_TOL, g1
# and g2 to a mean relative error below EMD_GRAD_TOL (the JAX package's own
# bound for its kernel against _emd_fwd_impl): ratioL divides by sums that
# vanish at the sharpest levels, so a sum in another order can move one
# point's gradient a lot while the cost barely moves
EMD_COST_TOL, EMD_GRAD_TOL = 1e-4, 5e-2


def random_linear(flat, rng, prefix, i, o):
    flat[f"{prefix}.kernel"] = rng.normal(0.0, i**-0.5, (i, o)).astype(np.float32)
    flat[f"{prefix}.bias"] = rng.normal(0.0, 0.1, (o,)).astype(np.float32)


def random_ipcrnet_state(rng, emb: int = IPC_EMB) -> dict:
    """A flat nnx state of iPCRNet(PointNet(emb, use_bn=False)) with
    numpy-seeded weights."""
    flat = {}
    dims = [3, 64, 64, 64, 128, emb]
    for k, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
        random_linear(flat, rng, f"feature_model.convs.{k}", i, o)
    dims = [2 * emb, 1024, 1024, 512, 512, 256]
    for k, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
        random_linear(flat, rng, f"linears.{k}", i, o)
    random_linear(flat, rng, "head", 256, 7)
    return flat


def random_pcn_state(rng, emb: int = PCN_EMB, num_coarse: int = PCN_COARSE, detailed: bool = False) -> dict:
    """A flat nnx state of PCN(emb, num_coarse) with numpy-seeded weights,
    the folding decoder's too if ``detailed``."""
    flat = {}
    for name, i, o in (("conv1", 3, 128), ("conv2", 128, 256), ("conv3", 512, 512), ("conv4", 512, emb),
                       ("linear1", emb, 1024), ("linear2", 1024, 1024), ("linear3", 1024, 3 * num_coarse)):
        random_linear(flat, rng, name, i, o)
    if detailed:
        for name, i, o in (("conv5", emb + 5, 512), ("conv6", 512, 512), ("conv7", 512, 3)):
            random_linear(flat, rng, name, i, o)
    return flat


def library_nn(x, y):
    """Yardstick only, never used by the port: torch.cdist, then the
    minimum over the other cloud with its index."""
    return torch.min(torch.cdist(x, y), dim=-1)


def k12_bound(b, n, m) -> tuple[float, str]:
    """K12's bound: B N M distances of 8 f32 operations each and one
    comparison a distance (on the CUDA cores); x and y read once, the
    (B, N) distances and indices written once."""
    return bound(0.0, 4 * b * (n + m) * 3 + 8 * b * n, f32_flops=9.0 * b * n * m)


def phase_kernel_k12(rng) -> dict:
    from learning3d_tpu_torch.kernels.chamfer import _nn_oneway_reference, nn_oneway

    def normal(b, n):
        return rng.normal(size=(b, n, 3)).astype(np.float32)

    cases = {
        "multistart": (normal(IPC_STARTS * IPC_B, IPC_N), normal(IPC_STARTS * IPC_B, IPC_N)),
        "fine_points_to_fine": (normal(PCN_B, PCN_N), normal(PCN_B, 16 * PCN_COARSE)),
        "ragged": (normal(3, 1000), normal(3, 136)),
        "ties": (lattice_cloud(rng, 2, 1000), lattice_cloud(rng, 2, 700)),
    }
    cases["fine_to_points"] = cases["fine_points_to_fine"][::-1]
    checked = {}
    with torch.inference_mode():
        for name, (x_np, y_np) in cases.items():
            x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()
            d, i = nn_oneway(x, y)
            want_d, want_i = _nn_oneway_reference(x, y)
            torch.cuda.synchronize()
            require(torch.equal(d, want_d), f"K12 vs plain ({name}): distances differ")
            require(torch.equal(i, want_i), f"K12 vs plain ({name}): indices differ")
            checked[name] = {"B": x.shape[0], "N": x.shape[1], "M": y.shape[1]}
            del want_d, want_i
        x, y = (torch.from_numpy(a).cuda() for a in cases["multistart"])
        k_ms = cuda_ms(lambda: nn_oneway(x, y))
        p_ms = cuda_ms(lambda: _nn_oneway_reference(x, y), reps=3, warmup=1)
        l_ms = cuda_ms(lambda: library_nn(x, y), reps=5)
        xf, yf = (torch.from_numpy(a).cuda() for a in cases["fine_points_to_fine"])
        fine_ms = {"points_to_fine": cuda_ms(lambda: nn_oneway(xf, yf), reps=5),
                   "fine_to_points": cuda_ms(lambda: nn_oneway(yf, xf), reps=5)}
    bound_ms, bound_by = k12_bound(*x.shape[:2], y.shape[1])
    fine_bound = k12_bound(PCN_B, PCN_N, 16 * PCN_COARSE)[0]
    result = {"max_abs_err": 0.0, "max_rel_err": 0.0, "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
              "bound_ms": bound_ms, "bound_by": bound_by}
    emit("kernel_k12", name="_nn_oneway_pallas", tolerance="distances bit-equal, indices equal", cases=checked,
         shape={"B": x.shape[0], "N": x.shape[1], "M": y.shape[1], "note": "multistart: 8 starts x 32 pairs"},
         fine_kernel_ms=fine_ms, fine_bound_ms=fine_bound,
         library="torch.cdist + torch.min over the other cloud, yardstick only", **result)
    return result


def k13_bound(b, n, m) -> tuple[float, str]:
    """K13's bound: 2 * 10 * B N M exponentials on the SFU (the TPU
    kernel's two passes a level) or 43 f32 operations a pair and level on
    the CUDA cores, whichever takes longer; x and y read once, cost, g1
    and g2 written once."""
    pairs = float(b) * n * m * EMD_LEVELS
    exp_s = SFU_BOUND_EXPS_PER_PAIR_LEVEL * pairs / SFU_EXP_PER_S
    f32_s = EMD_F32_OPS_PER_PAIR_LEVEL * pairs / PEAK_F32_FLOPS
    bytes_s = (4 * b * (n + m) * 3 * 2 + 4 * b) / PEAK_BYTES
    return 1e3 * max(exp_s, f32_s, bytes_s), "operations" if max(exp_s, f32_s) >= bytes_s else "bytes"


def emd_errors(got, want, what) -> dict:
    (c, g1, g2), (wc, wg1, wg2) = got, want
    require(all(bool(torch.isfinite(t).all()) for t in (c, g1, g2)), f"K13 {what}: outputs finite")
    cost_rel = ((c - wc).abs() / wc.abs()).max().item()
    require(cost_rel <= EMD_COST_TOL, f"K13 {what}: cost rel err {cost_rel} > {EMD_COST_TOL}")
    grads = {}
    for key, g, w in (("g1", g1, wg1), ("g2", g2, wg2)):
        require(g.shape == w.shape, f"K13 {what}: {key} shape")
        grads[key] = ((g - w).abs().mean() / w.abs().mean()).item()
        require(grads[key] < EMD_GRAD_TOL, f"K13 {what}: {key} mean rel err {grads[key]} >= {EMD_GRAD_TOL}")
    return {"abs": (c - wc).abs().max().item(), "rel": cost_rel, "g1_mean_rel": grads["g1"],
            "g2_mean_rel": grads["g2"]}


def phase_kernel_k13(rng) -> dict:
    from learning3d_tpu_torch.kernels.emd import _emd_fwd_reference, emd_kernel

    shapes = {"pcn": (PCN_B, PCN_N, PCN_COARSE), "n_gt_m": (3, 1000, 300), "n_lt_m": (2, 250, 1000)}
    errs = {}
    with torch.inference_mode():
        for name, (b, n, m) in shapes.items():
            x, y = (torch.from_numpy(rng.normal(size=(b, k, 3)).astype(np.float32)).cuda() for k in (n, m))
            got = emd_kernel(x, y)
            want = _emd_fwd_reference(x, y)
            torch.cuda.synchronize()
            errs[name] = emd_errors(got, want, name)
            if name == "pcn":
                full = (x, y)
        k_ms = cuda_ms(lambda: emd_kernel(*full), reps=5)
        p_ms = cuda_ms(lambda: _emd_fwd_reference(*full), reps=2, warmup=1)
    bound_ms, bound_by = k13_bound(PCN_B, PCN_N, PCN_COARSE)
    result = {"max_abs_err": max(e["abs"] for e in errs.values()), "max_rel_err": max(e["rel"] for e in errs.values()),
              "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    emit("kernel_k13", name="_emd_fwd_pallas",
         tolerance=f"cost rel <= {EMD_COST_TOL}; g1, g2 mean rel < {EMD_GRAD_TOL}", errors=errs,
         shape={"B": PCN_B, "N": PCN_N, "M": PCN_COARSE, "note": "PCN's coarse EMD loss"},
         library="none: no one PyTorch call computes approxmatch", **result)
    return result


def ipcrnet_agreement(model, template, source, rots, what) -> dict:
    """The gates of bf16 iPCRNet serving against the plain versions (see
    IPCRNET_TOL): the multistart candidates at the model's own step count
    rescored on K12's plain version (bit-equal scores), then the forward and
    every start's est_T and score at one step, kernels against plain; the
    picked start must agree wherever the plain run's two best scores lie
    more than twice the tolerance apart."""
    from learning3d_tpu_torch.serve import chamfer_scores, multistart_scores

    total, scores = multistart_scores(model, template, source, rots)
    with plain_versions():
        rescored = chamfer_scores(total, template, source)
    require(torch.equal(rescored, scores), f"{what}: K12's scores differ from its plain version's")
    iters = model.default_iterations
    model.default_iterations = 1
    try:
        first, (k_total, k_scores) = model(template, source), multistart_scores(model, template, source, rots)
        with plain_versions():
            plain, (p_total, p_scores) = model(template, source), multistart_scores(model, template, source, rots)
    finally:
        model.default_iterations = iters
    est_err = max((k - p).abs().max().item() / p.abs().max().item()
                  for k, p in ((first["est_T"], plain["est_T"]), (k_total, p_total)))
    require(est_err <= IPCRNET_TOL, f"{what}: one-step est_T rel err {est_err} > {IPCRNET_TOL}")
    score_err = ((k_scores - p_scores).abs() / p_scores).max().item()
    require(score_err <= IPCRNET_TOL, f"{what}: one-step chamfer score rel err {score_err} > {IPCRNET_TOL}")
    best2 = torch.topk(p_scores, 2, dim=0, largest=False).values
    apart = (best2[1] - best2[0]) > 2 * IPCRNET_TOL * best2[0]
    pick, plain_pick = k_scores.argmin(0), p_scores.argmin(0)
    require(bool((pick == plain_pick)[apart].all()), f"{what}: start_idx differs where the scores lie apart")
    return {"rescored_bit_equal": True, "one_step_est_T_rel": est_err, "one_step_chamfer_rel": score_err,
            "starts_apart": int(apart.sum()), "starts_differing": int((pick != plain_pick).sum()),
            "of": int(pick.numel())}


def phase_serve_ipcrnet(rng) -> dict:
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.models import PointNet, iPCRNet
    from learning3d_tpu_torch.serve import InferenceEngine, multistart_register, multistart_scores, rotation_starts
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    bf16 = torch.bfloat16
    model = load_nnx_state(iPCRNet(PointNet(emb_dims=IPC_EMB, dtype=bf16), dtype=bf16),
                           random_ipcrnet_state(rng)).eval()
    engine = InferenceEngine(model, batch_size=IPC_B)
    requests = [(rng.normal(size=(n, IPC_N, 3)).astype(np.float32), rng.normal(size=(n, IPC_N, 3)).astype(np.float32))
                for n in IPC_REQUESTS]
    chunks = sum(-(-n // IPC_B) for n in IPC_REQUESTS)
    iters = model.default_iterations
    reset_launches()
    outs = [engine(t, s) for t, s in requests]
    torch.cuda.synchronize()
    launches = LAUNCHES["pointnet_pooled_kernel"]
    require(launches == (1 + iters) * chunks, f"K1 launched {launches} times for {chunks} chunks (want 9 a chunk)")
    rot_err, rot_tol = 0.0, bf16_rotation_tol(iters)
    for (t, _), out in zip(requests, outs):
        require(out["est_T"].shape == (t.shape[0], 4, 4) and out["r"].shape == (t.shape[0], IPC_EMB), "result shapes")
        for key, val in out.items():
            require(bool(np.isfinite(val).all()), f"every {key} finite")
        rot_err = max(rot_err, rotation_error(out["est_R"]))
    require(rot_err <= rot_tol, f"est_R not a rotation to bf16 rounding: {rot_err} > {rot_tol}")

    rots = rotation_starts(IPC_STARTS)
    t_dev, s_dev = (torch.from_numpy(a[:IPC_B]).cuda() for a in requests[0])
    with torch.inference_mode():
        reset_launches()
        ms = multistart_register(model, t_dev, s_dev, rots)
        torch.cuda.synchronize()
        ms_launches = {k: LAUNCHES[k] for k in ("pointnet_pooled_kernel", "_nn_oneway_pallas")}
        require(ms_launches == {"pointnet_pooled_kernel": 1 + iters, "_nn_oneway_pallas": 2},
                f"multistart launches {ms_launches} (want K1 9, K12 2)")
        require(all(bool(torch.isfinite(v.float()).all()) for v in ms.values()), "multistart outputs finite")
        total, scores = multistart_scores(model, t_dev, s_dev, rots)
        require(torch.equal(scores.min(0).values, ms["chamfer"]) and torch.equal(scores.argmin(0), ms["start_idx"])
                and torch.equal(total[ms["start_idx"], torch.arange(IPC_B, device="cuda")], ms["est_T"]),
                "multistart's result is its best start's")
        require(rotation_error(ms["est_T"][:, :3, :3].cpu()) <= rot_tol, "multistart est_T's rotation")
        agree = ipcrnet_agreement(model, t_dev, s_dev, rots, "serve_ipcrnet")
        model_ms = cuda_ms(lambda: model(t_dev, s_dev), reps=5)
        ms_ms = cuda_ms(lambda: multistart_register(model, t_dev, s_dev, rots), reps=3, warmup=1)
        with plain_versions():
            plain_model_ms = cuda_ms(lambda: model(t_dev, s_dev), reps=3, warmup=1)
    engine(*requests[0])
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine(*requests[0])
    host_s = (time.perf_counter() - t0) / reps
    result = {"launches": launches, "multistart_launches": ms_launches}
    emit("serve_ipcrnet", config={"model": "iPCRNet(PointNet(1024, use_bn=False)) bf16 eval, 8 iterations",
                                  "B": IPC_B, "N": IPC_N, "starts": IPC_STARTS},
         requests=list(IPC_REQUESTS), chunks=chunks, launches=launches, multistart_launches=ms_launches,
         tolerance=f"one step: est_T, chamfer scores <= {IPCRNET_TOL} (relative); 8 steps: K12 rescoring bit-equal",
         agree=agree,
         rotation={"max_RRt_minus_I_or_det": rot_err, "tolerance": rot_tol}, pairs_per_s=IPC_B / host_s,
         engine_ms=1e3 * host_s,
         model_ms=model_ms, plain_model_ms=plain_model_ms, multistart_ms=ms_ms,
         multistart_pairs_per_s=IPC_B / (ms_ms * 1e-3),
         start_idx_counts=np.bincount(ms["start_idx"].cpu().numpy(), minlength=IPC_STARTS).tolist())
    return result


def phase_train_ipcrnet(rng) -> dict:
    import tempfile

    from learning3d_tpu_torch.data import RegistrationData, SyntheticModelNet40, batch_iterator, to_device
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.models import PointNet, iPCRNet
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    state = random_ipcrnet_state(rng)

    def build():
        return load_nnx_state(iPCRNet(PointNet(emb_dims=IPC_EMB)), state)

    data = RegistrationData("iPCRNet", SyntheticModelNet40(num_points=IPC_N, size=IPC_TRAIN_STEPS * IPC_TRAIN_B))
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(exp_name="chip_smoke_train_ipcrnet", task="ipcrnet", batch_size=IPC_TRAIN_B,
                          num_points=IPC_N, optimizer="adam", lr=TRAIN_LR, epochs=1, ckpt_dir=ckpt)
        trainer = Trainer(cfg, build())
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        reset_launches()
        with contextlib.redirect_stdout(sys.stderr):  # the Trainer's epoch line
            trainer.fit(data)
        torch.cuda.synchronize()
        launches = LAUNCHES["_nn_oneway_pallas"]
        require(launches == 2 * IPC_TRAIN_STEPS, f"K12 launched {launches} times in {IPC_TRAIN_STEPS} steps")
        require(LAUNCHES["pointnet_pooled_kernel"] == 0, "K1 launched on the f32 train path")
        epoch = trainer.history[-1]
        skipped, changed = check_trained(trainer, before)
        require(all(np.isfinite(epoch[k]) for k in ("train_rot_deg", "train_trans")), f"train metrics: {epoch}")
        batch = to_device(next(batch_iterator(data, IPC_TRAIN_B, seed=SEED)), "cuda")
        with torch.no_grad():
            f32_rot_err = rotation_error(trainer.model.eval()(*batch[:2])["est_R"].cpu())
        trainer.model.train()
        require(f32_rot_err <= ROT_TOL, f"f32 est_R not a rotation: {f32_rot_err}")
        agreement = step_agreement(lambda: Trainer(cfg, build()), batch, CHAMFER_STEP_TOL, plain_versions, (), 0.0,
                                   what="iPCRNet train step")
        timing = time_train_step(trainer, batch, unit="pairs")
        trainer.close()
    result = {"launches": launches, "train_loss": epoch["train_loss"], "train_rot_deg": epoch["train_rot_deg"],
              "epoch_s": epoch["seconds"], "f32_rotation_error": f32_rot_err, **timing}
    emit("train_ipcrnet", config={"model": "iPCRNet(PointNet(1024, use_bn=False)) f32, 8 iterations",
                                  "B": IPC_TRAIN_B, "N": IPC_N, "optimizer": "adam", "lr": TRAIN_LR,
                                  "steps": IPC_TRAIN_STEPS},
         dataset=f"RegistrationData(iPCRNet) over {data.data_class.version_tag()}", skipped_steps=skipped,
         tensors_changed=sum(changed.values()), tensors=len(changed),
         step_vs_plain={"tolerance": CHAMFER_STEP_TOL, **agreement}, **result)
    return result


def phase_train_pcn(rng) -> dict:
    import tempfile

    from learning3d_tpu_torch.data import ClassificationData, SyntheticModelNet40, batch_iterator, to_device
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.kernels.emd import _emd_fwd_reference
    from learning3d_tpu_torch.losses import emd_loss_mean
    from learning3d_tpu_torch.models import PCN
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    state = random_pcn_state(rng, detailed=True)
    coarse_state = {k: v for k, v in state.items() if not k.startswith(("conv5", "conv6", "conv7"))}

    def build(detailed=False):
        return load_nnx_state(PCN(emb_dims=PCN_EMB, num_coarse=PCN_COARSE, detailed_output=detailed),
                              state if detailed else coarse_state)

    data = ClassificationData(SyntheticModelNet40(num_points=PCN_N, size=PCN_TRAIN_STEPS * PCN_B))
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(exp_name="chip_smoke_train_pcn", task="pcn", batch_size=PCN_B, num_points=PCN_N,
                          optimizer="adam", lr=TRAIN_LR, epochs=1, ckpt_dir=ckpt)
        trainer = Trainer(cfg, build())
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        reset_launches()
        with contextlib.redirect_stdout(sys.stderr):  # the Trainer's epoch line
            trainer.fit(data)
        torch.cuda.synchronize()
        launches = {"coarse_fit": LAUNCHES["_nn_oneway_pallas"]}
        require(launches["coarse_fit"] == 2 * PCN_TRAIN_STEPS,
                f"K12 launched {launches['coarse_fit']} times in {PCN_TRAIN_STEPS} steps")
        epoch = trainer.history[-1]
        skipped, changed = check_trained(trainer, before)
        batch = to_device(next(batch_iterator(data, PCN_B, seed=SEED)), "cuda")
        agreement = {"coarse": step_agreement(lambda: Trainer(cfg, build()), batch, CHAMFER_STEP_TOL, plain_versions,
                                              (), 0.0, what="PCN train step")}
        timing = {"coarse": time_train_step(trainer, batch)}
        trainer.close()

        # one step of the detailed model: the fine Chamfer against 16384 points
        detailed = Trainer(cfg, build(detailed=True))
        detailed._ensure_optimizer(1)
        reset_launches()
        loss, aux = detailed.train_step(batch)
        torch.cuda.synchronize()
        launches["detailed_step"] = LAUNCHES["_nn_oneway_pallas"]
        require(launches["detailed_step"] == 4, f"K12 launched {launches['detailed_step']} times in a detailed step")
        require(np.isfinite(loss.item()) and all(np.isfinite(v.item()) for v in aux.values()),
                f"detailed step: {loss}, {aux}")
        require(int(detailed.skipped_steps) == 0, "detailed step skipped")
        agreement["detailed"] = step_agreement(lambda: Trainer(cfg, build(detailed=True)), batch, CHAMFER_STEP_TOL,
                                               plain_versions, (), 0.0, what="detailed PCN train step")
        torch.cuda.reset_peak_memory_stats()
        timing["detailed"] = time_train_step(detailed, batch, reps=3)
        timing["detailed"]["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        detailed.close()

    # the EMD loss on the coarse completion, forward and backward
    model = build()
    points = batch[0]
    emd = {}
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        reset_launches()
        coarse = model(points)["coarse_output"]
        coarse.retain_grad()
        with plain_versions() if plain else contextlib.nullcontext():
            loss = emd_loss_mean(points, coarse)
            loss.backward()
        torch.cuda.synchronize()
        emd["plain" if plain else "kernel"] = (loss.item(), coarse.grad.clone(), LAUNCHES["_emd_fwd_pallas"])
    (lk, gk, nk), (lp, gp, np_) = emd["kernel"], emd["plain"]
    require((nk, np_) == (1, 0), f"K13 launches {nk} (kernels), {np_} (plain) for one EMD loss")
    emd_rel = abs(lk - lp) / abs(lp)
    require(np.isfinite(lk) and emd_rel <= EMD_COST_TOL, f"EMD loss {lk} vs plain {lp}")
    grad_rel = ((gk - gp).abs().mean() / gp.abs().mean()).item()
    require(grad_rel < EMD_GRAD_TOL, f"EMD loss gradient mean rel err {grad_rel} >= {EMD_GRAD_TOL}")
    with torch.no_grad():
        coarse = model(points)["coarse_output"]
    emd_ms = cuda_ms(lambda: emd_loss_mean(points, coarse.detach().requires_grad_()).backward(), reps=5)
    launches["emd"] = nk
    result = {"launches": launches, "train_loss": epoch["train_loss"], "epoch_s": epoch["seconds"],
              "timing": timing, "emd_loss_ms": emd_ms}
    emit("train_pcn", config={"model": "PCN(emb 1024, num_coarse 1024) f32; detailed_output=True for one step",
                              "B": PCN_B, "N": PCN_N, "optimizer": "adam", "lr": TRAIN_LR,
                              "steps": PCN_TRAIN_STEPS},
         dataset=f"ClassificationData over {data.data_class.version_tag()}", skipped_steps=skipped,
         tensors_changed=sum(changed.values()), tensors=len(changed),
         step_vs_plain={"tolerance": CHAMFER_STEP_TOL, **agreement},
         emd={"loss": lk, "loss_rel_vs_plain": emd_rel, "grad_mean_rel_vs_plain": grad_rel,
              "tolerance": f"loss rel <= {EMD_COST_TOL}, gradient mean rel < {EMD_GRAD_TOL}"},
         **result)
    return result


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
    from learning3d_tpu_torch.quant import make_fused_quant_forward, quantize_dcp, quantize_pointnet_classifier
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
    calib = torch.from_numpy(rng.normal(size=(CALIB_CLOUDS, N, 3)).astype(np.float32)).cuda()
    fused = make_fused_quant_forward(quantize_pointnet_classifier(model, calib))
    k2 = phase_kernel_k2(fused, rng)
    int8_launches = phase_serve_int8(model, fused, rng)
    del model, fused

    dcp = DCP(DGCNN(emb_dims=DCP_EMB, k=DCP_K, dtype=bf16), dtype=bf16)
    load_nnx_state(dcp, random_dcp_state(rng, DCP_EMB))
    dcp.eval()
    k5 = phase_kernel_k5(dcp, rng)
    k6 = phase_kernel_k6(rng)
    dcp_launches = phase_serve_dcp(dcp, rng)
    calib_t, calib_s = (torch.from_numpy(rng.normal(size=(DCP_CALIB_PAIRS, DCP_N, 3)).astype(np.float32)).cuda()
                        for _ in range(2))
    qdcp = quantize_dcp(dcp, calib_t, calib_s, int8_pv=True, fused_layers=False)
    k9 = phase_kernel_k9(qdcp, rng)
    k10 = phase_kernel_k10(rng)
    dcp_int8_launches = phase_serve_dcp_variant("serve_dcp_int8", qdcp, rng, {
        "dgcnn_encode_fused_int8": 2, "attention_int8": 6, "attention_pallas": 1})
    del qdcp

    # bench.py's fused int8 DCP configurations: quantize_dcp's default
    # fused_layers=True, int8 and hybrid P.V; the approx clone is the hybrid
    # one with approx kNN switched on after calibration, as bench.py scopes
    # L3D_APPROX_KNN around the measurement only
    fused = {pv: quantize_dcp(dcp, calib_t, calib_s, int8_pv=pv, fused_layers=True) for pv in (True, False)}
    approx = quantize_dcp(dcp, calib_t, calib_s, int8_pv=False, fused_layers=True)
    approx.emb_nn.approx_knn = True
    with torch.inference_mode():
        feats = [fused[True].emb_nn(torch.from_numpy(rng.normal(size=(DCP_B, DCP_N, 3)).astype(np.float32)).cuda())
                 for _ in range(2)]
    k11 = phase_kernel_k11({pv: (q.pointer.enc_layers[0], q.pointer.dec_layers[0]) for pv, q in fused.items()},
                           feats)
    del feats
    per_chunk = {"dgcnn_encode_fused_int8": 2, "encoder_layer_int8": 2, "decoder_layer_int8": 2,
                 "attention_pallas": 1}
    fused_launches = phase_serve_dcp_variant("serve_dcp_int8_fused", fused[True], rng, per_chunk, FUSED_REQUESTS)
    phase_serve_dcp_variant("serve_dcp_int8_hybrid_fused", fused[False], rng, per_chunk, FUSED_REQUESTS)
    share = phase_approx_kernels(dcp, approx, rng)["share"]
    phase_serve_dcp_variant("serve_dcp_int8_hybrid_fused_approx", approx, rng, per_chunk, FUSED_REQUESTS,
                            picks_differing_from_exact=share)
    phase_serve_dcp_variant("serve_template", fused[False], rng, {**per_chunk, "dgcnn_encode_fused_int8": 1},
                            FUSED_REQUESTS, template=True)
    del fused, approx, dcp

    k3, k3_cases = phase_kernel_k3(rng)
    k4 = phase_kernel_k4(rng, k3_cases)
    del k3_cases
    train = phase_train(rng)
    k7 = phase_kernel_k7(rng)
    train_dcp = phase_train_dcp(rng)
    k12 = phase_kernel_k12(rng)
    k13 = phase_kernel_k13(rng)
    serve_ipc = phase_serve_ipcrnet(rng)
    train_ipc = phase_train_ipcrnet(rng)
    train_pcn = phase_train_pcn(rng)
    k12_launches = serve_ipc["multistart_launches"]["_nn_oneway_pallas"] + train_ipc["launches"] + \
        train_pcn["launches"]["coarse_fit"] + train_pcn["launches"]["detailed_step"]

    csrc = "learning3d_tpu_torch/kernels/csrc/"
    print(json.dumps({"kernels": [
        kernel_entry("pointnet_pooled_kernel", csrc + "pointnet_fused.cu",
                     "learning3d_tpu/kernels/pointnet_fused.py:205", launches, k1),
        kernel_entry("dgcnn_encode_fused", csrc + "dgcnn_fused.cu",
                     "learning3d_tpu/kernels/dgcnn_fused.py:205", dcp_launches["dgcnn_encode_fused"], k5),
        kernel_entry("attention_pallas", csrc + "attention.cu",
                     "learning3d_tpu/kernels/attention.py:61", dcp_launches["attention_pallas"], k6),
        kernel_entry("pointnet_pooled_int8", csrc + "pointnet_int8.cu",
                     "learning3d_tpu/kernels/pointnet_fused.py:128", int8_launches, k2),
        kernel_entry("dgcnn_encode_fused_int8", csrc + "dgcnn_int8.cu",
                     "learning3d_tpu/kernels/dgcnn_fused.py:455", dcp_int8_launches["dgcnn_encode_fused_int8"], k9),
        kernel_entry("attention_int8", csrc + "attention_int8.cu",
                     "learning3d_tpu/kernels/attention.py:222", dcp_int8_launches["attention_int8"], k10),
        kernel_entry("encoder_layer_int8", csrc + "transformer_int8.cu",
                     "learning3d_tpu/kernels/transformer_int8.py:274", fused_launches["encoder_layer_int8"],
                     k11["encoder"]),
        kernel_entry("decoder_layer_int8", csrc + "transformer_int8.cu",
                     "learning3d_tpu/kernels/transformer_int8.py:289", fused_launches["decoder_layer_int8"],
                     k11["decoder"]),
        kernel_entry("pool_stats_pallas", csrc + "poolgrad.cu", "learning3d_tpu/kernels/poolgrad.py:146",
                     train["launches"]["pool_stats_pallas"], k3),
        kernel_entry("pool_bwd_pallas", csrc + "poolgrad.cu", "learning3d_tpu/kernels/poolgrad.py:203",
                     train["launches"]["pool_bwd_pallas"], k4),
        kernel_entry("knn_neighbors_pallas", csrc + "edgeconv.cu", "learning3d_tpu/kernels/edgeconv.py:73",
                     train_dcp["launches"]["knn_neighbors_pallas"], k7),
        kernel_entry("_nn_oneway_pallas", csrc + "chamfer.cu", "learning3d_tpu/kernels/chamfer.py:65", k12_launches,
                     k12),
        kernel_entry("_emd_fwd_pallas", csrc + "emd.cu", "learning3d_tpu/kernels/emd.py:264",
                     train_pcn["launches"]["emd"], k13),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
