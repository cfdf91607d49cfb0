#!/usr/bin/env python3
"""Times of the port's redesigned kernels at the shapes of their main paths,
and of the models that run them, from one tree: the attention kernels K6
(attention_pallas) and K10 (attention_int8_kernel), the fused int8 pointer
layers K11a/K11b, K8 (knn_pallas), K1 (pointnet_pooled_kernel), K14
(fps_pallas), K9 (dgcnn_encode_int8_kernel), K5 (dgcnn_encode_fused), K17
(sinkhorn_log_pallas), K7 (knn_neighbors_pallas's edge features), K3
(pool_stats_pallas), K2 (pointnet_pooled_int8), K16 (ball_group_pallas), K15
(ball_query_pallas) and K4 (pool_bwd_pallas).

    python3 tools/torch_kernel_ab.py [--root TREE] [--label NAME]
        [--parts k6,k10,k11,serve,k8,k1,prnet,ipcrnet,k14,k9,flownet,dcp_int8,k5,k17,dcp_bf16,rpmnet,
                 k7,k3,dcp_f32,k2,k16,pointnet_int8,k15,k4,cls_step,k13]

(``tools/torch_attention_ab.py`` is the same script under its former name.)
``--root`` names the checkout whose ``learning3d_tpu_torch`` and
``chip_smoke.py`` are imported (default: this one), so that two versions
of the kernels are timed in one call on one card by running the script once
from each tree, in turns (a, b, b, a): the Python entries are the same in
both.

Shapes: K6 at the DCP pointer (B=32, H=4, N=M=1024, D=Dv=128) in bf16 and
f32, the SVD head (H=1, D=512, Dv=3), DCP(DGCNN(emb 1024))'s pointer
(D=Dv=256) and PRNet's f32 pointer (B=16, 768 queries against 1024 keys,
and back); K10 at the int8 pointer in both P.V modes; each at a tiny shape
(one block: B=H=1, N=M=128), which the host's work a call sets; and the
wrappers' preparation alone (K6's casts of f32 operands to bf16, K10's copy
of V). ``k11``: each of K11's launches alone and the whole encoder and
decoder layers in both P.V modes at the DCP shape (B=32, N=1024, d=512, 4
heads, ff 1024; ``sweep_torch_kernels.k11_stages``). ``serve``: ``model_ms``
of DCP quantized with fused_layers=True, int8 and hybrid P.V, on a device
batch (``profile_torch_serve.build``). ``k8``: K8 at ``chip_smoke.py``'s
timed shapes (PRNet's stages at B=16: C = 3, 64, 128 at N = 768 and 1024,
self searches, k=20; a cross-cloud search) and their sum over a PRNet
forward's 16 launches, and at FlowNet3D's three_nn (16 clouds of 2048
SyntheticSceneflow points among their 1024 farthest-point samples, k=3),
and at a tiny shape (32 points, the fixed cost of a call).
``k1``: K1 at B=256 and B=32 (N=1024, emb 1024) and at B=1, N=1 (the
fixed cost of a call). ``prnet``: ``model_ms`` of
PRNet() served at B=32. ``ipcrnet``: ``model_ms`` of bf16 iPCRNet at B=32 and
at the multi-start batch of 256 clouds, and ``multistart_register`` on 32
pairs from 8 starts. ``k14``: K14 at FlowNet3D's four shapes (sa1 (16, 2048
-> 1024), sa2 (16, 1024 -> 256), sa3 (16, 256 -> 64), sa4 (16, 64 -> 16) on
the SyntheticSceneflow clouds' own levels) and their sum over a forward's
six launches; where the tree has it, the chain floor at each shape (the
steps' reductions and barriers with no point work, ``fps_chain_floor``).
``k9``: K9 at the DCP shape (B=32, N=1024, k=20, emb 512,
numpy-seeded weights and scales), exact and approximate kNN. ``flownet``:
``model_ms`` of FlowNet3D() served at B=16. ``dcp_int8``: ``model_ms`` of DCP
quantized with fused_layers=False (unfused) and True (fused, int8 P.V) at
B=32. ``k5``: K5 at the DCP shape (B=32, N=1024, k=20, emb 512,
numpy-seeded folded weights), exact and approximate kNN, as the model calls
it (with the weight pack built once where the tree has one, else the
wrapper on folded weights), its device time by launch. ``k17``: K17 at
RPMNet's shape (J=K=1024, 5 iterations) at B = 1, 4 and 16 (the batch's
matrices in and past the 50 MB L2) and at B=16 with 0 and 1 iterations,
its device time and launches by kernel (the passes over the matrix).
``dcp_bf16``: ``model_ms`` of bf16 DCP at B=32. ``rpmnet``: ``model_ms`` of
served RPMNet() at B=16. ``k7``: K7's edge features at the DCP shape (B=32,
N=1024, k=20) and at k=40, device time by launch. ``k3``: K3 at the
classifier step's shape (B=256, N=1024, K=128, E=1024) in bf16 and f32,
device time by launch (the weight pack, f32's split, the statistics, the
sum of the partials). ``dcp_f32``: ``model_ms`` of the f32 DCP forward
(DCP(DGCNN(512, k=20)), the training path's, K7 twice) at B=32, in eval
mode. ``k2``: K2 at the int8 classifier's serving chunk (B=256, N=1024,
emb 1024) and at B=32, on a numpy-seeded int8 pack. ``k16``: K16 at RPMNet's
grouping (the template clouds of 16 pairs: 1024 queries among 1024 points, r
0.3, nsample 64, C=6), at N=20,000 (1/37 of the points as queries, r 0.1:
rows open across shared-memory chunks) and with rows of nsample 200.
``pointnet_int8``: ``model_ms`` of the served int8 classifier at B=256
(``profile_torch_serve.build("pointnet-int8")``, K2 and the head). ``k15``:
K15 at FlowNet3D's four shapes (sa1 (16, 1024 among 2048, r 0.5, 16), sa2
(16, 256 among 1024, r 1.0, 16), sa3 (16, 64 among 256, r 2.0, 8), sa4 (16,
16 among 64, r 4.0, 8) on the SyntheticSceneflow clouds' own levels), as
the kernel alone and through ``ops.geometry.query_ball_point`` (FlowNet3D's
call: int64 indices), and the sums over a forward's six launches, with the
SHA-256 of the int32 indices at the four shapes, and the host's
microseconds a call at sa4 in parts (``host_us``: the wrapper, the checks,
the allocation, the device and stream lookups, the C entry alone). ``k4``:
K4 at the classifier step's shape (B=256, N=1024, K=128, E=1024) in bf16
and f32 on K3's picks, device time by kernel (the wrapper's transpose of W
beside K4) and the transpose's host time, with the SHA-256 of dx_sp's and
dW_sel's bytes. ``k13``: K13 (_emd_fwd_pallas) at PCN's coarse EMD (B=32,
N=M=1024), at B=1 (N=M=1024 and the gate's 4096) and at N > M (3, 1000,
300), its device time and launches a call by kernel. ``cls_step``: the classifier
train step (``chip_smoke.time_train_step``, bench.py's configuration, B=256)
in bf16 and f32. The SHA-256 values tell whether two trees' kernels agree
bit for bit on the same seeded inputs. Inputs are
numpy-seeded. Prints one JSON line of
ms a call (chip_smoke.cuda_ms; for K8, K1, K14, K9, K5 and K17 also
``/device``, the kernels' own time under torch.profiler) with the card's
name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    parser.add_argument("--label", default="")
    parser.add_argument("--parts", default="k6,k10,k11,serve,k8,k1,prnet,ipcrnet,k14,k9,flownet,dcp_int8,"
                        "k5,k17,dcp_bf16,rpmnet,k7,k3,dcp_f32,k2,k16,pointnet_int8,k15,k4,cls_step,k13")
    args = parser.parse_args()
    parts = set(args.parts.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: needs a CUDA card")
    sys.path.insert(0, str(args.root.resolve()))
    sys.path.insert(1, str(Path(__file__).resolve().parent))  # this tree's tools, run on the root's package
    import chip_smoke
    from learning3d_tpu_torch.kernels import _build
    from learning3d_tpu_torch.kernels.attention import attention_int8_kernel, attention_pallas

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(chip_smoke.SEED)

    def normal(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(dtype)

    f32 = torch.float32
    k6_shapes = {
        "pointer": ((32, 4, 1024, 128), (32, 4, 1024, 128), (32, 4, 1024, 128), torch.bfloat16),
        "pointer_f32": ((32, 4, 1024, 128), (32, 4, 1024, 128), (32, 4, 1024, 128), f32),
        "head": ((32, 1, 1024, 512), (32, 1, 1024, 512), (32, 1, 1024, 3), torch.bfloat16),
        "dv256": ((32, 4, 1024, 256), (32, 4, 1024, 256), (32, 4, 1024, 256), torch.bfloat16),
        "prnet_f32": ((16, 4, 768, 128), (16, 4, 1024, 128), (16, 4, 1024, 128), f32),
        "prnet_back_f32": ((16, 4, 1024, 128), (16, 4, 768, 128), (16, 4, 768, 128), f32),
        "tiny": ((1, 1, 128, 128), (1, 1, 128, 128), (1, 1, 128, 128), torch.bfloat16),
    }
    times = {}
    with torch.inference_mode():
        for name, (sq, sk, sv, dtype) in k6_shapes.items() if "k6" in parts else ():
            q, k, v = normal(*sq, dtype=dtype), normal(*sk, dtype=dtype), normal(*sv, dtype=dtype)
            times[f"k6/{name}"] = chip_smoke.cuda_ms(lambda: attention_pallas(q, k, v))
            if name == "pointer_f32":  # the wrapper's casts to bf16 alone
                times["k6/prep_f32"] = chip_smoke.cuda_ms(lambda: [t.to(torch.bfloat16) for t in (q, k, v)])
        for shape in ((32, 4, 1024, 128), (1, 1, 128, 128)) if "k10" in parts else ():
            q, k, v = (torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).cuda() for _ in range(3))
            for int8_pv in (True, False):
                name = f"k10/{'int8_pv' if int8_pv else 'hybrid'}" + ("" if shape[0] > 1 else "/tiny")
                times[name] = chip_smoke.cuda_ms(lambda: attention_int8_kernel(q, k, v, 0.004, 0.005, 0.03, int8_pv))
        # the wrappers' copies of V alone, at the pointer's shape: torch's
        # transpose and widening, and the port's attention_int8_values
        v3 = torch.from_numpy(rng.integers(-127, 128, (128, 1024, 128)).astype(np.int8)).cuda()
        if "k10" in parts:
            times["k10/prep_transpose"] = chip_smoke.cuda_ms(lambda: v3.transpose(1, 2).contiguous())
            times["k10/prep_hybrid"] = chip_smoke.cuda_ms(lambda: v3.to(torch.bfloat16))
        lib = _build.library()
        if "k10" in parts and hasattr(lib, "attention_int8_values"):
            stream = torch.cuda.current_stream().cuda_stream
            for int8_pv, dtype in ((1, torch.int8), (0, torch.bfloat16)):
                out = torch.empty(128 * 1024 * 128, device=v3.device, dtype=dtype)
                times[f"k10/values_{'int8_pv' if int8_pv else 'hybrid'}"] = chip_smoke.cuda_ms(
                    lambda: lib.attention_int8_values(v3.data_ptr(), out.data_ptr(), 128, 1024, 1024, 128, int8_pv,
                                                      stream))
        if "k11" in parts:
            from sweep_torch_kernels import k11_stages

            times.update({f"k11/{k}": v for k, v in k11_stages(np.random.default_rng(chip_smoke.SEED), chip_smoke)
                          .items()})
    if "serve" in parts:
        from profile_torch_serve import build

        for name in ("dcp-int8-fused", "dcp-int8-hybrid-fused"):
            model, _, inputs = build(name, np.random.default_rng(chip_smoke.SEED))
            dev = [torch.from_numpy(a).cuda() for a in inputs]
            with torch.inference_mode():
                times[f"serve/{name}/model_ms"] = chip_smoke.cuda_ms(lambda: model(*dev), reps=10)
    with torch.inference_mode():
        if "k8" in parts:
            times.update(k8_times(chip_smoke))
        if "k1" in parts:
            times.update(k1_times(chip_smoke))
        if "k14" in parts:
            times.update(k14_times(chip_smoke))
        if "k9" in parts:
            times.update(k9_times(chip_smoke))
        if "k5" in parts:
            times.update(k5_times(chip_smoke))
        if "k17" in parts:
            times.update(k17_times(chip_smoke))
        if "k7" in parts:
            times.update(k7_times(chip_smoke))
        if "k3" in parts:
            times.update(k3_times(chip_smoke))
        if "k2" in parts:
            times.update(k2_times(chip_smoke))
        if "k16" in parts:
            times.update(k16_times(chip_smoke))
        if "k15" in parts:
            times.update(k15_times(chip_smoke))
        if "k4" in parts:
            times.update(k4_times(chip_smoke))
        if "k13" in parts:
            times.update(k13_times(chip_smoke))
    if "cls_step" in parts:
        times.update(cls_step_times(chip_smoke))
    if parts & {"prnet", "ipcrnet", "flownet", "dcp_int8", "dcp_bf16", "rpmnet", "dcp_f32", "pointnet_int8"}:
        times.update(model_times(chip_smoke, parts))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "root": str(args.root), "device": smi,
                      "ms": times}), flush=True)


def device_ms(fn, reps: int = 10, by_kernel: bool = False, counts: bool = False):
    """Device time of one call: the kernels' time under torch.profiler over
    ``reps`` calls (after one warm-up), divided by ``reps``; free of the
    host's time, which ``cuda_ms`` shows where it exceeds the device's. With
    ``by_kernel``, a dict of ms a call by kernel name instead; with
    ``counts`` also a dict of launches a call by kernel name."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and getattr(e, "self_device_time_total", 0.0) > 0]
    times = {e.key: e.self_device_time_total / 1e3 / reps for e in events}
    if counts:
        return times, {e.key: e.count / reps for e in events}
    return times if by_kernel else sum(times.values())


def kernel_name(key: str) -> str:
    """A profiler key's function name ("(anonymous namespace)::row_pass(float
    const*, ...)" -> "row_pass"), or the key itself (a memset)."""
    found = re.search(r"(\w+)(?:<[^()]*>)?\(", key)
    return found.group(1) if found else key


def k8_times(chip_smoke) -> dict:
    """K8 at chip_smoke's timed shapes, the PRNet forward's 16 launches and
    three_nn's shape."""
    from learning3d_tpu_torch.kernels.knn import knn_pallas
    from learning3d_tpu_torch.ops.geometry import farthest_point_sample, index_points

    cases = chip_smoke.k8_cases(np.random.default_rng(chip_smoke.SEED))
    sizes = (chip_smoke.PRNET_NT, chip_smoke.PRNET_NS)
    times = {}
    for name in [f"C{c}_N{n}" for n in sizes for c in (3, 64, 128)] + ["cross_cloud"]:
        q, p, k = cases[name]
        times[f"k8/{name}"] = chip_smoke.cuda_ms(lambda: knn_pallas(q, p, k))
        times[f"k8/{name}/device"] = device_ms(lambda: knn_pallas(q, p, k))
    tiny = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 32, 3)).astype(np.float32)).cuda()
    times["k8/tiny"] = chip_smoke.cuda_ms(lambda: knn_pallas(tiny, tiny, 20))
    times["k8/prnet_forward_16"] = sum((1 if n == chip_smoke.PRNET_NT else chip_smoke.PRNET_ITERS) *
                                       times[f"k8/C{c}_N{n}"] for c in (3, 64, 64, 128) for n in sizes)
    pc1 = torch.from_numpy(chip_smoke.flow_requests(chip_smoke.FLOW_B)[0]).cuda()
    known = index_points(pc1, farthest_point_sample(pc1, 1024))
    times["k8/three_nn"] = chip_smoke.cuda_ms(lambda: knn_pallas(pc1, known, 3))
    times["k8/three_nn/device"] = device_ms(lambda: knn_pallas(pc1, known, 3))
    return times


def k1_times(chip_smoke) -> dict:
    """K1 at B=256 and B=32, N=1024, emb 1024, on numpy-seeded folded
    weights."""
    from learning3d_tpu_torch.kernels.pointnet_fused import pointnet_pooled_kernel

    rng = np.random.default_rng(chip_smoke.SEED + 16)
    dims = [3, 64, 64, 64, 128, 1024]
    ws = [torch.from_numpy(rng.normal(0, i**-0.5, (i, o)).astype(np.float32)).cuda()
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.from_numpy(rng.normal(0, 0.1, o).astype(np.float32)).cuda() for o in dims[1:]]
    times = {}
    for b, n in ((256, 1024), (32, 1024), (1, 1)):
        x = torch.from_numpy(rng.normal(size=(b, n, 3)).astype(np.float32)).cuda()
        name = f"k1/B{b}" if n == 1024 else f"k1/B{b}_N{n}"
        times[name] = chip_smoke.cuda_ms(lambda: pointnet_pooled_kernel(x, ws, bs))
        times[f"{name}/device"] = device_ms(lambda: pointnet_pooled_kernel(x, ws, bs))
    return times


def k14_times(chip_smoke) -> dict:
    """K14 at FlowNet3D's four shapes, their sum over a forward's six
    launches, and (where the tree has it) the chain floor."""
    from learning3d_tpu_torch.kernels import _build
    from learning3d_tpu_torch.kernels.sampling import fps_pallas

    pc1 = torch.from_numpy(chip_smoke.flow_requests(chip_smoke.FLOW_B)[0]).cuda()
    levels = chip_smoke.flow_levels(pc1)
    lib = _build.library()
    new = "fps_chain_floor" in _build.SIGNATURES
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for k, (xyz, _, npoint, _, _) in enumerate(levels):
        name = f"k14/sa{k + 1}"
        times[name] = chip_smoke.cuda_ms(lambda: fps_pallas(xyz, npoint))
        times[f"{name}/device"] = device_ms(lambda: fps_pallas(xyz, npoint))
        if not new:
            continue
        B, N = xyz.shape[:2]
        idx = torch.empty((B, npoint), device=xyz.device, dtype=torch.int32)
        times[f"{name}/threads"] = lib.fps_default_threads(N)
        times[f"{name}/chain_floor"] = chip_smoke.cuda_ms(
            lambda: _build.check(lib.fps_chain_floor(idx.data_ptr(), B, N, npoint, stream), "fps_chain_floor"))
    for key in ("", "/device") + (("/chain_floor",) if new else ()):
        times[f"k14/flownet_forward_6{key}"] = sum(times[f"k14/sa{k + 1}{key}"] * (2 if k < 2 else 1)
                                                   for k in range(4))
    return times


def k9_times(chip_smoke) -> dict:
    """K9 at the DCP shape, exact and approximate kNN, on numpy-seeded
    weights and scales."""
    from learning3d_tpu_torch.kernels.dgcnn_fused import DGCNNInt8Weights, dgcnn_encode_int8_kernel

    rng = np.random.default_rng(chip_smoke.SEED + 17)
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, chip_smoke.DCP_EMB)]
    ws = [torch.from_numpy(rng.normal(0, i**-0.5, (i, o)).astype(np.float32)).cuda() for i, o in dims]
    bs = [torch.from_numpy(rng.normal(0, 0.1, o).astype(np.float32)).cuda() for _, o in dims]
    pack = DGCNNInt8Weights(ws, bs, (0.02, 0.03, 0.03, 0.04))
    x = torch.from_numpy(rng.normal(size=(chip_smoke.DCP_B, chip_smoke.DCP_N, 3)).astype(np.float32)).cuda()
    times = {}
    for name, approx in (("exact", False), ("approx", True)):
        fn = lambda: dgcnn_encode_int8_kernel(x, pack, chip_smoke.DCP_K, approx_knn=approx)  # noqa: E731
        times[f"k9/{name}"] = chip_smoke.cuda_ms(fn)
        kernels = device_ms(fn, by_kernel=True)
        times[f"k9/{name}/device"] = sum(kernels.values())
        # the K9 launches by name (the selection, the chain), the wrapper's
        # preparation (xw1q, its scale, approx kNN's scales) as the rest
        for key, ms in kernels.items():
            if "dgcnn" in key:
                times[f"k9/{name}/device/{re.search(r'dgcnn_[a-z0-9_]+', key).group(0)}"] = ms
        times[f"k9/{name}/device/prep"] = sum(ms for key, ms in kernels.items() if "dgcnn" not in key)
    return times


def k5_times(chip_smoke) -> dict:
    """K5 at the DCP shape, exact and approximate kNN, on numpy-seeded folded
    weights, as the model calls it: on the weight pack, built once, where
    the tree has one (``DGCNNBf16Weights``), else on the folded weights;
    device time by launch (the selection, the chain), the wrapper's
    preparation (xw1; the parent's weight casts; approx kNN's scales) as the
    rest."""
    from learning3d_tpu_torch.kernels import dgcnn_fused

    rng = np.random.default_rng(chip_smoke.SEED + 5)
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, chip_smoke.DCP_EMB)]
    ws = [torch.from_numpy(rng.normal(0, i**-0.5, (i, o)).astype(np.float32)).cuda() for i, o in dims]
    bs = [torch.from_numpy(rng.normal(0, 0.1, o).astype(np.float32)).cuda() for _, o in dims]
    x = torch.from_numpy(rng.normal(size=(chip_smoke.DCP_B, chip_smoke.DCP_N, 3)).astype(np.float32)).cuda()
    k = chip_smoke.DCP_K
    if hasattr(dgcnn_fused, "DGCNNBf16Weights"):
        pack = dgcnn_fused.DGCNNBf16Weights(ws, bs)
        run = lambda approx: dgcnn_fused.dgcnn_encode_packed(x, pack, k, approx_knn=approx)  # noqa: E731
    else:
        run = lambda approx: dgcnn_fused.dgcnn_encode_kernel(x, ws, bs, k, approx_knn=approx)  # noqa: E731
    times = {}
    for name, approx in (("exact", False), ("approx", True)):
        fn = lambda: run(approx)  # noqa: E731
        times[f"k5/{name}"] = chip_smoke.cuda_ms(fn)
        kernels = device_ms(fn, by_kernel=True)
        times[f"k5/{name}/device"] = sum(kernels.values())
        for key, ms in kernels.items():
            if "dgcnn" in key:
                times[f"k5/{name}/device/{kernel_name(key)}"] = ms
        times[f"k5/{name}/device/prep"] = sum(ms for key, ms in kernels.items() if "dgcnn" not in key)
    return times


def k17_times(chip_smoke) -> dict:
    """K17 at RPMNet's shape (J=K=1024) with 5 iterations at B = 1, 4 and 16,
    and at B=16 with 0 and 1 iterations: ms a call, device time, and device
    time and launches a call by kernel."""
    from learning3d_tpu_torch.kernels.sinkhorn import sinkhorn_log_pallas

    rng = np.random.default_rng(chip_smoke.SEED + 17)
    times = {}
    for b, n_iters in ((1, 5), (4, 5), (16, 5), (16, 1), (16, 0)):
        la = chip_smoke.rpm_affinity(rng, b, chip_smoke.RPM_N, chip_smoke.RPM_N)
        name = f"k17/B{b}" + ("" if n_iters == 5 else f"_it{n_iters}")
        fn = lambda: sinkhorn_log_pallas(la, n_iters)  # noqa: E731
        times[name] = chip_smoke.cuda_ms(fn)
        kernels, launches = device_ms(fn, counts=True)
        times[f"{name}/device"] = sum(kernels.values())
        for key, ms in kernels.items():
            times[f"{name}/device/{kernel_name(key)}"] = ms
            times[f"{name}/launches/{kernel_name(key)}"] = launches[key]
    return times


def by_launch(chip_smoke, times: dict, name: str, fn) -> None:
    """ms a call, device time, and device time by kernel name of ``fn``
    into ``times`` under ``name``."""
    times[name] = chip_smoke.cuda_ms(fn)
    kernels = device_ms(fn, by_kernel=True)
    times[f"{name}/device"] = sum(kernels.values())
    for key, ms in kernels.items():
        label = f"{name}/device/{kernel_name(key)}"
        times[label] = times.get(label, 0.0) + ms


def k7_times(chip_smoke) -> dict:
    """K7's edge features at the DCP shape (B=32, N=1024) at k=20 and k=40."""
    from learning3d_tpu_torch.kernels.edgeconv import edge_features

    rng = np.random.default_rng(chip_smoke.SEED + 7)
    x = torch.from_numpy(rng.normal(size=(chip_smoke.DCP_B, chip_smoke.DCP_N, 3)).astype(np.float32)).cuda()
    times = {}
    for k in (chip_smoke.DCP_K, 40):
        by_launch(chip_smoke, times, f"k7/k{k}", lambda: edge_features(x, k))
    return times


def k3_times(chip_smoke) -> dict:
    """K3 at the classifier step's shape, bf16 and f32, on ReLU'd inputs."""
    from learning3d_tpu_torch.kernels.poolgrad import pool_stats

    rng = np.random.default_rng(chip_smoke.SEED + 3)
    x = np.maximum(rng.normal(size=(chip_smoke.B, chip_smoke.N, chip_smoke.K_TAIL)), 0.0).astype(np.float32)
    w = rng.normal(0, chip_smoke.K_TAIL**-0.5, (chip_smoke.K_TAIL, chip_smoke.EMB)).astype(np.float32)
    c = torch.from_numpy(rng.normal(0, 0.1, chip_smoke.EMB).astype(np.float32)).cuda()
    times = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        xt, wt = (torch.from_numpy(a).cuda().to(dtype) for a in (x, w))
        by_launch(chip_smoke, times, f"k3/{name}", lambda: pool_stats(xt, wt, c))
        del xt
    return times


def k2_times(chip_smoke) -> dict:
    """K2 at B=256 and B=32 (N=1024, emb 1024) on a numpy-seeded int8 pack
    (per-channel weights, static scales), built once as the model builds
    it."""
    from learning3d_tpu_torch.kernels.pointnet_fused import PointNetInt8Weights, pointnet_pooled_int8_kernel

    rng = np.random.default_rng(chip_smoke.SEED + 2)
    dims = [3, 64, 64, 64, 128, chip_smoke.EMB]
    ws = [torch.from_numpy(rng.normal(0, i**-0.5, (i, o)).astype(np.float32)) for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.from_numpy(rng.normal(0, 0.1, o).astype(np.float32)) for o in dims[1:]]
    qlayers = []
    for w, b in zip(ws[1:], bs[1:]):
        s_w = w.abs().amax(0).clamp_min(1e-12) / 127
        qlayers.append((torch.clamp(torch.round(w / s_w), -127, 127).to(torch.int8), s_w, b,
                        float(rng.uniform(0.01, 0.05))))
    pack = PointNetInt8Weights(ws[0], bs[0], qlayers).cuda()
    times = {}
    for b in (chip_smoke.B, chip_smoke.K1_SMALL_B):
        x = torch.from_numpy(rng.normal(size=(b, chip_smoke.N, 3)).astype(np.float32)).cuda()
        by_launch(chip_smoke, times, f"k2/B{b}", lambda: pointnet_pooled_int8_kernel(x, pack))
    return times


def k16_times(chip_smoke) -> dict:
    """K16 at RPMNet's grouping, at N=20,000 (rows open across chunks) and
    with rows of nsample 200."""
    from learning3d_tpu_torch.kernels.sampling import ball_group_pallas

    pc = torch.from_numpy(chip_smoke.rpm_requests(chip_smoke.RPM_B)[0]).cuda()
    xyz = pc[..., :3].contiguous()
    every = torch.arange(chip_smoke.RPM_N, dtype=torch.int32, device="cuda").expand(chip_smoke.RPM_B, -1).contiguous()
    rng = np.random.default_rng(chip_smoke.SEED + 16)
    big = torch.from_numpy(rng.uniform(-1.0, 1.0, (2, 20000, 6)).astype(np.float32)).cuda()
    picks = torch.arange(0, 20000, 37, dtype=torch.int32, device="cuda")
    big_xyz = big[..., :3].contiguous()
    cases = {"rpmnet": (chip_smoke.RPM_RADIUS, chip_smoke.RPM_NSAMPLE, xyz, xyz, every, pc),
             "chunked": (0.1, chip_smoke.RPM_NSAMPLE, big_xyz, big_xyz[:, picks.long()].contiguous(),
                         picks.expand(2, -1).contiguous(), big),
             "nsample200": (chip_smoke.RPM_RADIUS, 200, xyz, xyz, every, pc)}
    times = {}
    for name, args in cases.items():
        by_launch(chip_smoke, times, f"k16/{name}", lambda: ball_group_pallas(*args))
    return times


def k15_times(chip_smoke) -> dict:
    """K15 at FlowNet3D's four shapes, alone and through query_ball_point,
    their sums over a forward's six launches, and the indices' SHA-256."""
    from learning3d_tpu_torch.kernels.sampling import ball_query_pallas
    from learning3d_tpu_torch.ops.geometry import query_ball_point

    pc1 = torch.from_numpy(chip_smoke.flow_requests(chip_smoke.FLOW_B)[0]).cuda()
    digest = hashlib.sha256()
    times = {}
    for k, (xyz, new, _, radius, nsample) in enumerate(chip_smoke.flow_levels(pc1)):
        name = f"k15/sa{k + 1}"
        times[name] = chip_smoke.cuda_ms(lambda: ball_query_pallas(radius, nsample, xyz, new))
        times[f"{name}/device"] = device_ms(lambda: ball_query_pallas(radius, nsample, xyz, new))
        times[f"{name}/query_ball_point"] = chip_smoke.cuda_ms(lambda: query_ball_point(radius, nsample, xyz, new))
        times[f"{name}/query_ball_point/device"] = device_ms(lambda: query_ball_point(radius, nsample, xyz, new))
        digest.update(ball_query_pallas(radius, nsample, xyz, new).cpu().numpy().tobytes())
    for key in ("", "/device", "/query_ball_point", "/query_ball_point/device"):
        times[f"k15/flownet_forward_6{key}"] = sum(times[f"k15/sa{k + 1}{key}"] * (2 if k < 2 else 1)
                                                   for k in range(4))
    times["k15/sha256"] = digest.hexdigest()
    xyz, new, _, radius, nsample = chip_smoke.flow_levels(pc1)[3]
    times.update(k15_host_us(xyz, new, radius, nsample))
    return times


def host_us(fn, reps: int = 2000) -> float:
    """Host microseconds a call of ``fn``, by the host's clock over ``reps``
    calls after a warm-up, ending in a synchronize (where ``fn`` enqueues
    device work that takes less than its host time, the host's)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / reps


def k15_host_us(xyz, new, radius, nsample) -> dict:
    """The host's work a K15 call at sa4 (its device time is the least), in
    parts: the wrapper as a whole, FlowNet3D's call (query_ball_point), the
    checks, the output's allocation (two ways), the current device, the
    device context, the current stream (two ways), and (where the tree's C
    entry takes an output type) the C entry alone."""
    from learning3d_tpu_torch.kernels import _build
    from learning3d_tpu_torch.kernels.sampling import _check_ball_query, ball_query_pallas, squared_radius
    from learning3d_tpu_torch.ops.geometry import query_ball_point

    dev = xyz.device
    B, N, S = xyz.shape[0], xyz.shape[1], new.shape[1]

    def enter_device():
        with torch.cuda.device(dev):
            pass

    out = {"k15/host_us/wrapper": host_us(lambda: ball_query_pallas(radius, nsample, xyz, new)),
           "k15/host_us/query_ball_point": host_us(lambda: query_ball_point(radius, nsample, xyz, new)),
           "k15/host_us/check": host_us(lambda: _check_ball_query(nsample, xyz, new)),
           "k15/host_us/empty": host_us(lambda: torch.empty((B, S, nsample), device=dev, dtype=torch.int32)),
           "k15/host_us/new_empty": host_us(lambda: new.new_empty((B, S, nsample), dtype=torch.int32)),
           "k15/host_us/device_enter": host_us(enter_device),
           "k15/host_us/current_device": host_us(torch.cuda.current_device),
           "k15/host_us/current_stream": host_us(lambda: torch.cuda.current_stream(dev).cuda_stream)}
    if hasattr(torch._C, "_cuda_getCurrentRawStream"):
        out["k15/host_us/raw_stream"] = host_us(lambda: torch._C._cuda_getCurrentRawStream(dev.index))
    if len(_build.SIGNATURES["ball_query"][0]) == 10:  # the C entry takes the output type
        lib, idx = _build.library(), torch.empty((B, S, nsample), device=dev, dtype=torch.int32)
        stream, r2 = torch.cuda.current_stream(dev).cuda_stream, float(squared_radius(radius))
        args = (xyz.data_ptr(), new.data_ptr(), idx.data_ptr(), 0, B, N, S, nsample, r2, stream)
        out["k15/host_us/entry"] = host_us(lambda: lib.ball_query(*args))
    return out


def k4_times(chip_smoke) -> dict:
    """K4 at the classifier step's shape in bf16 and f32 on K3's picks,
    device time by kernel, and the SHA-256 of dx_sp and dW_sel."""
    from learning3d_tpu_torch.kernels.poolgrad import pool_bwd, pool_stats

    times = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        rng = np.random.default_rng(chip_smoke.SEED + 4)
        x, w, c = chip_smoke.pool_tail_inputs(rng, chip_smoke.B, chip_smoke.N, chip_smoke.EMB, dtype)
        idx = pool_stats(x, w, c)[2]
        dsel = torch.from_numpy(rng.normal(size=idx.shape).astype(np.float32)).cuda()
        by_launch(chip_smoke, times, f"k4/{name}", lambda: pool_bwd(idx, dsel, w, x))
        times[f"k4/{name}/host_us/transpose"] = host_us(lambda: w.t().contiguous(), reps=500)
        dx, dw = pool_bwd(idx, dsel, w, x)
        digest = hashlib.sha256(dx.cpu().numpy().tobytes())
        digest.update(dw.contiguous().cpu().numpy().tobytes())
        times[f"k4/{name}/sha256"] = digest.hexdigest()
        del x, dx
    return times


def k13_times(chip_smoke) -> dict:
    """K13 at PCN's coarse EMD and the other shapes of the docstring, device
    time and launches a call."""
    from learning3d_tpu_torch.kernels import emd

    rng = np.random.default_rng(chip_smoke.SEED + 13)
    times = {}
    for name, (b, n, m) in {"pcn": (32, 1024, 1024), "b1": (1, 1024, 1024), "max": (1, 4096, 4096),
                            "n_gt_m": (3, 1000, 300)}.items():
        x, y = (torch.from_numpy(rng.normal(size=(b, k, 3)).astype(np.float32)).cuda() for k in (n, m))
        times[f"k13/{name}"] = chip_smoke.cuda_ms(lambda: emd.emd_kernel(x, y), reps=10)
        dev, counts = device_ms(lambda: emd.emd_kernel(x, y), reps=5, by_kernel=True, counts=True)
        times[f"k13/{name}/device"] = sum(dev.values())
        times[f"k13/{name}/launches"] = sum(counts.values())
    return times


def cls_step_times(chip_smoke) -> dict:
    """The classifier train step (bench.py's configuration, B=256, N=1024,
    Adam, augmentation) in bf16 and f32: ``chip_smoke.time_train_step``'s
    step and its parts."""
    import tempfile

    from learning3d_tpu_torch.models import Classifier, PointNet
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    times = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        rng = np.random.default_rng(chip_smoke.SEED)
        model = Classifier(PointNet(emb_dims=chip_smoke.EMB, use_bn=True, dtype=dtype), chip_smoke.CLASSES,
                           dtype=dtype)
        load_nnx_state(model, chip_smoke.random_nnx_state(rng, chip_smoke.EMB, chip_smoke.CLASSES))
        batch = (torch.from_numpy(rng.normal(size=(chip_smoke.B, chip_smoke.N, 3)).astype(np.float32)).cuda(),
                 torch.from_numpy(rng.integers(0, chip_smoke.CLASSES, chip_smoke.B)).cuda())
        with tempfile.TemporaryDirectory() as ckpt:
            trainer = Trainer(TrainConfig(batch_size=chip_smoke.B, num_points=chip_smoke.N, lr=chip_smoke.TRAIN_LR,
                                          ckpt_dir=ckpt, task="classification", augment=True), model)
            trainer._ensure_optimizer(1)
            step = chip_smoke.time_train_step(trainer, batch, reps=10)
            trainer.close()
        times.update({f"cls_step/{name}/{k}": v for k, v in step.items()})
    return times


def model_times(chip_smoke, parts) -> dict:
    """model_ms of served PRNet (B=32), of bf16 iPCRNet (B=32, the
    multi-start batch of 256, and multistart_register on 32 pairs), of
    FlowNet3D (B=16), of int8 DCP, unfused and fused (B=32), of bf16 DCP
    (B=32), of RPMNet (B=16), of the f32 DCP forward (B=32) and of the int8
    classifier (B=256)."""
    from profile_torch_serve import build

    times = {}
    for part, names in (("flownet", ("flownet",)), ("dcp_int8", ("dcp-int8", "dcp-int8-fused")),
                        ("dcp_bf16", ("dcp",)), ("rpmnet", ("rpmnet",)), ("pointnet_int8", ("pointnet-int8",))):
        for name in names if part in parts else ():
            model, _, inputs = build(name, np.random.default_rng(chip_smoke.SEED))
            if isinstance(model, torch.nn.Module):
                model.cuda().eval()
            dev = [torch.from_numpy(a).cuda() for a in inputs]
            with torch.inference_mode():
                times[f"{name}/model_ms"] = chip_smoke.cuda_ms(lambda: model(*dev), reps=10)
    if "dcp_f32" in parts:
        from learning3d_tpu_torch.models import DCP, DGCNN
        from learning3d_tpu_torch.utils.jax_import import load_nnx_state

        rng = np.random.default_rng(chip_smoke.SEED)
        model = load_nnx_state(DCP(DGCNN(emb_dims=chip_smoke.DCP_EMB, k=chip_smoke.DCP_K)),
                               chip_smoke.random_dcp_state(rng, chip_smoke.DCP_EMB)).cuda().eval()
        t, s = (torch.from_numpy(rng.normal(size=(chip_smoke.DCP_B, chip_smoke.DCP_N, 3)).astype(np.float32)).cuda()
                for _ in range(2))
        with torch.inference_mode():
            times["dcp_f32/model_ms"] = chip_smoke.cuda_ms(lambda: model(t, s), reps=10)
    if "prnet" in parts:
        model, _, inputs = build("prnet", np.random.default_rng(chip_smoke.SEED))
        model.cuda().eval()
        dev = [torch.from_numpy(a).cuda() for a in inputs]
        with torch.inference_mode():
            times["prnet/model_ms_B32"] = chip_smoke.cuda_ms(lambda: model(*dev), reps=5, warmup=2)
    if "ipcrnet" in parts:
        from learning3d_tpu_torch.serve import multistart_register, rotation_starts

        rng = np.random.default_rng(chip_smoke.SEED)
        model, _, inputs = build("ipcrnet", rng)
        model.cuda().eval()
        t, s = (torch.from_numpy(a).cuda() for a in inputs)
        t256, s256 = (torch.from_numpy(rng.normal(size=(256, chip_smoke.IPC_N, 3)).astype(np.float32)).cuda()
                      for _ in range(2))
        rots = rotation_starts(chip_smoke.IPC_STARTS)
        with torch.inference_mode():
            times["ipcrnet/model_ms_B32"] = chip_smoke.cuda_ms(lambda: model(t, s), reps=10)
            times["ipcrnet/model_ms_B256"] = chip_smoke.cuda_ms(lambda: model(t256, s256), reps=5)
            times["ipcrnet/multistart_ms_32x8"] = chip_smoke.cuda_ms(lambda: multistart_register(model, t, s, rots),
                                                                     reps=5)
    return times


if __name__ == "__main__":
    main()
