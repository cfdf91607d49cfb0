#!/usr/bin/env python3
"""Where the time of the port's serving goes, on one card.

    python3 tools/profile_torch_serve.py [--model pointnet|dcp|pointnet-int8|dcp-int8|dcp-int8-fused|
                                          dcp-int8-hybrid-fused|ipcrnet|prnet|flownet|rpmnet|masknet|pointnetlk|deepgmr|masknet2|
                                          pointconv|curvenet|dgcnn-cls]
                                         [--requests 20]

``pointnet``: Classifier(PointNet(emb_dims=1024, use_bn=True)), requests of
B=256 clouds of N=1024 points. ``dcp``: DCP(DGCNN(emb_dims=512, k=20)) with
the transformer pointer and the SVD head, requests of B=32 (template,
source) pairs of N=1024 points. ``pointnet-int8`` and ``dcp-int8``: the same
models quantized as bench.py quantizes them (the classifier on 64 clouds,
served through K2; DCP on 8 + 8 clouds with int8 P.V and fused_layers=False,
served through K9, K10 and K6). ``dcp-int8-fused`` and
``dcp-int8-hybrid-fused``: DCP quantized with fused_layers=True (int8 and
hybrid P.V), the pointer's layers served through K11a/K11b. ``ipcrnet``:
iPCRNet(PointNet(1024, use_bn=False)) with 8 refinement steps, requests of
B=32 (template, source) pairs of N=1024 points (K1 nine times a forward).
All in bf16 eval. ``prnet``: PRNet() (PRDGCNN(512, k=20), the transformer pointer, 512
keypoints, 3 iterations) in f32 eval, requests of B=32 (source, template)
pairs of 768 and 1024 points (K8 and K6). ``flownet``: FlowNet3D() in f32
eval, requests of B=16 SyntheticSceneflow pairs of N=2048 points (K14, K15
and K8). ``rpmnet``: RPMNet() (PPFNet emb 96, 2 iterations, 5 Sinkhorn
iterations) in f32 eval, requests of B=16 RegistrationData("RPMNet") pairs
of N=1024 points with normals (K16 and K17). ``masknet``:
MaskNet(PointNet(1024, use_bn=True)) in bf16 eval (the served draw of
chip_smoke.py's serve_masknet_pnlk), requests of B=32 pairs of a 1024-point
template and a 768-point partial source (K1 once a forward). ``pointnetlk``:
PointNetLK(PointNet(1024, use_bn=True)) in f32 eval, 10 iterations, on the
same pairs (no kernel: f32). ``pointconv``: PointConvDensityClsSsg(
classifier=True) in f32 eval (K14 and K8 twice a forward); ``curvenet``:
CurveNet() in f32 eval (K8 once, K14 and K15 twice); ``dgcnn-cls``:
Classifier(DGCNN(1024, k=20)) in bf16 eval (K5 once); each on requests of
B=32 SyntheticModelNet40 clouds of 1024 points, with the seeded weights of
chip_smoke.py's serve phases for these models. ``deepgmr``:
DeepGMR(use_rri=True, nearest_neighbors=20) and ``masknet2``: MaskNet2()
(its attention gates drawn), both in f32 eval on requests of B=32 pairs of
chip_smoke.py's serve_deepgmr and serve_masknet2 (no kernel). All with the numpy-seeded
weights of chip_smoke.py, served through learning3d_tpu_torch's
InferenceEngine under torch.profiler. Prints one JSON line: host wall time
per request, device time per request by kernel (largest first), the
device's idle share (1 - device busy time / wall time), and the wall time
of the model alone on a device batch, outside the engine. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def build(name: str, rng):
    """(model, batch, the request's numpy inputs) for one configuration."""
    import chip_smoke
    from learning3d_tpu_torch.models import DCP, DGCNN, Classifier, PointNet
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    bf16 = torch.bfloat16
    if "-int8" in name:
        from learning3d_tpu_torch.quant import make_fused_quant_forward, quantize_dcp, quantize_pointnet_classifier

        model, B, inputs = build(name.split("-")[0], rng)
        model.cuda().eval()
        if name == "pointnet-int8":
            calib = torch.from_numpy(rng.normal(size=(chip_smoke.CALIB_CLOUDS, inputs[0].shape[1], 3))
                                     .astype(np.float32)).cuda()
            return make_fused_quant_forward(quantize_pointnet_classifier(model, calib)), B, inputs
        t, s = (torch.from_numpy(a[: chip_smoke.DCP_CALIB_PAIRS]).cuda() for a in inputs)
        return quantize_dcp(model, t, s, int8_pv="hybrid" not in name, fused_layers=name.endswith("-fused")), B, inputs
    if name == "pointnet":
        B, N = chip_smoke.B, chip_smoke.N
        model = Classifier(PointNet(emb_dims=chip_smoke.EMB, use_bn=True, dtype=bf16), chip_smoke.CLASSES,
                           dtype=bf16)
        load_nnx_state(model, chip_smoke.random_nnx_state(rng, chip_smoke.EMB, chip_smoke.CLASSES))
        return model, B, [rng.normal(size=(B, N, 3)).astype(np.float32)]
    if name in ("masknet", "pointnetlk"):
        from learning3d_tpu_torch.models import MaskNet, PointNetLK

        from learning3d_tpu_torch.data import batch_iterator

        pairs = chip_smoke.lk_pairs(chip_smoke.LK_B, masknet=True)
        inputs = list(next(batch_iterator(pairs, chip_smoke.LK_B, shuffle=False))[:2])
        if name == "pointnetlk":
            return load_nnx_state(PointNetLK(PointNet(emb_dims=chip_smoke.LK_EMB, use_bn=True)),
                                  chip_smoke.random_pnlk_state(rng)), chip_smoke.LK_B, inputs
        state = chip_smoke.random_masknet_state(rng)
        state["maskNet.out.kernel"] *= chip_smoke.MASK_OUT_SCALE
        model = MaskNet(PointNet(emb_dims=chip_smoke.LK_EMB, use_bn=True, dtype=bf16), dtype=bf16)
        return load_nnx_state(model, state), chip_smoke.LK_B, inputs
    if name in ("pointconv", "curvenet", "dgcnn-cls"):
        import functools

        make = {"pointconv": chip_smoke.make_pointconv, "curvenet": chip_smoke.make_curvenet,
                "dgcnn-cls": functools.partial(chip_smoke.make_dgcnn_cls, dtype=bf16)}[name]
        state = chip_smoke.pointconv_state(rng) if name == "pointconv" else chip_smoke.seeded_state(make, rng)
        clouds = np.stack([chip_smoke.cls_data()[i][0] for i in range(chip_smoke.CLS_B)]).astype(np.float32)
        return chip_smoke.from_state(make, state), chip_smoke.CLS_B, [clouds]
    if name in ("deepgmr", "masknet2"):
        make, state = ((chip_smoke.make_deepgmr, chip_smoke.seeded_state(chip_smoke.make_deepgmr, rng))
                       if name == "deepgmr" else (chip_smoke.make_masknet2, chip_smoke.masknet2_state(rng)))
        data = chip_smoke.registration_data(name)
        pairs = [np.stack([data[i][j] for i in range(chip_smoke.CLS_B)]) for j in range(2)]
        return chip_smoke.from_state(make, state).eval(), chip_smoke.CLS_B, pairs
    if name == "rpmnet":
        from learning3d_tpu_torch.models import RPMNet

        model = load_nnx_state(RPMNet(), chip_smoke.random_rpmnet_state(rng))
        return model, chip_smoke.RPM_B, list(chip_smoke.rpm_requests(chip_smoke.RPM_B))
    if name == "flownet":
        from learning3d_tpu_torch.models import FlowNet3D

        model = load_nnx_state(FlowNet3D(), chip_smoke.random_flownet_state(rng))
        return model, chip_smoke.FLOW_B, list(chip_smoke.flow_requests(chip_smoke.FLOW_B))
    if name == "ipcrnet":
        from learning3d_tpu_torch.models import iPCRNet

        model = load_nnx_state(iPCRNet(PointNet(emb_dims=chip_smoke.IPC_EMB, dtype=bf16), dtype=bf16),
                               chip_smoke.random_ipcrnet_state(rng))
        B = chip_smoke.IPC_B
        return model, B, [rng.normal(size=(B, chip_smoke.IPC_N, 3)).astype(np.float32) for _ in range(2)]
    if name == "prnet":
        from learning3d_tpu_torch.models import PRNet

        model = load_nnx_state(PRNet(), chip_smoke.random_prnet_state(rng))
        B = chip_smoke.PRNET_B
        return model, B, [rng.normal(size=(B, n, 3)).astype(np.float32) for n in (chip_smoke.PRNET_NS,
                                                                                   chip_smoke.PRNET_NT)]
    B, N = chip_smoke.DCP_B, chip_smoke.DCP_N
    model = DCP(DGCNN(emb_dims=chip_smoke.DCP_EMB, k=chip_smoke.DCP_K, dtype=bf16), dtype=bf16)
    load_nnx_state(model, chip_smoke.random_dcp_state(rng, chip_smoke.DCP_EMB))
    return model, B, [rng.normal(size=(B, N, 3)).astype(np.float32) for _ in range(2)]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=("pointnet", "dcp", "pointnet-int8", "dcp-int8", "dcp-int8-fused",
                                            "dcp-int8-hybrid-fused", "ipcrnet", "prnet", "flownet", "rpmnet", "masknet",
                                            "pointnetlk", "pointconv", "curvenet", "dgcnn-cls", "deepgmr",
                                            "masknet2"),
                        default="pointnet")
    parser.add_argument("--requests", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from learning3d_tpu_torch.serve import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(chip_smoke.SEED)
    model, B, inputs = build(args.model, rng)
    engine = InferenceEngine(model, batch_size=B)
    for _ in range(3):
        engine(*inputs)
    torch.cuda.synchronize()

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            engine(*inputs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    per_kernel, launches = {}, 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", 0.0)
        if us > 0:
            per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + us
            launches += evt.count
    busy_ms = sum(per_kernel.values()) / 1e3 / args.requests
    wall_ms = 1e3 * wall_s / args.requests
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]

    dev = [torch.from_numpy(a).cuda() for a in inputs]
    with torch.inference_mode():
        model_ms = chip_smoke.cuda_ms(lambda: model(*dev), reps=10)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "model": args.model, "requests": args.requests, "batch": B, "points": inputs[0].shape[1],
        "wall_ms_per_request": wall_ms,
        "device_busy_ms_per_request": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches_per_request": launches / args.requests,
        "model_ms_device_batch": model_ms,
        "device_ms_per_request": {k: v / 1e3 / args.requests for k, v in top},
    }), flush=True)


if __name__ == "__main__":
    main()
