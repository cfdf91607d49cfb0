#!/usr/bin/env python3
"""Where the time of the port's training step goes, on one card.

    python3 tools/profile_torch_train.py [--model pointnet|dcp|ipcrnet|pcn|prnet|flownet|rpmnet|pointnetlk|
                                                  masknet|segmentation|pointconv|curvenet|dgcnn-cls|deepgmr|
                                                  masknet2] [--detailed]
                                         [--dtype bf16|f32] [--steps 10]

``--model pointnet`` (the default) is bench.py's training configuration:
Classifier(PointNet(emb_dims=1024, use_bn=True)), 40 classes, B=256 clouds
of N=1024 points, Adam at 1e-3 with on-device augmentation, in bf16 unless
``--dtype f32``. ``--model dcp`` is examples/train.py's DCP configuration:
DCP(DGCNN(emb_dims=512, k=20)) with the transformer pointer and the SVD
head, B=32 pairs of N=1024 points from RegistrationData("DCP",
SyntheticModelNet40), Adam at 1e-3, in f32 unless ``--dtype bf16``.
``--model ipcrnet`` is examples/train.py's iPCRNet configuration:
iPCRNet(PointNet(emb_dims=1024, use_bn=False)), 8 refinement steps, B=20
pairs (examples/train_pcrnet.py) of N=1024 points from
RegistrationData("iPCRNet", SyntheticModelNet40), the Chamfer loss (K12),
in f32. ``--model pcn`` is PCN(emb_dims=1024, num_coarse=1024) on B=32
clouds of N=1024 points, the Chamfer loss on the coarse output, in f32;
``--detailed`` adds the folding decoder (16,384 fine points) and its
Chamfer term. ``--model prnet`` is PRNet() (PRDGCNN(512, k=20), the
transformer pointer, 512 keypoints, 3 iterations) on B=16 pairs
(examples/train_prnet.py) of a 768-point partial source and a 1024-point
template from RegistrationData("PRNet", partial_source=True), its own
discounted loss, in f32. ``--model flownet`` is examples/train_flownet.py's
FlowNet3D() on B=16 SyntheticSceneflow pairs of N=2048 points, the masked
flow MSE, SGD (lr 1e-3, momentum 0.9), in f32. ``--model rpmnet`` is
examples/train.py's RPMNet() (PPFNet emb 96, 2 iterations) on B=16 pairs of
N=1024 points with normals from RegistrationData("RPMNet",
SyntheticModelNet40(use_normals=True)), the Frobenius + feature-residual
loss, Adam at 1e-3, in f32. ``--model deepgmr`` and ``masknet2`` are
chip_smoke.py's train_deepgmr (jittered DeepGMR pairs, Adam 1e-3) and
train_masknet2 (bce), B=32, no kernel. ``--model pointnetlk``, ``masknet`` and
``segmentation`` are chip_smoke.py's train_pnlk, train_masknet and
train_seg: PointNetLK(PointNet(1024, use_bn=True)) (10 iterations) on B=32
RegistrationData("PointNetLK") pairs of N=1024 (K3 twice a step, the
warm-up), MaskNet(PointNet(1024, use_bn=True)) on B=32 pairs of a 1024-point
template and a 768-point partial source with the bce loss (K3 and K4 once a
step), Segmentation(PointNet(1024, use_bn=True, global_feat=False), 40) on
B=32 SyntheticPartSegmentation clouds of N=1024 (no kernel); Adam at 1e-3,
f32. ``pointconv``, ``curvenet`` and ``dgcnn-cls`` are chip_smoke.py's
train_pointconv, train_curvenet and train_dgcnn_cls:
PointConvDensityClsSsg(classifier=True) (K14 and K8 twice a step, Adam at
1e-3), CurveNet() (K8 once, K14 and K15 twice; SGD 0.1 with momentum 0.9,
weight decay 1e-4, cosine decay, label smoothing 0.2 and augmentation, as
examples/train_curvenet.py) and Classifier(DGCNN(1024, k=20)) (K7 once,
Adam at 1e-3), on B=32 SyntheticModelNet40 clouds of N=1024, f32, with the
seeded weights of those phases. All run through
learning3d_tpu_torch's Trainer (its
train_step on one device batch), with the numpy-seeded weights of
chip_smoke.py. After a few warm-up
steps, ``--steps`` steps run without the profiler, timed on the host's
clock after a synchronize, then ``--steps`` more under torch.profiler.
Prints one JSON line: host wall time per step, with and without the
profiler, device time per step by kernel (largest first), the device's
idle share (1 - device busy time / wall time) against either wall time
(the profiler's own host overhead lengthens the profiled steps) and the
launches per step. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=("pointnet", "dcp", "ipcrnet", "pcn", "prnet", "flownet", "rpmnet",
                                            "pointnetlk", "masknet", "segmentation", "pointconv", "curvenet",
                                            "dgcnn-cls", "deepgmr", "masknet2"), default="pointnet")
    parser.add_argument("--detailed", action="store_true", help="pcn: with the folding decoder")
    parser.add_argument("--dtype", choices=("bf16", "f32"), default=None,
                        help="bf16 for pointnet and f32 for the others unless given")
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from learning3d_tpu_torch.data import (ClassificationData, RegistrationData, SyntheticModelNet40, batch_iterator,
                                           to_device)
    from learning3d_tpu_torch.models import DCP, DGCNN, PCN, Classifier, PointNet, iPCRNet
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(chip_smoke.SEED)
    dtype_name = args.dtype or ("bf16" if args.model == "pointnet" else "f32")
    dtype = torch.bfloat16 if dtype_name == "bf16" else None
    if args.model == "pointnet":
        B, N, unit = chip_smoke.B, chip_smoke.N, "clouds"
        model = Classifier(PointNet(emb_dims=chip_smoke.EMB, use_bn=True, dtype=dtype), chip_smoke.CLASSES,
                           dtype=dtype)
        load_nnx_state(model, chip_smoke.random_nnx_state(rng, chip_smoke.EMB, chip_smoke.CLASSES))
        batch = (torch.from_numpy(rng.normal(size=(B, N, 3)).astype(np.float32)).cuda(),
                 torch.from_numpy(rng.integers(0, chip_smoke.CLASSES, B)).cuda())
        cfg = dict(task="classification", augment=True)
    elif args.model == "ipcrnet":
        B, N, unit = chip_smoke.IPC_TRAIN_B, chip_smoke.IPC_N, "pairs"
        model = iPCRNet(PointNet(emb_dims=chip_smoke.IPC_EMB, dtype=dtype), dtype=dtype)
        load_nnx_state(model, chip_smoke.random_ipcrnet_state(rng))
        data = RegistrationData("iPCRNet", SyntheticModelNet40(num_points=N, size=B))
        batch = to_device(next(batch_iterator(data, B, shuffle=False)), "cuda")
        cfg = dict(task="ipcrnet")
    elif args.model == "pcn":
        B, N, unit = chip_smoke.PCN_B, chip_smoke.PCN_N, "clouds"
        model = PCN(emb_dims=chip_smoke.PCN_EMB, num_coarse=chip_smoke.PCN_COARSE, detailed_output=args.detailed,
                    dtype=dtype)
        load_nnx_state(model, chip_smoke.random_pcn_state(rng, detailed=args.detailed))
        data = ClassificationData(SyntheticModelNet40(num_points=N, size=B))
        batch = to_device(next(batch_iterator(data, B, shuffle=False)), "cuda")
        cfg = dict(task="pcn")
    elif args.model == "prnet":
        from learning3d_tpu_torch.models import PRNet

        B, N, unit = chip_smoke.PRNET_TRAIN_B, chip_smoke.PRNET_NT, "pairs"
        model = load_nnx_state(PRNet(dtype=dtype), chip_smoke.random_prnet_state(rng))
        data = RegistrationData("PRNet", SyntheticModelNet40(num_points=N, size=B), partial_source=True)
        batch = to_device(next(batch_iterator(data, B, shuffle=False)), "cuda")
        cfg = dict(task="prnet")
    elif args.model == "rpmnet":
        from learning3d_tpu_torch.models import RPMNet

        B, N, unit = chip_smoke.RPM_B, chip_smoke.RPM_N, "pairs"
        model = load_nnx_state(RPMNet(dtype=dtype), chip_smoke.random_rpmnet_state(rng))
        data = RegistrationData("RPMNet", chip_smoke.rpm_clouds())
        batch = to_device(next(batch_iterator(data, B, shuffle=False)), "cuda")
        cfg = dict(task="rpmnet")
    elif args.model in ("pointnetlk", "masknet"):
        from learning3d_tpu_torch.models import MaskNet, PointNetLK

        B, N, unit = chip_smoke.LK_B, chip_smoke.LK_N, "pairs"
        masknet = args.model == "masknet"
        model = (MaskNet if masknet else PointNetLK)(PointNet(emb_dims=chip_smoke.LK_EMB, use_bn=True, dtype=dtype))
        load_nnx_state(model, (chip_smoke.random_masknet_state if masknet else chip_smoke.random_pnlk_state)(rng))
        batch = to_device(next(batch_iterator(chip_smoke.lk_pairs(B, masknet=masknet), B, shuffle=False)), "cuda")
        cfg = dict(task=args.model, masknet_loss="bce")
    elif args.model == "segmentation":
        from learning3d_tpu_torch.data import SyntheticPartSegmentation
        from learning3d_tpu_torch.models import Segmentation

        B, N, unit = chip_smoke.LK_B, chip_smoke.LK_N, "clouds"
        model = Segmentation(PointNet(emb_dims=chip_smoke.LK_EMB, use_bn=True, global_feat=False, dtype=dtype),
                             chip_smoke.SEG_CLASSES, dtype=dtype)
        load_nnx_state(model, chip_smoke.random_segmentation_state(rng))
        batch = to_device(next(batch_iterator(SyntheticPartSegmentation(num_points=N, size=B), B, shuffle=False)),
                          "cuda")
        cfg = dict(task="segmentation")
    elif args.model in ("pointconv", "curvenet", "dgcnn-cls"):
        B, N, unit = chip_smoke.CLS_B, chip_smoke.CLS_N, "clouds"
        make = {"pointconv": chip_smoke.make_pointconv, "curvenet": chip_smoke.make_curvenet,
                "dgcnn-cls": chip_smoke.make_dgcnn_cls}[args.model]
        state = chip_smoke.pointconv_state(rng) if args.model == "pointconv" else chip_smoke.seeded_state(make, rng)
        model = chip_smoke.from_state(make, state)
        batch = chip_smoke.cls_batch()
        cfg = dict(task="classification")
        if args.model == "curvenet":
            cfg.update(optimizer="sgd", momentum=0.9, weight_decay=chip_smoke.CURVE_WD, cosine_decay=True,
                       label_smoothing=chip_smoke.CURVE_SMOOTHING, augment=True)
    elif args.model in ("deepgmr", "masknet2"):
        B, N, unit = chip_smoke.CLS_B, chip_smoke.CLS_N, "pairs"
        deepgmr = args.model == "deepgmr"
        make = chip_smoke.make_deepgmr if deepgmr else chip_smoke.make_masknet2
        model = chip_smoke.from_state(make, chip_smoke.seeded_state(make, rng) if deepgmr else
                                      chip_smoke.masknet2_state(rng))
        data = chip_smoke.registration_data("deepgmr_noise" if deepgmr else "masknet2")
        batch = to_device(next(batch_iterator(data, B, shuffle=False)), "cuda")
        cfg = dict(task="deepgmr" if deepgmr else "masknet", masknet_loss="bce")
    elif args.model == "flownet":
        from learning3d_tpu_torch.data import FlowData, SyntheticSceneflow
        from learning3d_tpu_torch.models import FlowNet3D

        B, N, unit = chip_smoke.FLOW_B, chip_smoke.FLOW_N, "pairs"
        model = load_nnx_state(FlowNet3D(dtype=dtype), chip_smoke.random_flownet_state(rng))
        data = FlowData(SyntheticSceneflow(npoints=N, size=B))
        batch = to_device(next(batch_iterator(data, B, shuffle=False)), "cuda")
        cfg = dict(task="flow", optimizer="sgd", momentum=chip_smoke.FLOW_MOMENTUM)
    else:
        B, N, unit = chip_smoke.DCP_B, chip_smoke.DCP_N, "pairs"
        model = DCP(DGCNN(emb_dims=chip_smoke.DCP_EMB, k=chip_smoke.DCP_K, dtype=dtype), dtype=dtype)
        load_nnx_state(model, chip_smoke.random_dcp_state(rng, chip_smoke.DCP_EMB))
        data = RegistrationData("DCP", SyntheticModelNet40(num_points=N, size=B))
        batch = to_device(next(batch_iterator(data, B, shuffle=False)), "cuda")
        cfg = dict(task="dcp")
    with tempfile.TemporaryDirectory() as ckpt:
        lr = chip_smoke.CURVE_LR if args.model == "curvenet" else chip_smoke.TRAIN_LR
        trainer = Trainer(TrainConfig(batch_size=B, num_points=N, lr=lr, ckpt_dir=ckpt, **cfg), model)
        trainer._ensure_optimizer(1)
        for _ in range(3):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        plain_wall_s = time.perf_counter() - t0
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                trainer.train_step(batch)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        trainer.close()

    per_kernel, launches = {}, 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", 0.0)
        if us > 0:
            per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + us
            launches += evt.count
    busy_ms = sum(per_kernel.values()) / 1e3 / args.steps
    wall_ms = 1e3 * wall_s / args.steps
    plain_wall_ms = 1e3 * plain_wall_s / args.steps
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:25]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "model": args.model + ("-detailed" if args.detailed else ""), "dtype": dtype_name, "steps": args.steps,
        "batch": B, "points": N,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "wall_ms_per_step_unprofiled": plain_wall_ms,
        "device_idle_share_unprofiled": 1.0 - busy_ms / plain_wall_ms,
        "device_launches_per_step": launches / args.steps,
        f"{unit}_per_s": B / (wall_ms * 1e-3),
        "device_ms_per_step": {k: v / 1e3 / args.steps for k, v in top},
    }), flush=True)


if __name__ == "__main__":
    main()
