#!/usr/bin/env python3
"""Where the time of the port's training step goes, on one card.

    python3 tools/profile_torch_train.py [--model pointnet|dcp|ipcrnet|pcn] [--detailed] [--dtype bf16|f32]
                                         [--steps 10]

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
Chamfer term. All run through learning3d_tpu_torch's Trainer (its
train_step on one device batch), with the numpy-seeded weights of
chip_smoke.py. After a few warm-up
steps, ``--steps`` steps run under torch.profiler. Prints one JSON line:
host wall time per step, device time per step by kernel (largest first),
the device's idle share (1 - device busy time / wall time) and the launches
per step. Needs a CUDA card.
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
    parser.add_argument("--model", choices=("pointnet", "dcp", "ipcrnet", "pcn"), default="pointnet")
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
    else:
        B, N, unit = chip_smoke.DCP_B, chip_smoke.DCP_N, "pairs"
        model = DCP(DGCNN(emb_dims=chip_smoke.DCP_EMB, k=chip_smoke.DCP_K, dtype=dtype), dtype=dtype)
        load_nnx_state(model, chip_smoke.random_dcp_state(rng, chip_smoke.DCP_EMB))
        data = RegistrationData("DCP", SyntheticModelNet40(num_points=N, size=B))
        batch = to_device(next(batch_iterator(data, B, shuffle=False)), "cuda")
        cfg = dict(task="dcp")
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = Trainer(TrainConfig(batch_size=B, num_points=N, lr=chip_smoke.TRAIN_LR, ckpt_dir=ckpt, **cfg), model)
        trainer._ensure_optimizer(1)
        for _ in range(3):
            trainer.train_step(batch)
        torch.cuda.synchronize()
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
        "device_launches_per_step": launches / args.steps,
        f"{unit}_per_s": B / (wall_ms * 1e-3),
        "device_ms_per_step": {k: v / 1e3 / args.steps for k, v in top},
    }), flush=True)


if __name__ == "__main__":
    main()
