#!/usr/bin/env python3
"""Where the time of the port's bf16 classifier serving goes, on one card.

    python3 tools/profile_torch_serve.py [--requests 20]

Builds Classifier(PointNet(emb_dims=1024, use_bn=True)) in bf16 eval with
the numpy-seeded weights of chip_smoke.py, serves requests of B=256 clouds
of N=1024 points through learning3d_tpu_torch's InferenceEngine under
torch.profiler, and prints one JSON line: host wall time per request,
device time per request by kernel (largest first), and the device's idle
share (1 - device busy time / wall time). Needs a CUDA card.
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--requests", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from learning3d_tpu_torch.models import Classifier, PointNet
    from learning3d_tpu_torch.serve import InferenceEngine
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    B, N, EMB, CLASSES = chip_smoke.B, chip_smoke.N, chip_smoke.EMB, chip_smoke.CLASSES
    rng = np.random.default_rng(chip_smoke.SEED)
    bf16 = torch.bfloat16
    model = Classifier(PointNet(emb_dims=EMB, use_bn=True, dtype=bf16), CLASSES, dtype=bf16)
    load_nnx_state(model, chip_smoke.random_nnx_state(rng, EMB, CLASSES))
    engine = InferenceEngine(model, batch_size=B)
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    for _ in range(3):
        engine(x)
    torch.cuda.synchronize()

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            engine(x)
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
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "requests": args.requests, "batch": B, "points": N,
        "wall_ms_per_request": wall_ms,
        "device_busy_ms_per_request": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches_per_request": launches / args.requests,
        "device_ms_per_request": {k: v / 1e3 / args.requests for k, v in top},
    }), flush=True)


if __name__ == "__main__":
    main()
