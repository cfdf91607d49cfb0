#!/usr/bin/env python3
"""What the CPU's rounding of ``ops.geometry.square_distance`` would cost on the card.

    python3 tools/torch_square_distance_ab.py [--rounds 8]

On the CPU ``square_distance`` emulates XLA's chain of fused multiply-adds in
float64 (the JAX package's CPU backend is the CPU tests' reference); on the
card it rounds each product and sum in float32. This script runs both on the
card, in one process and in alternating order: one call at FlowNet3D's kNN
shape (16, 256, 256), C=3 (host clock over 100 calls), FlowNet3D()'s eval
forward at B=16, N=2048 (host clock over 5 forwards) and its SGD train step
through the Trainer (host clock over 5 steps), with chip_smoke.py's
numpy-seeded weights and SyntheticSceneflow batch. Prints each reading and
the medians as JSON, with the card's name and power limit. Needs a CUDA card.
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
    parser.add_argument("--rounds", type=int, default=8)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_square_distance_ab: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from learning3d_tpu_torch.data import FlowData, SyntheticSceneflow, batch_iterator, to_device
    from learning3d_tpu_torch.models import FlowNet3D
    from learning3d_tpu_torch.ops import geometry
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    card = geometry.square_distance

    def f64_chain(src, dst):
        """The CPU's arithmetic of ``square_distance``, on whatever device."""
        src, dst = src.float(), dst.float()
        half = max(1, (src.shape[-2] + 1) // 2)
        src64, dst64 = src.double(), dst.double()
        dot = torch.cat([geometry._fma_dot(src[..., lo : lo + half, :], dst, src64[..., lo : lo + half, :], dst64)
                         for lo in range(0, max(src.shape[-2], 1), half)], dim=-2)
        return (-2.0 * dot + geometry._sq_norm(src)[..., :, None]) + geometry._sq_norm(dst)[..., None, :]

    versions = {"f32_card": card, "f64_chain": f64_chain}
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(chip_smoke.SEED)
    B, N = chip_smoke.FLOW_B, chip_smoke.FLOW_N
    model = load_nnx_state(FlowNet3D(), chip_smoke.random_flownet_state(rng))
    data = FlowData(SyntheticSceneflow(npoints=N, size=B))
    batch = to_device(next(batch_iterator(data, B, shuffle=False)), "cuda")
    q, p = torch.randn(16, 256, 3, device="cuda"), torch.randn(16, 256, 3, device="cuda")
    res = {name: {"call_us": [], "step_ms": [], "forward_ms": []} for name in versions}

    def timed(fn, reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    def order(rnd):
        return list(versions) if rnd % 2 == 0 else list(versions)[::-1]

    try:
        with tempfile.TemporaryDirectory() as ckpt:
            trainer = Trainer(TrainConfig(batch_size=B, num_points=N, lr=chip_smoke.FLOW_LR, ckpt_dir=ckpt,
                                          task="flow", optimizer="sgd", momentum=chip_smoke.FLOW_MOMENTUM), model)
            trainer._ensure_optimizer(1)
            for name in list(versions) * 3:
                geometry.square_distance = versions[name]
                trainer.train_step(batch)
            for rnd in range(args.rounds):
                for name in order(rnd):
                    geometry.square_distance = versions[name]
                    res[name]["step_ms"].append(1e3 * timed(lambda: trainer.train_step(batch), 5))
                    res[name]["call_us"].append(1e6 * timed(lambda: geometry.square_distance(q, p), 100))
            trainer.close()
        model.eval()
        with torch.inference_mode():
            for rnd in range(args.rounds):
                for name in order(rnd):
                    geometry.square_distance = versions[name]
                    model(*batch[:4])
                    res[name]["forward_ms"].append(1e3 * timed(lambda: model(*batch[:4]), 5))
    finally:
        geometry.square_distance = card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "readings": res,
                      "medians": {name: {k: float(np.median(v)) for k, v in r.items()} for name, r in res.items()}}),
          flush=True)


if __name__ == "__main__":
    main()
