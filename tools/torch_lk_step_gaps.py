#!/usr/bin/env python3
"""How far one f32 train step of PointNetLK and of MaskNet on K3/K4 lies
from the same step on their plain versions, next to the plain path's own
run-to-run spread and to each candidate control, over a few weight draws,
on one card.

    python3 tools/torch_lk_step_gaps.py

PointNetLK(PointNet(1024, use_bn=True)) (10 iterations, task pointnetlk)
and MaskNet(PointNet(1024, use_bn=True)) (bce) in f32 with chip_smoke.py's
numpy-seeded weights (``random_pnlk_state``, ``random_masknet_state``) on
B=32 RegistrationData("PointNetLK") pairs of its cached clouds (MaskNet: a
768-point partial source). For each family and weight seed it prints one
JSON line with the worst per-tensor relative error of the loss, the
gradients, the cancelling biases (against their layer's weight gradient)
and the running statistics, of one forward and backward through the Trainer
(chip_smoke.py's ``step_runs`` and ``step_differences``) for: the kernels,
the kernels again, the plain versions again, and the controls
``k3_bf16_input`` (K3 fed its input rounded to bf16), ``k3_misplaced``
(every 64th channel's picks on the next point) and
``k3_last_tile_dropped`` (each cloud's last 128 points left out), each
against the plain versions' step. For sizing LK_STEP_TOL, MASK_STEP_TOL
and the controls. Needs a CUDA card.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (1, 2)


@contextlib.contextmanager
def k3_bf16_input():
    """K3 fed its f32 input rounded to bf16: the statistics a kernel that
    dropped the low half of its bf16 hi/lo split would give."""
    from learning3d_tpu_torch.utils import layers

    kernel = layers.pool_stats
    layers.pool_stats = lambda x, W, c: kernel(x.to(torch.bfloat16).to(x.dtype), W, c)
    try:
        yield
    finally:
        layers.pool_stats = kernel


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from learning3d_tpu_torch.data import batch_iterator, to_device
    from learning3d_tpu_torch.models import MaskNet, PointNet, PointNetLK
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    runs_of = {"kernels": contextlib.nullcontext, "kernels_again": contextlib.nullcontext,
               "plain_again": cs.plain_poolgrad, "k3_bf16_input": k3_bf16_input, "k3_misplaced": cs.k3_misplaced,
               "k3_last_tile_dropped": cs.k3_last_tile_dropped}
    families = {"pointnetlk": (PointNetLK, cs.random_pnlk_state, False, cs.LK_ZERO_GRADIENT_BIASES),
                "masknet": (MaskNet, cs.random_masknet_state, True, cs.MASK_ZERO_GRADIENT_BIASES)}
    for family, (model, draw, masknet, zero) in families.items():
        batch = to_device(next(batch_iterator(cs.lk_pairs(cs.LK_B, masknet=masknet), cs.LK_B, seed=cs.SEED)), "cuda")
        for seed in SEEDS:
            state = draw(np.random.default_rng(seed))
            with tempfile.TemporaryDirectory() as ckpt:
                cfg = TrainConfig(task=family, batch_size=cs.LK_B, lr=cs.TRAIN_LR, masknet_loss="bce", ckpt_dir=ckpt)
                runs = cs.step_runs(lambda: Trainer(cfg, load_nnx_state(model(PointNet(emb_dims=cs.LK_EMB,
                                                                                       use_bn=True)), state)),
                                    batch, (cs.plain_poolgrad, *runs_of.values()))
            gaps = {}
            for label, run in zip(runs_of, runs[1:]):
                worst, _ = cs.step_differences(run, runs[0], float("inf"), zero, float("inf"))
                gaps[label] = worst
            print(json.dumps({"family": family, "weight_seed": seed, "B": cs.LK_B, "card": card, **gaps}),
                  flush=True)


if __name__ == "__main__":
    main()
