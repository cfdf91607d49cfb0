#!/usr/bin/env python3
"""How far one f32 DCP train step on the kernels (K7, K6) lies from the same
step on their plain versions, and how far the control does, over a few
weight draws and batch sizes, on one card.

    python3 tools/torch_dcp_step_gaps.py

DCP(DGCNN(emb_dims=512, k=20)) in f32 through learning3d_tpu_torch's
Trainer (one forward and backward, ``Trainer.forward_backward``), with
chip_smoke.py's numpy-seeded weights (``random_dcp_state``) and a batch of
RegistrationData("DCP", SyntheticModelNet40) pairs of N=1024 points. For
each (B, weight seed) it prints one JSON line: the worst per-tensor
relative gradient error and the loss's relative error of the kernels'
step against the plain versions' (chip_smoke.py's ``plain_versions``), and
the same for the control (``k6_bf16_output``: K6's output rounded to
bf16). chip_smoke.py's ``DCP_STEP_TOL`` must lie above every kernel gap
and below every control gap. Needs a CUDA card.
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
# (B, weight seed): examples/train.py's batch, then the card test's B=4
CASES = ((32, 0), (4, 12), (4, 0), (4, 1))


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from learning3d_tpu_torch.data import RegistrationData, SyntheticModelNet40, batch_iterator, to_device
    from learning3d_tpu_torch.models import DCP, DGCNN
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    zero, noise = chip_smoke.DCP_ZERO_GRADIENT_BIASES, chip_smoke.DCP_NOISE_TOL
    for batch_size, seed in CASES:
        state = chip_smoke.random_dcp_state(np.random.default_rng(seed), chip_smoke.DCP_EMB)
        data = RegistrationData("DCP", SyntheticModelNet40(num_points=chip_smoke.DCP_N, size=batch_size))
        batch = to_device(next(batch_iterator(data, batch_size, seed=0)), "cuda")
        with tempfile.TemporaryDirectory() as ckpt:
            cfg = TrainConfig(task="dcp", batch_size=batch_size, optimizer="adam", lr=chip_smoke.TRAIN_LR,
                              ckpt_dir=ckpt)
            runs = chip_smoke.step_runs(
                lambda: Trainer(cfg, load_nnx_state(DCP(DGCNN(emb_dims=chip_smoke.DCP_EMB, k=chip_smoke.DCP_K)),
                                                    state)),
                batch, (contextlib.nullcontext, chip_smoke.plain_versions, chip_smoke.k6_bf16_output))
        line = {"B": batch_size, "weight_seed": seed, "card": card, "tolerance": chip_smoke.DCP_STEP_TOL}
        for label, run in (("kernels", runs[0]), ("control", runs[2])):
            worst, _ = chip_smoke.step_differences(run, runs[1], chip_smoke.DCP_STEP_TOL, zero, noise)
            line[label] = {"grad": worst["grad"], "grad_tensor": worst["grad_tensor"], "loss": worst["loss"]}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
