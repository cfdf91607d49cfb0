#!/usr/bin/env python3
"""How far RPMNet on the kernels (K16, K17) lies from the same model on
their plain versions, served and in one f32 train step, next to the plain
path's own run-to-run spread, a one-ulp move of the source and a control,
over a few weight draws, on one card.

    python3 tools/torch_rpmnet_step_gaps.py

RPMNet() in f32 with chip_smoke.py's numpy-seeded weights
(``random_rpmnet_state``) on B=16 RegistrationData("RPMNet") pairs of
N=1024 points with normals. For each weight seed it prints one JSON line
with:
* ``serve``: the largest relative gap of est_T and transformed_source (max
  |k - p| / max |p|) and the absolute gap of r, of the kernels, of the
  plain path run again, and of the control ``k17_bf16_output`` (K17's
  output rounded to bf16), each against the plain versions' outputs
  (chip_smoke.py's ``rpm_gaps`` and ``plain_versions``);
* ``train``: the worst per-tensor relative gradient error and the loss's
  of one forward and backward through the Trainer (Adam's configuration) of
  the same four runs, and of the plain step on the source moved by one f32
  ulp (``torch.nextafter``): the gradient's own sensitivity to a
  rounding-sized change of its input. For sizing RPM_TOL and RPM_STEP_TOL.
  Needs a CUDA card.
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
SEEDS = (0, 1, 2)


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from learning3d_tpu_torch.data import RegistrationData, batch_iterator, to_device
    from learning3d_tpu_torch.models import RPMNet
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    b = cs.RPM_B
    batch = to_device(next(batch_iterator(RegistrationData("RPMNet", cs.rpm_clouds()), b, seed=cs.SEED)), "cuda")
    nudged = (batch[0], torch.nextafter(batch[1], torch.full_like(batch[1], float("inf"))), batch[2])
    for seed in SEEDS:
        state = cs.random_rpmnet_state(np.random.default_rng(seed))
        model = load_nnx_state(RPMNet(), state).eval()
        with torch.inference_mode():
            serve = {"kernels": cs.rpm_gaps(model, batch[:2], control=cs.k17_bf16_output)}
            with cs.plain_versions():
                serve["plain_again"] = cs.rpm_gaps(model, batch[:2])["rel_gap"]
        with tempfile.TemporaryDirectory() as ckpt:
            cfg = TrainConfig(task="rpmnet", batch_size=b, lr=cs.RPM_LR, ckpt_dir=ckpt)

            def make():
                return Trainer(cfg, load_nnx_state(RPMNet(), state))

            runs = cs.step_runs(make, batch, (cs.plain_versions, contextlib.nullcontext, cs.plain_versions,
                                              cs.k17_bf16_output))
            runs += cs.step_runs(make, nudged, (cs.plain_versions,))
        train = {}
        for label, run in zip(("kernels", "plain_again", "control", "one_ulp_source"), runs[1:]):
            worst, _ = cs.step_differences(run, runs[0], cs.RPM_STEP_TOL, (), cs.RPM_NOISE_TOL)
            train[label] = {k: worst.get(k) for k in ("grad", "grad_tensor", "loss")}
        print(json.dumps({"weight_seed": seed, "B": b, "N": cs.RPM_N, "card": card, "serve": serve,
                          "train": train}), flush=True)


if __name__ == "__main__":
    main()
