#!/usr/bin/env python3
"""How far FlowNet3D on the kernels (K14, K15, K8) lies from the same model on
their plain versions, served and in one f32 train step, next to the plain
path's own run-to-run spread, a one-ulp move of the input and a control,
over a few weight draws, on one card.

    python3 tools/torch_flownet_step_gaps.py

FlowNet3D() in f32 with chip_smoke.py's numpy-seeded weights
(``random_flownet_state``) on B=16 SyntheticSceneflow pairs of N=2048
points. For each weight seed it prints one JSON line with:
* ``serve``: the eval flow's largest relative gap (max |k - p| / max |p|)
  of the kernels, of the plain path run again, and of the control
  ``k15_nearest_first`` (each ball's nsample nearest points instead of the
  first nsample by index), each against the plain versions' flow
  (chip_smoke.py's ``plain_versions``);
* ``train``: the worst per-tensor relative gradient error, the loss's and
  the running statistics' of one forward and backward through the Trainer
  (``Trainer.forward_backward``, SGD's configuration) of the same four
  runs, and of the plain step on pc1 moved by one f32 ulp
  (``torch.nextafter``): the gradient's own sensitivity to a rounding-sized
  change of its input. For sizing FLOW_TOL and FLOW_STEP_TOL. Needs a CUDA
  card.
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
    from learning3d_tpu_torch.models import FlowNet3D
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    b = cs.FLOW_B
    pairs = [torch.from_numpy(a).cuda() for a in cs.flow_requests(b)]
    flow = pairs[1] - pairs[0]  # SyntheticSceneflow's flow is pc2 - pc1
    batch = (*pairs, flow, torch.ones(b, cs.FLOW_N, device="cuda"))
    nudged = (torch.nextafter(batch[0], torch.full_like(batch[0], float("inf"))), *batch[1:])
    zero, noise = cs.FLOW_ZERO_GRADIENT_BIASES, cs.FLOW_NOISE_TOL
    for seed in SEEDS:
        state = cs.random_flownet_state(np.random.default_rng(seed))
        model = load_nnx_state(FlowNet3D(), state).eval()
        with torch.inference_mode():
            want = None
            serve = {}
            for label, ctx in (("plain", cs.plain_versions), ("kernels", contextlib.nullcontext),
                               ("plain_again", cs.plain_versions), ("control", cs.k15_nearest_first)):
                with ctx():
                    out = model(*pairs)
                if want is None:
                    want = out
                    continue
                serve[label] = (out - want).abs().max().item() / want.abs().max().item()
        with tempfile.TemporaryDirectory() as ckpt:
            cfg = TrainConfig(task="flow", batch_size=b, optimizer="sgd", lr=cs.FLOW_LR, momentum=cs.FLOW_MOMENTUM,
                              ckpt_dir=ckpt)

            def make():
                return Trainer(cfg, load_nnx_state(FlowNet3D(), state))

            runs = cs.step_runs(make, batch, (cs.plain_versions, contextlib.nullcontext, cs.plain_versions,
                                              cs.k15_nearest_first))
            runs += cs.step_runs(make, nudged, (cs.plain_versions,))
        train = {}
        for label, run in zip(("kernels", "plain_again", "control", "one_ulp_pc1"), runs[1:]):
            worst, _ = cs.step_differences(run, runs[0], cs.FLOW_STEP_TOL, zero, noise)
            train[label] = {k: worst.get(k) for k in ("grad", "grad_tensor", "loss", "zero_gradient_bias",
                                                      "zero_gradient_bias_tensor", "running")}
        print(json.dumps({"weight_seed": seed, "B": b, "N": cs.FLOW_N, "card": card, "serve": serve,
                          "train": train}), flush=True)


if __name__ == "__main__":
    main()
