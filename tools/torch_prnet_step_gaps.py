#!/usr/bin/env python3
"""How far one f32 PRNet train step on the kernels (K8, K6) lies from the same
step on their plain versions, next to how far the plain step moves when the
source moves by one f32 ulp, over a few weight draws, at one and at three
iterations, on one card.

    python3 tools/torch_prnet_step_gaps.py

PRNet() (PRDGCNN(512, k=20), the transformer pointer, 512 keypoints of a
768-point partial source against a 1024-point template) in f32 through
learning3d_tpu_torch's Trainer (one forward and backward,
``Trainer.forward_backward``) with chip_smoke.py's numpy-seeded weights
(``random_prnet_state``) on a B=16 batch of RegistrationData("PRNet",
partial_source=True) pairs. For each (weight seed, iterations) it prints
one JSON line of worst per-tensor relative gradient errors and the loss's
relative error against the plain versions' step (chip_smoke.py's
``plain_versions``) of: the kernels' step; the plain step on the source
moved by one ulp (``torch.nextafter``), the gradient's own sensitivity to a
rounding-sized change of its input; and the control ``k6_bf16_output``
(K6's output rounded to bf16). Then, for each weight seed, one line of the
served model's gaps (``chip_smoke.prnet_gaps``: PRNet() in eval at B=32 on
normal (source, template) pairs, the largest relative gap of est_T and
transformed_source against the plain versions) at one and three iterations
and of the same control at one iteration, for sizing PRNET_TOL. Needs a
CUDA card.
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
SEEDS, ITERS = (0, 1, 2), (1, 3)


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from learning3d_tpu_torch.data import RegistrationData, SyntheticModelNet40, batch_iterator, to_device
    from learning3d_tpu_torch.models import PRNet
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    b = cs.PRNET_TRAIN_B
    data = RegistrationData("PRNet", SyntheticModelNet40(num_points=cs.PRNET_NT, size=b), partial_source=True)
    batch = to_device(next(batch_iterator(data, b, seed=0)), "cuda")
    nudged = (batch[0], torch.nextafter(batch[1], torch.full_like(batch[1], float("inf"))), batch[2])
    zero, noise = cs.PRNET_ZERO_GRADIENT_BIASES, cs.PRNET_NOISE_TOL
    for seed in SEEDS:
        state = cs.random_prnet_state(np.random.default_rng(seed))
        for iters in ITERS:
            with tempfile.TemporaryDirectory() as ckpt:
                cfg = TrainConfig(task="prnet", batch_size=b, optimizer="adam", lr=cs.TRAIN_LR, ckpt_dir=ckpt)

                def make():
                    return Trainer(cfg, load_nnx_state(PRNet(num_iters=iters), state))

                runs = cs.step_runs(make, batch, (contextlib.nullcontext, cs.plain_versions, cs.k6_bf16_output))
                runs += cs.step_runs(make, nudged, (cs.plain_versions,))
            line = {"weight_seed": seed, "iters": iters, "B": b, "card": card}
            for label, run in (("kernels", runs[0]), ("one_ulp_source", runs[3]), ("control", runs[2])):
                worst, _ = cs.step_differences(run, runs[1], cs.PRNET_STEP_TOL, zero, noise)
                line[label] = {k: worst.get(k) for k in ("grad", "grad_tensor", "loss", "zero_gradient_bias",
                                                         "zero_gradient_bias_tensor", "running")}
            print(json.dumps(line), flush=True)
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        model = load_nnx_state(PRNet(), cs.random_prnet_state(rng)).eval()
        source = torch.from_numpy(rng.normal(size=(cs.PRNET_B, cs.PRNET_NS, 3)).astype(np.float32)).cuda()
        template = torch.from_numpy(rng.normal(size=(cs.PRNET_B, cs.PRNET_NT, 3)).astype(np.float32)).cuda()
        with torch.inference_mode():
            gaps = cs.prnet_gaps(model, source, template, control=cs.k6_bf16_output)
        print(json.dumps({"serve_weight_seed": seed, "B": cs.PRNET_B, "card": card, **gaps}), flush=True)


if __name__ == "__main__":
    main()
