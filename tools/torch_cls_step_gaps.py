#!/usr/bin/env python3
"""Where the bf16 classifier train step on K3/K4 departs from the same step
on their plain versions, over several weight seeds, on one card.

    python3 tools/torch_cls_step_gaps.py [--seeds 12]

For each seed, ``tests/test_torch_cuda.py::test_train_step_kernels_match_plain``'s
case: Classifier(PointNet(1024, use_bn=True)) in bf16, weights drawn from a
``torch.Generator`` seeded with the seed, one forward and backward of
``tasks.classification`` in train mode on a (32, 512) batch made by numpy
(seed 11), three times: on K3/K4, on their plain versions
(``poolgrad.pool_stats_reference``/``pool_bwd_reference``), and on a plain
version whose sums are exact (chip_smoke.py's ``pool_stats_f64``: z, G and
the column sum in f64, rounded to f32 once). It prints one JSON line a seed:

* ``kernels``, ``f64``, ``control``: the worst per-tensor relative
  gradient error (the zero-gradient biases apart, as the test holds them)
  and the loss's, of the kernels' step, of the exact-sum step and of the
  test's control (``k3_misplaced``: 1.6% of K3's picks moved) against the
  plain step;
* ``k3_indices``: K3's argmax/argmin against the plain version's on the
  same bf16 inputs (those of the kernels' forward): how many differ, and
  for those the gap between the plain z at the two indices relative to
  max |z| (0 is an exact tie; a few 1e-7 a near tie that f32 rounding
  decides).

The test's tolerance must lie above the kernels' gaps and below the
control's; the exact-sum step shows how far the step moves when only the
rounding of f32 sums changes.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
ZERO_GRADIENT = {f"feature_model.convs.{i}.bias" for i in range(5)} | {
    "feature_model.bns.4.bias", "linear1.bias", "linear2.bias"}


def k3_misplaced(x, W, c):
    """tests/test_torch_cuda.py's control: K3 with the argmax and argmin of
    every 64th channel moved to the next point."""
    from learning3d_tpu_torch.kernels.poolgrad import pool_stats

    mx, mn, amax, amin, G, colsum = pool_stats(x, W, c)
    bad = torch.zeros_like(amax, dtype=torch.bool)
    bad[:, ::64] = True
    n_pts = x.shape[1]
    return mx, mn, torch.where(bad, (amax + 1) % n_pts, amax), torch.where(bad, (amin + 1) % n_pts, amin), G, colsum


def step(seed, batch, stats, bwd):
    """(loss, gradients) of one forward and backward with the tail's
    statistics from ``stats`` and its sparse backward from ``bwd``."""
    from learning3d_tpu_torch.models import Classifier, PointNet
    from learning3d_tpu_torch.train import tasks
    from learning3d_tpu_torch.utils import layers

    g = torch.Generator().manual_seed(seed)
    bf16 = torch.bfloat16
    model = Classifier(PointNet(emb_dims=1024, use_bn=True, dtype=bf16, generator=g, device="cuda"), 40, dtype=bf16,
                       generator=g, device="cuda",
                       dropout_generator=torch.Generator(device="cuda").manual_seed(3))
    saved = layers.pool_stats, layers.pool_bwd
    layers.pool_stats, layers.pool_bwd = stats, bwd
    try:
        loss, _ = tasks.classification(model.train(), batch)
        loss.backward()
    finally:
        layers.pool_stats, layers.pool_bwd = saved
    torch.cuda.synchronize()
    return loss.float().item(), {n: p.grad.float() for n, p in model.named_parameters()}


def gaps(run, ref):
    (lk, gk), (lp, gp) = run, ref
    worst, name, bias = 0.0, None, 0.0
    for n, g in gk.items():
        err = (g - gp[n]).norm().item()
        if n in ZERO_GRADIENT:
            bias = max(bias, err / gp[n.rsplit(".", 1)[0] + ".weight"].norm().item())
            continue
        rel = err / gp[n].norm().item()
        if rel >= worst:
            worst, name = rel, n
    return {"grad": worst, "grad_tensor": name, "zero_gradient_bias": bias, "loss": abs(lk - lp) / abs(lp)}


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=12)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from chip_smoke import pool_stats_f64
    from learning3d_tpu_torch.kernels import poolgrad

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(32, 512, 3)).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 40, 32)).cuda()
    summary = {"kernels": [], "f64": [], "control": [], "index_diffs": []}
    for seed in range(args.seeds):
        captured = []

        def k3(xx, W, c):
            captured.append((xx, W, c))
            return poolgrad.pool_stats(xx, W, c)

        kern = step(seed, (x, y), k3, poolgrad.pool_bwd)
        control = step(seed, (x, y), k3_misplaced, poolgrad.pool_bwd)
        plain = step(seed, (x, y), poolgrad.pool_stats_reference, poolgrad.pool_bwd_reference)
        exact = step(seed, (x, y), pool_stats_f64, poolgrad.pool_bwd_reference)
        xx, W, c = captured[0]
        got = poolgrad.pool_stats(xx, W, c)
        want = poolgrad.pool_stats_reference(xx, W, c)
        z = torch.matmul(xx.float(), W.float()) + c.float()
        scale = z.abs().max().item()
        idx = {}
        for name, gi, wi in (("amax", got[2], want[2]), ("amin", got[3], want[3])):
            diff = gi != wi
            at_k = torch.gather(z, 1, gi.long()[:, None, :])[:, 0][diff]
            at_p = torch.gather(z, 1, wi.long()[:, None, :])[:, 0][diff]
            idx[name] = {"differ": int(diff.sum()), "of": diff.numel(),
                         "max_z_gap": (at_k - at_p).abs().max().item() / scale if diff.any() else 0.0}
        line = {"seed": seed, "card": card, "kernels": gaps(kern, plain), "f64": gaps(exact, plain),
                "control": gaps(control, plain),
                "kernels_vs_f64": gaps(kern, exact), "k3_indices": idx}
        print(json.dumps(line), flush=True)
        summary["kernels"].append(line["kernels"]["grad"])
        summary["f64"].append(line["f64"]["grad"])
        summary["control"].append(line["control"]["grad"])
        summary["index_diffs"].append(idx["amax"]["differ"] + idx["amin"]["differ"])
    print(json.dumps({"summary": {k: {"min": min(v), "median": float(np.median(v)), "max": max(v)}
                                  for k, v in summary.items()}, "seeds": args.seeds, "card": card}), flush=True)


if __name__ == "__main__":
    main()
