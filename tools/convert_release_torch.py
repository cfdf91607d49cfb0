#!/usr/bin/env python
"""Convert a trained release of the JAX package (an orbax checkpoint) into a
checkpoint of the PyTorch port, on a host that has JAX:

    python tools/convert_release_torch.py --name r4_pointnet_cls --model pointnet \\
        --task classification --predictions

restores ``<releases>/<name>/best`` through the JAX ``Trainer.load`` (from a
temporary directory whose ``best`` links to the release, so nothing is
written beside the release), copies its weights into the port's model
(``utils.jax_import.load_nnx_state``) and writes

- ``<out>/<name>/best/model.pt``: the port model's state dict (no optimizer
  state), which the port's ``Trainer.load`` reads with no JAX;
- ``<out>/<name>/best/meta.json``: the release's ``epoch``, ``best_loss`` and
  ``dataset_version``.

``--predictions`` (classifiers) also writes
``<out>/<name>/best/reference_predictions.npz``: the JAX package's results on
the release's eval set (SyntheticModelNet40(train=False) of
``--dataset_size`` clouds of ``--num_points``, in order), computed here on
the CPU: ``labels``, the f32 argmax ``pred`` and its top-1 minus top-2 logit
``margin``, and ``pred_int8``, the argmax of JAX's
``quantize_pointnet_classifier`` calibrated as ``examples/evaluate.py``
calibrates (the first batch's first min(batch_size, 64) clouds). It then
runs the port's plain (CPU) path on the same clouds and prints one JSON line
of the gaps: the largest f32 logit difference, the f32 argmaxes that differ
and JAX's margins there, and the share of int8 argmaxes that agree.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def restore(name, task, jmodel, releases):
    """``jmodel`` with the release's ``best`` weights, and the release's
    meta.json."""
    from learning3d_tpu.train import TrainConfig, Trainer

    best = Path(releases).resolve() / name / "best"
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / name).mkdir()
        os.symlink(best, Path(tmp) / name / "best")
        Trainer(TrainConfig(exp_name=name, task=task, ckpt_dir=tmp), jmodel, loss_fn=lambda *a: (0.0, {})).load("best")
    return jmodel, json.loads((best / "meta.json").read_text())


def nnx_flat(module):
    from flax import nnx

    return {".".join(map(str, path)): np.asarray(v.get_value())
            for path, v in nnx.to_flat_state(nnx.state(module)) if "rngs" not in path}


def eval_clouds(args):
    """The release's eval set as the evaluate scripts build it where
    ModelNet40 is absent, and its batches in order (drop_last)."""
    from learning3d_tpu.data import ClassificationData, SyntheticModelNet40
    from learning3d_tpu.data.device_pipeline import batch_iterator

    data = ClassificationData(SyntheticModelNet40(train=False, num_points=args.num_points, size=args.dataset_size))
    return list(batch_iterator(data, args.batch_size, shuffle=False, seed=0))


def jax_predictions(jmodel, batches, batch_size):
    import jax
    from flax import nnx

    from learning3d_tpu.quant import quantize_pointnet_classifier

    jmodel.eval()
    graphdef, state = nnx.split(jmodel)
    logits_f32 = jax.jit(lambda st, x: nnx.merge(graphdef, st)(x))
    qm = quantize_pointnet_classifier(jmodel, batches[0][0][: min(batch_size, 64)])
    q_fwd = jax.jit(lambda q, x: q(x))
    logits, pred_q, labels = [], [], []
    for x, y in batches:
        logits.append(np.asarray(logits_f32(state, x), np.float32))
        pred_q.append(np.asarray(q_fwd(qm, x)).argmax(-1))
        labels.append(np.asarray(y).reshape(-1))
    return np.concatenate(logits), np.concatenate(pred_q), np.concatenate(labels)


def top2_margin(logits):
    top = np.sort(logits, axis=-1)
    return top[:, -1] - top[:, -2]


def port_gaps(model, batches, batch_size, want_logits, want_q):
    """The port's plain path on the same clouds against JAX's results."""
    import torch

    from learning3d_tpu_torch.quant import make_fused_quant_forward, quantize_pointnet_classifier

    model.eval()
    qm = make_fused_quant_forward(quantize_pointnet_classifier(model, torch.from_numpy(batches[0][0][: min(batch_size,
                                                                                                           64)])))
    logits, pred_q = [], []
    with torch.inference_mode():
        for x, _ in batches:
            xt = torch.from_numpy(x)
            logits.append(model(xt).numpy())
            pred_q.append(qm(xt).argmax(-1).numpy())
    logits, pred_q = np.concatenate(logits), np.concatenate(pred_q)
    differ = np.flatnonzero(logits.argmax(-1) != want_logits.argmax(-1))
    margin = top2_margin(want_logits)
    return {"clouds": len(logits), "max_abs_logit_diff": float(np.abs(logits - want_logits).max()),
            "max_abs_logit": float(np.abs(want_logits).max()),
            "f32_argmax_differ": differ.tolist(), "jax_margin_there": margin[differ].tolist(),
            "smallest_jax_margins": np.sort(margin)[:8].tolist(),
            "int8_agree": float((pred_q == want_q).mean()), "int8_differ": int((pred_q != want_q).sum())}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--name", required=True, help="release directory name, e.g. r4_pointnet_cls")
    p.add_argument("--model", required=True, help="examples/train.py model name")
    p.add_argument("--task", required=True)
    p.add_argument("--releases", default=str(ROOT / "releases"))
    p.add_argument("--out", default=str(ROOT / "learning3d_tpu_torch" / "trained"))
    p.add_argument("--emb_dims", type=int, default=1024)
    p.add_argument("--nearest_neighbors", type=int, default=20)
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--dataset_size", type=int, default=2048)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--predictions", action="store_true",
                   help="also write the JAX package's predictions on the eval set (classifiers)")
    args = p.parse_args(argv)

    import torch
    from flax import nnx

    from examples.train import build_model as jax_build_model
    from learning3d_tpu_torch.examples.train import build_model
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    args.seed = 0
    jmodel, meta = restore(args.name, args.task, jax_build_model(args.model, args, nnx.Rngs(0)), args.releases)
    model = load_nnx_state(build_model(args.model, args, torch.Generator().manual_seed(0), "cpu"), nnx_flat(jmodel))
    best = Path(args.out) / args.name / "best"
    best.mkdir(parents=True, exist_ok=True)
    torch.save(model.state_dict(), best / "model.pt")
    (best / "meta.json").write_text(json.dumps({k: meta[k] for k in ("epoch", "best_loss", "dataset_version")
                                                if k in meta}))
    print(f"wrote {best}/model.pt ({(best / 'model.pt').stat().st_size} bytes) and meta.json", flush=True)
    if args.predictions:
        batches = eval_clouds(args)
        logits, pred_q, labels = jax_predictions(jmodel, batches, args.batch_size)
        np.savez_compressed(best / "reference_predictions.npz", labels=labels.astype(np.int8),
                            pred=logits.argmax(-1).astype(np.int8), margin=top2_margin(logits).astype(np.float32),
                            pred_int8=pred_q.astype(np.int8))
        print(json.dumps({"jax_accuracy": float((logits.argmax(-1) == labels).mean()),
                          "jax_int8_accuracy": float((pred_q == labels).mean()),
                          "jax_top1_agreement": float((pred_q == logits.argmax(-1)).mean()),
                          "port_cpu": port_gaps(model, batches, args.batch_size, logits, pred_q)}), flush=True)


if __name__ == "__main__":
    main()
