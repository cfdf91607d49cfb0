#!/usr/bin/env python
"""Convert a trained release of the JAX package (an orbax checkpoint) into a
checkpoint of the PyTorch port, on a host that has JAX:

    python tools/convert_release_torch.py --name r4_pointnet_cls --model pointnet \\
        --task classification --predictions
    python tools/convert_release_torch.py --name r4b_rpmnet --model rpmnet --task rpmnet --predictions
    python tools/convert_release_torch.py --name r4_flownet --model flownet --task flow \\
        --dataset_size 256 --predictions

restores ``<releases>/<name>/best`` through the JAX ``Trainer.load`` (from a
temporary directory whose ``best`` links to the release, so nothing is
written beside the release), copies its weights into the port's model
(``utils.jax_import.load_nnx_state``) and writes

- ``<out>/<name>/best/model.pt``: the port model's state dict (no optimizer
  state), which the port's ``Trainer.load`` reads with no JAX;
- ``<out>/<name>/best/meta.json``: the release's ``epoch``, ``best_loss`` and
  ``dataset_version``.

``--predictions`` also writes ``<out>/<name>/best/reference_predictions.npz``,
the JAX package's results computed here on the CPU, and then runs the
port's plain (CPU) path on the same inputs and prints one JSON line of the
gaps. By task:

- ``classification``: the release's eval set (SyntheticModelNet40(train=False)
  of ``--dataset_size`` clouds of ``--num_points``, in order): ``labels``,
  the f32 argmax ``pred`` and its top-1 minus top-2 logit ``margin``, and
  ``pred_int8``, the argmax of JAX's ``quantize_pointnet_classifier``
  calibrated as ``examples/evaluate.py`` calibrates (the first batch's first
  min(batch_size, 64) clouds). Gaps: the largest f32 logit difference, the
  f32 argmaxes that differ and JAX's margins there, the share of int8
  argmaxes that agree.
- ``rpmnet``: the first PAIRS (16) pairs of the eval set as
  ``examples/evaluate.py`` builds it (RegistrationData("RPMNet") over
  SyntheticModelNet40(train=False, use_normals=True), in order): JAX's
  ``est_T`` and ``transformed_source``, the pairs' ``igt``, and the per-pair
  ``rot_deg`` and ``trans`` of ``learning3d_tpu.train.metrics``.
- ``flow``: the first PAIRS pairs of SyntheticSceneflow(npoints=
  ``--num_points``, size=``--dataset_size``), in order: JAX's ``flow``, the
  ground truth ``flow_gt``, and the per-pair ``epe``, ``acc3d_strict`` and
  ``acc3d_relax`` of the flow task's formulas (``learning3d_tpu/train/tasks.py``).

No clouds are stored: both packages rebuild them from the same numpy seeds.
Gaps (registration and flow): the largest difference of each output over
its largest value, and of the per-pair metrics.
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
# registration and flow: the pairs stored, the eval set's first batch of 16
# (chip_smoke.py's TRAINED_PAIRS)
PAIRS = 16
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


def first_pairs(args):
    """The first PAIRS items of the release's eval set, stacked, in
    batch order (the evaluate script's ``batch_iterator(shuffle=False)``)."""
    from learning3d_tpu.data import RegistrationData, SyntheticModelNet40, SyntheticSceneflow

    if args.task == "rpmnet":
        data = RegistrationData("RPMNet", SyntheticModelNet40(train=False, num_points=args.num_points,
                                                              size=args.dataset_size, use_normals=True))
    else:
        data = SyntheticSceneflow(npoints=args.num_points, size=args.dataset_size)
    items = [data[i] for i in range(PAIRS)]
    return tuple(np.stack([it[j] for it in items]) for j in range(len(items[0])))


def flow_metrics(pred, flow):
    """Per-pair EPE and Acc3D (strict 0.05, relaxed 0.10, absolute or
    relative), the flow task's formulas."""
    err = np.linalg.norm(pred - flow, axis=-1)
    mag = np.linalg.norm(flow, axis=-1)
    rel = err / (mag + 1e-12)
    return {"epe": err.mean(-1), "acc3d_strict": ((err < 0.05) | (rel < 0.05)).mean(-1),
            "acc3d_relax": ((err < 0.10) | (rel < 0.10)).mean(-1)}


def jax_pair_predictions(jmodel, task, inputs) -> dict:
    """JAX's CPU results on the pairs, with their per-pair metrics."""
    import jax
    import jax.numpy as jnp
    from flax import nnx

    from learning3d_tpu.train.metrics import registration_errors

    jmodel.eval()
    if task == "rpmnet":
        template, source, igt = inputs
        out = nnx.jit(lambda m, a, b: m(a, b))(jmodel, jnp.asarray(template), jnp.asarray(source))
        err = jax.tree.map(np.asarray, registration_errors(out["est_T"], jnp.asarray(igt)))
        return {"est_T": np.asarray(out["est_T"], np.float32),
                "transformed_source": np.asarray(out["transformed_source"], np.float32),
                "igt": igt.astype(np.float32), "rot_deg": err["rot_deg"].astype(np.float32),
                "trans": err["trans"].astype(np.float32)}
    pos1, pos2, color1, color2, flow, _ = inputs
    pred = np.asarray(nnx.jit(lambda m, *a: m(*a))(jmodel, *(jnp.asarray(a) for a in (pos1, pos2, color1, color2))),
                      np.float32)
    return {"flow": pred, "flow_gt": flow.astype(np.float32),
            **{k: v.astype(np.float32) for k, v in flow_metrics(pred, flow).items()}}


def port_pair_gaps(model, task, inputs, want) -> dict:
    """The port's plain path on the same pairs against JAX's results."""
    import torch

    from learning3d_tpu_torch.train.metrics import registration_errors

    model.eval()

    def rel(got, key):
        return float(np.abs(got - want[key]).max() / np.abs(want[key]).max())

    with torch.inference_mode():
        if task == "rpmnet":
            out = model(*(torch.from_numpy(a) for a in inputs[:2]))
            err = registration_errors(out["est_T"], torch.from_numpy(inputs[2]))
            got = {"est_T": out["est_T"].numpy(), "transformed_source": out["transformed_source"].numpy(),
                   "rot_deg": err["rot_deg"].numpy(), "trans": err["trans"].numpy()}
        else:
            pred = model(*(torch.from_numpy(a) for a in inputs[:4])).numpy()
            got = {"flow": pred, **flow_metrics(pred, inputs[4])}
    gaps = {f"{k}_max_rel_diff": rel(v, k) for k, v in got.items() if k in ("est_T", "transformed_source", "flow")}
    gaps.update({f"{k}_max_abs_diff": float(np.abs(v - want[k]).max()) for k, v in got.items()
                 if k not in ("est_T", "transformed_source", "flow")})
    if task == "rpmnet":
        per_pair = np.abs(got["est_T"] - want["est_T"]).reshape(len(got["est_T"]), -1).max(-1)
    else:
        per_pair = np.abs(got["flow"] - want["flow"]).reshape(len(got["flow"]), -1).max(-1)
    gaps["per_pair_max_abs_diff"] = per_pair.tolist()
    return {"pairs": len(per_pair), **gaps}


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
                   help="also write the JAX package's results on the eval set (classification, rpmnet, flow)")
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
    if args.predictions and args.task in ("rpmnet", "flow"):
        inputs = first_pairs(args)
        want = jax_pair_predictions(jmodel, args.task, inputs)
        np.savez_compressed(best / "reference_predictions.npz", **want)
        metrics = [k for k in want if want[k].ndim == 1]
        print(json.dumps({"npz_bytes": (best / "reference_predictions.npz").stat().st_size,
                          "jax_cpu": {k: float(want[k].mean()) for k in metrics},
                          "port_cpu": port_pair_gaps(model, args.task, inputs, want)}), flush=True)
    elif args.predictions:
        if args.task != "classification":
            raise SystemExit(f"--predictions takes the tasks classification, rpmnet and flow, not {args.task!r}")
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
