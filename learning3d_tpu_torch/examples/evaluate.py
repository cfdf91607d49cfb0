"""The port's evaluation CLI, twin of the JAX package's
``examples/evaluate.py`` (one script for the reference's test_*.py
scripts): load a checkpoint, run the eval loop and print the task's
metrics, in the JAX script's line formats:

    python -m learning3d_tpu_torch.examples.evaluate --model dcp --task dcp --ckpt exp_dcp
    python -m learning3d_tpu_torch.examples.evaluate --model pointnet --ckpt exp_pointnet --quantize

prints ``test_loss=... <metric>=...`` and then, for a registration task,
the whole set's summary (``Stage: test, Rot_MSE: ...``; with ``--quantize
--task dcp`` also the ``int8-ptq`` and ``int8-pv`` summaries), for the
classifier with ``--quantize`` the line ``bf16_acc=... int8_acc=...
top1_agreement=... (n=...)``. The flags are the JAX script's plus
``--device`` (default ``cuda``; ``cpu`` where asked); the data are
``examples.train``'s.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

REGISTRATION_TASKS = ("dcp", "prnet", "ipcrnet", "pointnetlk", "rpmnet", "deepgmr")


def parser():
    p = argparse.ArgumentParser("learning3d_tpu_torch.examples.evaluate")
    p.add_argument("--model", default="pointnet")
    p.add_argument("--task", default="classification")
    p.add_argument("--ckpt", default="")
    p.add_argument("--ckpt_name", default="best")
    p.add_argument("--ckpt_dir", default="checkpoints")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--emb_dims", type=int, default=1024)
    p.add_argument("--nearest_neighbors", type=int, default=20)
    p.add_argument("--noise", action="store_true")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--dataset_size", type=int, default=2048,
                   help="SyntheticModelNet40 item count: match the training run's")
    p.add_argument("--param_jitter", type=float, default=0.0,
                   help="synthetic per-item shape jitter: match the training run's")
    p.add_argument("--hard_cls", action="store_true",
                   help="the hard synthetic classification set: match the training run's")
    p.add_argument("--detail_amp", type=float, default=0.04,
                   help="hard-mode corrugation amplitude: match the training run's")
    p.add_argument("--pcn_detailed", action="store_true",
                   help="PCN: build with the folding fine decoder: match the training run's")
    p.add_argument("--cls_noise", type=float, default=None,
                   help="synthetic per-point noise sigma override: match the training run's")
    p.add_argument("--masknet_ckpt", default="",
                   help="chain a trained MaskNet before registration: the template is filtered by the predicted "
                   "inlier mask and mask precision/recall/F1 are reported (the reference's test_masknet.py)")
    p.add_argument("--num_iters", type=int, default=0,
                   help="override the refinement iteration count of prnet/rpmnet/ipcrnet at eval time "
                   "(0 = model default)")
    p.add_argument("--multistart", type=int, default=0,
                   help="multi-start registration: fold K octahedral initial rotations into the batch and keep "
                   "the start with the lowest symmetric chamfer per item (serve.multistart_register; 0 = off, "
                   "K in [1, 24])")
    p.add_argument("--use_bn", action="store_true",
                   help="build the encoder with BatchNorm (ipcrnet checkpoints trained with --transfer_ptnet)")
    p.add_argument("--quantize", action="store_true",
                   help="also evaluate the int8 post-training-quantized serving mode of the checkpoint (--task dcp, "
                   "--task classification)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    """Run the evaluation and print its lines. -> dict: ``test_loss``,
    ``aux`` and, where computed, ``summary`` (with ``int8-ptq`` and
    ``int8-pv``) or ``quantized`` (``evaluate_classification_quantized``'s)."""
    from learning3d_tpu_torch import resolve_device
    from learning3d_tpu_torch.examples.train import build_dataset, build_model
    from learning3d_tpu_torch.train import TrainConfig, Trainer

    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = TrainConfig(exp_name=args.ckpt or f"exp_{args.model}", task=args.task, batch_size=args.batch_size,
                      num_points=args.num_points, ckpt_dir=args.ckpt_dir)
    model = build_model(args.model, args, torch.Generator().manual_seed(args.seed), device)
    trainer = Trainer(cfg, model, device=device)
    if args.ckpt:
        trainer.load(args.ckpt_name)
    if args.num_iters:
        # the iteration counts are plain attributes, not checkpoint state
        for attr in ("num_iters", "default_iterations"):
            if hasattr(model, attr):
                setattr(model, attr, args.num_iters)
    test_data = build_dataset(args, train=False)
    loss, aux = trainer.evaluate(test_data)
    print(f"test_loss={loss:.6f} " + " ".join(f"{k}={v:.4f}" for k, v in aux.items()), flush=True)
    result = {"test_loss": loss, "aux": aux}

    if args.task in REGISTRATION_TASKS:
        from learning3d_tpu_torch.train.metrics import format_registration_summary

        mask_model = None
        if args.masknet_ckpt:
            # the reference's test_masknet.py: partial sources, the ground
            # truth masks in the batches, the template filtered by the
            # predicted mask
            from learning3d_tpu_torch.data import RegistrationData
            from learning3d_tpu_torch.models import MaskNet, PointNet

            test_data = RegistrationData(algorithm="PointNetLK", data_class=test_data.data_class,
                                         partial_source=True, noise=args.noise,
                                         additional_params={"use_masknet": True})
            mask_model = MaskNet(PointNet(emb_dims=1024, use_bn=True, generator=torch.Generator().manual_seed(0),
                                          device=device),
                                 generator=torch.Generator().manual_seed(1), device=device)
            Trainer(TrainConfig(exp_name=args.masknet_ckpt, task="masknet", ckpt_dir=args.ckpt_dir), mask_model,
                    device=device).load(args.ckpt_name)
        summary = evaluate_registration(model, test_data, args, mask_model=mask_model)
        print(format_registration_summary(summary), flush=True)
        result["summary"] = summary
        if args.quantize and args.task == "dcp":
            from learning3d_tpu_torch.data import batch_iterator
            from learning3d_tpu_torch.quant import quantize_dcp

            calib = next(iter(batch_iterator(test_data, min(args.batch_size, 8), shuffle=False, seed=0)))
            ct, cs = (torch.from_numpy(np.ascontiguousarray(a[..., :3])).to(device) for a in calib[:2])
            for name, int8_pv in (("int8-ptq", False), ("int8-pv", True)):
                qmodel = quantize_dcp(model, ct, cs, int8_pv=int8_pv)
                result[name] = evaluate_registration(qmodel, test_data, args, mask_model=mask_model)
                print(f"{name} " + format_registration_summary(result[name]), flush=True)
    elif args.quantize and args.task == "classification":
        result["quantized"] = evaluate_classification_quantized(model, test_data, args)
    trainer.close()
    return result


def evaluate_classification_quantized(model, test_data, args):
    """Top-1 accuracy of the loaded Classifier(PointNet) and of its int8
    post-training quantization, and their agreement, over the test set in
    order (the JAX package's recipe: calibration on the first batch's first
    min(batch_size, 64) clouds, ``quant.quantize_pointnet_classifier``; the
    int8 forward through ``make_fused_quant_forward``, K2 on the card).

    The key ``bf16_acc`` keeps the JAX script's name; here it is the model
    as loaded, f32 in full f32 (TF32 stays off), where the TPU's default
    precision ran the matmuls in bf16 passes.

    Prints ``bf16_acc=... int8_acc=... top1_agreement=... (n=...)`` and
    returns those values with the labels and both argmaxes (numpy)."""
    from learning3d_tpu_torch.data import batch_iterator
    from learning3d_tpu_torch.quant import make_fused_quant_forward, quantize_pointnet_classifier

    model.eval()
    device = next(model.parameters()).device
    first = next(iter(batch_iterator(test_data, args.batch_size, shuffle=False, seed=0)))
    calib = torch.from_numpy(first[0][: min(args.batch_size, 64)]).to(device)
    qm = make_fused_quant_forward(quantize_pointnet_classifier(model, calib))
    labels, pred, pred_q = [], [], []
    with torch.inference_mode():
        for batch in batch_iterator(test_data, args.batch_size, shuffle=False, seed=0):
            x = torch.from_numpy(batch[0]).to(device)
            labels.append(np.asarray(batch[1]).reshape(-1))
            pred.append(model(x).argmax(-1).cpu().numpy())
            pred_q.append(qm(x).argmax(-1).cpu().numpy())
    y, p, pq = (np.concatenate(a) for a in (labels, pred, pred_q))
    n = len(y)
    out = {"bf16_acc": float((p == y).sum() / n), "int8_acc": float((pq == y).sum() / n),
           "top1_agreement": float((p == pq).sum() / n), "n": n, "labels": y, "pred": p, "pred_int8": pq}
    print(f"bf16_acc={out['bf16_acc']:.4f} int8_acc={out['int8_acc']:.4f} "
          f"top1_agreement={out['top1_agreement']:.4f} (n={n})", flush=True)
    return out


def evaluate_registration(model, test_data, args, mask_model=None):
    """The whole test set's registration summary (``summarize_registration``:
    Rot_RMSE, Rot_MAE, Trans_RMSE, point_RMSE in the reference's units).

    The argument order is the model's ``forward_arg_order`` (PRNet:
    "source_template"; every other model "template_source"). With
    ``args.multistart`` K each pair is registered from K rotation starts
    (``serve.multistart_register``, K12 on the card). With ``mask_model``
    (the reference's test_masknet.py) the template is first filtered by the
    predicted inlier mask, and the mask's accuracy, precision, recall and F1
    against the set's ground truth join the summary as ``mask_*``."""
    from learning3d_tpu_torch.data import batch_iterator
    from learning3d_tpu_torch.serve import multistart_register, rotation_starts
    from learning3d_tpu_torch.train.metrics import mask_scores, summarize_registration

    model.eval()
    device = next(model.parameters()).device
    order = getattr(model, "forward_arg_order", "template_source")
    rots = rotation_starts(args.multistart) if getattr(args, "multistart", 0) else None

    def fwd(template, source):
        if rots is not None:
            return multistart_register(model, template, source, rots)["est_T"]
        out = model(source, template) if order == "source_template" else model(template, source)
        return out["est_T"]

    if mask_model is not None:
        mask_model.eval()
    est_Ts, igts, templates, mask_metrics = [], [], [], []
    with torch.inference_mode():
        for batch in batch_iterator(test_data, args.batch_size, shuffle=False, seed=0):
            template, source = (torch.from_numpy(a).to(device) for a in batch[:2])
            if mask_model is not None:
                masked_template, pred_mask = mask_model(template, source)
                if len(batch) > 3:
                    gt_mask = torch.from_numpy(batch[3]).to(device)
                    mask_metrics.append({k: float(v) for k, v in mask_scores(pred_mask, gt_mask).items()})
                template = masked_template
            est_Ts.append(fwd(template, source).float().cpu().numpy())
            igts.append(np.asarray(batch[2]))
            templates.append(template[..., :3].float().cpu().numpy())
    summary = summarize_registration(np.concatenate(est_Ts), np.concatenate(igts), np.concatenate(templates))
    for k in mask_metrics[0] if mask_metrics else ():
        summary[f"mask_{k}"] = float(np.mean([m[k] for m in mask_metrics]))
    return summary


if __name__ == "__main__":
    main()
