"""The port's train CLI, twin of the JAX package's ``examples/train.py``
(one script for the reference's train_*.py scripts):

    python -m learning3d_tpu_torch.examples.train --model pointnet --task classification
    python -m learning3d_tpu_torch.examples.train --model dcp --task dcp
    python -m learning3d_tpu_torch.examples.train --model pointnetlk --task pointnetlk \\
        --transfer_ptnet exp_pointnet

The flags and their defaults are the JAX script's, plus ``--device``
(default ``cuda``): the model, the steps and the batches run there; without
a card, ``cuda`` raises and ``--device cpu`` runs on the CPU (kernels as
their plain PyTorch versions).

The dataset is ModelNet40 from ``$LEARNING3D_DATA`` (else
``~/.learning3d_tpu/data``) where it is there and h5py is installed,
otherwise the procedural ``SyntheticModelNet40`` (a ``[data]`` line says
which). Unlike the JAX script, the CLI never downloads the archive: a run
reaches no network (``data.download_modelnet40()`` fetches it once).
Checkpoints are the port's (``model.pt``, ``opt.pt``, ``meta.json``) under
``<ckpt_dir>/<exp_name>/``; ``--export_feature`` writes the encoder to
``<exp_name>/feature_model/model.pt``, which ``--transfer_ptnet`` reads.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from learning3d_tpu_torch import DEFAULT_DEVICE

MODELS = ("pointnet", "pointconv", "curvenet", "dgcnn-cls", "segmentation", "dcp", "prnet", "ipcrnet", "pointnetlk",
          "rpmnet", "deepgmr", "masknet", "masknet2", "pcn", "flownet")


def build_model(name, args, generator=None, device=DEFAULT_DEVICE):
    """The model ``name`` at the JAX script's widths, its weights drawn from
    ``generator`` (a CPU ``torch.Generator``) and its dropout masks from a
    generator on ``device`` seeded with ``args.seed``."""
    from learning3d_tpu_torch import models

    g = dict(generator=generator, device=device)
    drop = torch.Generator(device=device).manual_seed(getattr(args, "seed", 0))
    if name == "pointnet":
        pn = models.PointNet(emb_dims=args.emb_dims, use_bn=True, **g)
        return models.Classifier(pn, num_classes=40, dropout_generator=drop, **g)
    if name == "pointconv":
        return models.PointConvDensityClsSsg(classifier=True, dropout_generator=drop, **g)
    if name == "curvenet":
        return models.CurveNet(dropout_generator=drop, **g)
    if name == "dgcnn-cls":
        return models.Classifier(models.DGCNN(emb_dims=args.emb_dims, **g), dropout_generator=drop, **g)
    if name == "segmentation":
        pn = models.PointNet(emb_dims=args.emb_dims, use_bn=True, global_feat=False, **g)
        return models.Segmentation(pn, **g)
    if name == "dcp":
        return models.DCP(models.DGCNN(emb_dims=512, **g), **g)
    if name == "prnet":
        return models.PRNet(**g)
    if name == "ipcrnet":
        # --transfer_ptnet starts the encoder from the classifier's exported
        # feature model, whose PointNet has BatchNorm; a cold start keeps the
        # reference's use_bn=False (train_pcrnet.py:206)
        use_bn = bool(getattr(args, "transfer_ptnet", "") or getattr(args, "use_bn", False))
        return models.iPCRNet(models.PointNet(emb_dims=1024, use_bn=use_bn, **g), dropout_generator=drop, **g)
    if name == "pointnetlk":
        return models.PointNetLK(models.PointNet(emb_dims=1024, use_bn=True, **g), device=device)
    if name == "rpmnet":
        return models.RPMNet(**g)
    if name == "deepgmr":
        return models.DeepGMR(use_rri=True, nearest_neighbors=args.nearest_neighbors, **g)
    if name == "masknet":
        return models.MaskNet(models.PointNet(emb_dims=1024, use_bn=True, **g), **g)
    if name == "masknet2":
        return models.MaskNet2(**g)
    if name == "pcn":
        # --pcn_detailed adds the folding fine decoder (the reference trains
        # coarse only, examples/train_pcn.py:58)
        return models.PCN(emb_dims=1024, detailed_output=getattr(args, "pcn_detailed", False), **g)
    if name == "flownet":
        return models.FlowNet3D(**g)
    raise ValueError(f"unknown model {name!r}; choose from: {', '.join(MODELS)}")


def build_dataset(args, train):
    """The JAX script's data for ``args.task``: ModelNet40 where a local copy
    can be read, else SyntheticModelNet40 (with the ``[data]`` line), wrapped for
    the task (classification and pcn items, registration pairs of the
    task's algorithm, part segmentation, scene flow)."""
    from learning3d_tpu_torch.data import (ClassificationData, ModelNet40Data, RegistrationData, SceneflowDataset,
                                           SyntheticModelNet40)

    use_normals = args.task == "rpmnet"
    try:
        base = ModelNet40Data(train=train, num_points=args.num_points, use_normals=use_normals, download=False)
    except Exception as e:
        print(f"[data] ModelNet40 unavailable ({e}); using SyntheticModelNet40")
        base = SyntheticModelNet40(
            train=train, num_points=args.num_points, size=getattr(args, "dataset_size", 2048),
            param_jitter=getattr(args, "param_jitter", 0.0), use_normals=use_normals,
            hard=getattr(args, "hard_cls", False), detail_amp=getattr(args, "detail_amp", 0.04),
            noise=getattr(args, "cls_noise", None))

    if args.task == "segmentation":
        from learning3d_tpu_torch.data import SegmentationData, SyntheticPartSegmentation

        return SegmentationData(SyntheticPartSegmentation(train=train, num_points=args.num_points))
    if args.task in ("classification", "pcn"):
        return ClassificationData(base)
    if args.task == "flow":
        ds = SceneflowDataset(npoints=args.num_points, partition="train" if train else "test")
        if len(ds) == 0:
            from learning3d_tpu_torch.data import SyntheticSceneflow

            print("[data] Sceneflow npz unavailable; using SyntheticSceneflow")
            ds = SyntheticSceneflow(npoints=args.num_points)
        return ds
    algo = {"dcp": "DCP", "prnet": "PRNet", "ipcrnet": "iPCRNet", "pointnetlk": "PointNetLK", "rpmnet": "RPMNet",
            "deepgmr": "DeepGMR", "masknet": "DCP"}[args.task]
    if args.task == "masknet":
        # reference train_masknet.py:157: a partial source, and the mask of
        # the template points that survive in it
        return RegistrationData(algorithm=algo, data_class=base, partial_source=True, noise=args.noise,
                                additional_params={"use_masknet": True})
    return RegistrationData(algorithm=algo, data_class=base, partial_source=args.task == "prnet", noise=args.noise,
                            additional_params={})


def parser():
    p = argparse.ArgumentParser("learning3d_tpu_torch.examples.train")
    p.add_argument("--model", default="pointnet")
    p.add_argument("--task", default="classification")
    p.add_argument("--pcn_detailed", action="store_true",
                   help="PCN: add the folding fine decoder (trains and reports coarse+fine chamfer)")
    p.add_argument("--exp_name", default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--emb_dims", type=int, default=1024)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", default="adam")
    p.add_argument("--cosine", action="store_true", help="cosine lr decay (the reference's CurveNet recipe)")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--noise", action="store_true")
    p.add_argument("--augment", action="store_true",
                   help="on-device rotate/scale/jitter augmentation (classification)")
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--masknet_loss", default="bce", choices=["bce", "mse"],
                   help="masknet training loss (the reference's train_masknet.py offers both)")
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off); non-finite steps are always skipped")
    p.add_argument("--curriculum", type=int, default=0,
                   help="ramp the registration train loader's transform scale 0.2 -> 1.0 over this many epochs "
                   "(0 = off; eval stays at 1.0)")
    p.add_argument("--best_metric", default="loss",
                   help="test-aux key that selects the best checkpoint (e.g. rot_deg; default: test loss)")
    p.add_argument("--nearest_neighbors", type=int, default=20)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--resume", default="")
    p.add_argument("--ckpt_dir", default="checkpoints")
    p.add_argument("--dataset_size", type=int, default=2048,
                   help="SyntheticModelNet40 item count (synthetic fallback only)")
    p.add_argument("--param_jitter", type=float, default=0.0,
                   help="per-item relative shape-parameter jitter of the synthetic set")
    p.add_argument("--hard_cls", action="store_true",
                   help="the hard synthetic classification set: classes told apart only by label-keyed local "
                   "corrugations near the noise floor")
    p.add_argument("--detail_amp", type=float, default=0.04, help="hard-mode corrugation amplitude")
    p.add_argument("--cls_noise", type=float, default=None, help="synthetic per-point noise sigma override")
    p.add_argument("--transfer_ptnet", default="",
                   help="exp_name whose exported feature_model initializes this model's encoder (the "
                   "reference's PointNetLK workflow)")
    p.add_argument("--export_feature", action="store_true",
                   help="after training, export the best checkpoint's feature_model for transfer")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = parser().parse_args(argv)

    from learning3d_tpu_torch import resolve_device
    from learning3d_tpu_torch.train import TrainConfig, Trainer

    device = resolve_device(args.device)
    cfg = TrainConfig(
        exp_name=args.exp_name or f"exp_{args.model}", task=args.task, batch_size=args.batch_size,
        num_points=args.num_points, epochs=args.epochs, lr=args.lr, optimizer=args.optimizer,
        cosine_decay=args.cosine, momentum=args.momentum, seed=args.seed, resume=args.resume,
        ckpt_dir=args.ckpt_dir, noise=args.noise, augment=args.augment, label_smoothing=args.label_smoothing,
        weight_decay=args.weight_decay, grad_clip_norm=args.grad_clip, masknet_loss=args.masknet_loss,
        curriculum_epochs=args.curriculum, best_metric=args.best_metric,
    )
    model = build_model(args.model, args, torch.Generator().manual_seed(args.seed), device)
    if args.transfer_ptnet:
        # the reference's PointNetLK recipe: train the classifier first and
        # start this model's encoder from its exported PointNet
        path = Path(args.ckpt_dir).resolve() / args.transfer_ptnet / "feature_model" / "model.pt"
        model.feature_model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
        print(f"[transfer] feature_model initialized from {path}")
    trainer = Trainer(cfg, model, device=device)
    train_data = build_dataset(args, train=True)
    test_data = build_dataset(args, train=False)
    trainer.fit(train_data, test_data)
    if args.export_feature:
        if trainer._ckpt_path("best").is_dir():  # the best snapshot's encoder, not the last epoch's
            trainer.load("best")
        trainer.export_feature_model()
        print(f"[transfer] exported feature_model under {cfg.exp_name}/feature_model")
    trainer.close()
    return trainer


if __name__ == "__main__":
    main()
