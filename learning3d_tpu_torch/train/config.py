"""The training configuration, the port's own copy of
``learning3d_tpu/train/config.py``'s ``TrainConfig``: the same fields, the
same defaults and the same CLI override. ``Trainer`` refuses ``remat`` and
``mesh_shape``, which are not ported yet."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class TrainConfig:
    # experiment
    exp_name: str = "exp"
    # a key of train.tasks.TASKS: classification | pointnetlk | rpmnet | ipcrnet | dcp | prnet | pcn | masknet |
    # flow | segmentation
    task: str = "classification"
    algorithm: str = ""  # registration transform sampler name, if task == registration
    seed: int = 1234

    # data
    batch_size: int = 32
    num_points: int = 1024
    noise: bool = False
    augment: bool = False  # on-device train-time augmentation (classification)

    # optimization
    optimizer: str = "adam"  # adam | sgd (adam with weight_decay is AdamW)
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 0.0
    epochs: int = 200
    cosine_decay: bool = False
    accum_steps: int = 1  # gradient accumulation: microbatches per optimizer update
    remat: bool = False  # recompute the forward in the backward (not ported: the Trainer raises)
    label_smoothing: float = 0.0  # the CurveNet/DGCNN cal_loss epsilon
    masknet_loss: str = "bce"  # masknet loss: "bce" or "mse"
    grad_clip_norm: float = 0.0  # >0: clip grads to this global L2 norm
    # >0: ramp a registration loader's transform scale 0.2 -> 1.0 over this
    # many epochs (the dataset's set_difficulty); eval stays at 1.0
    curriculum_epochs: int = 0
    # the test-aux key that selects the "best" checkpoint ("loss" = test
    # loss); a key the task does not report falls back to the loss
    best_metric: str = "loss"
    # a non-finite gradient zeroes the update instead of poisoning the
    # parameters; the optimizer's moments still decay one step
    skip_nonfinite: bool = True

    # checkpointing
    ckpt_dir: str = "checkpoints"
    resume: str = ""
    save_every: int = 1

    # parallel
    mesh_shape: tuple | None = None  # not ported: the Trainer raises unless None

    extras: dict = field(default_factory=dict)

    @classmethod
    def from_cli(cls, argv=None):
        import argparse

        parser = argparse.ArgumentParser("learning3d_tpu_torch trainer")
        for f in dataclasses.fields(cls):
            if f.name in ("extras", "mesh_shape"):
                continue
            if f.type in ("bool", bool):
                parser.add_argument(f"--{f.name}", action="store_true", default=f.default)
            else:
                typ = {"int": int, "float": float, "str": str}.get(str(f.type), str)
                parser.add_argument(f"--{f.name}", type=typ, default=f.default)
        args = parser.parse_args(argv)
        return cls(**vars(args))
