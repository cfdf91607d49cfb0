"""The generic Trainer of the port, counterpart of
``learning3d_tpu/train/trainer.py``: the train step (value and grad, the
gradient guard, one optimizer update, with optional gradient accumulation),
the epoch loop with its dataset hooks, best/latest checkpoints and the
feature-model export, a text log and optional tensorboard scalars.

Where the JAX package compiles the step, the port runs it eagerly on the
device it is given (``device="cuda"`` unless the caller asks for the CPU).
Checkpoints are the port's own: ``model.pt`` (the model's state_dict),
``opt.pt`` (the optimizer's and the learning-rate schedule's state_dicts)
and the JAX package's ``meta.json``, under ``<ckpt_dir>/<exp_name>/<name>/``.
"""

from __future__ import annotations

import functools
import json
import math
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from learning3d_tpu_torch import DEFAULT_DEVICE, resolve_device
from learning3d_tpu_torch.data.device_pipeline import (
    augment_classification_batch, batch_iterator, prefetch_to_device, to_device)
from learning3d_tpu_torch.train import tasks as _tasks
from learning3d_tpu_torch.train.config import TrainConfig


class IOStream:
    """Append-to-file + stdout text logger (the reference's IOStream). The
    file is opened at the first line, so a Trainer that only loads and
    evaluates writes nothing beside its checkpoint."""

    def __init__(self, path):
        self.path = Path(path)
        self.f = None

    def cprint(self, text):
        print(text)
        if self.f is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.f = open(self.path, "a")
        self.f.write(text + "\n")
        self.f.flush()

    def close(self):
        if self.f is not None:
            self.f.close()


def _dataset_version(ds, depth=4):
    """The distribution tag of a (possibly wrapped) dataset: walks the
    ``data_class``/``base`` chain for a ``version_tag()`` provider
    (SyntheticModelNet40). None for real or untagged datasets."""
    while ds is not None and depth > 0:
        if hasattr(ds, "version_tag"):
            return ds.version_tag()
        ds = getattr(ds, "data_class", getattr(ds, "base", None))
        depth -= 1
    return None


def cosine_decay(step: int, decay_steps: int) -> float:
    """optax.cosine_decay_schedule's factor at update ``step`` (0 for the
    first update): 0.5 (1 + cos(pi min(step, T) / T))."""
    return 0.5 * (1.0 + math.cos(math.pi * min(step, decay_steps) / decay_steps))


def _make_optimizer(cfg: TrainConfig, params, steps_per_epoch: int):
    """(optimizer, scheduler or None), the torch twins of the JAX package's
    optax chain: adam -> Adam(eps=1e-8); adam with weight decay -> AdamW
    (optax.adamw's decoupled decay); sgd -> SGD with momentum, weight decay
    added to the gradient before the momentum (optax.add_decayed_weights);
    cosine_decay -> a LambdaLR with optax's formula over epochs x steps,
    stepped after each update so that the first update uses the full lr."""
    params = list(params)
    if cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum, weight_decay=cfg.weight_decay)
    elif cfg.weight_decay:
        opt = torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    sched = None
    if cfg.cosine_decay:
        decay_steps = cfg.epochs * max(steps_per_epoch, 1)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, functools.partial(cosine_decay, decay_steps=decay_steps))
    return opt, sched


class Trainer:
    def __init__(self, config: TrainConfig, model: torch.nn.Module, loss_fn=None, mesh=None, augment_fn=None,
                 device=DEFAULT_DEVICE):
        if mesh is not None or config.mesh_shape is not None:
            raise NotImplementedError("mesh / mesh_shape: data-parallel training is not ported yet "
                                      "(ROADMAP Queue 1, the parallel/ item: parallel/ -> torch.distributed)")
        if config.remat:
            raise NotImplementedError("remat: not ported yet (ROADMAP Queue 1, the Trainer(remat=True) item); a "
                                      "torch.utils.checkpoint recompute would update the BatchNorm running "
                                      "statistics twice")
        self.cfg = config
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        wrong = {str(p.device) for p in model.parameters() if p.device != self.device}
        if wrong:
            raise ValueError(f"the model's parameters are on {sorted(wrong)}, the Trainer runs on {self.device}")
        self.model = model
        if loss_fn is None:
            if config.task not in _tasks.TASKS:
                raise NotImplementedError(f"task {config.task!r} is not ported yet")
            loss_fn = _tasks.TASKS[config.task]
            if config.task == "classification" and config.label_smoothing:
                loss_fn = functools.partial(_tasks.classification, smoothing=config.label_smoothing)
            if config.task == "masknet":
                loss_fn = functools.partial(_tasks.masknet, loss_fn=config.masknet_loss)
        self.loss_fn = loss_fn
        if augment_fn is None and config.augment and config.task == "classification":
            def augment_fn(generator, batch):
                return (augment_classification_batch(batch[0], generator=generator), *batch[1:])
        self.augment_fn = augment_fn
        # the step's randomness (augmentation, the loss_fn's draws): the
        # JAX Trainer's PRNG key
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.best_loss = float("inf")
        self.epoch = 0
        self.optimizer = None
        self.scheduler = None
        self.dataset_version = None
        self.accum = max(int(config.accum_steps or 1), 1)
        self.clip = float(config.grad_clip_norm or 0.0)
        self.skip_nonfinite = bool(config.skip_nonfinite)
        self.skipped_steps = 0  # steps whose update the non-finite guard zeroed (a device tensor once counted)
        self._warned_metric = False
        self.history = []  # one dict of losses and metrics per epoch of fit()
        self.textio = IOStream(Path(config.ckpt_dir) / config.exp_name / "run.log")
        self.writer = None  # tensorboard scalars, opened by fit

    # -- the step -----------------------------------------------------
    def _params(self):
        return [p for p in self.model.parameters() if p.requires_grad]

    def guard_grads(self, grads):
        """Global-norm clip and the non-finite skip, in place: scale every
        gradient by min(1, clip / max(norm, 1e-12)), and where the norm is
        not finite set every gradient to zeros (not None: the optimizer then
        still decays its moments and applies the momentum, as optax does on
        a skipped step). Skipped steps are counted in ``skipped_steps``
        without a host round trip."""
        if self.clip <= 0.0 and not self.skip_nonfinite:
            return
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
            scale = torch.ones((), device=gnorm.device)
            if self.clip > 0.0:
                scale = torch.clamp(self.clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            ok = torch.isfinite(gnorm) if self.skip_nonfinite else torch.ones((), dtype=torch.bool,
                                                                                device=gnorm.device)
            self.skipped_steps = self.skipped_steps + (~ok).int()
            for g in grads:
                g32 = g.float() * scale
                # nan * 0 == nan: a skipped step is where'd out, not scaled
                g.copy_(torch.where(ok, g32, torch.zeros_like(g32)))

    def forward_backward(self, batch):
        """Augment, then the loss and its gradients in each parameter's
        ``.grad`` (summed over ``accum_steps`` equal microbatches and
        divided by their count), guarded. -> (loss, aux), detached."""
        if self.augment_fn is not None:
            batch = self.augment_fn(self.generator, batch)
        params = self._params()
        for p in params:
            p.grad = None
        if self.accum == 1:
            loss, aux = self.loss_fn(self.model, batch, self.generator)
            loss.backward()
            loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
        else:
            # equal microbatches keep a mean-reduced loss the full batch's
            # (mean of means); BN statistics update once per microbatch
            b = batch[0].shape[0]
            if b % self.accum:
                raise ValueError(f"batch of {b} does not split into accum_steps={self.accum} equal microbatches")
            micro = [a.reshape((self.accum, b // self.accum) + tuple(a.shape[1:])) for a in batch]
            loss = aux = None
            for i in range(self.accum):
                li, ai = self.loss_fn(self.model, tuple(a[i] for a in micro), self.generator)
                li.backward()
                loss = li.detach() if loss is None else loss + li.detach()
                ai = {k: v.detach() for k, v in ai.items()}
                aux = ai if aux is None else {k: aux[k] + ai[k] for k in aux}
            inv = 1.0 / self.accum
            loss = loss * inv
            aux = {k: v * inv if torch.is_floating_point(v) else v for k, v in aux.items()}
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.grad.mul_(inv)
        for p in params:  # optax updates every parameter; torch skips a None grad
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.guard_grads([p.grad for p in params])
        return loss, aux

    def update(self):
        """One optimizer update, then one step of the learning-rate
        schedule."""
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()

    def train_step(self, batch):
        """One training step on a device batch -> (loss, aux), tensors on
        the device (no host synchronisation)."""
        loss, aux = self.forward_backward(batch)
        self.update()
        return loss, aux

    def eval_step(self, batch):
        with torch.no_grad():
            loss, aux = self.loss_fn(self.model, batch, self.generator)
        return loss, aux

    def _ensure_optimizer(self, steps_per_epoch: int):
        if self.optimizer is None:
            self.optimizer, self.scheduler = _make_optimizer(self.cfg, self._params(), steps_per_epoch)

    # -- checkpointing ------------------------------------------------
    def _ckpt_path(self, name):
        return Path(self.cfg.ckpt_dir).resolve() / self.cfg.exp_name / name

    def save(self, name="latest"):
        """Snapshot the model, the optimizer (and schedule) and the progress,
        like the reference's ``snap`` dict, which restores model and
        optimizer on --resume."""
        path = self._ckpt_path(name)
        path.mkdir(parents=True, exist_ok=True)
        torch.save(self.model.state_dict(), path / "model.pt")
        if self.optimizer is not None:
            torch.save({"optimizer": self.optimizer.state_dict(),
                        "scheduler": None if self.scheduler is None else self.scheduler.state_dict()},
                       path / "opt.pt")
        meta = {"epoch": self.epoch, "best_loss": self.best_loss}
        if self.dataset_version:
            # metrics against checkpoints trained on another synthetic
            # dataset version are not comparable
            meta["dataset_version"] = self.dataset_version
        (path / "meta.json").write_text(json.dumps(meta))

    def load(self, name="latest"):
        path = self._ckpt_path(name)
        # tensors load on the CPU: load_state_dict copies the model's into
        # place and moves the optimizer's moments to their parameters'
        # device, keeping Adam's step counts on the CPU where torch wants them
        self.model.load_state_dict(torch.load(path / "model.pt", map_location="cpu", weights_only=True))
        if self.optimizer is not None and (path / "opt.pt").exists():
            opt = torch.load(path / "opt.pt", map_location="cpu", weights_only=True)
            self.optimizer.load_state_dict(opt["optimizer"])
            if self.scheduler is not None and opt["scheduler"] is not None:
                self.scheduler.load_state_dict(opt["scheduler"])
        meta = json.loads((path / "meta.json").read_text())
        self.epoch = meta["epoch"]
        self.best_loss = meta["best_loss"]

    def export_feature_model(self, name="feature_model", attr="feature_model"):
        """Save just the encoder's state_dict for transfer (the reference's
        ptnet export, consumed by PointNetLK)."""
        path = self._ckpt_path(name)
        path.mkdir(parents=True, exist_ok=True)
        torch.save(getattr(self.model, attr).state_dict(), path / "model.pt")

    # -- loops --------------------------------------------------------
    def _epoch(self, dataset, train: bool):
        self.model.train(train)
        if hasattr(dataset, "set_epoch"):
            # fresh pairs per train epoch; eval pins epoch 0 so that its
            # metrics stay comparable across runs
            dataset.set_epoch(self.epoch if train else 0)
        # every step is queued without a host round trip; the losses are
        # read once at the end of the epoch
        losses, auxes, count = [], [], 0
        it = prefetch_to_device(
            batch_iterator(dataset, self.cfg.batch_size, shuffle=train, seed=self.cfg.seed + self.epoch),
            put=lambda b: to_device(b, self.device),
        )
        for batch in it:
            loss, aux = self.train_step(batch) if train else self.eval_step(batch)
            losses.append(loss)
            auxes.append(aux)
            count += 1
        n = max(count, 1)
        tot_loss = sum(float(l) for l in losses) / n
        tot_aux = {}
        for aux in auxes:
            for k, v in aux.items():
                tot_aux[k] = tot_aux.get(k, 0.0) + float(np.mean(v.float().cpu().numpy())) / n
        return tot_loss, tot_aux

    def _score(self, metric, test_loss, test_aux):
        """The JAX Trainer's selection: the test loss, or the test-aux entry
        ``metric``, falling back to the loss where the task reports no such
        entry (with a warning here, once)."""
        if metric == "loss":
            return test_loss
        if metric not in test_aux and not self._warned_metric:
            warnings.warn(f"best_metric {metric!r} is not among the test metrics {sorted(test_aux)}; "
                          "selecting the best checkpoint by the test loss", stacklevel=3)
            self._warned_metric = True
        return test_aux.get(metric, test_loss)

    def fit(self, train_data, test_data=None, epochs=None):
        epochs = self.cfg.epochs if epochs is None else epochs
        self.dataset_version = _dataset_version(train_data)
        self._ensure_optimizer(max(len(train_data) // self.cfg.batch_size, 1))
        if self.cfg.resume:
            self.load(self.cfg.resume)
        start = self.epoch
        cur = int(self.cfg.curriculum_epochs or 0)
        metric = self.cfg.best_metric or "loss"
        if self.writer is None:
            try:  # tensorboard scalars, like the reference's SummaryWriter
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(logdir=str(Path(self.cfg.ckpt_dir) / self.cfg.exp_name / "tb"))
            except Exception:
                pass
        for ep in range(start, epochs):
            self.epoch = ep
            if cur > 0 and hasattr(train_data, "set_difficulty"):
                # ramp 0.2 -> 1.0 over the first `cur` epochs, then full
                train_data.set_difficulty(min(1.0, 0.2 + 0.8 * ep / cur))
            t0 = time.time()
            train_loss, train_aux = self._epoch(train_data, train=True)
            record = {"epoch": ep, "train_loss": train_loss, **{f"train_{k}": v for k, v in train_aux.items()}}
            msg = f"epoch {ep}: train_loss={train_loss:.6f}"
            if test_data is not None:
                test_loss, test_aux = self._epoch(test_data, train=False)
                record.update(test_loss=test_loss, **{f"test_{k}": v for k, v in test_aux.items()})
                msg += f" test_loss={test_loss:.6f}"
                for k, v in test_aux.items():
                    msg += f" {k}={v:.4f}"
                score = self._score(metric, test_loss, test_aux)
                if score < self.best_loss:
                    self.best_loss = score
                    self.save("best")
            for k, v in train_aux.items():
                msg += f" train_{k}={v:.4f}"
            record["seconds"] = time.time() - t0
            msg += f" ({record['seconds']:.1f}s)"
            self.history.append(record)
            self.textio.cprint(msg)
            if self.writer is not None:
                self.writer.add_scalar("train/loss", train_loss, ep)
                for k, v in train_aux.items():
                    self.writer.add_scalar(f"train/{k}", v, ep)
                if test_data is not None:
                    self.writer.add_scalar("test/loss", test_loss, ep)
                    self.writer.add_scalar("test/best_loss", self.best_loss, ep)
                    for k, v in test_aux.items():
                        self.writer.add_scalar(f"test/{k}", v, ep)
            if (ep + 1) % self.cfg.save_every == 0:
                self.save("latest")
        return self.best_loss

    def evaluate(self, test_data):
        return self._epoch(test_data, train=False)

    def close(self):
        """Close the text log and the tensorboard writer."""
        self.textio.close()
        if self.writer is not None:
            self.writer.close()
