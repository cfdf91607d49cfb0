"""The port's training slice against the JAX package on the CPU:
train-mode BatchNorm, dropout, one train step of the PointNet classifier
through the Trainer, the optimizers, the gradient guard, gradient
accumulation, the data pipeline and the checkpoints.

Inputs and weights are made with numpy from a seed; weights cross through
``load_nnx_state``.
"""

import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from learning3d_tpu.data import dataloaders as jdata
from learning3d_tpu.data import device_pipeline as jpipe
from learning3d_tpu.models import Classifier as JClassifier
from learning3d_tpu.models import PointNet as JPointNet
from learning3d_tpu.train import TrainConfig as JTrainConfig
from learning3d_tpu.train import Trainer as JTrainer
from learning3d_tpu.train import tasks as jtasks
from learning3d_tpu.train import trainer as jtrainer
from learning3d_tpu.utils import layers as jlayers
from learning3d_tpu_torch.data import (
    ClassificationData, SyntheticModelNet40, augment_classification_batch, batch_iterator, prefetch_to_device)
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.losses import classification_loss
from learning3d_tpu_torch.models import Classifier, PointNet
from learning3d_tpu_torch.train import TrainConfig, Trainer, tasks
from learning3d_tpu_torch.train.trainer import _make_optimizer
from learning3d_tpu_torch.utils import layers as tlayers
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from test_torch_poolgrad import tpu_guard
from torch_port_util import cloud, nnx_flat, randomize_bn

EMB, CLASSES, B, N = 128, 40, 8, 128
DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- train-mode BatchNorm and dropout ------------------------------------

# f32: the same statistics, f32 sums in another order. bf16: the output is
# rounded to bf16 on both sides, the statistics in f32.
BN_TOL = {"f32": 1e-5, "bf16": 1e-2}


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 30, 16), (6, 16)])
def test_batchnorm_train_matches_nnx(name, shape):
    """Output, gradients (x, scale, bias) and the running statistics after
    two calls, against nnx.BatchNorm(momentum=0.9) in train mode."""
    jdt, tdt = DTYPES[name]
    c = shape[-1]
    jbn = nnx.BatchNorm(c, use_running_average=False, momentum=0.9, dtype=jdt, rngs=nnx.Rngs(0))
    randomize_bn(jbn, np.random.default_rng(1))
    tbn = tlayers.BatchNorm(c, dtype=tdt, device="cpu")
    load_nnx_state(tbn, nnx_flat(jbn))
    rng = np.random.default_rng(2)
    x1, x2 = (rng.normal(1.0, 2.0, shape).astype(np.float32) for _ in range(2))
    wts = rng.normal(size=shape).astype(np.float32)
    jbn(jnp.asarray(x1))
    tbn(torch.from_numpy(x1))

    def loss(bn, x):
        return jnp.sum(bn(x).astype(jnp.float32) * wts)

    gbn, gx = nnx.grad(loss, argnums=(0, 1))(jbn, jnp.asarray(x2))
    out_j = jbn(jnp.asarray(x2), use_running_average=True)  # after the two updates
    tx = torch.from_numpy(x2).requires_grad_(True)
    out = tbn(tx)
    (out.float() * torch.from_numpy(wts)).sum().backward()
    assert out.shape == shape and out.dtype == (tdt or torch.float32)
    assert rel(tx.grad, gx) <= BN_TOL[name]
    assert rel(tbn.weight.grad, gbn.scale[...]) <= BN_TOL[name]
    assert rel(tbn.bias.grad, gbn.bias[...]) <= BN_TOL[name]
    assert rel(tbn.running_mean, jbn.mean[...]) <= 1e-6
    assert rel(tbn.running_var, jbn.var[...]) <= 1e-6
    with torch.no_grad():
        assert rel(tbn(torch.from_numpy(x2), use_running_average=True).float(), out_j.astype(jnp.float32)) \
            <= BN_TOL[name]


def test_batchnorm_keeps_the_biased_fast_variance():
    """The running variance moves by 0.1 of the biased E[x^2] - E[x]^2
    (torch's own BatchNorm would take 0.1 of the unbiased variance)."""
    bn = tlayers.BatchNorm(1, device="cpu")
    bn(torch.tensor([[0.0], [2.0]]))
    assert float(bn.running_mean) == pytest.approx(0.1)
    assert float(bn.running_var) == pytest.approx(0.9 * 1.0 + 0.1 * 1.0)  # biased var of {0, 2} is 1
    bn(torch.tensor([[3.0], [3.0]]), use_running_average=True)  # an eval call leaves them
    assert float(bn.running_mean) == pytest.approx(0.1)


def test_dropout_semantics():
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(0)
    drop = tlayers.Dropout(0.7, generator=gen, device="cpu")
    y = drop(x)
    kept = y != 0
    assert 0.27 < kept.float().mean().item() < 0.33
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.3))
    gen.manual_seed(0)
    assert torch.equal(drop(x), y)  # the same generator state, the same mask
    assert not torch.equal(drop(x), y)  # the generator moved on
    drop.eval()
    assert drop(x) is x
    drop.train()
    drop.rate = 0.0
    assert drop(x) is x


def test_classifier_dropout_draws_from_its_generator():
    m1, m2 = (Classifier(PointNet(emb_dims=64, use_bn=True, device="cpu"), 10, device="cpu",
                         dropout_generator=torch.Generator().manual_seed(5)) for _ in range(2))
    m2.load_state_dict(m1.state_dict())
    x = torch.from_numpy(cloud(4, 32))
    torch.manual_seed(1)
    a = m1.train()(x)
    torch.manual_seed(2)  # the global RNG plays no part
    b = m2.train()(x)
    assert torch.equal(a, b)
    assert m1.dropout1.generator is m1.dropout2.generator


def test_use_running_average_override_and_set_bn_mode():
    net = PointNet(emb_dims=EMB, use_bn=True, device="cpu")
    x = torch.from_numpy(cloud(2, 64))
    stats = {k: v.clone() for k, v in net.state_dict().items() if "running" in k}
    with torch.no_grad():
        frozen = net.pooled_features(x, use_running_average=True)
        per_point = net(x, use_running_average=True)
    assert all(torch.equal(v, net.state_dict()[k]) for k, v in stats.items())
    tlayers.set_bn_mode(net, True)
    assert not net.training
    with torch.no_grad():
        assert torch.equal(net.pooled_features(x), frozen)
        assert torch.equal(net(x), per_point)
    tlayers.set_bn_mode(net, False)
    assert net.training
    with torch.no_grad():
        net.pooled_features(x)
    assert not torch.equal(stats["bns.4.running_mean"], net.bns[4].running_mean)


# -- one train step of the slice against the JAX Trainer -----------------

def recorder():
    """An optax transformation that updates nothing and keeps the gradients
    it is given in its state: the JAX Trainer's own step then hands them
    over (after its gradient guard)."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u))


def step_batch():
    return cloud(B, N, seed=21), (np.arange(B) * 7 % CLASSES).astype(np.int64)


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """One ``Trainer._train_step`` of the JAX package per dtype, dropout off:
    the weights before, the loss, the gradients and the state after. bf16
    opens the TPU guard of ``utils/layers`` so that JAX runs K3 and K4 in
    Pallas interpret mode (counted); f32 takes its XLA branch."""
    x, y = step_batch()
    out = {}
    for name, (jdt, _) in DTYPES.items():
        jm = JClassifier(JPointNet(emb_dims=EMB, use_bn=True, dtype=jdt, rngs=nnx.Rngs(0)), CLASSES, dtype=jdt,
                         rngs=nnx.Rngs(1))
        jm.dropout1.rate = jm.dropout2.rate = 0.0
        before = nnx_flat(jm)
        tr = JTrainer(JTrainConfig(batch_size=B, ckpt_dir=str(tmp_path_factory.mktemp(name))), jm)
        tr._tx = recorder()
        tr.optimizer = nnx.Optimizer(tr.model, tr._tx, wrt=nnx.Param)
        calls = {"stats": 0, "bwd": 0}
        saved = jlayers._pool_stats_pallas, jlayers._pool_bwd_pallas

        def counted(fn, key):
            def wrapped(*a, **k):
                calls[key] += 1
                return fn(*a, **k)
            return wrapped

        jlayers._pool_stats_pallas, jlayers._pool_bwd_pallas = counted(saved[0], "stats"), counted(saved[1], "bwd")
        try:
            with tpu_guard() if name == "bf16" else contextlib.nullcontext():
                loss, aux = tr._train_step(tr.model, tr.optimizer, (x, y), jax.random.PRNGKey(0))
        finally:
            jlayers._pool_stats_pallas, jlayers._pool_bwd_pallas = saved
        grads = {".".join(map(str, p[1:])): np.asarray(v.get_value())
                 for p, v in nnx.to_flat_state(nnx.state(tr.optimizer)) if p[0] == "opt_state"}
        out[name] = {"before": before, "loss": float(loss), "accuracy": float(aux["accuracy"]),
                     "grads": nnx_to_torch(grads), "after": nnx_to_torch(nnx_flat(jm)), "calls": calls}
    return out


# f32: the same math (K3/K4's plain versions against JAX's XLA branch), f32
# sums in another order: loss and statistics to 1e-5, each gradient to 1e-3
# of its norm. bf16: both run the kernels' math, but XLA and torch round the
# bf16 activations at other places (2^-8 each), and the train-mode
# BatchNorms' backward cancels most of a gradient's terms, so a bf16
# gradient of this step lies far from the f32 one (the JAX package's own
# bf16 and f32 steps, same weights and batch). Each port gradient is held to
# JAX's bf16 gradient within that distance, or within 5% of its layer's
# weight gradient where the exact gradient vanishes (a bias in front of a
# train-mode BatchNorm); the loss to 1e-2 and the statistics to 2e-2.
STEP_TOL = {"f32": {"loss": 1e-5, "grad": 1e-3, "stats": 1e-5},
            "bf16": {"loss": 1e-2, "grad": 5e-2, "stats": 2e-2}}


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_train_step_matches_jax(jax_steps, name, tmp_path):
    """The port's Trainer step (forward, backward, guard) on the same
    weights and batch as the JAX Trainer's: the loss, every parameter's
    gradient and the BN running statistics."""
    ref = jax_steps[name]
    assert ref["calls"] == ({"stats": 1, "bwd": 1} if name == "bf16" else {"stats": 0, "bwd": 0})
    _, tdt = DTYPES[name]
    tm = Classifier(PointNet(emb_dims=EMB, use_bn=True, dtype=tdt, device="cpu"), CLASSES, dtype=tdt, device="cpu")
    load_nnx_state(tm, ref["before"])
    tm.dropout1.rate = tm.dropout2.rate = 0.0
    tr = Trainer(TrainConfig(batch_size=B, ckpt_dir=str(tmp_path)), tm, device="cpu")
    x, y = step_batch()
    launches = dict(LAUNCHES)
    loss, aux = tr.forward_backward((torch.from_numpy(x), torch.from_numpy(y)))
    assert LAUNCHES == launches  # CPU tensors: the plain versions
    tol = STEP_TOL[name]
    assert abs(float(loss) - ref["loss"]) <= tol["loss"] * abs(ref["loss"])
    assert float(aux["accuracy"]) == ref["accuracy"]
    grads = dict(tm.named_parameters())
    assert set(grads) == set(ref["grads"])
    for key, p in grads.items():
        want = np.asarray(ref["grads"][key], np.float64)
        weight = np.linalg.norm(ref["grads"][key.rsplit(".", 1)[0] + ".weight"])
        err = np.linalg.norm(p.grad.double().numpy() - want)
        if name == "f32":
            # a bias in front of a train-mode BatchNorm has no gradient in
            # exact arithmetic: its noise is held to its layer's weight gradient
            assert err <= tol["grad"] * max(np.linalg.norm(want), 1e-3 * weight), key
        else:
            gap = np.linalg.norm(want - jax_steps["f32"]["grads"][key])
            assert err <= max(gap, tol["grad"] * weight), key
    for key, buf in tm.named_buffers():
        assert rel(buf, ref["after"][key]) <= tol["stats"], key


def test_bf16_step_runs_the_kernels_plain_versions(monkeypatch, tmp_path):
    """At K = E = 128 the bf16 step goes through K3's and K4's wrappers once
    each (their plain versions on the CPU)."""
    from learning3d_tpu_torch.kernels import poolgrad

    calls = []
    monkeypatch.setattr(tlayers, "pool_stats", lambda *a: calls.append("stats") or poolgrad.pool_stats(*a))
    monkeypatch.setattr(tlayers, "pool_bwd", lambda *a: calls.append("bwd") or poolgrad.pool_bwd(*a))
    tm = Classifier(PointNet(emb_dims=EMB, use_bn=True, dtype=torch.bfloat16, device="cpu"), CLASSES,
                    dtype=torch.bfloat16, device="cpu")
    tr = Trainer(TrainConfig(batch_size=B, ckpt_dir=str(tmp_path)), tm, device="cpu")
    x, y = step_batch()
    tr.forward_backward((torch.from_numpy(x), torch.from_numpy(y)))
    assert calls == ["stats", "bwd"]


# -- optimizers, the gradient guard, accumulation ------------------------

def optax_run(cfg, params, grads, steps_per_epoch):
    tx = jtrainer._make_optimizer(cfg, steps_per_epoch)
    params = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in params.items()}


def port_run(cfg, params, grads, steps_per_epoch):
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt, sched = _make_optimizer(cfg, ps.values(), steps_per_epoch)
    for g in grads:
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        if sched is not None:
            sched.step()
    return {k: p.detach().numpy() for k, p in ps.items()}


@pytest.mark.parametrize("opt", ["adam", "adamw", "sgd", "sgd_wd", "sgd_plain", "adam_cosine", "sgd_cosine"])
def test_optimizers_match_optax(opt):
    """The same numpy gradients for 3 updates through the JAX package's
    ``_make_optimizer`` (optax, flattened) and the port's (torch.optim):
    the parameters agree to f32 rounding."""
    kw = {"adam": {}, "adamw": {"weight_decay": 0.05}, "sgd": {"optimizer": "sgd"},
          "sgd_wd": {"optimizer": "sgd", "weight_decay": 0.05}, "sgd_plain": {"optimizer": "sgd", "momentum": 0.0},
          "adam_cosine": {"cosine_decay": True, "epochs": 1}, "sgd_cosine": {"optimizer": "sgd", "cosine_decay": True,
                                                                         "epochs": 2}}[opt]
    rng = np.random.default_rng(3)
    params = {"w": rng.normal(size=(5, 4)).astype(np.float32), "b": rng.normal(size=4).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()} for _ in range(3)]
    want = optax_run(JTrainConfig(lr=0.1, **kw), params, grads, steps_per_epoch=2)
    got = port_run(TrainConfig(lr=0.1, **kw), params, grads, steps_per_epoch=2)
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-6, atol=2e-6)
        assert not np.allclose(got[k], params[k])


def tiny_trainer(tmp_path, **cfg):
    """A Trainer over a 3 -> 1 linear model of the mean point, with an MSE
    loss (the JAX package's accumulation test model)."""
    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(3, 1)
            with torch.no_grad():
                self.lin.weight.copy_(torch.tensor([[0.5, -0.25, 0.125]]))
                self.lin.bias.fill_(0.1)

        def forward(self, x):
            return self.lin(x.mean(1))

    def lf(model, batch, generator):
        x, y = batch
        loss = torch.mean((model(x)[:, 0] - y) ** 2)
        return loss, {"mse": loss}

    base = dict(batch_size=8, ckpt_dir=str(tmp_path), exp_name="tiny")
    return Trainer(TrainConfig(**{**base, **cfg}), Tiny(), loss_fn=lf, device="cpu")


def tiny_batch():
    rng = np.random.default_rng(4)
    return torch.from_numpy(rng.normal(size=(8, 16, 3)).astype(np.float32)), \
        torch.from_numpy(rng.normal(size=8).astype(np.float32))


def test_accum_steps_matches_full_batch(tmp_path):
    """accum_steps=4 makes the same update as the full batch (equal
    microbatches: the mean of the means)."""
    results = {}
    for accum in (1, 4):
        tr = tiny_trainer(tmp_path / str(accum), optimizer="sgd", lr=0.1, momentum=0.0, accum_steps=accum)
        tr._ensure_optimizer(1)
        loss, aux = tr.train_step(tiny_batch())
        results[accum] = (float(loss), float(aux["mse"]), [p.detach().clone() for p in tr.model.parameters()])
    np.testing.assert_allclose(results[1][0], results[4][0], rtol=1e-6)
    np.testing.assert_allclose(results[1][1], results[4][1], rtol=1e-6)
    for a, b in zip(results[1][2], results[4][2]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="equal microbatches"):
        tiny_trainer(tmp_path / "odd", accum_steps=3).forward_backward(tiny_batch())


def test_guard_grads_clips_to_the_global_norm(tmp_path):
    tr = tiny_trainer(tmp_path, grad_clip_norm=1.0)
    grads = [torch.tensor([3.0, 0.0]), torch.tensor([[4.0]])]  # global norm 5
    tr.guard_grads(grads)
    assert torch.allclose(grads[0], torch.tensor([0.6, 0.0])) and torch.allclose(grads[1], torch.tensor([[0.8]]))
    small = [torch.tensor([0.3, 0.4])]
    tr.guard_grads(small)
    assert torch.equal(small[0], torch.tensor([0.3, 0.4]))
    assert int(tr.skipped_steps) == 0


def test_nonfinite_step_is_skipped_and_adam_moments_decay(tmp_path):
    """A NaN gradient zeroes the whole update's gradients (zeros, not None),
    so Adam's moments decay and its momentum still moves the parameters,
    as optax's Adam does with zero gradients."""
    tr = tiny_trainer(tmp_path, lr=0.01)
    tr._ensure_optimizer(1)
    params = {"w": tr.model.lin.weight.detach().numpy().copy(), "b": tr.model.lin.bias.detach().numpy().copy()}
    g1 = {"w": np.array([[0.3, -0.2, 0.1]], np.float32), "b": np.array([0.5], np.float32)}
    for g in (g1, {"w": np.array([[np.nan, 0.0, 0.0]], np.float32), "b": np.array([1.0], np.float32)}):
        tr.model.lin.weight.grad = torch.from_numpy(g["w"].copy())
        tr.model.lin.bias.grad = torch.from_numpy(g["b"].copy())
        tr.guard_grads([tr.model.lin.weight.grad, tr.model.lin.bias.grad])
        tr.update()
    assert int(tr.skipped_steps) == 1
    assert torch.equal(tr.model.lin.bias.grad, torch.zeros(1))
    zeros = {k: np.zeros_like(v) for k, v in g1.items()}
    tx = optax.adam(0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    for g in (g1, zeros):
        up, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, up)
    # torch and optax order Adam's bias corrections and square root
    # differently: f32 rounding of a few operations
    np.testing.assert_allclose(tr.model.lin.weight.detach().numpy(), np.asarray(jp["w"]), rtol=1e-5)
    np.testing.assert_allclose(tr.model.lin.bias.detach().numpy(), np.asarray(jp["b"]), rtol=1e-5)
    m = tr.optimizer.state[tr.model.lin.bias]["exp_avg"]
    np.testing.assert_allclose(m.numpy(), np.asarray(st[0].mu["b"]), rtol=1e-6)


# -- tasks and losses -----------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.2])
def test_classification_task_matches_jax(smoothing):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(6, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 6)
    jl, ja = jtasks.classification(lambda p: jnp.asarray(logits), (None, jnp.asarray(labels)), None, smoothing)
    tl, ta = tasks.classification(lambda p: torch.from_numpy(logits), (None, torch.from_numpy(labels)), None,
                                  smoothing)
    assert rel(tl, jl) <= 1e-6 and float(ta["accuracy"]) == float(ja["accuracy"])
    logp = torch.log_softmax(torch.from_numpy(logits), -1)
    assert float(classification_loss(logp, torch.from_numpy(labels))) == pytest.approx(
        float(-logp[torch.arange(6), torch.from_numpy(labels)].mean()))


# -- data ------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"train": False, "size": 100}, {"hard": True, "param_jitter": 0.1},
                                {"use_normals": True, "num_points": 64}, {"unseen": True, "train": False}])
def test_synthetic_modelnet40_matches_jax(kw):
    kw = {"num_points": 128, **kw}
    jds, tds = jdata.SyntheticModelNet40(**kw), SyntheticModelNet40(**kw)
    assert tds.version_tag() == jds.version_tag() and len(tds) == len(jds)
    for i in (0, 7, 41):
        (ja, jl), (ta, tl) = jds[i], tds[i]
        assert tl == jl and ta.dtype == ja.dtype
        np.testing.assert_array_equal(ta, ja)
    wrapped = ClassificationData(tds)
    assert len(wrapped) == len(tds) and wrapped.get_shape(3) == jdata.ClassificationData(jds).get_shape(3)


def test_batch_iterator_matches_jax():
    ds = ClassificationData(SyntheticModelNet40(num_points=32, size=20))
    jds = jdata.ClassificationData(jdata.SyntheticModelNet40(num_points=32, size=20))
    for kw in ({"shuffle": True, "seed": 3}, {"shuffle": False}, {"shuffle": True, "seed": 3, "drop_last": False}):
        got, want = list(batch_iterator(ds, 6, **kw)), list(jpipe.batch_iterator(jds, 6, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_augmentation_properties():
    pts = torch.from_numpy(cloud(4, 50, seed=6))
    gen = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    rot = augment_classification_batch(pts, jitter=False, scale=False, generator=gen())
    torch.testing.assert_close(rot[..., 2], pts[..., 2])  # about z only
    torch.testing.assert_close(rot[..., :2].norm(dim=-1), pts[..., :2].norm(dim=-1), rtol=1e-5, atol=1e-5)
    assert not torch.allclose(rot, pts)
    sc = augment_classification_batch(pts, rotate=False, jitter=False, generator=gen())
    ratio = sc / pts
    assert torch.allclose(ratio, ratio[:, :1].expand_as(ratio), rtol=1e-5)  # one scale per cloud and axis
    assert float(ratio.min()) >= 0.8 - 1e-6 and float(ratio.max()) <= 1.25 + 1e-6
    jit = augment_classification_batch(pts, rotate=False, scale=False, generator=gen())
    assert 0 < float((jit - pts).abs().max()) <= 0.05 + 1e-7
    a = augment_classification_batch(pts, generator=gen())
    assert torch.equal(a, augment_classification_batch(pts, generator=gen()))
    assert not torch.equal(a, augment_classification_batch(pts, generator=torch.Generator().manual_seed(10)))


def test_prefetch_keeps_order_and_raises_the_workers_error():
    assert [b for b in prefetch_to_device(iter(range(7)), put=lambda v: v * 2)] == [0, 2, 4, 6, 8, 10, 12]

    def broken():
        yield 1
        raise OSError("disk")

    with pytest.raises(OSError, match="disk"):
        list(prefetch_to_device(broken()))


# -- the Trainer's loop, checkpoints and entry points ------------------------

def small_classifier(dtype=None):
    return Classifier(PointNet(emb_dims=EMB, use_bn=True, dtype=dtype, device="cpu"), 10, dtype=dtype, device="cpu")


def test_fit_checkpoints_and_resume(tmp_path):
    """fit writes best/latest (model.pt, opt.pt, meta.json) and run.log; a
    Trainer with resume= restores the model and the optimizer state exactly;
    export_feature_model saves the encoder alone."""
    data = ClassificationData(SyntheticModelNet40(num_points=64, size=16, num_classes=10))
    cfg = TrainConfig(batch_size=8, epochs=1, augment=True, cosine_decay=True, ckpt_dir=str(tmp_path),
                      exp_name="run")
    tr = Trainer(cfg, small_classifier(), device="cpu")
    tr.fit(data, data)
    run = tmp_path / "run"
    assert "epoch 0: train_loss=" in (run / "run.log").read_text()
    for name in ("best", "latest"):
        assert {p.name for p in (run / name).iterdir()} == {"model.pt", "opt.pt", "meta.json"}
    meta = json.loads((run / "latest" / "meta.json").read_text())
    assert meta["epoch"] == 0 and meta["dataset_version"] == "synthetic-v2+size16+pts64"
    assert np.isfinite(tr.history[0]["train_loss"]) and "test_accuracy" in tr.history[0]

    again = Trainer(dataclasses.replace(cfg, resume="latest"), small_classifier(), device="cpu")
    again.fit(data, epochs=0)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, again.model.state_dict()[k]), k
    saved, loaded = tr.optimizer.state_dict(), again.optimizer.state_dict()
    for i, st in saved["state"].items():
        for key, v in st.items():
            assert torch.equal(v, loaded["state"][i][key]), (i, key)
    assert again.scheduler.state_dict()["last_epoch"] == tr.scheduler.state_dict()["last_epoch"] == 2
    assert again.best_loss == tr.best_loss

    tr.export_feature_model()
    enc = PointNet(emb_dims=EMB, use_bn=True, device="cpu")
    enc.load_state_dict(torch.load(run / "feature_model" / "model.pt", weights_only=True))
    assert torch.equal(enc.convs[0].weight, tr.model.feature_model.convs[0].weight)
    tr.close()
    again.close()


def test_best_metric_fallback_warns(tmp_path):
    """A best_metric the task does not report falls back to the test loss,
    as in the JAX Trainer, and says so."""
    data = ClassificationData(SyntheticModelNet40(num_points=32, size=8, num_classes=10))
    tr = Trainer(TrainConfig(batch_size=8, epochs=1, best_metric="rot_deg", ckpt_dir=str(tmp_path)),
                 small_classifier(), device="cpu")
    with pytest.warns(UserWarning, match="rot_deg"):
        best = tr.fit(data, data)
    assert best == tr.history[0]["test_loss"]


def test_trainer_refuses_what_is_not_ported(tmp_path):
    cfg = TrainConfig(ckpt_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="the parallel/ item"):
        Trainer(dataclasses.replace(cfg, mesh_shape=(1, 1)), small_classifier(), device="cpu")
    with pytest.raises(NotImplementedError, match="the parallel/ item"):
        Trainer(cfg, small_classifier(), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="remat"):
        Trainer(dataclasses.replace(cfg, remat=True), small_classifier(), device="cpu")
    with pytest.raises(NotImplementedError, match="registration"):
        Trainer(dataclasses.replace(cfg, task="registration"), small_classifier(), device="cpu")
    with pytest.raises(ValueError, match="parameters are on"):
        Trainer(cfg, small_classifier(), device="meta")


def test_trainer_defaults_to_cuda(tmp_path):
    import inspect

    assert inspect.signature(Trainer).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(TrainConfig(ckpt_dir=str(tmp_path)), small_classifier())


def test_train_config_matches_jax():
    """The port's TrainConfig is a copy: the same fields and defaults."""
    jf = {f.name: f.default for f in dataclasses.fields(JTrainConfig) if f.name != "extras"}
    tf = {f.name: f.default for f in dataclasses.fields(TrainConfig) if f.name != "extras"}
    assert tf == jf
    assert TrainConfig.from_cli(["--lr", "0.5", "--augment"]).lr == 0.5
