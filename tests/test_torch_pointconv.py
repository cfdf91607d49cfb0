"""The port's PointConv against the JAX package's, on the CPU: the grouping
operators (``sample_and_group_knn``, ``compute_density``,
``sample_and_group`` and ``_all``, FPS at ``npoint >= N``), each block
(DensityNet, WeightNet, the set abstraction with kNN and with one group of
all), the whole classifier at B=2, N=512, emb 64 in eval and train mode,
and one classification step's loss and gradients. Weights cross as numpy
through ``load_nnx_state``; inputs are made with numpy from seeds; dropout
is fed rate 0 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from learning3d_tpu.data import dataloaders as jdata
from learning3d_tpu.models import pointconv as jpc
from learning3d_tpu.ops import geometry as jgeo
from learning3d_tpu.ops import grouping as jgrp
from learning3d_tpu.train import tasks as jtasks
from learning3d_tpu_torch.models import PointConvDensityClsSsg, create_pointconv
from learning3d_tpu_torch.models import pointconv as tpc
from learning3d_tpu_torch.ops import geometry as tgeo
from learning3d_tpu_torch.ops import grouping as tgrp
from learning3d_tpu_torch.train import TrainConfig, Trainer, tasks
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from torch_port_util import hold_to_jax, nnx_flat, randomize_bn

B, N, EMB = 2, 512, 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def cloud(seed, b=B, n=N, c=3):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (b, n, c)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


# the groupings copy coordinates and features: bit for bit where the same
# neighbours are picked, which the indices show (the CPU kNN, ball query and
# FPS are the JAX package's CPU paths)
def test_sample_and_group_knn_matches_jax():
    xyz, pts = cloud(1), cloud(2, c=5)
    dens = np.random.default_rng(3).uniform(0.5, 2.0, (B, N)).astype(np.float32)
    want = jgrp.sample_and_group_knn(64, 16, jnp.asarray(xyz), jnp.asarray(pts), density_scale=jnp.asarray(dens))
    got = tgrp.sample_and_group_knn(64, 16, t(xyz), t(pts), density_scale=t(dens))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got3 = tgrp.sample_and_group_knn(64, 16, t(xyz))
    want3 = jgrp.sample_and_group_knn(64, 16, jnp.asarray(xyz))
    assert len(got3) == 3
    for g, w in zip(got3, want3):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("returnfps", [False, True])
def test_sample_and_group_matches_jax(returnfps):
    xyz, pts = cloud(4), cloud(5, c=4)
    for npoint in (64, 0):
        want = jgrp.sample_and_group(npoint, 0.4, 16, jnp.asarray(xyz), jnp.asarray(pts), returnfps=returnfps)
        got = tgrp.sample_and_group(npoint, 0.4, 16, t(xyz), t(pts), returnfps=returnfps)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sample_and_group_all_matches_jax():
    xyz, pts = cloud(6), cloud(7, c=4)
    for p in (pts, None):
        want = jgrp.sample_and_group_all(jnp.asarray(xyz), None if p is None else jnp.asarray(p))
        got = tgrp.sample_and_group_all(t(xyz), None if p is None else t(p))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("npoint", [N, N + 40, 2 * N])
def test_fps_at_npoint_past_n_matches_jax(npoint):
    """npoint >= N: every point once in the JAX scan's order, then the scan's
    repeats (the first index of the all-zero distances); the grouping's
    FPS runs there too (``_fps_or_all``)."""
    xyz = cloud(8)
    want = np.asarray(jgeo.farthest_point_sample(jnp.asarray(xyz), npoint))
    got = tgeo.farthest_point_sample(t(xyz), npoint).numpy()
    np.testing.assert_array_equal(got, want)
    assert all(len(np.unique(row[:N])) == N for row in got)
    new_xyz, idx = tgrp._fps_or_all(t(xyz), npoint)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(new_xyz.numpy(), np.take_along_axis(xyz, want[..., None], 1))


# compute_density: the same squared distances (JAX's CPU matmul expansion,
# bit for bit at C = 3), the same divide, exp, scale and mean; the mean over
# N in another sum order: 1e-6 of max (measured 1.7e-7-2.0e-7)
DENSITY_TOL = 1e-6


@pytest.mark.parametrize("bandwidth", [0.1, 0.2, 0.4])
def test_compute_density_matches_jax(bandwidth):
    xyz = cloud(9, n=300)
    want = jgrp.compute_density(jnp.asarray(xyz), bandwidth)
    got = tgrp.compute_density(t(xyz), bandwidth)
    assert got.shape == (B, 300)
    assert rel(got, want) <= DENSITY_TOL


def test_compute_density_control_fails():
    """The tolerance sees a squared bandwidth 0.01% off (measured 7.2e-5 of
    max)."""
    xyz = cloud(9, n=300)
    want = np.asarray(jgrp.compute_density(jnp.asarray(xyz), 0.1))
    d = tgeo.square_distance(t(xyz), t(xyz))
    other = torch.mean(torch.exp(-d * (1 / (2 * 0.01)) * 0.9999) * (1 / 0.25), -1)
    assert rel(other, want) > DENSITY_TOL


def live_density(*sas):
    """Each set abstraction's DensityNet's last BatchNorm bias at 1: random
    weights otherwise leave its ReLU 0 at every point of some stages (the
    features times 0, the logits blind to the cloud there)."""
    for sa in sas:
        sa.densitynet.blocks[-1].bn.bias.set_value(jnp.ones((1,), jnp.float32))


def jax_model(seed, emb=EMB, classifier=True):
    jm = jpc.PointConvDensityClsSsg(emb_dims=emb, classifier=classifier, rngs=nnx.Rngs(seed))
    randomize_bn(jm, np.random.default_rng(seed + 1))
    live_density(jm.sa1, jm.sa2, jm.sa3)
    if classifier:
        jm.drop1.rate = jm.drop2.rate = 0.0
    return jm


def port_model(flat, emb=EMB, classifier=True, **kw):
    tm = load_nnx_state(PointConvDensityClsSsg(emb_dims=emb, classifier=classifier, device="cpu", **kw), flat)
    if classifier:
        tm.drop1.rate = tm.drop2.rate = 0.0
    return tm


@pytest.fixture(scope="module")
def jax_pc():
    """The JAX classifier (emb 64, dropout 0), built once for the file."""
    return jax_model(20)


def test_load_nnx_state_carries_pointconv(jax_pc):
    flat = nnx_flat(jax_pc)
    tm = port_model(flat)
    assert set(tm.state_dict()) == set(nnx_to_torch(flat))
    assert {k.split(".")[0] for k in flat} == {"sa1", "sa2", "sa3", "fc1", "bn1", "fc2", "bn2", "fc3"}
    np.testing.assert_array_equal(tm.sa2.weightnet.blocks[2].lin.weight.detach().numpy(),
                                  flat["sa2.weightnet.blocks.2.lin.kernel"].T)
    np.testing.assert_array_equal(tm.sa1.densitynet.blocks[0].bn.running_var.numpy(),
                                  flat["sa1.densitynet.blocks.0.bn.var"])
    assert create_pointconv(classifier=True) is PointConvDensityClsSsg
    with pytest.raises(ValueError):
        PointConvDensityClsSsg(input_shape="nbc", device="cpu")


# f32 in eval mode: the same math in other sum orders, 1e-5 of max. In
# train mode the BatchNorms' fast variance (E[x^2] - E[x]^2) loses digits
# where a channel barely varies: the one-channel BatchNorms of DensityNet
# (density ratios near 1), and the rows of two clouds that a group of all
# normalizes. There JAX's own f32 lies up to 2.7e-3 of max from its f64
# (this file's draws). So in train mode the port's f64 outputs and running
# statistics are held to JAX's f64 ones (F64_TOL, measured 8.3e-7), and the
# port's f32 ones to JAX's f64 no further than twice JAX's own f32 plus
# TRAIN_F32_TOL (the port's f32 measured up to 5.4e-4 from f64, where JAX's
# own lay at 1.2e-4: the whole classifier at B=2, whose head's train-mode
# BatchNorms normalize two rows): a missing or wrong term would be off by
# the order of the values themselves
BLOCK_TOL = 1e-5
F64_TOL = 1e-5
TRAIN_F32_TOL = 1e-3


def hold(port, module, mode, *args):
    return hold_to_jax(port, module, mode, *args, tol=BLOCK_TOL, f64_tol=F64_TOL, train_f32_tol=TRAIN_F32_TOL)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("block", ["densitynet", "weightnet"])
def test_density_and_weight_nets_match_jax(block, mode):
    rngs = nnx.Rngs(11)
    jb, tcls, cin = ((jpc.DensityNet(rngs=rngs), tpc.DensityNet, 1) if block == "densitynet"
                     else (jpc.WeightNet(3, 16, rngs=rngs), tpc.WeightNet, 3))
    randomize_bn(jb, np.random.default_rng(12))
    getattr(jb, mode)()
    tb = load_nnx_state(tcls(device="cpu"), nnx_flat(jb))
    x = np.random.default_rng(13).normal(size=(B, 16, 8, cin)).astype(np.float32)
    hold(tb, jb, mode, x)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("group_all", [False, True])
def test_set_abstraction_matches_jax(group_all, mode):
    """The density-weighted point convolution, with features (D=5) and
    without, at 64 centers of 16 neighbours and with one group of all."""
    npoint, nsample = (1, None) if group_all else (64, 16)
    xyz, pts = cloud(14, n=256), cloud(15, n=256, c=5)
    for feats, cin in ((pts, 8), (None, 3)):
        jb = jpc.PointConvDensitySetAbstraction(npoint, nsample, cin, [16, 24], 0.2, group_all, rngs=nnx.Rngs(16))
        randomize_bn(jb, np.random.default_rng(17))
        live_density(jb)
        getattr(jb, mode)()
        tb = load_nnx_state(tpc.PointConvDensitySetAbstraction(npoint, nsample, cin, [16, 24], 0.2, group_all,
                                                                device="cpu"), nnx_flat(jb))
        (got_xyz, got), (want_xyz, _) = hold(tb, jb, mode, xyz, feats)
        assert got.shape == (B, npoint, 24)
        np.testing.assert_array_equal(got_xyz.numpy(), want_xyz)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_pointconv_classifier_matches_jax(jax_pc, mode):
    """The whole classifier's log-softmax outputs."""
    jm = nnx.clone(jax_pc)
    getattr(jm, mode)()
    flat = nnx_flat(jm)
    x = cloud(21)
    got = hold(port_model(flat), jm, mode, x)[0]
    assert got.shape == (B, 40)
    np.testing.assert_allclose(torch.logsumexp(got, -1).numpy(), 0.0, atol=1e-5)
    if mode == "eval":
        bcn = port_model(flat).eval()
        bcn.input_shape = "bcn"
        with torch.no_grad():
            assert torch.equal(bcn(t(x).transpose(1, 2)), got)
            feats = port_model({k: v for k, v in flat.items() if k.startswith("sa")}, classifier=False).eval()(t(x))
        assert feats.shape == (B, EMB)


def test_pointconv_with_extra_channels_matches_jax():
    """input_channel_dim 6: the normals ride along as sa1's features."""
    jm = jpc.PointConvDensityClsSsg(emb_dims=EMB, input_channel_dim=6, rngs=nnx.Rngs(22))
    randomize_bn(jm, np.random.default_rng(23))
    live_density(jm.sa1, jm.sa2, jm.sa3)
    jm.eval()
    x = np.concatenate([cloud(24), cloud(25)], -1)
    tm = load_nnx_state(PointConvDensityClsSsg(emb_dims=EMB, input_channel_dim=6, device="cpu"), nnx_flat(jm))
    assert hold(tm, jm, "eval", x)[0].shape == (B, EMB)


def step_batch():
    """B SyntheticModelNet40 clouds of N points and their labels."""
    data = jdata.SyntheticModelNet40(num_points=N, size=B, seed=31)
    return (np.stack([data[i][0] for i in range(B)]).astype(np.float32),
            np.array([data[i][1] for i in range(B)], np.int32).reshape(B))


def jax_grads(jm, batch, x64):
    """The JAX task's loss, accuracy and gradients, jitted, in f32 or x64."""
    with jax.enable_x64(x64):
        dt = np.float64 if x64 else np.float32
        step = nnx.jit(lambda m, x, y: nnx.value_and_grad(lambda m: jtasks.classification(m, (x, y), None),
                                                          has_aux=True)(m))
        (loss, aux), grads = step(nnx.clone(jm), jnp.asarray(batch[0].astype(dt)), jnp.asarray(batch[1]))
        return float(loss), float(aux["accuracy"]), nnx_to_torch(
            {".".join(map(str, p)): np.asarray(v.get_value(), np.float64) for p, v in nnx.to_flat_state(grads)})


@pytest.fixture(scope="module")
def jax_step(jax_pc):
    jm = nnx.clone(jax_pc)
    jm.train()
    batch = step_batch()
    loss, acc, g32 = jax_grads(jm, batch, False)
    loss64, _, g64 = jax_grads(jm, batch, True)
    return {"flat": nnx_flat(jm), "batch": batch, "loss": loss, "loss64": loss64, "accuracy": acc, "grads": g32,
            "grads64": g64}


# One classification step (JAX's task applies log_softmax to the model's
# log-softmax, as the port's does), on SyntheticModelNet40 clouds. The
# train-mode BatchNorms make the f32 gradients ill-conditioned in both
# packages: JAX's own f32 gradient of the last DensityNet BatchNorm's scale
# lies 2.4x its norm from its f64 one on this draw (a one-channel BatchNorm
# of density ratios that barely vary), jitted 8.1x, the rest up to 1%. So
# the port's f64 gradients are held to JAX's f64 ones (GRAD_TOL of each
# tensor's norm, measured 1.3e-5), and the port's f32 gradients, as one
# vector, to JAX's f64 ones no further than twice JAX's own f32 gap, plus
# F32_SLACK. The biases in front of a train-mode BatchNorm have no
# exact gradient (the batch mean takes them out): held against their
# layer's weight gradient. The loss to 1e-5 in f64 (measured 2.1e-7)
GRAD_TOL, F32_SLACK, LOSS_TOL = 1e-4, 1e-3, 1e-5


def cancelling(name):
    return name.endswith("lin.bias") or name.endswith("linear.bias") or name in ("fc1.bias", "fc2.bias")


def grad_gaps(grads, want):
    assert set(grads) == set(want)
    return {n: float(np.linalg.norm(g - want[n]) /
                     max(np.linalg.norm(want[n.rsplit(".", 1)[0] + ".weight" if cancelling(n) else n]), 1e-30))
            for n, g in grads.items()}


def port_step(flat, batch, dtype, bandwidth=None):
    model = port_model(flat).train().to(dtype)
    if bandwidth is not None:
        model.sa1.bandwidth = bandwidth
    loss, aux = tasks.classification(model, (t(batch[0]).to(dtype), t(batch[1])))
    loss.backward()
    return loss.item(), aux["accuracy"].item(), {n: p.grad.double().numpy() for n, p in model.named_parameters()}


def check_step(jax_step, bandwidth=None):
    loss64, _, g64 = port_step(jax_step["flat"], jax_step["batch"], torch.float64, bandwidth)
    assert abs(loss64 - jax_step["loss64"]) <= LOSS_TOL * abs(jax_step["loss64"])
    gaps = grad_gaps(g64, jax_step["grads64"])
    assert max(gaps.values()) <= GRAD_TOL, max(gaps.items(), key=lambda kv: kv[1])
    loss, acc, g32 = port_step(jax_step["flat"], jax_step["batch"], torch.float32, bandwidth)
    own, gap = (whole_gap(g, jax_step["grads64"]) for g in (jax_step["grads"], g32))
    assert gap <= 2 * own + F32_SLACK, (gap, own)
    return loss, acc


def whole_gap(grads, want):
    """The gap of all gradients as one vector, over its norm."""
    names = sorted(want)
    flat = lambda g: np.concatenate([g[n].ravel() for n in names])  # noqa: E731
    return float(np.linalg.norm(flat(grads) - flat(want)) / np.linalg.norm(flat(want)))


def test_pointconv_step_matches_jax(jax_step):
    loss, acc = check_step(jax_step)
    own = abs(jax_step["loss"] - jax_step["loss64"])
    assert abs(loss - jax_step["loss64"]) <= 2 * own + LOSS_TOL * abs(jax_step["loss64"])
    assert acc == pytest.approx(jax_step["accuracy"], abs=1e-7)


def test_pointconv_step_control_fails(jax_step):
    """The step check sees a density that lost its bandwidth's factor 2
    (exp(-d / bw^2)) in the first set abstraction."""
    with pytest.raises(AssertionError):
        check_step(jax_step, bandwidth=0.1 / np.sqrt(2.0))


def test_trainer_step_with_dropout_generator(jax_step, tmp_path):
    """Trainer.train_step on the classification task: the loss is the
    task's (dropout 0), every weight and statistic changes; with dropout on,
    two models on equal dropout generators take the same step."""
    model = port_model(jax_step["flat"])
    tr = Trainer(TrainConfig(batch_size=B, task="classification", lr=1e-3, ckpt_dir=str(tmp_path)), model,
                 device="cpu")
    tr._ensure_optimizer(1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, _ = tr.train_step(tuple(map(t, jax_step["batch"])))
    assert float(loss) == pytest.approx(port_step(jax_step["flat"], jax_step["batch"], torch.float32)[0], rel=1e-6)
    for k, v in model.state_dict().items():
        if k.endswith("weight") or "running" in k:
            assert not torch.equal(v, before[k]), k
    tr.close()
    outs = []
    for _ in range(2):
        m = load_nnx_state(PointConvDensityClsSsg(emb_dims=EMB, classifier=True, device="cpu",
                                                  dropout_generator=torch.Generator().manual_seed(5)),
                           jax_step["flat"]).train()
        with torch.no_grad():
            outs.append(m(t(jax_step["batch"][0])))
    assert torch.equal(outs[0], outs[1])
    with torch.no_grad():
        assert rel(outs[0], port_model(jax_step["flat"]).train()(t(jax_step["batch"][0]))) > 1e-3  # dropout acted
