"""The port's FlowNet3D slice against the JAX package, on the CPU: each
layer at small widths in eval and train mode, the whole ``FlowNet3D()`` at
B=1, N=1024 (the smallest N at which sa1's 1024 samples are distinct) in
eval and train mode, ``tasks.flow`` with its gradients, one Trainer step
with examples/train_flownet.py's SGD, the serving engine on four inputs and
a ragged tail, and the scene-flow datasets item for item. Weights and
BatchNorm statistics cross by ``load_nnx_state`` (some BN scales negative).

On a CPU tensor both packages sample, group and interpolate on their plain
paths (the FPS scan, the ball query's expansion, three-NN by exact
differences), so the selections agree; K14, K15 and K8 are held to their
plain versions by ``tests/test_torch_sampling.py``, ``tests/test_torch_knn.py``
and on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from learning3d_tpu.data import dataloaders as jdata
from learning3d_tpu.data.device_pipeline import batch_iterator as jbatch_iterator
from learning3d_tpu.models import FlowNet3D as JFlowNet3D
from learning3d_tpu.models import flownet3d as jflow
from learning3d_tpu.train import tasks as jtasks
from learning3d_tpu_torch.data import FlowData, SceneflowDataset, SyntheticSceneflow, batch_iterator
from learning3d_tpu_torch.data import dataloaders as tdata
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.models import FlowNet3D
from learning3d_tpu_torch.models import flownet3d as tflow
from learning3d_tpu_torch.serve import InferenceEngine
from learning3d_tpu_torch.train import TrainConfig, Trainer, tasks
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from torch_port_util import nnx_flat, randomize_bn

N = 1024
LR, MOMENTUM = 1e-3, 0.9  # examples/train.py's defaults for --optimizer sgd
# f32 on both sides, sums in other orders. Eval: 1e-4 of the largest flow
# (measured 6.0e-7). Train mode: every layer's BatchNorm takes its
# statistics from the batch with the fast variance E[x^2] - E[x]^2, which
# loses digits where a channel's mean is large beside its spread: 1e-3
# (measured 2.6e-4), for the flow, the loss and the running statistics after
# the forward (measured 1.3e-4 of a tensor's largest value)
FWD_TOL = {"eval": 1e-4, "train": 1e-3}
# small layers: 1e-5 in eval, 1e-4 in train mode (the fast variance)
LAYER_TOL = {"eval": 1e-5, "train": 1e-4}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def check_module(jmod, tmod, inputs, mode):
    """One forward of a JAX layer and its port twin (weights carried) in
    ``mode``; in train mode also the BN running statistics after it."""
    getattr(jmod, mode)()
    getattr(tmod, mode)()
    want = jmod(*(None if a is None else jnp.asarray(a) for a in inputs))
    got = tmod(*(None if a is None else torch.from_numpy(a) for a in inputs))
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert g.shape == w.shape
        assert rel(g, w) <= LAYER_TOL[mode]
    if mode == "train":
        after = nnx_to_torch(nnx_flat(jmod))
        for name, buf in tmod.named_buffers():
            assert rel(buf, after[name]) <= 1e-5, name


def twin(jmod, tcls, *args, **kw):
    randomize_bn(jmod, np.random.default_rng(7))
    return load_nnx_state(tcls(*args, device="cpu", **kw), nnx_flat(jmod))


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("features", [True, False])
def test_set_abstraction_matches_jax(mode, features):
    """FPS (48 of 96 points), the ball query (r 0.8, 8 samples), the grouped
    offsets beside the gathered features, the shared MLP and the max pool."""
    args = (48, 0.8, 8, 5 if features else 0, [8, 16], False)
    jm = jflow.PointNetSetAbstraction(*args, rngs=nnx.Rngs(1))
    tm = twin(jm, tflow.PointNetSetAbstraction, *args)
    xyz = normal((2, 96, 3), 2)
    check_module(jm, tm, (xyz, normal((2, 96, 5), 3) if features else None), mode)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_set_abstraction_group_all_matches_jax(mode):
    jm = jflow.PointNetSetAbstraction(None, None, None, 5, [8, 16], True, rngs=nnx.Rngs(2))
    tm = twin(jm, tflow.PointNetSetAbstraction, None, None, None, 5, [8, 16], True)
    check_module(jm, tm, (normal((2, 40, 3), 4), normal((2, 40, 5), 5)), mode)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_flow_embedding_matches_jax(mode):
    """The cross-cloud kNN (16 of 64 points), the offsets, the second cloud's
    gathered features beside the first's, the MLP and the max pool."""
    jm = jflow.FlowEmbedding(10.0, 16, 6, [8, 8], rngs=nnx.Rngs(3))
    tm = twin(jm, tflow.FlowEmbedding, 10.0, 16, 6, [8, 8])
    check_module(jm, tm, (normal((2, 50, 3), 6), normal((2, 64, 3), 7), normal((2, 50, 6), 8),
                          normal((2, 64, 6), 9)), mode)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("mlp", [[], [8, 12]])
def test_set_upconv_matches_jax(mode, mlp):
    """kNN of the coarse level (4 of 20), with and without the first MLP
    (su1 of FlowNet3D has none), the skip features, the second MLP."""
    args = (4, 1.0, 5, 7, mlp, [10])
    jm = jflow.PointNetSetUpConv(*args, rngs=nnx.Rngs(4))
    tm = twin(jm, tflow.PointNetSetUpConv, *args)
    check_module(jm, tm, (normal((2, 60, 3), 10), normal((2, 20, 3), 11), normal((2, 60, 5), 12),
                          normal((2, 20, 7), 13)), mode)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_feature_propagation_matches_jax(mode):
    """Three-NN interpolation with coincident points (the coarse cloud is a
    subset of the fine one, as sa1's samples are of pc1: d = 0 exactly,
    clamped to 1e-10), the skip features, the MLP."""
    pos1 = normal((2, 70, 3), 14)
    pos2 = pos1[:, ::2].copy()
    jm = jflow.PointNetFeaturePropogation(6 + 4, [12, 8], rngs=nnx.Rngs(5))
    tm = twin(jm, tflow.PointNetFeaturePropogation, 6 + 4, [12, 8])
    check_module(jm, tm, (pos1, pos2, normal((2, 70, 4), 15), normal((2, 35, 6), 16)), mode)


# -- the whole model at B=1, N=1024 --------------------------------------------

@pytest.fixture(scope="module")
def jax_flownet():
    """A JAX FlowNet3D with non-trivial BatchNorm statistics and its flat
    nnx state; built once for the module."""
    jm = JFlowNet3D(rngs=nnx.Rngs(0))
    randomize_bn(jm, np.random.default_rng(0))
    return jm, nnx_flat(jm)


def port_flownet(flat):
    return load_nnx_state(FlowNet3D(device="cpu"), flat)


def scene_batch(n=N, seed=0, b=1):
    """B items of SyntheticSceneflow (zero colors, as the synthetic set has)."""
    ds = SyntheticSceneflow(npoints=n, size=b, seed=seed)
    return tuple(np.stack(f) for f in zip(*(ds[i] for i in range(b))))


def test_load_nnx_state_carries_flownet(jax_flownet):
    """Every weight and statistic of a JAX FlowNet3D maps onto the port's,
    through the nnx.List blocks (su1's first list empty); nothing is left on
    either side."""
    _, flat = jax_flownet
    tm = port_flownet(flat)
    mapped = nnx_to_torch(flat)
    state = tm.state_dict()
    assert set(state) == set(mapped)
    for key, val in state.items():
        np.testing.assert_array_equal(val.numpy(), mapped[key], err_msg=key)
    assert len(tm.su1.blocks1) == 0 and "su1.blocks2.1.bn.running_var" in state and "conv2.bias" in state


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_flownet_forward_matches_jax(jax_flownet, mode):
    """The flow of the whole model on random features, to FWD_TOL; in train
    mode also every BN running statistic after it. No kernel launches on a
    CPU tensor."""
    jm, flat = jax_flownet
    jm = nnx.clone(jm)
    tm = port_flownet(flat)
    pc1, pc2 = normal((1, N, 3), 20), normal((1, N, 3), 21)
    f1, f2 = normal((1, N, 3), 22), normal((1, N, 3), 23)
    getattr(jm, mode)()
    getattr(tm, mode)()
    before = dict(LAUNCHES)
    want = jm(*map(jnp.asarray, (pc1, pc2, f1, f2)))
    got = tm(*map(torch.from_numpy, (pc1, pc2, f1, f2)))
    assert got.shape == (1, N, 3) and bool(torch.isfinite(got).all())
    assert rel(got, want) <= FWD_TOL[mode]
    assert LAUNCHES == before
    if mode == "train":
        after = nnx_to_torch(nnx_flat(jm))
        for name, buf in tm.named_buffers():
            assert rel(buf, after[name]) <= FWD_TOL["train"], name


# Gradients of the flow task. JAX's own f32 eager gradient is
# ill-conditioned here: on this draw it lies 10-21% from its f64 eager
# gradient in every layer (the train-mode BatchNorms' fast variance loses
# digits), and the port's f32 gradient as far (9-17%). In f64 both are
# exact to far below that: the port's f64 gradient is held to JAX's eager
# gradient on f64 inputs to GRAD_TOL of each tensor's norm (measured 4e-8).
# The last BatchNorm biases of sa2, sa3 and sa4 have no gradient in exact
# arithmetic (a constant shift of a level's features passes the ReLU and
# the max pool and is taken out by the next train-mode BatchNorm): held to
# GRAD_TOL of their layer's weight gradient instead. The port's f32
# gradient is held to its own f64 gradient within F32_GRAD_TOL, twice JAX's
# own f32 spread on this draw: a missing or wrong term would be off by the
# order of the gradient itself.
GRAD_TOL, F32_GRAD_TOL = 1e-6, 0.5
VANISHING = {f"{sa}.blocks.2.bn.bias" for sa in ("sa2", "sa3", "sa4")}


@pytest.fixture(scope="module")
def jax_task(jax_flownet):
    """The JAX flow task on one SyntheticSceneflow batch in train mode: the
    loss and metrics in f32, the BN statistics after the f32 forward, and
    the eager gradients on f64 inputs."""
    jm, flat = jax_flownet
    batch = scene_batch()
    jm32 = nnx.clone(jm)
    jm32.train()
    loss, aux = jtasks.flownet(jm32, tuple(map(jnp.asarray, batch)), None)
    after = nnx_to_torch(nnx_flat(jm32))
    with jax.enable_x64(True):
        jm64 = nnx.clone(jm)
        jm64.train()
        batch64 = tuple(jnp.asarray(a.astype(np.float64)) for a in batch)
        _, grads = nnx.value_and_grad(lambda m: jtasks.flownet(m, batch64, None), has_aux=True)(jm64)
        grads = nnx_to_torch({".".join(map(str, p)): np.asarray(v.get_value(), np.float64)
                              for p, v in nnx.to_flat_state(grads)})
    return {"batch": batch, "flat": flat, "after": after, "loss": float(loss),
            "aux": {k: float(v) for k, v in aux.items()}, "grads": grads}


def task_grads(flat, batch, dtype):
    model = port_flownet(flat).to(dtype).train()
    loss, aux = tasks.flownet(model, tuple(torch.from_numpy(a).to(dtype) for a in batch))
    loss.backward()
    grads = {n: p.grad.double().numpy() for n, p in model.named_parameters()}
    return model, loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def grad_gaps(got, want):
    out = {}
    for name, g in got.items():
        ref = want[name.rsplit(".", 2)[0] + ".lin.weight"] if name in VANISHING else want[name]
        out[name] = np.linalg.norm(g - want[name]) / np.linalg.norm(ref)
    return out


def test_flow_task_matches_jax(jax_task):
    """tasks.flow in train mode: the loss and EPE/Acc3D metrics against the
    JAX task's, the running statistics after the forward, the port's f64
    gradients against JAX's eager f64 gradients (GRAD_TOL) and its f32
    gradients against its own f64 ones (F32_GRAD_TOL)."""
    assert tasks.TASKS["flow"] is tasks.flownet
    model, loss, aux, g32 = task_grads(jax_task["flat"], jax_task["batch"], torch.float32)
    assert abs(float(loss) - jax_task["loss"]) <= FWD_TOL["train"] * abs(jax_task["loss"])
    assert set(aux) == set(jax_task["aux"]) == {"epe", "acc3d_strict", "acc3d_relax"}
    assert abs(float(aux["epe"]) - jax_task["aux"]["epe"]) <= FWD_TOL["train"] * jax_task["aux"]["epe"]
    for key in ("acc3d_strict", "acc3d_relax"):
        assert abs(float(aux[key]) - jax_task["aux"][key]) <= 2.0 / N  # a point at the threshold may flip
    for name, buf in model.named_buffers():
        assert rel(buf, jax_task["after"][name]) <= FWD_TOL["train"], name
    _, _, _, g64 = task_grads(jax_task["flat"], jax_task["batch"], torch.float64)
    gaps = grad_gaps(g64, jax_task["grads"])
    assert max(gaps.values()) <= GRAD_TOL, max(gaps.items(), key=lambda kv: kv[1])
    gaps = grad_gaps(g32, g64)
    assert max(gaps.values()) <= F32_GRAD_TOL, max(gaps.items(), key=lambda kv: kv[1])


def test_flow_task_loss_and_metrics_match_jax():
    """The masked MSE/2 and the metrics on fixed predictions, a mask with
    zeros, errors on both sides of each threshold."""
    rng = np.random.default_rng(30)
    pos1, pos2, c1, c2 = (rng.normal(size=(2, 64, 3)).astype(np.float32) for _ in range(4))
    flow = rng.normal(0.0, 0.5, (2, 64, 3)).astype(np.float32)
    pred = (flow + rng.normal(0.0, 0.06, flow.shape)).astype(np.float32)
    mask = (rng.uniform(size=(2, 64)) < 0.7).astype(np.float32)
    batch = (pos1, pos2, c1, c2, flow, mask)
    loss, aux = tasks.flownet(lambda *a: torch.from_numpy(pred), tuple(map(torch.from_numpy, batch)))
    want_loss, want_aux = jtasks.flownet(lambda *a: jnp.asarray(pred), tuple(map(jnp.asarray, batch)), None)
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    for key, val in want_aux.items():
        assert abs(float(aux[key]) - float(val)) <= 1e-6 * max(abs(float(val)), 1.0), key
    assert 0.0 < float(aux["acc3d_strict"]) < float(aux["acc3d_relax"]) < 1.0


def test_trainer_step_matches_jax(jax_task, tmp_path):
    """One Trainer.train_step with examples/train_flownet.py's optimizer (SGD,
    momentum 0.9, lr 1e-3) on the 6-tuple batch the host batcher stacks from
    SyntheticSceneflow (the same arrays as the JAX batcher's): the loss and
    the running statistics against JAX's, and each parameter after the
    first update, ``p - lr g`` of its own gradient."""
    ds, jds = SyntheticSceneflow(npoints=N, size=1), jdata.SyntheticSceneflow(npoints=N, size=1)
    batch = next(batch_iterator(FlowData(ds), 1, seed=3))
    want_batch = next(jbatch_iterator(jdata.FlowData(jds), 1, seed=3))
    assert len(batch) == 6
    for a, w in zip(batch, want_batch):
        np.testing.assert_array_equal(a, w)
    for a, w in zip(batch, jax_task["batch"]):
        np.testing.assert_array_equal(a, w)
    model = port_flownet(jax_task["flat"])
    cfg = TrainConfig(task="flow", batch_size=1, num_points=N, optimizer="sgd", lr=LR, momentum=MOMENTUM,
                      ckpt_dir=str(tmp_path))
    tr = Trainer(cfg, model, device="cpu")
    tr._ensure_optimizer(1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, aux = tr.train_step(tuple(map(torch.from_numpy, batch)))
    assert abs(float(loss) - jax_task["loss"]) <= FWD_TOL["train"] * abs(jax_task["loss"])
    assert set(aux) == {"epe", "acc3d_strict", "acc3d_relax"}
    for name, buf in model.named_buffers():
        assert rel(buf, jax_task["after"][name]) <= FWD_TOL["train"], name
    for name, p in model.named_parameters():
        want = before[name] - LR * p.grad
        torch.testing.assert_close(p.detach(), want, rtol=0, atol=1e-6 * LR + 2e-7 * before[name].abs().max().item())
    tr.close()


def test_flownet_serves_four_inputs_with_a_ragged_tail(jax_flownet):
    """InferenceEngine(batch_size=2) on 3 pairs (pc1, pc2, feature1,
    feature2): the tail chunk is padded and stripped, and each pair's flow is
    the eval model's on that pair alone (eval mode is per item)."""
    _, flat = jax_flownet
    model = port_flownet(flat).eval()
    pc1, pc2, f1, f2 = (normal((3, N, 3), 40 + i) for i in range(4))
    got = InferenceEngine(model, batch_size=2, device="cpu")(pc1, pc2, f1, f2)
    assert isinstance(got, np.ndarray) and got.shape == (3, N, 3)
    with torch.inference_mode():
        want = model(*(torch.from_numpy(a[2:]) for a in (pc1, pc2, f1, f2))).numpy()
    np.testing.assert_allclose(got[2:], want, rtol=0, atol=1e-6 * np.abs(want).max())


# -- data ----------------------------------------------------------------------

@pytest.mark.parametrize("npoints", [256, 2048])
def test_synthetic_sceneflow_matches_jax(npoints):
    ds, jds = SyntheticSceneflow(npoints=npoints, size=5, seed=1), jdata.SyntheticSceneflow(npoints=npoints, size=5,
                                                                                             seed=1)
    assert len(ds) == len(jds) == 5
    for i in (0, 3):
        got, want = ds[i], jds[i]
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def write_npz_archive(root):
    """Two small FlyingThings3D-style npz files (and the one the reference
    excludes) under ``root``."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(31)
    for name in ("TRAIN_A_0001_left_0000-0", "TRAIN_C_0140_left_0006-0", "TEST_A_0002_left_0000-0"):
        n = 300
        np.savez(root / f"{name}.npz", points1=rng.normal(size=(n, 3)), points2=rng.normal(size=(n, 3)),
                 color1=rng.uniform(size=(n, 3)), color2=rng.uniform(size=(n, 3)),
                 flow=rng.normal(size=(n, 3)), valid_mask1=rng.uniform(size=n) < 0.9)


def test_sceneflow_dataset_matches_jax(tmp_path, monkeypatch):
    """SceneflowDataset on an archive the test writes: the excluded sample is
    left out, train items draw the same points from the same seeded rng as
    JAX's (item for item, twice, so the rng advances alike), test items take
    the first points; FlowData() falls back to SyntheticSceneflow where the
    default root holds nothing, as the JAX package's does, and reads the
    archive where it is."""
    root = tmp_path / "data_processed_maxcut_35_20k_2k_8192"
    write_npz_archive(root)
    for partition in ("train", "test"):
        ds = SceneflowDataset(npoints=128, root=str(root), partition=partition, seed=4)
        jds = jdata.SceneflowDataset(npoints=128, root=str(root), partition=partition, seed=4)
        assert len(ds) == len(jds) == 1
        for _ in range(2):
            for g, w in zip(ds[0], jds[0]):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    monkeypatch.setattr(tdata, "_DATA_DIR", tmp_path / "empty")
    monkeypatch.setattr(jdata, "_DATA_DIR", tmp_path / "empty")
    fd, jfd = FlowData(npoints=64), jdata.FlowData(npoints=64)
    assert isinstance(fd.data_class, SyntheticSceneflow) and isinstance(jfd.data_class, jdata.SyntheticSceneflow)
    assert len(fd) == len(jfd)
    for g, w in zip(fd[1], jfd[1]):
        np.testing.assert_array_equal(g, w)
    monkeypatch.setattr(tdata, "_DATA_DIR", tmp_path)
    monkeypatch.setattr(jdata, "_DATA_DIR", tmp_path)
    fd, jfd = FlowData(npoints=64, partition="test"), jdata.FlowData(npoints=64, partition="test")
    assert isinstance(fd.data_class, SceneflowDataset) and len(fd) == len(jfd) == 1
    for g, w in zip(fd[0], jfd[0]):
        np.testing.assert_array_equal(g, w)
