"""The port's DCP training slice against the JAX package on the CPU: the
gradients of the Kabsch solver, of the pointer's LayerNorm and of the
kernel-backed attention, the registration metrics, the registration pairs
of ``RegistrationData``, the DCP task's loss and gradients, one Trainer
step against the JAX ``Trainer._train_step``, and ``Trainer.fit`` selecting
by ``rot_deg``.

Where the JAX package guards a kernel with a TPU test, the test opens the
guard: its DGCNN's edge features come from ``get_graph_feature_fused(...,
use_pallas=True)`` (K7) and its SVD head's attention gate drops the
platform test (K6), both kernels in Pallas interpret mode. On the CPU the
port runs K7's and K6's plain versions; the attention's backward recomputes
through the oracle on both sides.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx
from jax.experimental.pallas import tpu as pltpu

from learning3d_tpu.data import dataloaders as jdata
from learning3d_tpu.kernels import attention as jattn
from learning3d_tpu.kernels import edgeconv as jedge
from learning3d_tpu.models import DCP as JDCP
from learning3d_tpu.models import DGCNN as JDGCNN
from learning3d_tpu.models import dgcnn as jdgcnn_mod
from learning3d_tpu.train import TrainConfig as JTrainConfig
from learning3d_tpu.train import Trainer as JTrainer
from learning3d_tpu.train import metrics as jmetrics
from learning3d_tpu.train import tasks as jtasks
from learning3d_tpu.utils import svd3 as jsvd3
from learning3d_tpu.utils import transformer as jtr
from learning3d_tpu_torch.data import RegistrationData, SyntheticModelNet40, batch_iterator
from learning3d_tpu_torch.data import dataloaders as tdata
from learning3d_tpu_torch.kernels import attention as tattn
from learning3d_tpu_torch.models import DCP, DGCNN
from learning3d_tpu_torch.train import TrainConfig, Trainer, metrics, tasks
from learning3d_tpu_torch.utils import svd3 as tsvd3
from learning3d_tpu_torch.utils import transformer as ttr
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from torch_port_util import nnx_flat, randomize_bn

EMB, K, N, B, LR = 128, 20, 256, 2, 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# -- gradients of the pieces ------------------------------------------------

def covariances(kind, rng):
    u, w = rng.normal(size=(2, 4, 3))
    if kind == "random":
        return rng.normal(size=(4, 3, 3)).astype(np.float32)
    if kind == "rank1_noisy":
        return (np.einsum("bi,bj->bij", u, w) + 1e-4 * rng.normal(size=(4, 3, 3))).astype(np.float32)
    if kind == "near_identity":
        return (np.eye(3) + 1e-5 * rng.normal(size=(4, 3, 3))).astype(np.float32)
    if kind == "rank1":
        return np.einsum("bi,bj->bij", u, w).astype(np.float32)
    return np.zeros((4, 3, 3), np.float32)


@pytest.mark.parametrize("kind", ["random", "rank1_noisy", "near_identity", "rank1", "zero"])
def test_kabsch_gradient_matches_jax(kind):
    """d/dH sum(R(H) * W) by autograd against jax.grad. A non-degenerate H
    has a unique rotation whose gradient both follow through the same 6
    Jacobi sweeps: 1e-5 of the largest entry. Near-degenerate H (equal
    singular values, rank 1, zero) leave the rotation (nearly) free: the
    gradient there is whatever the fixed sweeps and the where guards make
    of it, and it must be finite on both sides, the guards' untaken
    branches contributing no NaN."""
    rng = np.random.default_rng(31)
    H, W = covariances(kind, rng), rng.normal(size=(4, 3, 3)).astype(np.float32)
    want = np.asarray(jax.grad(lambda h: jnp.sum(jsvd3.kabsch_rotation_3x3(h) * W))(jnp.asarray(H)))
    th = torch.from_numpy(H).requires_grad_(True)
    (tsvd3.kabsch_rotation_3x3(th) * torch.from_numpy(W)).sum().backward()
    got = th.grad.numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    if kind == "random":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_layer_norm_gradients_match_jax(name, tol):
    """AnnotatedLayerNorm (unbiased std, eps on the std): the gradients of
    x, a and b. f32: another sum order (1e-5 of each norm); bf16: the input
    and the cotangent rounded to bf16 on both sides, the statistics in f32."""
    jdt, tdt = (jnp.float32, torch.float32) if name == "f32" else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(32)
    jln = jtr.AnnotatedLayerNorm(64, rngs=nnx.Rngs(0))
    jln.a[...] = jnp.asarray(rng.normal(1.0, 0.2, 64), jnp.float32)
    jln.b[...] = jnp.asarray(rng.normal(0.0, 0.2, 64), jnp.float32)
    tln = load_nnx_state(ttr.AnnotatedLayerNorm(64, device="cpu"), nnx_flat(jln))
    x = rng.normal(1.0, 2.0, (2, 12, 64)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def loss(m, x):
        return jnp.sum(m(x).astype(jnp.float32) * w)

    gm, gx = nnx.grad(loss, argnums=(0, 1))(jln, jnp.asarray(x, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    (tln(tx).float() * torch.from_numpy(w)).sum().backward()
    assert rel(tx.grad.float(), np.asarray(gx, np.float32)) <= tol
    assert rel(tln.a.grad, gm.a[...]) <= tol
    assert rel(tln.b.grad, gm.b[...]) <= tol


def test_attention_fused_gradients_match_jax():
    """The kernel-backed attention's VJP at the SVD head's shape (D=128 over
    M=256 keys, Dv=3): the JAX custom VJP and the port's autograd Function
    both recompute through the oracle (bf16 operands, f32 softmax), and
    both round q, k and v's gradients to bf16 at the end (the backward of
    the bf16 cast): an f32 sum in another order moves a few of them across
    a rounding boundary, one bf16 step of 2^-8 each (1e-4 of each norm). The
    forward is K6 in interpret mode against its plain version, in f32: both
    round the unnormalized P to bf16 and divide by l after, so only the f32
    sums' order differs, which moves a probability across a bf16 rounding
    boundary now and then (1.7e-5 of the norm). Held to 1e-4, which an
    output rounded to bf16 (1.4e-3 here) fails."""
    rng = np.random.default_rng(33)
    q, k = (rng.normal(0.0, 0.3, (2, 1, 256, 128)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(2, 1, 256, 3)).astype(np.float32)
    g = rng.normal(size=(2, 1, 256, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        out_j, vjp = jax.vjp(jattn.attention_fused, *map(jnp.asarray, (q, k, v)))
        want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tattn.attention_fused(tq, tk, tv)
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32
    assert rel(out, out_j) <= 1e-4
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert rel(got, w) <= 1e-4


# -- metrics --------------------------------------------------------------------

def rotations(rng, n, max_deg):
    from scipy.spatial.transform import Rotation

    return Rotation.from_euler("zyx", rng.uniform(-max_deg, max_deg, (n, 3)), degrees=True).as_matrix()


def test_registration_errors_match_jax():
    """rot_deg and trans of est_T against igt^-1, in f32 with the cosine
    clamped: random poses to 1e-4 degrees (arccos of an f32 trace summed in
    the same order), the exact inverse (a clamped cosine of 1, 0 degrees) to
    3e-2 degrees on both sides (f32 rounding of the trace, which arccos
    amplifies near 0), trans to 1e-6."""
    rng = np.random.default_rng(34)
    igt = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    igt[:, :3, :3], igt[:, :3, 3] = rotations(rng, 6, 60), rng.uniform(-1, 1, (6, 3))
    est = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    est[:, :3, :3], est[:, :3, 3] = rotations(rng, 6, 90), rng.uniform(-1, 1, (6, 3))
    est[0] = np.linalg.inv(igt[0])
    got = metrics.registration_errors(torch.from_numpy(est), torch.from_numpy(igt))
    want = jmetrics.registration_errors(jnp.asarray(est), jnp.asarray(igt))
    assert set(got) == set(want) == {"rot_deg", "trans"}
    np.testing.assert_allclose(got["rot_deg"][1:].numpy(), np.asarray(want["rot_deg"])[1:], rtol=0, atol=1e-4)
    assert float(got["rot_deg"][0]) <= 3e-2 and float(want["rot_deg"][0]) <= 3e-2
    np.testing.assert_allclose(got["trans"].numpy(), np.asarray(want["trans"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(metrics.translation_error(torch.ones(2, 3), torch.zeros(2, 3)).numpy(),
                               np.sqrt(3.0), rtol=1e-6)


# -- registration data ----------------------------------------------------------

DATA_CASES = {
    "dcp": ("DCP", {}),
    "prnet_partial": ("PRNet", {"partial_source": True, "partial_template": True}),
    "pcrnet_noise": ("PCRNet", {"noise": True}),
    "ipcrnet": ("iPCRNet", {}),
    "pointnetlk": ("PointNetLK", {}),
    "rpmnet_normals_crop": ("RPMNet", {"additional_params": {"partial_point_cloud_method": "planar_crop",
                                                             "use_masknet": True}}),
    "deepgmr": ("DeepGMR", {"seed": 3}),
    "masknet_partial": ("iPCRNet", {"partial_source": True, "additional_params": {"use_masknet": True}}),
}


@pytest.mark.parametrize("name", list(DATA_CASES))
def test_registration_data_matches_jax(name):
    """Items equal to the JAX package's bit for bit, for every transform mode
    (euler_pos, euler_pm, twist), with partial clouds, jitter, planar crops
    with masks and normals, at epoch 0 and 3 and at difficulty 0.4."""
    algorithm, kw = DATA_CASES[name]
    normals = name.startswith("rpmnet")
    base = dict(num_points=96, size=8, use_normals=normals)
    got = RegistrationData(algorithm, SyntheticModelNet40(**base), **kw)
    want = jdata.RegistrationData(algorithm, jdata.SyntheticModelNet40(**base), **kw)
    assert len(got) == len(want) and got.mode == want.mode
    for epoch, difficulty in ((0, 1.0), (3, 1.0), (3, 0.4)):
        for ds in (got, want):
            ds.set_epoch(epoch)
            ds.set_difficulty(difficulty)
        for i in (0, 5):
            a, b = got[i], want[i]
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def test_registration_data_epochs_and_difficulty():
    """DCP resamples per epoch, the PCRNet family keeps one pair per index;
    difficulty scales the rotation angles and the translation (0 gives the
    identity) and is clipped to [0, 1]; igt maps template -> source."""
    data = SyntheticModelNet40(num_points=64, size=4)
    dcp = RegistrationData("DCP", data)
    t0, s0, g0 = dcp[1]
    np.testing.assert_allclose(s0, t0 @ g0[:3, :3].T + g0[:3, 3], atol=1e-5)
    dcp.set_epoch(1)
    assert not np.array_equal(dcp[1][2], g0)
    pcr = RegistrationData("PCRNet", data)
    first = pcr[1][2]
    pcr.set_epoch(4)
    np.testing.assert_array_equal(pcr[1][2], first)
    dcp.set_difficulty(-2.0)
    np.testing.assert_array_equal(dcp[1][2], np.eye(4, dtype=np.float32))
    dcp.set_difficulty(7.0)
    assert dcp._difficulty == 1.0
    with pytest.raises(ValueError, match="not available"):
        RegistrationData("ICP", data)
    gmr = RegistrationData("DeepGMR", data, additional_params={"nearest_neighbors": 20})
    plain = RegistrationData("DeepGMR", data)
    (t1, s1, g1), (t2, s2, g2) = gmr[1], plain[1]
    assert t1.shape == s1.shape == (64, 3 + 80)  # the RRI features of 20 neighbours appended
    for a, b in ((t1[:, :3], t2), (s1[:, :3], s2), (g1, g2)):
        np.testing.assert_array_equal(a, b)


def test_registration_helpers_match_jax():
    rng_args = (np.random.default_rng(35), np.random.default_rng(35))
    pts = np.random.default_rng(36).normal(size=(128, 3)).astype(np.float32)
    for fn in ("jitter_pointcloud", "farthest_subsample_points", "planar_crop"):
        a, b = getattr(tdata, fn)(pts, rng=rng_args[0]), getattr(jdata, fn)(pts, rng=rng_args[1])
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)
    assert tdata.deg_to_rad(45.0) == jdata.deg_to_rad(45.0)


# -- the DCP task and the train step ------------------------------------------

def open_attention_gate(q, k, v):
    """The JAX package's attention gate without its platform test."""
    D, M, n = q.shape[-1], k.shape[2], q.shape[2]
    return D % 128 == 0 and D <= 512 and 256 <= M <= 4096 and n >= 256


def keep_grads():
    """An optax transformation that passes the updates on and keeps them in
    its state: chained before Adam, the JAX Trainer's step hands over its
    gradients (after the guard) beside the updated parameters."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))


def dcp_batch():
    data = jdata.RegistrationData("DCP", jdata.SyntheticModelNet40(num_points=N, size=B))
    items = [data[i] for i in range(B)]
    return tuple(np.stack([it[j] for it in items]) for j in range(3))


def flat_grads(state):
    return nnx_to_torch({".".join(map(str, p)): np.asarray(v.get_value()) for p, v in nnx.to_flat_state(state)})


@pytest.fixture(scope="module")
def jax_dcp(tmp_path_factory):
    """DCP(DGCNN(128, k=20)) of the JAX package in f32 with K7 and K6 in
    interpret mode: its weights, the DCP task's loss, metrics and gradients
    (eager ``nnx.value_and_grad``), and one ``Trainer._train_step`` with
    Adam 1e-3 (the loss, the gradients it applied, the parameters and BN
    statistics after)."""
    batch = dcp_batch()

    def build():
        jm = JDCP(JDGCNN(emb_dims=EMB, k=K, rngs=nnx.Rngs(0)), rngs=nnx.Rngs(1))
        randomize_bn(jm, np.random.default_rng(0))
        return jm

    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        mp.setattr(jdgcnn_mod, "get_graph_feature_fused", functools.partial(jedge.get_graph_feature_fused,
                                                                           use_pallas=True))
        mp.setattr(jattn, "attention_pallas_ok", open_attention_gate)
        jm = build()
        before = nnx_flat(jm)
        (loss, aux), grads = nnx.value_and_grad(lambda m: jtasks.dcp(m, tuple(map(jnp.asarray, batch)), None),
                                                has_aux=True)(jm)
        jm = build()
        tr = JTrainer(JTrainConfig(batch_size=B, task="dcp", lr=LR, ckpt_dir=str(tmp_path_factory.mktemp("j"))), jm)
        tr._tx = optax.chain(keep_grads(), optax.adam(LR))
        tr.optimizer = nnx.Optimizer(tr.model, tr._tx, wrt=nnx.Param)
        step_loss, step_aux = tr._train_step(tr.model, tr.optimizer, batch, jax.random.PRNGKey(0))
    applied = {".".join(map(str, p[2:])): np.asarray(v.get_value())
               for p, v in nnx.to_flat_state(nnx.state(tr.optimizer)) if p[:2] == ("opt_state", 0)}
    return {"batch": batch, "before": before, "loss": float(loss),
            "aux": {k: np.asarray(v) for k, v in aux.items()}, "grads": flat_grads(grads),
            "step_loss": float(step_loss), "step_aux": {k: np.asarray(v) for k, v in step_aux.items()},
            "step_grads": nnx_to_torch(applied), "after": nnx_to_torch(nnx_flat(jm))}


def port_dcp(state):
    return load_nnx_state(DCP(DGCNN(emb_dims=EMB, k=K, device="cpu"), device="cpu"), state)


# The key projections' biases have no gradient in exact arithmetic (a bias
# on every key adds one constant to a query's scores, which the softmax
# takes out): what both sides compute is rounding noise, held to 1e-6 of
# the projection's weight gradient.
VANISHING = {f"pointer.{layer}.{attn}.wk.bias" for layer, attn in (
    ("enc_layers.0", "self_attn"), ("dec_layers.0", "self_attn"), ("dec_layers.0", "cross_attn"))}


def check_grads(got, want, tol):
    failed = {}
    for name, g in got.items():
        ref = want[name]
        if name in VANISHING:
            err = np.linalg.norm(g - ref) / np.linalg.norm(want[name.replace(".bias", ".weight")])
            limit = 1e-6
        else:
            err, limit = rel(torch.from_numpy(g), ref), tol
        if not err <= limit:
            failed[name] = err
    assert not failed, failed


# One loss and its gradients: f32 on both sides with the same neighbors
# (K7 is exact) and the same attention math (K6's forward on both sides
# rounds the unnormalized P to bf16 and divides by l after). The two
# frameworks sum in f32 in another order, in the convolutions and in the
# scores, where a probability can cross a bf16 rounding boundary; through
# the Kabsch solver that moves the loss by ~1e-5 of itself and each gradient
# by up to ~7e-4 of its norm. Held to 1e-4 and 3e-3; the metrics to 1e-3 degrees and 1e-4.
TASK_TOL = {"loss": 1e-4, "grad": 3e-3, "rot_deg": 1e-3, "trans": 1e-4}


def test_dcp_task_matches_jax(jax_dcp, monkeypatch):
    """tasks.dcp on copied weights in train mode: the loss, rot_deg/trans,
    and every parameter's gradient against the JAX task's; the head's
    attention goes through K6's plain version (counted) and the encoder's
    edge features through K7's."""
    from learning3d_tpu_torch.kernels import edgeconv as tedge

    calls = {"k6": 0, "k7": 0}
    k6, k7 = tattn.attention_reference, tedge.edge_features_reference
    monkeypatch.setattr(tattn, "attention_reference", lambda *a: calls.__setitem__("k6", calls["k6"] + 1) or k6(*a))
    monkeypatch.setattr(tedge, "edge_features_reference",
                        lambda *a: calls.__setitem__("k7", calls["k7"] + 1) or k7(*a))
    model = port_dcp(jax_dcp["before"]).train()
    loss, aux = tasks.dcp(model, tuple(torch.from_numpy(a) for a in jax_dcp["batch"]))
    loss.backward()
    assert calls == {"k6": 1, "k7": 2}
    assert abs(float(loss.detach()) - jax_dcp["loss"]) <= TASK_TOL["loss"] * abs(jax_dcp["loss"])
    for key in ("rot_deg", "trans"):
        np.testing.assert_allclose(aux[key].detach().numpy(), jax_dcp["aux"][key], rtol=0, atol=TASK_TOL[key])
    check_grads({n: p.grad.numpy() for n, p in model.named_parameters()}, jax_dcp["grads"], TASK_TOL["grad"])
    assert tasks.TASKS["dcp"] is tasks.dcp


def test_trainer_step_matches_jax(jax_dcp, tmp_path):
    """One ``Trainer.train_step`` (forward, backward, guard, Adam 1e-3) on the
    weights and batch of the JAX ``Trainer._train_step``: the loss and
    metrics, the BN running statistics, the gradients applied and the
    parameters after.

    The JAX step is jitted, and on the CPU its gradients of DGCNN's stages
    1-4 (the convs and BatchNorms in front of the max over neighbors) lie
    37-137% from its own eager gradients, which the port and an f64
    evaluation agree with to ~1e-6 (ROADMAP Queue 3): those tensors are held
    to the eager JAX gradient of ``jax_dcp`` instead, at the task's
    tolerance. Every other gradient is held to the step's. Adam's first
    update is -lr g / (|g| + eps), so the parameters after follow from the
    gradients: each is held to before + that update of the port's own
    gradient (to f32 rounding) and, where the two gradients share a sign and
    lie well above eps (at least 90% of each tensor), to JAX's parameters
    after."""
    model = port_dcp(jax_dcp["before"])
    tr = Trainer(TrainConfig(batch_size=B, task="dcp", lr=LR, ckpt_dir=str(tmp_path)), model, device="cpu")
    tr._ensure_optimizer(1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, aux = tr.train_step(tuple(torch.from_numpy(a) for a in jax_dcp["batch"]))
    assert abs(float(loss) - jax_dcp["step_loss"]) <= TASK_TOL["loss"] * abs(jax_dcp["step_loss"])
    for key in ("rot_deg", "trans"):
        np.testing.assert_allclose(aux[key].numpy(), jax_dcp["step_aux"][key], rtol=0, atol=TASK_TOL[key])
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), jax_dcp["after"][name], rtol=1e-5, atol=1e-6, err_msg=name)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    encoder = {n for n in grads if n.startswith(("emb_nn.convs.", "emb_nn.bns.")) and n.split(".")[2] in "0123"}
    check_grads({n: g for n, g in grads.items() if n in encoder}, jax_dcp["grads"], TASK_TOL["grad"])
    check_grads({n: g for n, g in grads.items() if n not in encoder}, jax_dcp["step_grads"], TASK_TOL["grad"])
    for name, p in model.named_parameters():
        g = torch.from_numpy(grads[name])
        want = before[name] - LR * g / (g.abs() + 1e-8)
        torch.testing.assert_close(p.detach(), want, rtol=0, atol=1e-6 * LR + 2e-7 * before[name].abs().max().item())
        if name in encoder or name in VANISHING:
            continue
        g_j = jax_dcp["step_grads"][name]
        # where both gradients share a sign and lie well above eps, both
        # updates are -lr sign(g) to 1e-2 of lr
        firm = (np.sign(grads[name]) == np.sign(g_j)) & (np.minimum(np.abs(grads[name]), np.abs(g_j)) >= 1e-6)
        assert firm.mean() >= 0.9, name
        np.testing.assert_allclose(p.detach().numpy()[firm], jax_dcp["after"][name][firm], rtol=0,
                                   atol=1e-2 * LR + 2e-7 * before[name].abs().max().item(), err_msg=name)
    tr.close()


def small_dcp():
    return DCP(DGCNN(emb_dims=64, k=5, device="cpu"), device="cpu")


class Recorded(RegistrationData):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.calls = []

    def set_epoch(self, epoch):
        self.calls.append(("epoch", epoch))
        super().set_epoch(epoch)

    def set_difficulty(self, scale):
        self.calls.append(("difficulty", scale))
        super().set_difficulty(scale)


def test_fit_selects_by_rot_deg(tmp_path):
    """Two epochs of DCP through Trainer.fit on RegistrationData("DCP"):
    set_epoch per train epoch and 0 for eval, the curriculum's difficulty
    ramp, finite losses and metrics, the best checkpoint chosen by the test
    rot_deg (no fallback warning), best/latest written."""
    import warnings

    train = Recorded("DCP", SyntheticModelNet40(num_points=64, size=8))
    test = Recorded("DCP", SyntheticModelNet40(num_points=64, size=4, train=False))
    cfg = TrainConfig(batch_size=4, epochs=2, task="dcp", best_metric="rot_deg", curriculum_epochs=2,
                      ckpt_dir=str(tmp_path), exp_name="dcp")
    tr = Trainer(cfg, small_dcp(), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        best = tr.fit(train, test)
    assert train.calls == [("difficulty", 0.2), ("epoch", 0), ("difficulty", pytest.approx(0.6)), ("epoch", 1)]
    assert test.calls == [("epoch", 0), ("epoch", 0)]
    assert [h["epoch"] for h in tr.history] == [0, 1]
    for h in tr.history:
        assert all(np.isfinite(h[k]) for k in ("train_loss", "test_loss", "test_rot_deg", "test_trans"))
    assert best == min(h["test_rot_deg"] for h in tr.history)
    assert {p.name for p in (tmp_path / "dcp" / "best").iterdir()} == {"model.pt", "opt.pt", "meta.json"}
    assert (tmp_path / "dcp" / "latest" / "meta.json").exists()
    batch = next(batch_iterator(test, 4, shuffle=False))
    assert [a.shape for a in batch] == [(4, 64, 3), (4, 64, 3), (4, 4, 4)]
    tr.close()


def test_trainer_takes_the_dcp_task(tmp_path):
    tr = Trainer(dataclasses.replace(TrainConfig(ckpt_dir=str(tmp_path)), task="dcp"), small_dcp(), device="cpu")
    assert tr.loss_fn is tasks.dcp and tr.augment_fn is None
    tr.close()
