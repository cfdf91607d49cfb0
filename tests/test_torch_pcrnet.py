"""The port's iPCRNet slice against the JAX package, on the CPU: the
quaternion ops, iPCRNet in f32 and in bf16 eval (JAX's K1 guard opened, its
kernel in Pallas interpret mode; the port's K1 wrapper runs its plain
version), ``rotation_starts`` and ``multistart_register`` (on iPCRNet and on
an identity stub), the iPCRNet task and one Trainer step against the JAX
``Trainer._train_step``. Weights cross as numpy through ``load_nnx_state``;
inputs are made with numpy from seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx
from jax.experimental.pallas import tpu as pltpu

from learning3d_tpu import serve as jserve
from learning3d_tpu.data import dataloaders as jdata
from learning3d_tpu.kernels import pointnet_fused as jfused
from learning3d_tpu.models import PointNet as JPointNet
from learning3d_tpu.models import iPCRNet as JiPCRNet
from learning3d_tpu.ops import quaternion as jquat
from learning3d_tpu.train import TrainConfig as JTrainConfig
from learning3d_tpu.train import Trainer as JTrainer
from learning3d_tpu.train import tasks as jtasks
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.models import PointNet, iPCRNet
from learning3d_tpu_torch.ops import quaternion as tquat
from learning3d_tpu_torch.serve import multistart_register, multistart_scores, rotation_starts
from learning3d_tpu_torch.train import TrainConfig, Trainer, tasks
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from test_torch_poolgrad import _TpuBackend
from torch_port_util import check_adam_first_step, keep_grads, nnx_flat

EMB, N, B, LR = 128, 128, 2, 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jax_ipcrnet(jdtype=None, seed=0):
    jm = JiPCRNet(JPointNet(emb_dims=EMB, use_bn=False, dtype=jdtype, rngs=nnx.Rngs(seed)), dtype=jdtype,
                  rngs=nnx.Rngs(seed + 1))
    jm.eval()
    return jm


def port_ipcrnet(flat, tdtype=None):
    return load_nnx_state(iPCRNet(PointNet(emb_dims=EMB, dtype=tdtype, device="cpu"), dtype=tdtype, device="cpu"),
                          flat)


def pair(seed, n=N, b=B):
    """A template and a rotated, shifted, jittered copy (so that the
    registration has something to find)."""
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(b, n, 3)).astype(np.float32)
    a = rng.uniform(-0.6, 0.6, (b, 3))
    from scipy.spatial.transform import Rotation

    R = Rotation.from_euler("xyz", a).as_matrix().astype(np.float32)
    s = np.einsum("bij,bnj->bni", R, t) + rng.uniform(-0.3, 0.3, (b, 1, 3)) + 0.01 * rng.normal(size=t.shape)
    return t, s.astype(np.float32)


class k1_guard:
    """Open the JAX package's K1 guard (its ``jax.default_backend()`` as the
    pointnet_fused module sees it answers "tpu") and run the kernel in
    Pallas interpret mode."""

    def __enter__(self):
        self._saved = jfused.jax
        jfused.jax = _TpuBackend()
        self._interpret = pltpu.force_tpu_interpret_mode()
        self._interpret.__enter__()
        return self

    def __exit__(self, *exc):
        self._interpret.__exit__(*exc)
        jfused.jax = self._saved
        return False


def test_quaternion_ops_match_jax():
    q = np.random.default_rng(1).normal(size=(5, 4)).astype(np.float32)
    q[0] = 0.0  # the eps floor
    qn = tquat.qnormalize(torch.from_numpy(q))
    np.testing.assert_allclose(qn.numpy(), np.asarray(jquat.qnormalize(jnp.asarray(q))), rtol=1e-6, atol=1e-7)
    R = tquat.quat2mat(qn)
    np.testing.assert_allclose(R.numpy(), np.asarray(jquat.quat2mat(jnp.asarray(qn.numpy()))), rtol=0, atol=1e-6)
    assert R.shape == (5, 3, 3)


@pytest.mark.parametrize("n_starts", [1, 8, 24])
def test_rotation_starts_match_jax(n_starts):
    """The same rotations in the same greedy order (the JAX package's "min"
    quirk kept)."""
    got = rotation_starts(n_starts)
    assert got.dtype == torch.float32 and got.shape == (n_starts, 3, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jserve.rotation_starts(n_starts)))
    for bad in (0, 25):
        with pytest.raises(ValueError):
            rotation_starts(bad)


def test_ipcrnet_f32_matches_jax():
    """All five outputs in f32, on the JAX package's CPU path: the same math
    with f32 sums in another order, carried through 8 composed iterations:
    1e-4 of each output's largest value."""
    jm = jax_ipcrnet()
    tm = port_ipcrnet(nnx_flat(jm)).eval()
    t, s = pair(2)
    want = jm(jnp.asarray(t), jnp.asarray(s))
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(s))
    assert set(got) == set(want) == {"est_R", "est_t", "est_T", "r", "transformed_source"}
    for key in got:
        assert got[key].dtype == torch.float32 and tuple(got[key].shape) == want[key].shape
        assert rel(got[key], want[key]) <= 1e-4, key
    assert tm.default_iterations == 8
    with torch.no_grad():
        one = tm(torch.from_numpy(t), torch.from_numpy(s), max_iteration=1)
        bcn = iPCRNet(tm.feature_model, input_shape="bcn", device="cpu")
        bcn.load_state_dict(tm.state_dict())
        swapped = bcn.eval()(torch.from_numpy(t).transpose(1, 2), torch.from_numpy(s).transpose(1, 2))
    assert rel(one["est_T"], jm(jnp.asarray(t), jnp.asarray(s), max_iteration=1)["est_T"]) <= 1e-5
    assert torch.equal(swapped["est_T"], got["est_T"])


# bf16 iPCRNet with random weights turns each step's pose into a random
# rotation, and K1 rounds the moved source to bf16 again in every step: an
# f32 rounding in the composition that flips one coordinate's bf16 value
# changes the next step's features. Measured on the CPU over 5 draws of this
# test's sizes: bit-equal to the JAX package for 1 and (mostly) 2 steps,
# then 4.8% to 7.4% of est_R's largest entry apart after 8; moving the
# port's own source by one f32 ulp moved est_R by up to 11.5%.
BF16_STEP1_TOL, BF16_CHAOS_TOL = 1e-3, 0.15


def test_ipcrnet_bf16_k1_matches_jax():
    """bf16 eval: the JAX model runs its K1 in Pallas interpret mode (guard
    opened) 1 + max_iteration times a forward, the port its K1 wrapper's
    plain version (no launch on the CPU). One step: every output to
    BF16_STEP1_TOL (both sides round the same bf16 operands; only f32 sums'
    order can differ). Eight steps: est_T, est_t and the moved source to
    BF16_CHAOS_TOL (the amplification above), est_R as much a rotation as
    the JAX package's bf16 steps make it."""
    jm = jax_ipcrnet(jnp.bfloat16)
    tm = port_ipcrnet(nnx_flat(jm), torch.bfloat16).eval()
    t, s = pair(3)
    for iters, tol, keys in ((1, BF16_STEP1_TOL, ("est_R", "est_t", "est_T", "r", "transformed_source")),
                             (8, BF16_CHAOS_TOL, ("est_T", "est_t", "transformed_source"))):
        calls = []
        saved = jfused.pointnet_pooled_fused
        try:
            jfused.pointnet_pooled_fused = lambda *a: calls.append(1) or saved(*a)
            with k1_guard():
                want = jm(jnp.asarray(t), jnp.asarray(s), max_iteration=iters)
        finally:
            jfused.pointnet_pooled_fused = saved
        assert len(calls) == 1 + iters
        before = LAUNCHES["pointnet_pooled_kernel"]
        with torch.inference_mode():
            got = tm(torch.from_numpy(t), torch.from_numpy(s), max_iteration=iters)
        assert LAUNCHES["pointnet_pooled_kernel"] == before
        assert got["r"].dtype == torch.bfloat16 and got["est_T"].dtype == torch.float32
        for key in keys:
            assert rel(got[key].float(), np.asarray(want[key], np.float32)) <= tol, (iters, key)
    err = lambda R: np.abs(R @ np.swapaxes(R, -1, -2) - np.eye(3)).max()  # noqa: E731
    assert err(got["est_R"].double().numpy()) <= 2 * err(np.asarray(want["est_R"], np.float64)) + 1e-2


class IdentityRegistrar:
    """Registration stub that always predicts the identity, as
    tests/test_serve_multistart.py's: isolates multistart's pre-rotation,
    composition and Chamfer selection."""

    def __call__(self, template, source):
        eye = torch.eye(4, dtype=template.dtype).expand(template.shape[0], 4, 4)
        return {"est_T": eye}


class JIdentityRegistrar:
    def __call__(self, template, source):
        return {"est_T": jnp.broadcast_to(jnp.eye(4, dtype=template.dtype), (template.shape[0], 4, 4))}


class SourceFirst(IdentityRegistrar):
    forward_arg_order = "source_template"

    def __call__(self, source, template):
        assert source.shape[1] == 40
        return super().__call__(template, source)


def anisotropic(seed, n, b=3, normals=False):
    """Clouds no nontrivial octahedral rotation maps onto themselves; with
    unit normals if asked."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(b, n, 3)) * np.array([1.0, 0.55, 0.3])
    if normals:
        nrm = rng.normal(size=(b, n, 3))
        pts = np.concatenate([pts, nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)], -1)
    return pts.astype(np.float32)


@pytest.mark.parametrize("normals", [False, True])
def test_multistart_identity_stub_matches_jax(normals):
    """On the identity stub the winner is the start whose pre-rotation best
    undoes the source's rotation: est_T, start_idx and chamfer against the
    JAX package's (f32 sums in another order: 1e-5), with normals carried
    through the pre-rotation."""
    from scipy.spatial.transform import Rotation

    t = anisotropic(4, 60, normals=normals)
    R = np.stack([Rotation.from_euler("z", 180, degrees=True).as_matrix(), np.eye(3),
                  Rotation.from_euler("x", 90, degrees=True).as_matrix()]).astype(np.float32)
    s = t.copy()
    s[..., :3] = np.einsum("bij,bnj->bni", R, t[..., :3]) + 0.5
    if normals:
        s[..., 3:] = np.einsum("bij,bnj->bni", R, t[..., 3:])
    want = jserve.multistart_register(JIdentityRegistrar(), jnp.asarray(t), jnp.asarray(s), jserve.rotation_starts(8))
    got = multistart_register(IdentityRegistrar(), torch.from_numpy(t), torch.from_numpy(s), rotation_starts(8))
    np.testing.assert_array_equal(got["start_idx"].numpy(), np.asarray(want["start_idx"]))
    np.testing.assert_allclose(got["est_T"].numpy(), np.asarray(want["est_T"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["chamfer"].numpy(), np.asarray(want["chamfer"]), rtol=1e-5)
    assert len(set(got["start_idx"].tolist())) > 1  # the items pick different starts


def test_multistart_honors_the_argument_order():
    t, s = anisotropic(5, 50, b=2), anisotropic(6, 40, b=2)
    out = multistart_register(SourceFirst(), torch.from_numpy(t), torch.from_numpy(s), rotation_starts(3))
    assert out["est_T"].shape == (2, 4, 4) and out["start_idx"].shape == (2,)


def test_multistart_ipcrnet_matches_jax():
    """f32 iPCRNet folded over 8 starts (one forward at batch 8 B): the
    picked starts, the composed est_T (1e-4, as the forward) and the Chamfer
    scores (1e-4) against the JAX package's; with one start (the identity),
    the plain forward's est_T."""
    jm = jax_ipcrnet(seed=7)
    tm = port_ipcrnet(nnx_flat(jm)).eval()
    t, s = pair(8)
    want = jserve.multistart_register(jm, jnp.asarray(t), jnp.asarray(s), jserve.rotation_starts(8))
    with torch.no_grad():
        got = multistart_register(tm, torch.from_numpy(t), torch.from_numpy(s), rotation_starts(8))
        total, score = multistart_scores(tm, torch.from_numpy(t), torch.from_numpy(s), rotation_starts(8))
        one = multistart_register(tm, torch.from_numpy(t), torch.from_numpy(s), rotation_starts(1))
        plain = tm(torch.from_numpy(t), torch.from_numpy(s))
    np.testing.assert_array_equal(got["start_idx"].numpy(), np.asarray(want["start_idx"]))
    assert rel(got["est_T"], want["est_T"]) <= 1e-4
    np.testing.assert_allclose(got["chamfer"].numpy(), np.asarray(want["chamfer"]), rtol=1e-4)
    assert total.shape == (8, B, 4, 4) and score.shape == (8, B)
    assert torch.equal(score.min(0).values, got["chamfer"])
    assert (one["start_idx"] == 0).all()
    torch.testing.assert_close(one["est_T"], plain["est_T"], rtol=0, atol=1e-5)


# -- the iPCRNet task and the train step ----------------------------------------

def ipcrnet_batch():
    data = jdata.RegistrationData("iPCRNet", jdata.SyntheticModelNet40(num_points=N, size=B))
    items = [data[i] for i in range(B)]
    return tuple(np.stack([it[j] for it in items]) for j in range(3))


@pytest.fixture(scope="module")
def jax_ipc(tmp_path_factory):
    """The JAX iPCRNet task's loss, metrics and eager gradients, and one
    ``Trainer._train_step`` with Adam 1e-3 on the same weights and batch."""
    batch = ipcrnet_batch()
    jm = jax_ipcrnet(seed=11)
    jm.train()
    before = nnx_flat(jm)
    (loss, aux), grads = nnx.value_and_grad(lambda m: jtasks.ipcrnet(m, tuple(map(jnp.asarray, batch)), None),
                                            has_aux=True)(jm)
    jm = jax_ipcrnet(seed=11)
    jm.train()
    tr = JTrainer(JTrainConfig(batch_size=B, task="ipcrnet", lr=LR, ckpt_dir=str(tmp_path_factory.mktemp("j"))), jm)
    tr._tx = optax.chain(keep_grads(), optax.adam(LR))
    tr.optimizer = nnx.Optimizer(tr.model, tr._tx, wrt=nnx.Param)
    step_loss, step_aux = tr._train_step(tr.model, tr.optimizer, batch, jax.random.PRNGKey(0))
    applied = {".".join(map(str, p[2:])): np.asarray(v.get_value())
               for p, v in nnx.to_flat_state(nnx.state(tr.optimizer)) if p[:2] == ("opt_state", 0)}
    flat = {".".join(map(str, p)): np.asarray(v.get_value()) for p, v in nnx.to_flat_state(grads)}
    return {"batch": batch, "before": before, "loss": float(loss), "aux": {k: np.asarray(v) for k, v in aux.items()},
            "grads": nnx_to_torch(flat), "step_loss": float(step_loss),
            "step_aux": {k: np.asarray(v) for k, v in step_aux.items()}, "step_grads": nnx_to_torch(applied),
            "after": nnx_to_torch(nnx_flat(jm))}


def grad_rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# f32 on both sides, the same nearest neighbours (checked); the sums of 8
# composed iterations and their backward in another order: the loss to
# 1e-5, each gradient to 1e-3 of its norm, the metrics to 1e-3 degrees and
# 1e-4
TASK_TOL = {"loss": 1e-5, "grad": 1e-3, "rot_deg": 1e-3, "trans": 1e-4}


def test_ipcrnet_task_matches_jax(jax_ipc):
    """tasks.ipcrnet on copied weights: the Chamfer loss of the template
    against the transformed source, rot_deg and trans, and every gradient
    against eager ``nnx.value_and_grad`` of the JAX task."""
    model = port_ipcrnet(jax_ipc["before"]).train()
    loss, aux = tasks.ipcrnet(model, tuple(torch.from_numpy(a) for a in jax_ipc["batch"]))
    loss.backward()
    assert abs(loss.item() - jax_ipc["loss"]) <= TASK_TOL["loss"] * abs(jax_ipc["loss"])
    for key in ("rot_deg", "trans"):
        np.testing.assert_allclose(aux[key].detach().numpy(), jax_ipc["aux"][key], rtol=0, atol=TASK_TOL[key])
    failed = {n: grad_rel(p.grad.numpy(), jax_ipc["grads"][n]) for n, p in model.named_parameters()}
    assert all(v <= TASK_TOL["grad"] for v in failed.values()), failed
    assert tasks.TASKS["ipcrnet"] is tasks.ipcrnet


def test_trainer_step_matches_jax(jax_ipc, tmp_path):
    """One ``Trainer.train_step`` (forward, backward, guard, Adam 1e-3) on the
    weights and batch of the JAX ``Trainer._train_step``: the loss and
    metrics, the gradients applied and the parameters after
    (``check_adam_first_step``)."""
    model = port_ipcrnet(jax_ipc["before"])
    tr = Trainer(TrainConfig(batch_size=B, task="ipcrnet", lr=LR, ckpt_dir=str(tmp_path)), model, device="cpu")
    assert tr.loss_fn is tasks.ipcrnet and tr.augment_fn is None
    tr._ensure_optimizer(1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, aux = tr.train_step(tuple(torch.from_numpy(a) for a in jax_ipc["batch"]))
    assert abs(float(loss) - jax_ipc["step_loss"]) <= TASK_TOL["loss"] * abs(jax_ipc["step_loss"])
    for key in ("rot_deg", "trans"):
        np.testing.assert_allclose(aux[key].numpy(), jax_ipc["step_aux"][key], rtol=0, atol=TASK_TOL[key])
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    failed = {n: grad_rel(g, jax_ipc["step_grads"][n]) for n, g in grads.items()}
    assert all(v <= TASK_TOL["grad"] for v in failed.values()), failed
    check_adam_first_step(model, before, grads, jax_ipc["step_grads"], jax_ipc["after"], LR)
    tr.close()


def test_load_nnx_state_carries_ipcrnet():
    """Every iPCRNet parameter crosses: the PointNet convs, the MLP and the
    head, Linear kernels transposed."""
    jm = jax_ipcrnet(seed=3)
    flat = nnx_flat(jm)
    tm = port_ipcrnet(flat)
    assert set(tm.state_dict()) == set(nnx_to_torch(flat))
    np.testing.assert_array_equal(tm.linears[0].weight.detach().numpy(), flat["linears.0.kernel"].T)
    np.testing.assert_array_equal(tm.head.bias.detach().numpy(), flat["head.bias"])
