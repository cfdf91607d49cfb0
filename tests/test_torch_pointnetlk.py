"""The port's PointNetLK against the JAX package's, on the CPU: the weights
and ``dt`` crossing through ``load_nnx_state`` (a buffer, or a parameter
under ``learn_delta``), the eval forward's every output in f32 and f64, the
train-mode warm-up's running statistics, the ``pointnetlk`` task's loss and
gradients (``dt``'s included), one Trainer step, and serving through
``InferenceEngine`` with a ragged tail. Weights cross as numpy; inputs are
made with numpy from seeds. A narrow encoder (emb 64) with random weights
and random BatchNorm statistics, B = 2, N = 128, 3 iterations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from scipy.spatial.transform import Rotation

from learning3d_tpu.data import dataloaders as jdata
from learning3d_tpu.models import PointNet as JPointNet
from learning3d_tpu.models import PointNetLK as JPointNetLK
from learning3d_tpu.ops import mean_shift as jmean_shift
from learning3d_tpu.train import tasks as jtasks
from learning3d_tpu_torch.models import PointNet, PointNetLK
from learning3d_tpu_torch.serve import InferenceEngine
from learning3d_tpu_torch.train import TrainConfig, Trainer, tasks
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from torch_port_util import nnx_flat, randomize_bn

EMB, N, B, ITERS = 64, 128, 2, 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jax_pnlk(seed, learn_delta=False):
    jm = JPointNetLK(JPointNet(emb_dims=EMB, use_bn=True, rngs=nnx.Rngs(seed)), learn_delta=learn_delta)
    randomize_bn(jm, np.random.default_rng(seed + 10))
    return jm


def port_pnlk(flat, learn_delta=False, dtype=torch.float32):
    model = PointNetLK(PointNet(emb_dims=EMB, use_bn=True, device="cpu"), learn_delta=learn_delta, device="cpu")
    return load_nnx_state(model, flat).to(dtype)


def to_x64(jm):
    """Every variable of a JAX model in f64 (dt and the running statistics
    included, so that nothing is rounded to f32 inside an x64 run)."""
    jm = nnx.clone(jm)
    nnx.update(jm, jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), nnx.state(jm)))
    return jm


def pair(seed, b=B, n=N):
    """A template and a rotated, shifted copy."""
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(b, n, 3)).astype(np.float32)
    R = Rotation.from_euler("xyz", rng.uniform(-0.4, 0.4, (b, 3))).as_matrix().astype(np.float32)
    s = np.einsum("bij,bnj->bni", R, t) + rng.uniform(-0.2, 0.2, (b, 1, 3))
    return t, s.astype(np.float32)


OUTPUTS = {"est_R", "est_t", "est_T", "r", "transformed_source", "est_T_series"}


def test_load_nnx_state_carries_pointnetlk():
    """dt (an nnx.Variable, (1, 6)) reaches the buffer, or the parameter
    under learn_delta; the encoder's convs and BatchNorms cross as
    PointNet's."""
    for learn in (False, True):
        jm = jax_pnlk(1, learn_delta=learn)
        flat = nnx_flat(jm)
        flat["dt"] = np.full((1, 6), 0.03, np.float32)
        tm = port_pnlk(flat, learn_delta=learn)
        assert set(tm.state_dict()) == set(nnx_to_torch(flat))
        assert ("dt" in dict(tm.named_parameters())) == learn and ("dt" in dict(tm.named_buffers())) != learn
        np.testing.assert_array_equal(tm.dt.detach().numpy(), flat["dt"])
        np.testing.assert_array_equal(tm.feature_model.bns[2].running_var.numpy(), flat["feature_model.bns.2.var"])


# The f32 forward differences the features of the template and of its six
# moved copies (dt = 0.01), so f32 rounding in the features is amplified
# ~100x into the Jacobian; measured over three weight draws, each side's
# est_T lies up to 1.3e-4 of max from its own f64 result and the two sides
# 1.5e-4 from each other (r, est_t: 1.4e-4). In f64 the same math to 1e-9.
F32_TOL, F64_TOL = 5e-4, 1e-9


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pointnetlk_eval_matches_jax(dtype):
    """Every output of the eval forward (BatchNorm on its running
    statistics), est_T_series's first entry, and the bcn layout."""
    jm = jax_pnlk(0)
    jm.eval()
    flat = nnx_flat(jm)
    t, s = (a.astype(dtype) for a in pair(2))
    with jax.enable_x64(dtype == np.float64):
        jmx = to_x64(jm) if dtype == np.float64 else jm
        want = jax.tree.map(np.asarray, nnx.jit(lambda m, a, b: m(a, b, maxiter=ITERS))(jmx, jnp.asarray(t),
                                                                                          jnp.asarray(s)))
    tm = port_pnlk(flat, dtype=torch.float64 if dtype == np.float64 else torch.float32).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(s), maxiter=ITERS)
    assert set(got) == set(want) == OUTPUTS
    tol = F64_TOL if dtype == np.float64 else F32_TOL
    for key in OUTPUTS:
        assert got[key].dtype == torch.from_numpy(t).dtype
        assert rel(got[key], want[key]) <= tol, key
    # the series starts at the identity of the centred clouds, folded back:
    # the translation between the clouds' means
    assert got["est_T_series"].shape == (ITERS + 1, B, 4, 4)
    first = got["est_T_series"][0]
    assert torch.equal(first[:, :3, :3], torch.eye(3, dtype=first.dtype).expand(B, 3, 3))
    torch.testing.assert_close(first[:, :3, 3], torch.from_numpy(t.mean(1) - s.mean(1)))
    assert torch.equal(got["est_T_series"][-1], got["est_T"])
    bcn = port_pnlk(flat, dtype=got["est_T"].dtype).eval()
    bcn.input_shape = "bcn"
    with torch.no_grad():
        swapped = bcn(torch.from_numpy(t).transpose(1, 2), torch.from_numpy(s).transpose(1, 2), maxiter=ITERS)
    assert torch.equal(swapped["est_T"], got["est_T"])


@pytest.mark.parametrize("p0_zero_mean", [False, True])
def test_pointnetlk_without_zero_mean_matches_jax(p0_zero_mean):
    """p1_zero_mean=False: against the JAX forward with neither cloud
    centred, and with the template alone centred against JAX's iteration on
    the centred template and the source as given, folded back (the JAX
    forward itself raises there: ``jnp.eye(4, template.dtype)`` passes the
    dtype as the column count, ``models/pointnetlk.py:97-99``)."""
    jm = JPointNetLK(JPointNet(emb_dims=EMB, use_bn=False, rngs=nnx.Rngs(5)), p0_zero_mean=False,
                     p1_zero_mean=False)
    t, s = pair(6)
    if p0_zero_mean:
        t0, _, a0, _ = jmean_shift.mean_shift(jnp.asarray(t), jnp.asarray(s))
        est0, _, _ = jm._iclk(t0, jnp.asarray(s), 2)
        want = jmean_shift.postprocess(est0, a0, jnp.broadcast_to(jnp.eye(4), a0.shape))
    else:
        want = nnx.jit(lambda m, a, b: m(a, b, maxiter=2))(jm, jnp.asarray(t), jnp.asarray(s))["est_T"]
    tm = load_nnx_state(PointNetLK(PointNet(emb_dims=EMB, device="cpu"), p0_zero_mean=p0_zero_mean,
                                   p1_zero_mean=False, device="cpu"), nnx_flat(jm))
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(s), maxiter=2)
    assert rel(got["est_T"], want) <= F32_TOL


def test_warm_up_updates_the_running_statistics_once():
    """In train mode the template and the source are embedded once in train
    mode (two EMA updates of every BatchNorm), and everything after reads
    the running statistics: the running statistics equal JAX's after its
    forward, and the outputs equal an eval forward of the updated model
    bit for bit."""
    jm = jax_pnlk(3)
    jm.train()
    flat = nnx_flat(jm)
    t, s = pair(4)
    want = jm(jnp.asarray(t), jnp.asarray(s), maxiter=ITERS)
    after = nnx_to_torch(nnx_flat(jm))
    tm = port_pnlk(flat).train()
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(s), maxiter=ITERS)
        for name, buf in tm.named_buffers():
            if "running" in name:
                assert not np.array_equal(buf.numpy(), nnx_to_torch(flat)[name]), name
                assert rel(buf, after[name]) <= 1e-5, name
        assert rel(got["est_T"], want["est_T"]) <= F32_TOL
        frozen = tm.eval()(torch.from_numpy(t), torch.from_numpy(s), maxiter=ITERS)
    for key in OUTPUTS:
        assert torch.equal(frozen[key], got[key]), key


def registration_batch(b=B, seed=0):
    data = jdata.RegistrationData("PointNetLK", jdata.SyntheticModelNet40(num_points=N, size=b, seed=seed))
    items = [data[i] for i in range(b)]
    return tuple(np.stack([it[j] for it in items]) for j in range(3))


@pytest.fixture(scope="module")
def jax_task():
    """The JAX pointnetlk task (learn_delta, BatchNorms in train mode) on a
    PointNetLK batch: loss, metrics and gradients, jitted, in f32 and in
    x64."""
    jm = jax_pnlk(0, learn_delta=True)
    jm.train()
    batch = registration_batch()

    @nnx.jit
    def task(m, bt):
        return nnx.value_and_grad(lambda m: jtasks.pointnetlk(m, bt, None), has_aux=True)(m)

    out = {"flat": nnx_flat(jm), "batch": batch}
    for key, x64 in (("f32", False), ("f64", True)):
        with jax.enable_x64(x64):
            m = to_x64(jm) if x64 else nnx.clone(jm)
            (loss, aux), grads = task(m, tuple(jnp.asarray(a.astype(np.float64 if x64 else np.float32))
                                               for a in batch))
            out[key] = {"loss": float(loss), "aux": {k: np.asarray(v, np.float64) for k, v in aux.items()},
                        "grads": nnx_to_torch({".".join(map(str, p)): np.asarray(v.get_value(), np.float64)
                                               for p, v in nnx.to_flat_state(grads)})}
    return out


def port_task(flat, batch, dtype):
    model = port_pnlk(flat, learn_delta=True, dtype=dtype).train()
    loss, aux = tasks.pointnetlk(model, tuple(torch.from_numpy(a).to(dtype) for a in batch))
    loss.backward()
    return loss.item(), aux, {n: p.grad.double().numpy() for n, p in model.named_parameters()}


def grad_rel(got, want, scale):
    return float(np.linalg.norm(got - want) / scale)


# The biases in front of the last BatchNorm shift the template's and the
# moved copies' features alike, so their gradient cancels to rounding
# (measured 5e-6 against the layer weight's 200 on one draw): they are held
# against their layer's weight gradient
CANCELLING = {"feature_model.convs.4.bias": "feature_model.convs.4.weight",
              "feature_model.bns.4.bias": "feature_model.bns.4.weight"}


def scales(grads):
    return {n: np.linalg.norm(grads[CANCELLING.get(n, n)]) or 1.0 for n in grads}


def test_pointnetlk_task_f64_matches_jax(jax_task):
    """frobenius_norm_loss + rmse_features_loss and the metrics in f64, and
    every gradient (dt's included, through se3.exp(-diag(dt))) against the
    JAX task's in x64 (measured 1e-13 for the loss, 3e-8 for the worst
    gradient, a cancelling bias)."""
    want = jax_task["f64"]
    loss, aux, grads = port_task(jax_task["flat"], jax_task["batch"], torch.float64)
    assert abs(loss - want["loss"]) <= 1e-10 * abs(want["loss"])
    for key in ("rot_deg", "trans"):
        np.testing.assert_allclose(aux[key].detach().numpy(), want["aux"][key], rtol=0, atol=1e-6)
    assert set(grads) == set(want["grads"]) and "dt" in grads
    sc = scales(want["grads"])
    errs = {n: grad_rel(g, want["grads"][n], sc[n]) for n, g in grads.items()}
    assert max(errs.values()) <= 1e-6, errs
    assert tasks.TASKS["pointnetlk"] is tasks.pointnetlk


def test_pointnetlk_task_f32_is_as_close_to_f64_as_jax(jax_task):
    """In f32 the finite-difference Jacobian amplifies rounding (one draw:
    JAX's own f32 gradient up to 16x its norm from its x64 one on a
    cancelling bias, 0.7% on the others): each of the port's f32 gradients
    lies no further from the port's f64 gradient than twice JAX's f32 from
    JAX's x64, plus 2e-3; the loss likewise."""
    loss64, _, g64 = port_task(jax_task["flat"], jax_task["batch"], torch.float64)
    loss32, _, g32 = port_task(jax_task["flat"], jax_task["batch"], torch.float32)
    j32, j64 = jax_task["f32"], jax_task["f64"]
    assert abs(loss32 - loss64) <= 2 * abs(j32["loss"] - j64["loss"]) + 2e-3 * abs(loss64)
    sc = scales(g64)
    for n in g64:
        port_gap = grad_rel(g32[n], g64[n], sc[n])
        jax_gap = grad_rel(j32["grads"][n], j64["grads"][n], sc[n])
        assert port_gap <= 2 * jax_gap + 2e-3, (n, port_gap, jax_gap)


def test_trainer_step_learns_dt_and_updates_statistics(tmp_path):
    """One Trainer.train_step of the pointnetlk task: the task is picked by
    name, the loss is finite, every parameter (dt under learn_delta
    included) moves, and every BatchNorm's running statistics move (the
    warm-up)."""
    jm = jax_pnlk(7, learn_delta=True)
    model = port_pnlk(nnx_flat(jm), learn_delta=True)
    tr = Trainer(TrainConfig(batch_size=B, task="pointnetlk", lr=1e-3, ckpt_dir=str(tmp_path)), model, device="cpu")
    assert tr.loss_fn is tasks.pointnetlk
    tr._ensure_optimizer(1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, aux = tr.train_step(tuple(torch.from_numpy(a) for a in registration_batch(seed=1)))
    assert np.isfinite(float(loss)) and set(aux) == {"rot_deg", "trans"}
    for k, v in model.state_dict().items():
        if k.endswith("weight") or "running" in k or k == "dt":
            assert not torch.equal(v, before[k]), k
    tr.close()


def test_pointnetlk_serves_three_pairs_with_a_ragged_tail():
    """InferenceEngine(batch_size=2) on 3 pairs: est_T and the other
    per-pair outputs come back with 3 rows, the tail pair's equal to the
    model's on that pair alone (eval BatchNorms: every pair on its own) to
    1e-5. est_T_series is (iterations + 1, B, 4, 4): the engine cuts every
    output's first axis, so it comes back as each chunk's first rows of
    iterations (2 of the first chunk, 1 of the tail), as the JAX engine
    does."""
    model = port_pnlk(nnx_flat(jax_pnlk(8))).eval()
    t, s = pair(9, b=3)
    got = InferenceEngine(model, batch_size=2, device="cpu")(t, s)
    assert set(got) == OUTPUTS
    assert got["est_T"].shape == (3, 4, 4) and got["r"].shape == (3, EMB)
    assert got["est_T_series"].shape == (3, 2, 4, 4)
    with torch.inference_mode():
        head = model(torch.from_numpy(t[:2]), torch.from_numpy(s[:2]))
        tail = model(torch.from_numpy(t[2:]), torch.from_numpy(s[2:]))
    np.testing.assert_allclose(got["est_T_series"][:2], head["est_T_series"][:2].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["est_T_series"][2, :1], tail["est_T_series"][0].numpy(), rtol=0, atol=1e-5)
    for key in ("est_T", "r", "transformed_source"):
        assert np.abs(got[key][2:] - tail[key].numpy()).max() <= 1e-5 * max(np.abs(tail[key].numpy()).max(), 1.0)
