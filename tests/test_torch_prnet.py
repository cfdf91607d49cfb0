"""The port's PRNet slice against the JAX package, on the CPU at the size of
``tests/test_models.py``'s PRNet tests: emb 64, 32 keypoints of a 48-point
partial source against a 64-point template, k = 20, B = 4, f32, weights and
BatchNorm statistics carried across by ``load_nnx_state`` (some BN scales
negative). Every module (cycle_consistency, PRPointNet, PRDGCNN in train
and eval mode, TemperatureNet, PRSVDHead, KeyPointNet), the whole forward
with and without igt, its argument order through the serving engine and
multi-start registration, the PRNet task's gradients and one Trainer step.

At N < 512 both packages select neighbors on their plain path (the matmul
expansion and a stable sort), so the kNN graphs are the same; K8 is held
to its plain version by ``tests/test_torch_knn.py`` and on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from scipy.spatial.transform import Rotation

from learning3d_tpu import serve as jserve
from learning3d_tpu.models import PRNet as JPRNet
from learning3d_tpu.models import prnet as jprnet
from learning3d_tpu.train import tasks as jtasks
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.models import PRNet
from learning3d_tpu_torch.models import prnet as tprnet
from learning3d_tpu_torch.serve import InferenceEngine, multistart_register, rotation_starts
from learning3d_tpu_torch.train import TrainConfig, Trainer, tasks
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from torch_port_util import nnx_flat, randomize_bn

B, NT, NS, EMB, KP, LR = 4, 64, 48, 64, 32, 1e-3
# f32 on both sides, sums in other orders. Eval: 1e-4 of each output's
# largest value (measured <= 3.1e-5 over 6 weight draws). Train mode: the
# BatchNorms take their statistics over the batch, TemperatureNet's over
# only B = 4 rows with the fast variance E[x^2] - E[x]^2, which amplifies
# the sum-order rounding: 1e-3 (measured <= 1.9e-4 over 6 draws)
FWD_TOL = {"eval": 1e-4, "train": 1e-3}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def pair(seed, b=B):
    """A template, the ground truth igt (template -> source) and a partial
    source: the moved template's points in a random subset of NS."""
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(b, NT, 3)).astype(np.float32)
    R = Rotation.from_euler("zyx", rng.uniform(-0.7, 0.7, (b, 3))).as_matrix().astype(np.float32)
    igt = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    igt[:, :3, :3], igt[:, :3, 3] = R, rng.uniform(-0.5, 0.5, (b, 3))
    s = np.einsum("bij,bnj->bni", R, t) + igt[:, None, :3, 3]
    return t, s[:, rng.permutation(NT)[:NS]].astype(np.float32), igt


def jax_prnet(seed=0, **kw):
    jm = JPRNet(emb_dims=EMB, num_keypoints=KP, num_subsampled_points=NS, rngs=nnx.Rngs(seed), **kw)
    randomize_bn(jm, np.random.default_rng(seed))
    return jm


def port_prnet(flat, **kw):
    return load_nnx_state(PRNet(emb_dims=EMB, num_keypoints=KP, num_subsampled_points=NS, device="cpu", **kw), flat)


def feats(b, n, c, seed):
    return np.random.default_rng(seed).normal(size=(b, n, c)).astype(np.float32)


def test_cycle_consistency_matches_jax():
    rng = np.random.default_rng(1)
    R_ab, R_ba = (Rotation.random(3, random_state=s).as_matrix().astype(np.float32) for s in (2, 3))
    t_ab, t_ba = rng.normal(size=(2, 3, 3)).astype(np.float32)
    want = float(jprnet.cycle_consistency(*map(jnp.asarray, (R_ab, t_ab, R_ba, t_ba))))
    got = float(tprnet.cycle_consistency(*map(torch.from_numpy, (R_ab, t_ab, R_ba, t_ba))))
    assert abs(got - want) <= 1e-6 * abs(want)


def check_module(jmod, tmod, inputs, mode, tol):
    """One forward of a JAX module and its port twin (weights carried) in
    ``mode``; in train mode also the BN running statistics after it."""
    getattr(jmod, mode)()
    getattr(tmod, mode)()
    want = jmod(*map(jnp.asarray, inputs))
    got = tmod(*map(torch.from_numpy, inputs))
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert rel(g, w) <= tol
    if mode == "train":
        after = nnx_to_torch(nnx_flat(jmod))
        for name, buf in tmod.named_buffers():
            np.testing.assert_allclose(buf.numpy(), after[name], rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_prpointnet_matches_jax(mode):
    jm = jprnet.PRPointNet(EMB, rngs=nnx.Rngs(1))
    randomize_bn(jm, np.random.default_rng(1))
    tm = load_nnx_state(tprnet.PRPointNet(EMB, device="cpu"), nnx_flat(jm))
    check_module(jm, tm, (feats(B, NS, 3, 4),), mode, 1e-5)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_prdgcnn_matches_jax(mode):
    """Both forms: train mode's BatchNorm over the (B, N, k, Co) edge tensor,
    eval mode's per-channel max (scale >= 0) / min (scale < 0) of the
    gathered neighbor term; some BN scales are negative, so the min branch
    runs. The kNN graph of every stage is recomputed from its input."""
    jm = jprnet.PRDGCNN(EMB, k=20, rngs=nnx.Rngs(2))
    randomize_bn(jm, np.random.default_rng(2))
    assert (np.asarray(jm.bns[1].scale.get_value()) < 0).any()
    tm = load_nnx_state(tprnet.PRDGCNN(EMB, k=20, device="cpu"), nnx_flat(jm))
    check_module(jm, tm, (feats(B, NT, 3, 5),), mode, 1e-5)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_temperature_net_matches_jax(mode):
    """The temperature (clipped to [0.01, 100]) and the disparity, to 1e-5;
    in train mode the BatchNorms take the fast variance over the B = 4 rows,
    which amplifies the sum-order rounding (1.3e-5 measured): 1e-4."""
    jm = jprnet.TemperatureNet(EMB, rngs=nnx.Rngs(3))
    randomize_bn(jm, np.random.default_rng(3))
    tm = load_nnx_state(tprnet.TemperatureNet(EMB, device="cpu"), nnx_flat(jm))
    check_module(jm, tm, (feats(B, KP, EMB, 6), feats(B, KP, EMB, 7)), mode, 1e-5 if mode == "eval" else 1e-4)


@pytest.mark.parametrize("sampler", ["softmax", "gumbel_softmax"])
def test_svd_head_matches_jax(sampler, monkeypatch):
    """R and t of PRSVDHead, to 1e-5. The Gumbel sampler's uniforms come from
    a generator the port's head owns (the JAX package draws from
    ``rngs.gumbel``), so both sides are fed the same numpy uniforms."""
    src_emb, tgt_emb = feats(B, KP, EMB, 8), feats(B, KP, EMB, 9)
    src, tgt = feats(B, KP, 3, 10), feats(B, KP, 3, 11)
    temp = np.random.default_rng(12).uniform(0.5, 3.0, (B, 1)).astype(np.float32)
    jm = jprnet.PRSVDHead(EMB, sampler, rngs=nnx.Rngs(gumbel=0))
    tm = tprnet.PRSVDHead(EMB, sampler, device="cpu")
    assert tm.temperature.shape == (1,) and float(tm.temperature) == 0.5
    u = np.random.default_rng(13).uniform(size=(B, KP, KP)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **kw: jnp.asarray(u))
    tm.uniform = lambda shape, device: torch.from_numpy(u)
    inputs = (src_emb, tgt_emb, src, tgt, temp)
    want = jm(*map(jnp.asarray, inputs))
    got = tm(*map(torch.from_numpy, inputs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_keypointnet_ties_match_jax():
    """Top-k by embedding norm in lax.top_k's order: rows of equal norm (the
    same row repeated, so the norms are equal bit for bit) go to the smaller
    index. The same picks as the JAX KeyPointNet, in the same order."""
    emb = feats(B, NS, EMB, 14)
    emb[:, 10:30] = emb[:, 5:6]  # 21 rows of one norm straddle the cut
    src = feats(B, NS, 3, 15)
    want = jprnet.KeyPointNet(KP)(*map(jnp.asarray, (src, src, emb, emb)))
    got = tprnet.KeyPointNet(KP)(*map(torch.from_numpy, (src, src, emb, emb)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_load_nnx_state_carries_prnet():
    """Every weight and statistic of a JAX PRNet maps onto the port's, the
    head's unused temperature included; nothing is left on either side."""
    jm = jax_prnet(4)
    flat = nnx_flat(jm)
    tm = port_prnet(flat)
    mapped = nnx_to_torch(flat)
    state = tm.state_dict()
    assert set(state) == set(mapped)
    for key, val in state.items():
        np.testing.assert_array_equal(val.numpy(), mapped[key], err_msg=key)
    assert "head.temperature" in state and "emb_nn.bns.3.running_var" in state


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("with_igt", [False, True])
def test_prnet_forward_matches_jax(mode, with_igt):
    """The whole forward (3 iterations, the template embedded once): est_R,
    est_t, est_T, transformed_source and, given igt, the discounted loss, to
    FWD_TOL; in train mode also the BN running statistics after it."""
    t, s, igt = pair(20)
    jm = jax_prnet(5)
    tm = port_prnet(nnx_flat(jm))
    getattr(jm, mode)()
    getattr(tm, mode)()
    gt = np.linalg.inv(igt).astype(np.float32) if with_igt else None
    want = jm(jnp.asarray(s), jnp.asarray(t), igt=None if gt is None else jnp.asarray(gt))
    got = tm(torch.from_numpy(s), torch.from_numpy(t), igt=None if gt is None else torch.from_numpy(gt))
    assert set(got) == set(want) == {"est_R", "est_t", "est_T", "transformed_source"} | ({"loss"} if with_igt else set())
    for key in want:
        assert rel(got[key], want[key]) <= FWD_TOL[mode], key
    if mode == "train":
        after = nnx_to_torch(nnx_flat(jm))
        for name, buf in tm.named_buffers():  # (measured <= 4.6e-6 of the tensor's largest value)
            assert rel(buf, after[name]) <= 1e-4, name


def test_prnet_argument_order_through_serving():
    """forward_arg_order is "source_template": InferenceEngine takes (source,
    template) as the model does (3 pairs at batch 2, a padded tail), and
    multistart_register hands the model (source, template), against the JAX
    engine and the JAX multistart_register on the same model."""
    assert PRNet.forward_arg_order == JPRNet.forward_arg_order == "source_template"
    t, s, _ = pair(21, b=3)
    jm = jax_prnet(6)
    tm = port_prnet(nnx_flat(jm)).eval()
    jm.eval()
    want = jserve.InferenceEngine(jm, batch_size=2)(s, t)
    got = InferenceEngine(tm, batch_size=2, device="cpu")(s, t)
    for key in want:
        assert rel(got[key], want[key]) <= FWD_TOL["eval"], key
    rots = rotation_starts(4)
    want = jserve.multistart_register(jm, jnp.asarray(t[:2]), jnp.asarray(s[:2]), jnp.asarray(rots.numpy()))
    with torch.inference_mode():
        got = multistart_register(tm, torch.from_numpy(t[:2]), torch.from_numpy(s[:2]), rots)
    np.testing.assert_array_equal(got["start_idx"].numpy(), np.asarray(want["start_idx"]))
    assert rel(got["est_T"], want["est_T"]) <= FWD_TOL["eval"]
    assert rel(got["chamfer"], want["chamfer"]) <= FWD_TOL["eval"]


# -- training ------------------------------------------------------------------

# Gradients of the PRNet task. The JAX package's own f32 eager gradient is
# ill-conditioned here: on the draw below it lies 173% from its f64 eager
# gradient (0.4% and 0.1% on two other draws), while the port's f32 gradient
# lies within 9.3e-4 of the port's f64 one and the two f64 gradients within
# 2.6e-4 of each other. So the reference is ``nnx.value_and_grad`` run
# eagerly with the same f32 weights on f64 inputs (JAX's x64 mode), and
# every gradient is held to 5e-3 of its norm. The biases whose exact
# gradient is 0 (the Linears feeding TemperatureNet's train-mode
# BatchNorms, and the key projections', which the softmax takes out) are
# rounding noise on both sides: held to 1e-3 of their layer's weight
# gradient instead.
GRAD_TOL, NOISE_TOL = 5e-3, 1e-3
VANISHING = {f"temp_net.layers.{i}.bias" for i in range(3)} | {
    f"attention.{layer}.{attn}.wk.bias"
    for layer, attn in (("enc_layers.0", "self_attn"), ("dec_layers.0", "self_attn"), ("dec_layers.0", "cross_attn"))}


@pytest.fixture(scope="module")
def jax_task():
    """The JAX PRNet task on one batch in train mode: the loss and metrics in
    f32, the eager gradients on f64 inputs, the parameters and statistics
    before, and the statistics after the f32 forward."""
    t, s, igt = pair(22)
    jm = jax_prnet(2)
    before = nnx_flat(jm)
    loss, aux = jtasks.prnet(jm, tuple(map(jnp.asarray, (t, s, igt))), None)
    after = nnx_to_torch(nnx_flat(jm))
    with jax.enable_x64(True):
        jm64 = jax_prnet(2)
        batch64 = tuple(jnp.asarray(a.astype(np.float64)) for a in (t, s, igt))
        _, grads = nnx.value_and_grad(lambda m: jtasks.prnet(m, batch64, None), has_aux=True)(jm64)
        grads = nnx_to_torch({".".join(map(str, p)): np.asarray(v.get_value(), np.float64)
                              for p, v in nnx.to_flat_state(grads)})
    return {"batch": (t, s, igt), "before": before, "after": after, "loss": float(loss),
            "aux": {k: np.asarray(v) for k, v in aux.items()}, "grads": grads}


def check_grads(model, want):
    failed = {}
    for name, p in model.named_parameters():
        if name == "head.temperature":  # unused by the forward: a zero gradient (or none) on both sides
            assert (p.grad is None or not p.grad.any()) and not np.asarray(want[name]).any()
            continue
        g = p.grad.double().numpy()
        if name in VANISHING:
            err, limit = np.linalg.norm(g - want[name]) / np.linalg.norm(want[name[:-4] + "weight"]), NOISE_TOL
        else:
            err, limit = np.linalg.norm(g - want[name]) / np.linalg.norm(want[name]), GRAD_TOL
        if not err <= limit:
            failed[name] = err
    assert not failed, failed


def test_prnet_task_matches_jax(jax_task):
    """tasks.prnet in train mode: the loss (PRNet's own, given igt^-1) and the
    registration metrics against the JAX task's, every gradient against the
    eager JAX gradient."""
    model = port_prnet(jax_task["before"]).train()
    loss, aux = tasks.prnet(model, tuple(map(torch.from_numpy, jax_task["batch"])))
    loss.backward()
    assert abs(float(loss) - jax_task["loss"]) <= FWD_TOL["train"] * abs(jax_task["loss"])
    np.testing.assert_allclose(aux["rot_deg"].detach().numpy(), jax_task["aux"]["rot_deg"], rtol=0, atol=1e-2)
    np.testing.assert_allclose(aux["trans"].detach().numpy(), jax_task["aux"]["trans"], rtol=0, atol=1e-4)
    check_grads(model, jax_task["grads"])
    assert tasks.TASKS["prnet"] is tasks.prnet


def test_trainer_step_matches_jax(jax_task, tmp_path):
    """One Trainer.train_step (forward, backward, guard, Adam 1e-3) with
    tasks.prnet: the loss, the gradients against the eager JAX gradient, the
    BN running statistics against JAX's after the same forward, and each
    parameter after Adam's first update, -lr g / (|g| + eps) of its own
    gradient (to f32 rounding)."""
    model = port_prnet(jax_task["before"])
    tr = Trainer(TrainConfig(batch_size=B, task="prnet", lr=LR, ckpt_dir=str(tmp_path)), model, device="cpu")
    tr._ensure_optimizer(1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, aux = tr.train_step(tuple(map(torch.from_numpy, jax_task["batch"])))
    assert abs(float(loss) - jax_task["loss"]) <= FWD_TOL["train"] * abs(jax_task["loss"])
    assert set(aux) == {"rot_deg", "trans"}
    check_grads(model, jax_task["grads"])
    for name, buf in model.named_buffers():
        assert rel(buf, jax_task["after"][name]) <= 1e-4, name
    for name, p in model.named_parameters():
        if p.grad is None:
            torch.testing.assert_close(p.detach(), before[name], rtol=0, atol=0)
            continue
        want = before[name] - LR * p.grad / (p.grad.abs() + 1e-8)
        torch.testing.assert_close(p.detach(), want, rtol=0, atol=1e-6 * LR + 2e-7 * before[name].abs().max().item())
    assert LAUNCHES["knn_pallas"] == 0
    tr.close()
