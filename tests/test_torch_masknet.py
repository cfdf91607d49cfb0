"""The port's MaskNet against the JAX package's, on the CPU: the mask and
the masked template in f32 and in bf16 eval (JAX's K1 guard opened, its
kernel in Pallas interpret mode; the port's K1 wrapper runs its plain
version), the order of the picks among tied scores (``lax.top_k``'s),
``select_by_threshold``, ``mask_scores``, the ``masknet`` task with both
losses and its gradients, the same step in f32 train mode with JAX's K3/K4
guard open (both run the fused tail's kernels: JAX in interpret mode, the
port their plain versions), and the tuple a served MaskNet returns. Weights
cross as numpy through ``load_nnx_state``; inputs are made with numpy from
seeds.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from learning3d_tpu.data import dataloaders as jdata
from learning3d_tpu.kernels import pointnet_fused as jfused
from learning3d_tpu.models import MaskNet as JMaskNet
from learning3d_tpu.models import PointNet as JPointNet
from learning3d_tpu.models.masknet import select_by_threshold as jselect
from learning3d_tpu.train import metrics as jmetrics
from learning3d_tpu.train import tasks as jtasks
from learning3d_tpu.utils import layers as jlayers
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import pointnet_fused as tfused
from learning3d_tpu_torch.models import MaskNet, PointNet
from learning3d_tpu_torch.models.masknet import select_by_threshold, top_indices
from learning3d_tpu_torch.serve import InferenceEngine
from learning3d_tpu_torch.train import TrainConfig, Trainer, metrics, tasks
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from test_torch_pcrnet import k1_guard
from test_torch_poolgrad import tpu_guard
from torch_port_util import nnx_flat, randomize_bn

EMB, NT, NS, B = 64, 128, 96, 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jax_masknet(seed, emb=EMB, jdtype=None):
    jm = JMaskNet(JPointNet(emb_dims=emb, use_bn=True, dtype=jdtype, rngs=nnx.Rngs(seed)), dtype=jdtype,
                  rngs=nnx.Rngs(seed + 1))
    randomize_bn(jm, np.random.default_rng(seed + 2))
    return jm


def port_masknet(flat, emb=EMB, tdtype=None):
    return load_nnx_state(MaskNet(PointNet(emb_dims=emb, use_bn=True, dtype=tdtype, device="cpu"), dtype=tdtype,
                                  device="cpu"), flat)


def masknet_batch(seed, b=B, nt=NT, ns=NS):
    """(template, partial source, igt, gt_mask): each template rotated and
    moved, its ns points nearest a far pivot kept as the source
    (``farthest_subsample_points``), gt_mask marking them."""
    data = jdata.RegistrationData("PointNetLK", jdata.SyntheticModelNet40(num_points=nt, size=b, seed=seed))
    rng = np.random.default_rng(seed)
    items = []
    for i in range(b):
        template, source, igt = data[i]
        source, gt_mask = jdata.farthest_subsample_points(source, ns, rng=rng)
        items.append((template, source.astype(np.float32), igt, gt_mask))
    return tuple(np.stack([it[j] for it in items]) for j in range(4))


def test_load_nnx_state_carries_masknet():
    """maskNet.feature_model.*, maskNet.h3.{0..3}.* and maskNet.out.*."""
    jm = jax_masknet(0)
    flat = nnx_flat(jm)
    tm = port_masknet(flat)
    assert set(tm.state_dict()) == set(nnx_to_torch(flat))
    assert {k.split(".")[1] for k in flat} == {"feature_model", "h3", "out"}
    np.testing.assert_array_equal(tm.maskNet.h3[3].weight.detach().numpy(), flat["maskNet.h3.3.kernel"].T)
    np.testing.assert_array_equal(tm.maskNet.out.bias.detach().numpy(), flat["maskNet.out.bias"])


# f32: the same math, sums in other orders: the mask to 1e-5 and the same
# picks (checked: no two scores of a row closer than the error)
F32_TOL = 1e-5


def test_masknet_takes_no_unused_arguments():
    """JAX's is_training and point_selection are read nowhere there; the
    port refuses them rather than ignore them."""
    tm = MaskNet(PointNet(emb_dims=EMB, use_bn=True, device="cpu"), device="cpu").eval()
    t, s = (torch.zeros(1, n, 3) for n in (NT, NS))
    with pytest.raises(TypeError):
        MaskNet(PointNet(emb_dims=EMB, device="cpu"), is_training=True, device="cpu")
    with pytest.raises(TypeError):
        tm(t, s, point_selection="threshold")
    with pytest.raises(TypeError):
        tm(t, s, "topk")


def test_masknet_f32_matches_jax():
    jm = jax_masknet(3)
    jm.eval()
    t, s, _, _ = masknet_batch(4)
    want_t, want_m = jm(jnp.asarray(t), jnp.asarray(s))
    tm = port_masknet(nnx_flat(jm)).eval()
    with torch.no_grad():
        got_t, got_m = tm(torch.from_numpy(t), torch.from_numpy(s))
    assert got_m.shape == (B, NT) and got_t.shape == (B, NS, 3)
    assert rel(got_m, want_m) <= F32_TOL
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    bcn = port_masknet(nnx_flat(jm)).eval()
    bcn.input_shape = "bcn"
    with torch.no_grad():
        swapped = bcn(torch.from_numpy(t).transpose(1, 2), torch.from_numpy(s).transpose(1, 2))
    assert torch.equal(swapped[1], got_m)


# bf16 eval: K1 (JAX in interpret mode, the port's plain version) pools the
# source in bf16 on both sides; the per-point template features and the MLP
# round bf16 at the same places, f32 sums in other orders: the mask and the
# pooled source to 2e-2 of max (a few bf16 steps of a score). Random weights
# leave every score within 0.02 of the others, about what pooling half of
# each source moves them, so the output layer is drawn BF16_OUT_SCALE times
# wider about the median logit (scores over 0.33-0.78). Readings on the
# CPU: the mask 5.0e-3, the pooled source 0.0; the control (K1 pooling the
# first half of each source) 0.118 and 0.193
BF16_TOL = 2e-2
BF16_OUT_SCALE = 30.0


@contextlib.contextmanager
def k1_half_cloud():
    """The port's K1 wrapper pooling only the first half of each cloud."""
    kernel = tfused.pointnet_pooled_kernel
    tfused.pointnet_pooled_kernel = lambda x, ws, bs, **kw: kernel(x[:, : x.shape[1] // 2].contiguous(), ws, bs, **kw)
    try:
        yield
    finally:
        tfused.pointnet_pooled_kernel = kernel


def test_masknet_bf16_k1_matches_jax():
    jm = jax_masknet(5, emb=128, jdtype=jnp.bfloat16)
    jm.eval()
    t, s, _, _ = masknet_batch(6, nt=192, ns=128)  # JAX's K1 gate: emb % 128 == 0, N >= 128
    m = np.asarray(jm(jnp.asarray(t), jnp.asarray(s))[1], np.float64)
    median = float(np.median(np.log(m) - np.log1p(-m)))
    out = jm.maskNet.out
    out.kernel.set_value(BF16_OUT_SCALE * out.kernel.get_value())
    out.bias.set_value(BF16_OUT_SCALE * (out.bias.get_value() - median))
    calls = []
    saved = jfused.pointnet_pooled_fused
    try:
        jfused.pointnet_pooled_fused = lambda *a: calls.append(1) or saved(*a)
        with k1_guard():
            _, want_m = jm(jnp.asarray(t), jnp.asarray(s))
            want_g = jm.maskNet.feature_model.pooled_features(jnp.asarray(s))
    finally:
        jfused.pointnet_pooled_fused = saved
    assert len(calls) == 2
    want_m, want_g = np.asarray(want_m, np.float32), np.asarray(want_g, np.float32)
    tm = port_masknet(nnx_flat(jm), emb=128, tdtype=torch.bfloat16).eval()
    pool = tm.maskNet.feature_model.pooled_features
    before = LAUNCHES["pointnet_pooled_kernel"]
    with torch.inference_mode():
        got_t, got_m = tm(torch.from_numpy(t), torch.from_numpy(s))
        got_g = pool(torch.from_numpy(s))
        with k1_half_cloud():
            control_m = tm(torch.from_numpy(t), torch.from_numpy(s))[1]
            control_g = pool(torch.from_numpy(s))
    assert LAUNCHES["pointnet_pooled_kernel"] == before
    assert got_m.dtype == torch.bfloat16 and got_t.dtype == torch.float32
    assert float(want_m.max() - want_m.min()) > 0.3  # the widened draw's spread
    assert rel(got_m.float(), want_m) <= BF16_TOL
    assert rel(got_g.float(), want_g) <= BF16_TOL
    assert rel(control_m.float(), want_m) > BF16_TOL
    assert rel(control_g.float(), want_g) > BF16_TOL


@pytest.mark.parametrize("levels", [1, 3, 17])
def test_top_indices_order_ties_as_lax_top_k(levels):
    """Scores on a few levels (1: every score equal), in f32 and bf16: the
    same indices in the same order as lax.top_k, the lower index first
    among equal scores."""
    rng = np.random.default_rng(levels)
    scores = (rng.integers(0, levels, (4, 256)) / max(levels - 1, 1)).astype(np.float32)
    for k in (1, 100, 256):
        want = np.asarray(jax.lax.top_k(jnp.asarray(scores), k)[1])
        np.testing.assert_array_equal(top_indices(torch.from_numpy(scores), k).numpy(), want)
        bf = torch.from_numpy(scores).to(torch.bfloat16)
        want = np.asarray(jax.lax.top_k(jnp.asarray(scores, jnp.bfloat16), k)[1])
        np.testing.assert_array_equal(top_indices(bf, k).numpy(), want)


def test_saturated_mask_picks_as_jax():
    """A MaskNet whose sigmoid saturates to exactly 1.0 on some points (as a
    trained one does in f32): the masked template's rows are JAX's, in
    JAX's order."""
    jm = jax_masknet(7)
    jm.eval()
    t, s, _, _ = masknet_batch(8)
    # the logits (random weights: within 0.03 of each other) spread 1000x
    # about their median, moved to 17: about half of them land past 16.7,
    # where the f32 sigmoid rounds to 1.0
    m = np.asarray(jm(jnp.asarray(t), jnp.asarray(s))[1], np.float64)
    median = float(np.median(np.log(m) - np.log1p(-m)))
    out = jm.maskNet.out
    out.kernel.set_value(1000.0 * out.kernel.get_value())
    out.bias.set_value(1000.0 * (out.bias.get_value() - median) + 17.0)
    want_t, want_m = jm(jnp.asarray(t), jnp.asarray(s))
    tm = port_masknet(nnx_flat(jm)).eval()
    with torch.no_grad():
        got_t, got_m = tm(torch.from_numpy(t), torch.from_numpy(s))
    ones = (np.asarray(want_m) == 1.0).sum(-1)
    assert (ones > 1).all() and (ones < NT).all() and torch.equal((got_m == 1.0).sum(-1), torch.from_numpy(ones))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_select_by_threshold_matches_jax():
    rng = np.random.default_rng(9)
    t = rng.normal(size=(2, 50, 3)).astype(np.float32)
    m = rng.random((2, 50)).astype(np.float32)
    for thr in (0.5, 0.9):
        got = select_by_threshold(torch.from_numpy(t), torch.from_numpy(m).to(torch.bfloat16), thr)
        want = jselect(t, np.asarray(torch.from_numpy(m).to(torch.bfloat16).float()), thr)
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray)
            np.testing.assert_array_equal(g, w)
        assert got[0].shape == (1, int(got[1].sum()), 3)


def test_mask_scores_match_jax():
    rng = np.random.default_rng(10)
    pred = rng.random((3, 40)).astype(np.float32)
    gt = (rng.random((3, 40)) > 0.4).astype(np.float32)
    for p, g in ((pred, gt), (np.zeros_like(pred), np.zeros_like(gt))):  # the empty case's clamps
        got = metrics.mask_scores(torch.from_numpy(p), torch.from_numpy(g))
        want = jmetrics.mask_scores(jnp.asarray(p), jnp.asarray(g))
        assert set(got) == set(want) == {"accuracy", "precision", "recall", "f1"}
        for key in got:
            assert abs(got[key].item() - float(want[key])) <= 1e-6, key


def grad_rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def jax_task():
    """The JAX masknet task with both losses, BatchNorms in train mode
    (emb 64: outside the fused tail's kernel gate): loss, scores and
    gradients, jitted."""
    jm = jax_masknet(11)
    jm.train()
    batch = masknet_batch(12)
    out = {"flat": nnx_flat(jm), "batch": batch}
    for loss_fn in ("bce", "mse"):
        @nnx.jit
        def task(m, bt):
            return nnx.value_and_grad(lambda m: jtasks.masknet(m, bt, None, loss_fn=loss_fn), has_aux=True)(m)

        (loss, aux), grads = task(nnx.clone(jm), tuple(map(jnp.asarray, batch)))
        out[loss_fn] = {"loss": float(loss), "aux": {k: float(v) for k, v in aux.items()},
                        "grads": nnx_to_torch({".".join(map(str, p)): np.asarray(v.get_value())
                                               for p, v in nnx.to_flat_state(grads)})}
    return out


# f32, no finite differences here: the loss to 1e-5, the scores exactly
# (the same binarized masks), each gradient to 1e-3 of its norm; the biases
# in front of a train-mode BatchNorm have a gradient that cancels to
# rounding, held to 1e-3 of their layer's weight gradient
TASK_TOL = {"loss": 1e-5, "grad": 1e-3}


def check_grads(grads, want):
    assert set(grads) == set(want)
    errs = {}
    for n, g in grads.items():
        ref = want[n]
        if n.startswith("maskNet.feature_model.convs.") and n.endswith("bias"):
            ref_norm = np.linalg.norm(want[n[: -len("bias")] + "weight"])
            errs[n] = float(np.linalg.norm(g - ref) / ref_norm)
        else:
            errs[n] = grad_rel(g, ref)
    assert max(errs.values()) <= TASK_TOL["grad"], errs


@pytest.mark.parametrize("loss_fn", ["bce", "mse"])
def test_masknet_task_matches_jax(jax_task, loss_fn):
    want = jax_task[loss_fn]
    model = port_masknet(jax_task["flat"]).train()
    loss, aux = tasks.masknet(model, tuple(map(torch.from_numpy, jax_task["batch"])), loss_fn=loss_fn)
    loss.backward()
    assert abs(loss.item() - want["loss"]) <= TASK_TOL["loss"] * abs(want["loss"])
    for key, val in aux.items():
        assert val.item() == pytest.approx(want["aux"][key], abs=1e-6), key
    check_grads({n: p.grad.numpy() for n, p in model.named_parameters()}, want["grads"])


def test_trainer_picks_the_configured_masknet_loss(jax_task, tmp_path):
    """The Trainer's masknet task takes TrainConfig.masknet_loss (default
    bce, as the JAX Trainer); one step's loss and gradients are the task's."""
    for loss_fn in ("bce", "mse"):
        model = port_masknet(jax_task["flat"])
        cfg = TrainConfig(batch_size=B, task="masknet", masknet_loss=loss_fn, ckpt_dir=str(tmp_path))
        tr = Trainer(cfg, model, device="cpu")
        assert tr.loss_fn.keywords == {"loss_fn": loss_fn}
        loss, aux = tr.forward_backward(tuple(map(torch.from_numpy, jax_task["batch"])))
        assert abs(float(loss) - jax_task[loss_fn]["loss"]) <= TASK_TOL["loss"] * abs(jax_task[loss_fn]["loss"])
        check_grads({n: p.grad.numpy() for n, p in model.named_parameters()}, jax_task[loss_fn]["grads"])
        tr.close()
    assert TrainConfig().masknet_loss == "bce"


def test_masknet_task_reads_masknet2_template_mask():
    """The task takes MaskNet2's tuple the other way round: its template
    mask first (MaskNet's is second); a stand-in whose second output is
    garbage shows which one is read."""
    class MaskNet2(torch.nn.Module):
        def forward(self, template, source):
            return torch.full(template.shape[:2], 0.25), torch.full(source.shape[:2], float("nan"))

    batch = tuple(map(torch.from_numpy, masknet_batch(13)))
    loss, aux = tasks.masknet(MaskNet2(), batch, loss_fn="mse")
    assert loss.item() == pytest.approx(torch.mean((0.25 - batch[3]) ** 2).item())
    assert np.isfinite(aux["accuracy"].item())


def test_masknet_f32_train_step_in_the_kernel_gate_matches_jax():
    """emb 128, f32 train mode: the source's pool is inside the fused tail's
    gate (K % 128 == E % 128 == 0). JAX, its TPU guard opened, runs K3 and
    K4 once each in Pallas interpret mode; the port runs their plain
    versions (no launch on the CPU). Loss, gradients and every running
    statistic (the template's per-point pass and the source's pool each
    update them) against JAX."""
    jm = jax_masknet(14, emb=128)
    jm.train()
    flat = nnx_flat(jm)
    batch = masknet_batch(15)
    calls = {"stats": 0, "bwd": 0}
    saved = jlayers._pool_stats_pallas, jlayers._pool_bwd_pallas

    def counted(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    jlayers._pool_stats_pallas, jlayers._pool_bwd_pallas = counted(saved[0], "stats"), counted(saved[1], "bwd")
    try:
        with tpu_guard():
            (loss_j, _), grads_j = nnx.value_and_grad(lambda m: jtasks.masknet(m, tuple(map(jnp.asarray, batch)),
                                                                              None, loss_fn="bce"), has_aux=True)(jm)
    finally:
        jlayers._pool_stats_pallas, jlayers._pool_bwd_pallas = saved
    assert calls == {"stats": 1, "bwd": 1}
    grads_j = nnx_to_torch({".".join(map(str, p)): np.asarray(v.get_value()) for p, v in nnx.to_flat_state(grads_j)})
    after_j = nnx_to_torch(nnx_flat(jm))
    model = port_masknet(flat, emb=128).train()
    before = {k: LAUNCHES[k] for k in ("pool_stats_pallas", "pool_bwd_pallas")}
    loss, _ = tasks.masknet(model, tuple(map(torch.from_numpy, batch)), loss_fn="bce")
    loss.backward()
    assert {k: LAUNCHES[k] for k in before} == before
    assert abs(loss.item() - float(loss_j)) <= TASK_TOL["loss"] * abs(float(loss_j))
    check_grads({n: p.grad.numpy() for n, p in model.named_parameters()}, grads_j)
    for name, buf in model.named_buffers():
        assert rel(buf, after_j[name]) <= 1e-5, name


def test_masknet_serves_a_tuple_with_a_ragged_tail():
    """InferenceEngine(batch_size=2) on 3 pairs returns the model's tuple
    (masked_template (3, NS, 3), mask (3, NT)), the tail pair's equal to the
    model's on that pair alone."""
    model = port_masknet(nnx_flat(jax_masknet(16))).eval()
    t, s, _, _ = masknet_batch(17, b=3)
    got = InferenceEngine(model, batch_size=2, device="cpu")(t, s)
    assert isinstance(got, tuple) and len(got) == 2
    assert got[0].shape == (3, NS, 3) and got[1].shape == (3, NT)
    with torch.inference_mode():
        tail = model(torch.from_numpy(t[2:]), torch.from_numpy(s[2:]))
    np.testing.assert_array_equal(got[0][2:], tail[0].numpy())
    np.testing.assert_allclose(got[1][2:], tail[1].numpy(), rtol=0, atol=1e-6)
