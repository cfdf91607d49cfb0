"""The port's MaskNet2 against the JAX package's, on the CPU: Mish, the
bias-free conv block, the point self-attention (``SelfAttn``), the
self-attention PointNet, the coupled global attention
(``SelfAttentionFC``), the whole model in eval and train mode, the
``masknet`` task on MaskNet2's tuple (template mask first) with both losses
and its gradients, a Trainer step, and serving through InferenceEngine with
a ragged tail. Weights cross as numpy through ``load_nnx_state``; inputs
are made with numpy from seeds; the JAX side is jitted.

Every attention gate beta starts at 0 in both packages, which leaves the
attention outputs unused: the JAX models here draw each beta from N(0, 0.5)
(``live_beta``), and the control of every agreement check is the port with
its betas at 0, which must fail it. Train-mode BatchNorms make f32
ill-conditioned (the coupled blocks normalise one vector a cloud, B rows),
so train mode is held as ``torch_port_util.hold_to_jax`` holds it: the
port's f64 to JAX's x64 and its f32 within twice JAX's own f32 gap.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from learning3d_tpu.data import dataloaders as jdata
from learning3d_tpu.models import masknet2 as jm2
from learning3d_tpu.train import tasks as jtasks
from learning3d_tpu_torch.models import MaskNet2
from learning3d_tpu_torch.models import masknet2 as tm2
from learning3d_tpu_torch.serve import InferenceEngine
from learning3d_tpu_torch.train import TrainConfig, Trainer, tasks
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from torch_port_util import hold_to_jax, max_rel, nnx_flat, randomize_bn

B, NT, NS = 4, 128, 96


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def live_beta(module, rng):
    """Every beta of a JAX module from N(0, 0.5): at 0 the attention is a
    dead branch that no agreement check could see."""
    for path, v in nnx.to_flat_state(nnx.state(module)):
        if path[-1] == "beta":
            v.set_value(jnp.asarray(rng.normal(0.0, 0.5, (1,)), jnp.float32))


def dead_beta(model):
    """The control: the port's betas at 0."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("beta"):
                p.zero_()
    return model


# eval mode: the same math in other sum orders, BLOCK_TOL of max (the
# attention's softmax over q q^T amplifies rounding: at AttnPointNet's last
# stage the port's f32 lay 1.1e-5 from JAX's, JAX's own f32 2.2e-5 from its
# x64); train mode: f64 to F64_TOL, f32 within twice JAX's own f32 gap plus
# TRAIN_F32_TOL (at B=2 the coupled blocks' two-row statistics put JAX's own
# f32 3.5e-3 from its x64, at B=4 6.7e-6-9.7e-6)
BLOCK_TOL, F64_TOL, TRAIN_F32_TOL = 5e-5, 1e-6, 1e-4


def hold(port, module, mode, *args):
    return hold_to_jax(port, module, mode, *args, tol=BLOCK_TOL, f64_tol=F64_TOL, train_f32_tol=TRAIN_F32_TOL)


def test_mish_matches_jax():
    """Mish with softplus as logaddexp(x, 0), past torch's softplus
    threshold (20) and far below 0, to 1e-6 relative (the two libraries'
    tanh and log1p differ by an ulp or two: measured 2.8e-7); from about
    -87 down softplus is subnormal, which XLA's CPU backend flushes to 0 and
    torch keeps (|mish| < 1e-30 there)."""
    x = np.concatenate([np.linspace(-120.0, 120.0, 4001), np.random.default_rng(0).normal(0, 3, 1000)])
    x = x.astype(np.float32)
    want = np.asarray(jm2.mish(jnp.asarray(x)))
    got = tm2.mish(t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)
    other = (t(x) * torch.tanh(torch.nn.functional.softplus(t(x), threshold=1.0))).numpy()
    assert np.abs(other - want).max() > 1e-3  # a softplus that cuts over early is seen


def cloud(seed, b=B, n=NT, c=3):
    return np.random.default_rng(seed).normal(size=(b, n, c)).astype(np.float32)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("block", ["conv", "self_attn", "attn_pointnet"])
def test_blocks_match_jax(block, mode):
    rngs = nnx.Rngs(11)
    jb, tb, x = {
        "conv": (jm2.BasicConv1D(16, 24, rngs=rngs), tm2.BasicConv1D(16, 24, device="cpu"), cloud(1, c=16)),
        "self_attn": (jm2.SelfAttn(16, 24, rngs=rngs), tm2.SelfAttn(16, 24, device="cpu"), cloud(2, c=16)),
        "attn_pointnet": (jm2.AttnPointNet(rngs=rngs), tm2.AttnPointNet(device="cpu"), cloud(3)),
    }[block]
    randomize_bn(jb, np.random.default_rng(12))
    live_beta(jb, np.random.default_rng(13))
    getattr(jb, mode)()
    tb = load_nnx_state(tb, nnx_flat(jb))
    got = hold(tb, jb, mode, x)[0]
    if block != "conv":
        with pytest.raises(AssertionError):
            hold(dead_beta(tb), jb, mode, x)
    if block == "attn_pointnet":
        assert got.shape == (B, NT, 512)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_self_attention_fc_matches_jax(mode):
    """The coupled global attention on two (B, 1024) vectors: in train mode
    its BatchNorm's statistics are the batch's rows (one a cloud)."""
    jb = jm2.SelfAttentionFC(1024, 512, rngs=nnx.Rngs(14))
    randomize_bn(jb, np.random.default_rng(15))
    live_beta(jb, np.random.default_rng(16))
    getattr(jb, mode)()
    tb = load_nnx_state(tm2.SelfAttentionFC(1024, 512, device="cpu"), nnx_flat(jb))
    x, y = (np.random.default_rng(s).normal(size=(B, 1024)).astype(np.float32) for s in (17, 18))
    got = hold(tb, jb, mode, x, y)[0]
    assert [g.shape for g in got] == [(B, 512), (B, 512)]
    with pytest.raises(AssertionError):
        hold(dead_beta(tb), jb, mode, x, y)


@pytest.fixture(scope="module")
def jax_mask2():
    jm = jm2.MaskNet2(rngs=nnx.Rngs(20))
    randomize_bn(jm, np.random.default_rng(21))
    live_beta(jm, np.random.default_rng(22))
    return jm


def port_model(flat):
    return load_nnx_state(MaskNet2(device="cpu"), flat)


def masknet_batch(seed, b=B, nt=NT, ns=NS):
    """(template, partial source, igt, gt_mask), as the masknet task draws
    them: RegistrationData("DCP", partial_source=True, use_masknet=True)
    over SyntheticModelNet40 (examples/train.py's masknet data), the source
    cut to its ns points nearest a far pivot."""
    data = jdata.RegistrationData("DCP", jdata.SyntheticModelNet40(num_points=nt, size=b, seed=seed),
                                  partial_source=True, additional_params={"use_masknet": True})
    rng = np.random.default_rng(seed)
    items = []
    for i in range(b):
        template, source, igt = data[i][:3]
        source, gt_mask = jdata.farthest_subsample_points(source, ns, rng=rng)
        items.append((template, source.astype(np.float32), igt, gt_mask.astype(np.float32)))
    return tuple(np.stack([it[j] for it in items]) for j in range(4))


def test_load_nnx_state_carries_masknet2(jax_mask2):
    flat = nnx_flat(jax_mask2)
    tm = port_model(flat)
    assert set(tm.state_dict()) == set(nnx_to_torch(flat))
    assert sum(k.endswith("beta") for k in flat) == 8
    np.testing.assert_array_equal(tm.maskNet.global_feat_2.query_conv.conv.weight.detach().numpy(),
                                  flat["maskNet.global_feat_2.query_conv.conv.kernel"].T)
    assert tm.maskNet.feature_model.conv5.beta.item() == flat["maskNet.feature_model.conv5.beta"][0] != 0.0
    with pytest.raises(ValueError):
        MaskNet2(input_shape="nbc", device="cpu")


def test_masknet2_takes_no_unused_arguments():
    """JAX's is_training and mask_threshold are read nowhere there; the port
    refuses them rather than ignore them."""
    tm = MaskNet2(device="cpu").eval()
    template, source = (torch.zeros(1, n, 3) for n in (NT, NS))
    with pytest.raises(TypeError):
        MaskNet2(is_training=True, device="cpu")
    with pytest.raises(TypeError):
        tm(template, source, mask_threshold=0.5)
    with pytest.raises(TypeError):
        tm(template, source, 0.5)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_masknet2_matches_jax(jax_mask2, mode):
    """Both masks, template first, in [0, 1]; the control (betas at 0)
    fails."""
    jm = nnx.clone(jax_mask2)
    getattr(jm, mode)()
    flat = nnx_flat(jm)
    template, source = masknet_batch(23)[:2]
    got = hold(port_model(flat), jm, mode, template, source)[0]
    assert got[0].shape == (B, NT) and got[1].shape == (B, NS)
    assert all(bool(((g >= 0) & (g <= 1)).all()) for g in got)
    with pytest.raises(AssertionError):
        hold(dead_beta(port_model(flat)), jm, mode, template, source)
    if mode == "eval":
        bcn = port_model(flat).eval()
        bcn.input_shape = "bcn"
        with torch.no_grad():
            for a, b in zip(bcn(t(template).transpose(1, 2), t(source).transpose(1, 2)), got):
                assert torch.equal(a, b)


def test_engine_serves_masknet2_with_a_ragged_tail(jax_mask2):
    """Eval mode through InferenceEngine at batch 3 on 4 pairs (a chunk of
    one, zero-padded): each pair's masks are its own, as one forward of the
    4 gives them (the eval BatchNorms use running statistics)."""
    template, source = masknet_batch(24)[:2]
    model = port_model(nnx_flat(jax_mask2)).eval()
    tmask, smask = InferenceEngine(model, batch_size=3, device="cpu")(template, source)
    with torch.no_grad():
        want = model(t(template), t(source))
    assert tmask.shape == (B, NT) and smask.shape == (B, NS)
    for got, w in zip((tmask, smask), want):
        np.testing.assert_allclose(got, w.numpy(), rtol=0, atol=1e-6)


def jax_grads(jm, batch, loss_fn, x64):
    with jax.enable_x64(x64):
        batch = tuple(jnp.asarray(a.astype(np.float64) if x64 else a) for a in batch)
        step = nnx.jit(lambda m, b: nnx.value_and_grad(lambda m: jtasks.masknet(m, b, None, loss_fn=loss_fn),
                                                       has_aux=True)(m))
        (loss, _), grads = step(nnx.clone(jm), batch)
        return float(loss), nnx_to_torch({".".join(map(str, p)): np.asarray(v.get_value(), np.float64)
                                          for p, v in nnx.to_flat_state(grads)})


@pytest.fixture(scope="module")
def jax_task(jax_mask2):
    jm = nnx.clone(jax_mask2)
    jm.train()
    batch = masknet_batch(25)
    out = {"flat": nnx_flat(jm), "batch": batch}
    for loss_fn in ("bce", "mse"):
        out[loss_fn] = {"f32": jax_grads(jm, batch, loss_fn, False), "f64": jax_grads(jm, batch, loss_fn, True)}
    return out


def port_grads(model, batch, loss_fn, dtype):
    model = model.train().to(dtype)
    loss, aux = tasks.masknet(model, tuple(t(a).to(dtype) for a in batch), loss_fn=loss_fn)
    loss.backward()
    return loss.item(), aux, {n: p.grad.double().numpy() for n, p in model.named_parameters()}


def whole_gap(grads, want):
    names = sorted(want)
    flat = lambda g: np.concatenate([g[n].ravel() for n in names])  # noqa: E731
    return float(np.linalg.norm(flat(grads) - flat(want)) / np.linalg.norm(flat(want)))


# The masknet task on MaskNet2 (the template mask against gt_mask): the
# port's f64 loss to LOSS_TOL of JAX's x64 and each f64 gradient to
# GRAD_TOL of its norm; the f32 gradients as one vector within twice JAX's
# own f32 gap to x64, plus STEP_SLACK. The convs' outputs go through
# train-mode BatchNorms, so no gradient cancels here (no conv has a bias)
LOSS_TOL, GRAD_TOL, STEP_SLACK = 1e-9, 1e-6, 1e-3


def check_task(jax_task, loss_fn, control=False):
    want_loss, want = jax_task[loss_fn]["f64"]
    model = port_model(jax_task["flat"])
    if control:
        dead_beta(model)
    loss64, _, g64 = port_grads(copy.deepcopy(model), jax_task["batch"], loss_fn, torch.float64)
    assert abs(loss64 - want_loss) <= LOSS_TOL * abs(want_loss)
    assert set(g64) == set(want)
    for n, g in g64.items():
        assert np.linalg.norm(g - want[n]) <= GRAD_TOL * max(np.linalg.norm(want[n]), 1e-30), n
    loss, aux, g32 = port_grads(model, jax_task["batch"], loss_fn, torch.float32)
    own = whole_gap(jax_task[loss_fn]["f32"][1], want)
    assert whole_gap(g32, want) <= 2 * own + STEP_SLACK
    return loss, aux


@pytest.mark.parametrize("loss_fn", ["bce", "mse"])
def test_masknet_task_on_masknet2_matches_jax(jax_task, loss_fn):
    loss, aux = check_task(jax_task, loss_fn)
    assert np.isfinite(loss) and set(aux) >= {"accuracy", "precision", "recall", "f1"}
    with pytest.raises(AssertionError):
        check_task(jax_task, loss_fn, control=True)


def test_trainer_step_with_masknet2(jax_task, tmp_path):
    """Trainer.train_step on the masknet task (bce, TrainConfig's default)
    with MaskNet2: the loss is the task's, every weight (the betas too) and
    running statistic changes."""
    model = port_model(jax_task["flat"])
    tr = Trainer(TrainConfig(batch_size=B, task="masknet", lr=1e-3, ckpt_dir=str(tmp_path)), model, device="cpu")
    tr._ensure_optimizer(1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, _ = tr.train_step(tuple(map(t, jax_task["batch"])))
    want = port_grads(port_model(jax_task["flat"]), jax_task["batch"], "bce", torch.float32)[0]
    assert float(loss) == pytest.approx(want, rel=1e-6)
    for k, v in model.state_dict().items():
        assert not torch.equal(v, before[k]), k
    tr.close()
