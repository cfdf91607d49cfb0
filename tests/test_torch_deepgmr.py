"""The port's DeepGMR against the JAX package's, on the CPU: the
rotation-invariant representation (``ops.geometry.get_rri``, its neighbour
order among exact distance ties, and ``get_rri_numpy`` inside
``RegistrationData("DeepGMR")``), the mixture statistics (``gmm_params``)
and the closed-form registration (``gmm_register``), ClusterNet with its
TNet, the whole model in eval and train mode with RRI computed in the
forward, given by the data, and off, and one ``deepgmr`` task step's loss
and gradients. Weights cross as numpy through ``load_nnx_state``; inputs are
made with numpy from seeds; the JAX side is jitted.

Random weights leave the backbone's softmax over the clusters nearly
uniform, so the mixtures' means crowd the centroid and the Kabsch solve is
ill-conditioned in f32 (in both packages it takes its input in f32, under
x64 too). Where that shows, the port's f64 is held to JAX's x64 and its f32
within twice JAX's own f32 gap to x64 plus a slack, as
``torch_port_util.hold_to_jax`` does.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from learning3d_tpu.data import dataloaders as jdata
from learning3d_tpu.models import deepgmr as jgmr
from learning3d_tpu.ops import geometry as jgeo
from learning3d_tpu.train import tasks as jtasks
from learning3d_tpu_torch.data import RegistrationData, SyntheticModelNet40
from learning3d_tpu_torch.models import DeepGMR
from learning3d_tpu_torch.models import deepgmr as tgmr
from learning3d_tpu_torch.ops import geometry as tgeo
from learning3d_tpu_torch.train import TrainConfig, Trainer, tasks
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from torch_port_util import jax_both, lattice_cloud, max_rel, nnx_flat, randomize_bn

B, N, K, D_MODEL, CLUSTERS = 4, 128, 8, 64, 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def centred(seed, b=B, n=N):
    x = np.random.default_rng(seed).normal(size=(b, n, 3)).astype(np.float32)
    return (x - x.mean(1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_rri():
    return jax.jit(jgeo.get_rri, static_argnums=1)


# RRI: the same neighbours (the CPU square_distance is JAX's, bit for bit at
# C = 3, and the stable sort lax.top_k's order), so |p| and |q| agree to
# rounding (NORM_TOL of max). theta and phi come from arccos and atan2,
# whose f32 results differ between the two libraries by an ulp or so: held
# to ANGLE_TOL radians (measured 4.0e-6 at N=128), except where the
# features jump: |cos theta| within 1e-6 of 1, where arccos turns a
# rounding of the cosine into ~sqrt(eps) of angle, and phi within 1e-4 of
# 0 or 2 pi, where the mod 2 pi wraps one side's angle to the other end.
# Such slots must stay under 1% (measured: none at these draws)
NORM_TOL, ANGLE_TOL, UNSTABLE_SHARE = 1e-6, 1e-5, 0.01


def unstable(feat, k):
    f = feat.reshape(*feat.shape[:2], k, 4)
    theta, phi = f[..., 2], f[..., 3]
    return (np.abs(np.cos(theta)) > 1 - 1e-6) | (phi < 1e-4) | (phi > 2 * np.pi - 1e-4)


def check_rri(got, want, k, share=UNSTABLE_SHARE):
    assert got.shape == want.shape
    g, w = (a.reshape(*a.shape[:2], k, 4) for a in (got, want))
    assert np.abs(g[..., :2] - w[..., :2]).max() <= NORM_TOL * np.abs(w[..., :2]).max()
    bad = unstable(got, k) | unstable(want, k)
    assert bad.mean() <= share, bad.mean()
    assert np.abs(g[..., 2:] - w[..., 2:])[~bad].max() <= ANGLE_TOL


def shuffled(feat, k):
    """The control: the neighbour slots in reverse order."""
    return feat.reshape(*feat.shape[:2], k, 4)[:, :, ::-1].reshape(feat.shape)


@pytest.mark.parametrize("k", [K, 20])
def test_get_rri_matches_jax(jax_rri, k):
    x = centred(k)
    want = np.asarray(jax_rri(jnp.asarray(x), k))
    got = tgeo.get_rri(t(x), k).numpy()
    assert got.shape == (B, N, 4 * k)
    check_rri(got, want, k)
    with pytest.raises(AssertionError):
        check_rri(shuffled(got, k), want, k)


def test_get_rri_tie_order_matches_jax(jax_rri):
    """A lattice cloud: many neighbours lie at exactly the same distance, so
    the k + 1 nearest depend on the order among ties (lax.top_k's: the lower
    index first). Tied neighbours differ in |q|, which shows the order. On
    a lattice many neighbours are collinear with the point (theta 0) or
    coplanar with another (phi 0): a third of the slots jump (measured
    0.331), and the angles are held on the rest."""
    x = lattice_cloud(2, 216, seed=3)
    want = np.asarray(jax_rri(jnp.asarray(x), K))
    got = tgeo.get_rri(t(x), K).numpy()
    check_rri(got, want, K, share=0.4)
    with pytest.raises(AssertionError):
        check_rri(shuffled(got, K), want, K, share=0.4)
    d = tgeo.square_distance(t(x), t(x))
    kth = torch.sort(d, -1).values[..., K + 1]
    assert (d == kth[..., None]).sum(-1).max() > 2  # ties at the cut


def test_registration_data_with_rri_matches_jax():
    """RegistrationData("DeepGMR", nearest_neighbors=k) appends each cloud's
    RRI (of the cloud centred) to its points, as the JAX package's does."""
    base = dict(num_points=96, size=4)
    params = {"nearest_neighbors": K}
    got = RegistrationData("DeepGMR", SyntheticModelNet40(**base), additional_params=params)
    want = jdata.RegistrationData("DeepGMR", jdata.SyntheticModelNet40(**base), additional_params=params)
    for i in (0, 3):
        a, b = got[i], want[i]
        assert len(a) == len(b) == 3 and a[0].shape == (96, 3 + 4 * K)
        np.testing.assert_array_equal(a[2], b[2])
        for x, y in zip(a[:2], b[:2]):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x[:, :3], y[:, :3])
            check_rri(x[None, :, 3:], y[None, :, 3:], K)


def mixture(seed, b=B, n=N, j=CLUSTERS, scale=1.0):
    """A soft assignment (softmax of random logits times ``scale``) and
    points, numpy f32."""
    rng = np.random.default_rng(seed)
    logits = scale * rng.normal(size=(b, n, j))
    gamma = np.exp(logits - logits.max(-1, keepdims=True))
    gamma = (gamma / gamma.sum(-1, keepdims=True)).astype(np.float32)
    return gamma, rng.normal(size=(b, n, 3)).astype(np.float32)


# gmm_params: the same sums in other orders, 1e-6 of max. gmm_register on
# well separated mixtures (logits scaled 4x): the Kabsch solve in f32 in both
# packages, 1e-5 of max (measured below 1e-6)
GMM_TOL, REGISTER_TOL = 1e-6, 1e-5


def test_gmm_params_matches_jax():
    gamma, pts = mixture(1)
    want = jgmr.gmm_params(jnp.asarray(gamma), jnp.asarray(pts))
    got = tgmr.gmm_params(t(gamma), t(pts))
    for g, w in zip(got, want):
        assert max_rel(g, np.asarray(w)) <= GMM_TOL


def register_inputs(seed):
    gamma_s, pts_s = mixture(seed, scale=4.0)
    gamma_t, _ = mixture(seed + 1, scale=4.0)
    rng = np.random.default_rng(seed + 2)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.sign(np.linalg.det(R))
    pts_t = (pts_s @ R.T + rng.normal(size=3)).astype(np.float32)
    return gamma_s, pts_s, gamma_t, pts_t


def check_register(fn, seed):
    gamma_s, pts_s, gamma_t, pts_t = register_inputs(seed)
    s_pi, s_mu, _ = jgmr.gmm_params(jnp.asarray(gamma_s), jnp.asarray(pts_s))
    _, t_mu, t_sigma = jgmr.gmm_params(jnp.asarray(gamma_t), jnp.asarray(pts_t))
    want = np.asarray(jgmr.gmm_register(s_pi, s_mu, t_mu, t_sigma))
    got = fn(*(t(np.asarray(a)) for a in (s_pi, s_mu, t_mu, t_sigma)))
    assert got.shape == (B, 4, 4)
    assert max_rel(got, want) <= REGISTER_TOL


def test_gmm_register_matches_jax():
    check_register(tgmr.gmm_register, 5)
    with pytest.raises(AssertionError):  # the control: the two mixtures' means swapped
        check_register(lambda pi, mu_s, mu_t, sigma: tgmr.gmm_register(pi, mu_t, mu_s, sigma), 5)


# The model: in eval mode the poses in f32 to EVAL_TOL of max (the Kabsch
# solve's conditioning with random weights: measured 2.4e-5-1.4e-4 at
# d_model 64; r, the RRI features' difference, jumps by 2 pi where phi
# wraps, and is held as below only); every
# output, in both modes, is also held in f64 to JAX's x64 (F64_TOL: both
# packages round the Kabsch input to f32 there, so the two agree to f32
# rounding of well-conditioned inputs) and the port's f32 to JAX's x64 within
# twice JAX's own f32 gap plus F32_SLACK
EVAL_TOL, F64_TOL, F32_SLACK = 1e-3, 1e-4, 1e-4
OUT_KEYS = ("est_R", "est_t", "est_R_inverse", "est_t_inverse", "est_T", "est_T_inverse", "r", "transformed_source")


@pytest.fixture(scope="module")
def jax_gmr():
    jm = jgmr.DeepGMR(use_rri=True, nearest_neighbors=K, d_model=D_MODEL, n_clusters=CLUSTERS, rngs=nnx.Rngs(0))
    randomize_bn(jm, np.random.default_rng(1))
    return jm


def port_model(flat, use_rri=True):
    return load_nnx_state(DeepGMR(use_rri=use_rri, nearest_neighbors=K, d_model=D_MODEL, n_clusters=CLUSTERS,
                                  device="cpu"), flat)


def hold_model(port, jm, mode, *args):
    """The port in ``mode`` against the JAX model on numpy ``args``: every
    output and running statistic after the call (see the tolerances above).
    -> the port's f32 outputs."""
    want32, want64, after, after64 = jax_both(jm, *args)
    with torch.no_grad():
        got64 = getattr(copy.deepcopy(port).double(), mode)()(*(t(a).double() for a in args))
        got = getattr(port, mode)()(*(t(a) for a in args))
    for key in OUT_KEYS:
        assert max_rel(got64[key], want64[key]) <= F64_TOL, key
        assert max_rel(got[key], want64[key]) <= 2 * max_rel(want32[key], want64[key]) + F32_SLACK, key
        if mode == "eval" and key != "r":
            assert max_rel(got[key], want32[key]) <= EVAL_TOL, key
    for name, b in port.named_buffers():
        assert max_rel(b, after[name]) <= F64_TOL, name
    return got


def pairs(n=N, b=B, rri=0, noise=False):
    """b RegistrationData("DeepGMR") pairs of n points over
    SyntheticModelNet40: (template, source, igt), numpy. A clean source is
    its template moved, so its RRI features (rotation invariant) and soft
    assignments are the template's and the closed form recovers igt
    whatever the weights: the step takes jittered sources (``noise``)."""
    extra = {"nearest_neighbors": rri} if rri else None
    data = jdata.RegistrationData("DeepGMR", jdata.SyntheticModelNet40(num_points=n, size=b, seed=7), noise=noise,
                                  additional_params=extra)
    items = [data[i] for i in range(b)]
    return tuple(np.stack([it[j] for it in items]) for j in range(3))


def test_load_nnx_state_carries_deepgmr(jax_gmr):
    flat = nnx_flat(jax_gmr)
    tm = port_model(flat)
    assert set(tm.state_dict()) == set(nnx_to_torch(flat))
    assert {k.split(".")[1] for k in flat} == {"encoder", "decoder", "head"}
    np.testing.assert_array_equal(tm.backbone.decoder[1].lin.weight.detach().numpy(),
                                  flat["backbone.decoder.1.lin.kernel"].T)
    with pytest.raises(ValueError):
        DeepGMR(input_shape="nbc", device="cpu")


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_deepgmr_with_rri_in_the_forward_matches_jax(jax_gmr, mode):
    """Clouds of 3 channels: both packages compute the RRI of each centred
    cloud inside the forward."""
    jm = nnx.clone(jax_gmr)
    getattr(jm, mode)()
    template, source, _ = pairs()
    got = hold_model(port_model(nnx_flat(jm)), jm, mode, template, source)
    assert got["est_T"].shape == (B, 4, 4) and got["r"].shape == (B, N, 4 * K)
    R = got["est_R"].double()
    assert (R @ R.transpose(1, 2) - torch.eye(3, dtype=R.dtype)).abs().max() < 1e-5


def test_deepgmr_with_rri_from_the_data_matches_jax(jax_gmr):
    """Clouds of 3 + 4k channels from RegistrationData(nearest_neighbors=k):
    the forward takes the features as they come."""
    jm = nnx.clone(jax_gmr)
    jm.eval()
    template, source, _ = pairs(rri=K)
    assert template.shape == (B, N, 3 + 4 * K)
    want = jax_both(jm, template, source, x64=False)[0]
    with torch.no_grad():
        got = port_model(nnx_flat(jm)).eval()(t(template), t(source))
    for key in OUT_KEYS:
        assert max_rel(got[key], want[key]) <= (EVAL_TOL if key != "r" else 1e-6), key


def test_deepgmr_without_rri_and_clusternet_with_tnet_match_jax():
    """use_rri=False (the backbone reads the centred coordinates) and
    ClusterNet's TNet (its Gram-Schmidt rotation), in eval mode, and the
    bcn layout."""
    jm = jgmr.DeepGMR(use_rri=False, d_model=D_MODEL, n_clusters=CLUSTERS, rngs=nnx.Rngs(2))
    randomize_bn(jm, np.random.default_rng(3))
    jm.eval()
    template, source, _ = pairs(b=B)
    want = jax_both(jm, template, source, x64=False)[0]
    with torch.no_grad():
        got = port_model(nnx_flat(jm), use_rri=False).eval()(t(template), t(source))
    for key in OUT_KEYS:
        assert max_rel(got[key], want[key]) <= EVAL_TOL, key
    bcn = port_model(nnx_flat(jm), use_rri=False).eval()
    bcn.input_shape = "bcn"
    with torch.no_grad():
        assert torch.equal(bcn(t(template).transpose(1, 2), t(source).transpose(1, 2))["est_T"], got["est_T"])
    jc = jgmr.ClusterNet(use_rri=False, use_tnet=True, d_model=D_MODEL, n_clusters=CLUSTERS, rngs=nnx.Rngs(4))
    randomize_bn(jc, np.random.default_rng(5))
    jc.eval()
    tc = load_nnx_state(tgmr.ClusterNet(use_rri=False, use_tnet=True, d_model=D_MODEL, n_clusters=CLUSTERS,
                                        device="cpu"), nnx_flat(jc)).eval()
    x = centred(6)
    with torch.no_grad():
        assert max_rel(tc(t(x)), np.asarray(nnx.jit(lambda m, a: m(a))(jc, jnp.asarray(x)))) <= 1e-5


def jax_grads(jm, batch, x64):
    with jax.enable_x64(x64):
        dt = np.float64 if x64 else np.float32
        step = nnx.jit(lambda m, a, b, g: nnx.value_and_grad(lambda m: jtasks.deepgmr(m, (a, b, g), None),
                                                             has_aux=True)(m))
        (loss, _), grads = step(nnx.clone(jm), *(jnp.asarray(a.astype(dt)) for a in batch))
        return float(loss), nnx_to_torch({".".join(map(str, p)): np.asarray(v.get_value(), np.float64)
                                          for p, v in nnx.to_flat_state(grads)})


@pytest.fixture(scope="module")
def jax_step(jax_gmr):
    jm = nnx.clone(jax_gmr)
    jm.train()
    batch = pairs(noise=True)
    loss, g32 = jax_grads(jm, batch, False)
    loss64, g64 = jax_grads(jm, batch, True)
    return {"flat": nnx_flat(jm), "batch": batch, "loss": loss, "loss64": loss64, "grads": g32, "grads64": g64}


def port_step(flat, batch, dtype):
    model = port_model(flat).train().to(dtype)
    loss, aux = tasks.deepgmr(model, tuple(t(a).to(dtype) for a in batch))
    loss.backward()
    return loss.item(), aux, {n: p.grad.double().numpy() for n, p in model.named_parameters()}


def whole_gap(grads, want):
    names = sorted(want)
    flat = lambda g: np.concatenate([g[n].ravel() for n in names])  # noqa: E731
    return float(np.linalg.norm(flat(grads) - flat(want)) / np.linalg.norm(flat(want)))


# One deepgmr step (MSE(est_T_inverse igt^-1, I) + MSE(est_T igt, I)) on
# RegistrationData("DeepGMR") pairs: the port's f64 loss to LOSS_TOL of
# JAX's x64 and each f64 gradient to GRAD_TOL of its norm (the Kabsch input
# rounded to f32 on both sides bounds the agreement: measured below 1e-5);
# the f32 gradients as one vector within twice JAX's own f32 gap to x64,
# plus STEP_SLACK
LOSS_TOL, GRAD_TOL, STEP_SLACK = 1e-5, 1e-4, 1e-3


def check_step(jax_step):
    loss64, _, g64 = port_step(jax_step["flat"], jax_step["batch"], torch.float64)
    assert abs(loss64 - jax_step["loss64"]) <= LOSS_TOL * abs(jax_step["loss64"])
    assert set(g64) == set(jax_step["grads64"])
    for n, g in g64.items():
        w = jax_step["grads64"][n]
        assert np.linalg.norm(g - w) <= GRAD_TOL * max(np.linalg.norm(w), 1e-30), n
    loss, aux, g32 = port_step(jax_step["flat"], jax_step["batch"], torch.float32)
    own = whole_gap(jax_step["grads"], jax_step["grads64"])
    assert whole_gap(g32, jax_step["grads64"]) <= 2 * own + STEP_SLACK
    jax_step["port_loss32"] = loss  # the Trainer test's reference
    return loss, aux


def test_deepgmr_step_matches_jax(jax_step):
    loss, aux = check_step(jax_step)
    assert np.isfinite(loss) and set(aux) >= {"rot_deg", "trans"}


def test_deepgmr_step_control_fails(jax_step, monkeypatch):
    """The step check sees the neighbour slots of the RRI in reverse order."""
    rri = tgmr.get_rri
    monkeypatch.setattr(tgmr, "get_rri", lambda pts, k: torch.flip(rri(pts, k).reshape(*pts.shape[:2], k, 4),
                                                                     [2]).reshape(*pts.shape[:2], 4 * k))
    with pytest.raises(AssertionError):
        check_step(jax_step)


def test_trainer_step_on_the_deepgmr_task(jax_step, tmp_path):
    """Trainer.train_step on the deepgmr task: the loss is the task's and
    every weight and running statistic changes."""
    model = port_model(jax_step["flat"])
    tr = Trainer(TrainConfig(batch_size=B, task="deepgmr", lr=1e-3, ckpt_dir=str(tmp_path)), model, device="cpu")
    tr._ensure_optimizer(1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, _ = tr.train_step(tuple(map(t, jax_step["batch"])))
    want = jax_step.get("port_loss32") or port_step(jax_step["flat"], jax_step["batch"], torch.float32)[0]
    assert float(loss) == pytest.approx(want, rel=1e-6)
    for k, v in model.state_dict().items():
        assert not torch.equal(v, before[k]), k
    tr.close()
