"""The port's RPMNet slice against the JAX package, on the CPU: the robust
angle, PPFNet's grouping (``ops.grouping``), the flax-compatible GroupNorm,
PPFNet, the parameter network, the whole ``RPMNet`` (every output, both
iterations), its losses, ``tasks.rpmnet`` with its gradients, one Trainer
step, and serving through the engine. Weights cross by ``load_nnx_state``
(GroupNorm scales and biases drawn away from 1 and 0).

Sizes: B=2, N=128 clouds with normals from ``RegistrationData("RPMNet")``
over ``SyntheticModelNet40(use_normals=True)``, PPFNet(emb 32) with the
default radius 0.3 and 64 neighbours (most slots padded with the center at
this N: the offset d = 0 exactly, the degenerate band of ``angle``). On a
CPU tensor both packages group on their CPU path (the ball query by the
matmul expansion) and normalise on the Sinkhorn's XLA oracle and its twin;
K16 and K17 are held to their plain versions by
``tests/test_torch_sampling.py``, ``tests/test_torch_sinkhorn.py`` and on
the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from learning3d_tpu.losses import losses as jlosses
from learning3d_tpu.models import ppfnet as jppf
from learning3d_tpu.models import rpmnet as jrpm
from learning3d_tpu.ops import geometry as jgeo
from learning3d_tpu.ops import grouping as jgrouping
from learning3d_tpu.train import tasks as jtasks
from learning3d_tpu_torch.data import RegistrationData, SyntheticModelNet40
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import sampling as tsampling
from learning3d_tpu_torch.losses import losses as tlosses
from learning3d_tpu_torch.models import PPFNet, RPMNet
from learning3d_tpu_torch.models import rpmnet as trpm
from learning3d_tpu_torch.ops import geometry as tgeo
from learning3d_tpu_torch.ops import grouping as tgrouping
from learning3d_tpu_torch.serve import InferenceEngine
from learning3d_tpu_torch.train import TrainConfig, Trainer, tasks
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from learning3d_tpu_torch.utils.layers import GroupNorm
from torch_port_util import nnx_flat

B, N, EMB = 2, 128, 32
LR = 1e-3  # examples/train.py's Adam default
# f32 on both sides; GroupNorm's fast-variance statistics over up to 64 N
# values and the feature matmul sum in other orders: PPFNet's unit features
# to 1e-5 absolute (measured 8.5e-6), the parameter network's beta and
# alpha to 1e-5 of max (measured 7e-7)
FEAT_TOL = 1e-5
# RPMNet's outputs, each to 5e-4 of its largest value (measured 5e-6 to
# 7.3e-5): the Kabsch solve is an f32 Jacobi sweep on both sides (1e-5 of
# est_R) and the second iteration starts from the first's transform; r is
# the difference of two sets of unit features, held to 5e-4 absolute
FWD_TOL = 5e-4
# Gradients of tasks.rpmnet. With random weights the f32 gradient is
# ill-conditioned: on this draw one pre-ReLU value of PPFNet's last GroupNorm
# lies at 7e-6 in f64 and -4e-6 in the port's f32, and that one ReLU flip
# moves PPFNet's gradients 0.2-0.55% (JAX's own f32 gradient happens to stay
# on the f64 side). So the port's f64 gradient is held to JAX's jitted
# gradient on f64 inputs, each tensor's error over its norm, to GRAD_TOL
# (measured 2.9e-6 on the default GroupNorms: both sides solve Kabsch in
# f32, as the JAX package casts the covariance), and the port's f32 gradient
# to its own f64 one within F32_GRAD_TOL, ten times the flip's 5.5e-3: a
# missing or wrong term is off by the order of the gradient itself
GRAD_TOL, F32_GRAD_TOL = 1e-4, 5e-2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def randomize_gn(module, rng):
    """GroupNorm scales in +-[0.5, 1.5] and biases around 0, so that the
    mapping of both shows."""
    for path, v in nnx.to_flat_state(nnx.state(module)):
        if "gn" in path and path[-1] in ("scale", "bias"):
            shape = v.get_value().shape
            if path[-1] == "scale":
                val = rng.choice([-1.0, 1.0], shape, p=[0.2, 0.8]) * rng.uniform(0.5, 1.5, shape)
            else:
                val = rng.normal(0.0, 0.2, shape)
            v.set_value(jnp.asarray(val, jnp.float32))


def registration_batch(b=B, n=N, seed=0):
    ds = RegistrationData("RPMNet", SyntheticModelNet40(num_points=n, size=b + 2, use_normals=True, seed=seed))
    return tuple(np.stack(f) for f in zip(*(ds[i] for i in range(b))))


# -- ops ------------------------------------------------------------------------

def angle_pairs():
    """(v1, v2) of 3-vectors: random, parallel and anti-parallel, angles
    below 1e-6, zero and tiny vectors (the degenerate band)."""
    rng = np.random.default_rng(0)
    v1 = rng.normal(size=(40, 3))
    v2 = rng.normal(size=(40, 3))
    v2[0:4] = v1[0:4] * 2.5
    v2[4:8] = -v1[4:8]
    v2[8:12] = v1[8:12] + 1e-8 * rng.normal(size=(4, 3))
    v2[12:16] = 0.0
    v1[16:20] = 0.0
    v2[20:24] = 1e-7 * rng.normal(size=(4, 3))
    v1[24:28] = 3e-7 * rng.normal(size=(4, 3))
    return v1.astype(np.float32), v2.astype(np.float32)


def test_angle_matches_jax_with_its_degenerate_band():
    """Values to 1e-6 (atan2 of the same arguments, the cross product in
    another rounding) and the gradient to 1e-5 of its largest entry, finite
    (zero) at the zero vectors."""
    v1, v2 = angle_pairs()
    a, b = torch.from_numpy(v1).requires_grad_(True), torch.from_numpy(v2).requires_grad_(True)
    got = tgeo.angle(a, b)
    want = np.asarray(jgeo.angle(jnp.asarray(v1), jnp.asarray(v2)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    assert (got.detach().numpy()[12:20] == 0).all()
    got.sum().backward()
    jg = jax.grad(lambda x, y: jnp.sum(jgeo.angle(x, y)), (0, 1))(jnp.asarray(v1), jnp.asarray(v2))
    for g, w in zip((a.grad, b.grad), jg):
        w = np.asarray(w)
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    assert (a.grad.numpy()[12:20] == 0).all()


def test_angle_broadcasts_a_center_against_its_neighbours():
    rng = np.random.default_rng(1)
    nr = rng.normal(size=(2, 5, 1, 3)).astype(np.float32)
    d = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    got = tgeo.angle(torch.from_numpy(nr), torch.from_numpy(d))
    assert got.shape == (2, 5, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgeo.angle(jnp.asarray(nr), jnp.asarray(d))), atol=1e-6)


def radius_lattice(side=5, h=0.1, offset=0.37, seed=0):
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    x = (h * g + offset).astype(np.float32)
    return x[np.random.default_rng(seed).permutation(len(x))][None]


@pytest.mark.parametrize("case", ["cloud", "lattice_on_the_radius", "nsample_past_n"])
def test_query_ball_point_excluding_self_matches_jax(case):
    """The CPU path's indices equal JAX's (the same expansion, bit for bit
    at C = 3), the center left out and padded, on the radius too."""
    if case == "cloud":
        x = registration_batch()[0][..., :3]
        radius, nsample, q, itself = 0.3, 64, x, np.broadcast_to(np.arange(N), (B, N))
    elif case == "lattice_on_the_radius":
        x = radius_lattice()
        radius, nsample, q, itself = 0.1, 16, x, np.arange(125)[None]
    else:
        x = registration_batch()[0][:, :40, :3]
        radius, nsample, q, itself = 0.5, 48, x[:, :10], np.broadcast_to(np.arange(10) * 3, (B, 10))
    itself = np.ascontiguousarray(itself, np.int32)
    got = tgrouping.query_ball_point_excluding_self(radius, nsample, *map(torch.from_numpy, (x, q, itself)))
    assert got.dtype == torch.int64 and got.shape == q.shape[:2] + (nsample,)
    assert bool((got != torch.from_numpy(itself).long()[..., None]).any(-1).any())
    if nsample <= x.shape[1]:
        want = jgrouping.query_ball_point_excluding_self(radius, nsample, *map(jnp.asarray, (x, q, itself)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:  # past N the JAX top_k refuses; the port pads with the center
        assert bool((got[..., x.shape[1]:] == torch.from_numpy(itself).long()[..., None]).all())


def test_ball_group_and_cpu_path_differ_on_the_radius():
    """On a lattice whose neighbours lie on the radius, K16's plain version
    (exact differences, as the TPU kernel) and the CPU path (the
    expansion, as JAX's CPU path) keep different neighbours: each is held to
    its own JAX twin (here and in tests/test_torch_sampling.py)."""
    x = radius_lattice()
    itself = np.arange(125, dtype=np.int32)[None]
    xt, it = torch.from_numpy(x), torch.from_numpy(itself)
    cpu = tgeo.index_points(xt, tgrouping.query_ball_point_excluding_self(0.1, 16, xt, xt, it))
    kernel = tsampling.ball_group_reference(0.1, 16, xt, xt, it, xt)
    assert not torch.equal(cpu, kernel)


@pytest.mark.parametrize("npoint", [-1, 40])
def test_sample_and_group_multi_matches_jax(npoint):
    """xyz and dxyz bit-equal, ppf to 1e-6 (the angles' atan2; |d| exact at
    the padded slots, where d = 0 and every angle with d is 0). npoint 40
    samples the centers by FPS from point 0 on both sides."""
    t, _, _ = registration_batch()
    xyz, nrm = t[..., :3], t[..., 3:]
    got = tgrouping.sample_and_group_multi(npoint, 0.3, 64, torch.from_numpy(xyz), torch.from_numpy(nrm))
    want = jgrouping.sample_and_group_multi(npoint, 0.3, 64, jnp.asarray(xyz), jnp.asarray(nrm))
    assert set(got) == {"xyz", "dxyz", "ppf"}
    for key in ("xyz", "dxyz"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_allclose(got["ppf"].numpy(), np.asarray(want["ppf"]), rtol=0, atol=1e-6)
    padded = got["ppf"][..., 3] == 0
    assert 0 < int(padded.sum()) < padded.numel()
    assert bool((got["ppf"][..., :2][padded] == 0).all())


# -- layers and models ------------------------------------------------------------

@pytest.mark.parametrize("shape,groups", [((2, 40, 16, 24), 8), ((2, 70, 64), 8), ((3, 48), 16)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_group_norm_matches_nnx(shape, groups, dtype):
    """All three input ranks RPMNet gives it ((B, N, ns, C) in PPFNet's
    prepool, (B, N, C) after the pool, (B, C) in the parameter network's
    head), with a mean far from 0 (where the fast variance loses digits),
    through load_nnx_state (scale -> weight): 1e-4 of max in f32 (E[x^2] -
    E[x]^2 at a mean of 3 cancels a digit, and the sums go in other orders:
    measured 2.4e-5), 1e-12 in f64."""
    rng = np.random.default_rng(len(shape))
    C = shape[-1]
    x = (3.0 + rng.normal(size=shape)).astype(dtype)
    tol = 1e-12 if dtype == np.float64 else 1e-4
    with jax.enable_x64(dtype == np.float64):
        jm = nnx.GroupNorm(C, num_groups=groups, rngs=nnx.Rngs(0))
        randomize_gn(nnx.Dict(gn=jm), rng)
        tm = load_nnx_state(GroupNorm(C, groups, device="cpu"), nnx_flat(jm))
        want = np.asarray(jm(jnp.asarray(x)))
    tm = tm.to(torch.float64 if dtype == np.float64 else torch.float32)
    got = tm(torch.from_numpy(x))
    assert got.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    assert rel(got, want) <= tol


@pytest.fixture(scope="module")
def jax_rpmnet():
    """JAX RPMNet(PPFNet(emb 32)) with random GroupNorm affines, its flat
    state, a batch, the jitted forward's outputs, the jitted task's loss and
    metrics, and its gradients on f64 inputs."""
    jm = jrpm.RPMNet(feature_model=jppf.PPFNet(emb_dims=EMB, rngs=nnx.Rngs(1)), rngs=nnx.Rngs(0))
    randomize_gn(jm, np.random.default_rng(2))
    batch = registration_batch()
    jb = tuple(map(jnp.asarray, batch))

    @nnx.jit
    def forward(m, t, s):
        return m(t, s)

    @nnx.jit
    def task(m, b):
        return nnx.value_and_grad(lambda m: jtasks.rpmnet(m, b, None), has_aux=True)(m)

    out = jax.tree.map(np.asarray, forward(nnx.clone(jm), jb[0], jb[1]))
    (loss, aux), _ = task(nnx.clone(jm), jb)
    with jax.enable_x64(True):
        _, grads = task(nnx.clone(jm), tuple(jnp.asarray(a.astype(np.float64)) for a in batch))
        grads = nnx_to_torch({".".join(map(str, p)): np.asarray(v.get_value(), np.float64)
                              for p, v in nnx.to_flat_state(grads)})
    return {"model": jm, "flat": nnx_flat(jm), "batch": batch, "out": out, "loss": float(loss),
            "aux": {k: np.asarray(v) for k, v in aux.items()}, "grads": grads}


def port_rpmnet(flat):
    return load_nnx_state(RPMNet(feature_model=PPFNet(emb_dims=EMB, device="cpu"), device="cpu"), flat)


def test_load_nnx_state_carries_rpmnet(jax_rpmnet):
    """Every weight of a JAX RPMNet maps onto the port's: Linear kernels
    transposed, GroupNorm scale -> weight, bias -> bias; nothing is left on
    either side, and a missing, unexpected or misshapen entry raises."""
    flat = jax_rpmnet["flat"]
    tm = port_rpmnet(flat)
    mapped = nnx_to_torch(flat)
    state = tm.state_dict()
    assert set(state) == set(mapped)
    for key, val in state.items():
        np.testing.assert_array_equal(val.numpy(), mapped[key], err_msg=key)
    assert "feat_extractor.prepool.2.gn.weight" in state and "weights_net.post2.gn.bias" in state
    assert not any("running" in k for k in state)
    gn = "feat_extractor.postpool.1.gn.scale"
    for broken, err in (({k: v for k, v in flat.items() if k != gn}, KeyError), ({**flat, "extra.gn.scale":
                        np.ones(3, np.float32)}, KeyError), ({**flat, gn: np.ones(7, np.float32)}, ValueError)):
        with pytest.raises(err):
            port_rpmnet(broken)


def test_ppfnet_and_parameter_net_match_jax(jax_rpmnet):
    """PPFNet's unit features and the parameter network's (beta, alpha) on
    one batch, to FEAT_TOL; no kernel launch on a CPU tensor."""
    jm, flat = jax_rpmnet["model"], jax_rpmnet["flat"]
    tm = port_rpmnet(flat)
    t, s, _ = jax_rpmnet["batch"]
    before = dict(LAUNCHES)
    with torch.no_grad():
        feats = tm.feat_extractor(torch.from_numpy(t[..., :3]), torch.from_numpy(t[..., 3:]))
        beta, alpha = tm.weights_net(torch.from_numpy(s[..., :3]), torch.from_numpy(t[..., :3]))
    assert LAUNCHES == before
    want = np.asarray(jm.feat_extractor(jnp.asarray(t[..., :3]), jnp.asarray(t[..., 3:])))
    assert feats.shape == (B, N, EMB)
    assert np.abs(feats.numpy() - want).max() <= FEAT_TOL
    np.testing.assert_allclose(torch.linalg.vector_norm(feats, dim=-1).numpy(), 1.0, atol=1e-6)
    jb, ja = jm.weights_net(jnp.asarray(s[..., :3]), jnp.asarray(t[..., :3]))
    assert rel(beta, jb) <= FEAT_TOL and rel(alpha, ja) <= FEAT_TOL


def test_rpmnet_forward_matches_jax(jax_rpmnet):
    """Every output of the two-iteration forward, each iteration of the
    lists, against the JAX model's, to FWD_TOL (r absolute: unit
    features)."""
    tm = port_rpmnet(jax_rpmnet["flat"])
    t, s, _ = jax_rpmnet["batch"]
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(s))
    want = jax_rpmnet["out"]
    assert set(got) == set(want)
    for key, val in got.items():
        if isinstance(val, list):
            assert len(val) == len(want[key]) == 2, key
            pairs = list(zip(val, want[key]))
        else:
            pairs = [(val, want[key])]
        for g, w in pairs:
            assert tuple(g.shape) == w.shape, key
            err = np.abs(g.double().numpy() - w).max() if key == "r" else rel(g, w)
            assert err <= FWD_TOL, (key, err)
    R = got["est_R"].double()
    np.testing.assert_allclose((R @ R.transpose(1, 2)).numpy(), np.broadcast_to(np.eye(3), (B, 3, 3)), atol=1e-5)


def test_rpmnet_losses_match_jax():
    rng = np.random.default_rng(3)
    pred, igt = rng.normal(size=(3, 4, 4)).astype(np.float32), rng.normal(size=(3, 4, 4)).astype(np.float32)
    r = rng.normal(size=(3, 20, 8)).astype(np.float32)
    got = tlosses.frobenius_norm_loss(torch.from_numpy(pred), torch.from_numpy(igt))
    assert abs(float(got) - float(jlosses.frobenius_norm_loss(jnp.asarray(pred), jnp.asarray(igt)))) <= 1e-5 * float(got)
    got = tlosses.rmse_features_loss(torch.from_numpy(r))
    assert abs(float(got) - float(jlosses.rmse_features_loss(jnp.asarray(r)))) <= 1e-6 * float(got)


def task_grads(flat, batch, dtype=torch.float32):
    model = port_rpmnet(flat).to(dtype)
    loss, aux = tasks.rpmnet(model, tuple(torch.from_numpy(a).to(dtype) for a in batch))
    loss.backward()
    return model, loss.detach(), aux, {n: p.grad.double().numpy() for n, p in model.named_parameters()}


def test_rpmnet_task_matches_jax(jax_rpmnet):
    """tasks.rpmnet: the loss and the registration metrics against JAX's in
    f32; the f64 gradients against JAX's (GRAD_TOL of each norm), the f32
    ones against the port's own f64 ones (F32_GRAD_TOL)."""
    assert tasks.TASKS["rpmnet"] is tasks.rpmnet
    _, loss, aux, g32 = task_grads(jax_rpmnet["flat"], jax_rpmnet["batch"])
    assert abs(float(loss) - jax_rpmnet["loss"]) <= FWD_TOL * abs(jax_rpmnet["loss"])
    assert set(aux) == set(jax_rpmnet["aux"]) == {"rot_deg", "trans"}
    for key, val in aux.items():
        np.testing.assert_allclose(val.detach().numpy(), jax_rpmnet["aux"][key], rtol=1e-3, atol=1e-3)
    _, _, _, g64 = task_grads(jax_rpmnet["flat"], jax_rpmnet["batch"], torch.float64)
    want = jax_rpmnet["grads"]
    assert set(g64) == set(want)
    for got, ref, tol in ((g64, want, GRAD_TOL), (g32, g64, F32_GRAD_TOL)):
        gaps = {n: np.linalg.norm(g - ref[n]) / np.linalg.norm(ref[n]) for n, g in got.items()}
        assert max(gaps.values()) <= tol, max(gaps.items(), key=lambda kv: kv[1])


def test_trainer_step(jax_rpmnet, tmp_path):
    """One Trainer.train_step with examples/train.py's Adam (lr 1e-3) on the
    task: the loss as JAX's, and each parameter after the first update
    ``p - lr g / (|g| + eps)`` of its own gradient (Adam's first step)."""
    model = port_rpmnet(jax_rpmnet["flat"])
    cfg = TrainConfig(task="rpmnet", batch_size=B, num_points=N, lr=LR, ckpt_dir=str(tmp_path))
    tr = Trainer(cfg, model, device="cpu")
    tr._ensure_optimizer(1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, aux = tr.train_step(tuple(map(torch.from_numpy, jax_rpmnet["batch"])))
    assert abs(float(loss) - jax_rpmnet["loss"]) <= FWD_TOL * abs(jax_rpmnet["loss"])
    assert set(aux) == {"rot_deg", "trans"}
    for name, p in model.named_parameters():
        want = before[name] - LR * p.grad / (p.grad.abs() + 1e-8)
        torch.testing.assert_close(p.detach(), want, rtol=0, atol=1e-6 * LR + 2e-7 * before[name].abs().max().item())
    tr.close()


def test_rpmnet_serves_three_pairs_with_a_ragged_tail(jax_rpmnet):
    """InferenceEngine(batch_size=2) on 3 (template, source) pairs: the dict
    of tensors and per-iteration lists comes back as numpy with 3 rows, and
    the tail pair's outputs equal the model's on that pair alone to 1e-5 of
    max (GroupNorm's statistics are per item)."""
    model = port_rpmnet(jax_rpmnet["flat"]).eval()
    t, s, _ = registration_batch(b=3, seed=1)
    got = InferenceEngine(model, batch_size=2, device="cpu")(t, s)
    assert isinstance(got["perm_matrices"], list) and len(got["perm_matrices"]) == 2
    assert got["est_T"].shape == (3, 4, 4) and got["perm_matrices"][1].shape == (3, N, N)
    # beta and alpha are stacked (iterations, B): the engine cuts every
    # output's first axis, so they come back as each chunk's rows of
    # iterations, as the JAX engine does
    assert got["beta"].shape == (3, 2)
    with torch.inference_mode():
        want = model(torch.from_numpy(t[2:]), torch.from_numpy(s[2:]))
    for key in ("est_T", "r", "transformed_source"):
        assert np.abs(got[key][2:] - want[key].numpy()).max() <= 1e-5 * max(np.abs(want[key].numpy()).max(), 1.0)


def test_match_features_is_the_squared_distance():
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(2, 30, 8)).astype(np.float32), rng.normal(size=(2, 20, 8)).astype(np.float32)
    got = trpm.match_features(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jrpm.match_features(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
