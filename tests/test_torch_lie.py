"""The port's Lie-group layer (``ops.sinc``, ``quaternion``, ``so3``,
``se3``, ``invmat``, ``mean_shift``) against the JAX package's, on the CPU
in f32: values and vector-Jacobian products of each function on the same
numpy inputs, the sinc family on both sides of each switch point and at 0,
first and second derivatives of the exponentials and of the inverse left
Jacobian finite at w = 0 and equal to JAX's near it, the log near pi, and
round trips."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from learning3d_tpu.ops import invmat as jinvmat
from learning3d_tpu.ops import mean_shift as jmean_shift
from learning3d_tpu.ops import quaternion as jquat
from learning3d_tpu.ops import se3 as jse3
from learning3d_tpu.ops import sinc as jsinc
from learning3d_tpu.ops import so3 as jso3
from learning3d_tpu_torch.ops import invmat, mean_shift, quaternion, se3, sinc, so3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# f32 on both sides, the same formulas: values and gradients agree to f32
# rounding carried through a few operations, relative to the output's
# largest entry
VAL_TOL, GRAD_TOL = 2e-6, 1e-5


def rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def check_vjp(fn_t, fn_j, inputs, seed=0, val_tol=VAL_TOL, grad_tol=GRAD_TOL):
    """The output and the gradient of <output, c> for a random cotangent c,
    with respect to every float input, torch against JAX."""
    tin = [torch.tensor(a, requires_grad=a.dtype == np.float32) for a in inputs]
    out = fn_t(*tin)
    want = jax.jit(fn_j)(*map(jnp.asarray, inputs))
    assert rel(out, want) <= val_tol
    cot = np.random.default_rng(seed).normal(size=np.shape(want)).astype(np.float32)
    diff = [i for i, a in enumerate(inputs) if a.dtype == np.float32]
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), [tin[i] for i in diff], allow_unused=True)
    grads = [torch.zeros_like(tin[i]) if g is None else g for i, g in zip(diff, grads)]

    def scalar(*xs):
        args = list(map(jnp.asarray, inputs))
        for i, x in zip(diff, xs):
            args[i] = x
        return jnp.sum(fn_j(*args) * cot)

    jgrads = jax.jit(jax.grad(scalar, argnums=tuple(range(len(diff)))))(*(jnp.asarray(inputs[i]) for i in diff))
    for g, jg in zip(grads, jgrads):
        assert np.isfinite(g.numpy()).all()
        assert rel(g, jg) <= grad_tol


def rotvecs(n, seed, scale=1.5):
    return (np.random.default_rng(seed).normal(size=(n, 3)) * scale).astype(np.float32)


def rotations(n, seed):
    return Rotation.random(n, random_state=seed).as_matrix().astype(np.float32)


def twists(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 6)).astype(np.float32)


# -- sinc ---------------------------------------------------------------------

SWITCH = {1: 0.09, 2: 0.25, 3: 0.64, 4: 1.0}
SINC_GRAD_TOL = 1e-4


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_sinc_matches_jax_around_each_switch_point(k):
    """sinc_k and sinc_k_sq just below and above their switch point, at 0,
    and over a spread of t (including negative t): values and first
    derivatives against JAX."""
    s0 = SWITCH[k]
    t0 = float(np.sqrt(s0))
    t = np.array([0.0, t0 * (1 - 1e-4), t0 * (1 + 1e-4), -t0 * (1 + 1e-4), 1e-3, 0.3, 1.0, 2.5, 3.1, -2.0],
                 np.float32)
    s = np.array([0.0, s0 * (1 - 1e-4), s0 * (1 + 1e-4), 1e-6, 0.5, 4.0, 9.0], np.float32)
    # just above a switch point the closed form cancels (sinc4's numerator
    # is O(t^4): ~12 bits lost at s = 1), and the two sides' derivatives
    # round its terms in another order: gradients to SINC_GRAD_TOL
    check_vjp(getattr(sinc, f"sinc{k}"), getattr(jsinc, f"sinc{k}"), [t], grad_tol=SINC_GRAD_TOL)
    check_vjp(getattr(sinc, f"sinc{k}_sq"), getattr(jsinc, f"sinc{k}_sq"), [s], grad_tol=SINC_GRAD_TOL)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_sinc_second_derivative_finite_at_zero(k):
    """Both branches are smooth: d2/dt2 of sinc_k at t = 0 is finite and is
    the Taylor series' own (-2 c1, c1 the series' s coefficient)."""
    t = torch.zeros(1, requires_grad=True)
    (g,) = torch.autograd.grad(getattr(sinc, f"sinc{k}")(t).sum(), t, create_graph=True)
    (h,) = torch.autograd.grad(g.sum(), t)
    want = jax.grad(jax.grad(lambda x: getattr(jsinc, f"sinc{k}")(x)))(0.0)
    assert g.item() == 0.0 and np.isfinite(h.item())
    assert abs(h.item() - float(want)) <= 1e-7


# -- quaternions ----------------------------------------------------------------


def quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", ["qmul", "qinv", "qrot", "mat2quat", "axis_angle_to_quat", "quat_to_axis_angle",
                                  "quat2mat", "qfix"])
def test_quaternion_op_matches_jax(name):
    q, r = quats(6, 1), quats(6, 2)
    v = np.random.default_rng(3).normal(size=(6, 3)).astype(np.float32)
    inputs = {"qmul": [q, r], "qinv": [q], "qrot": [q, v], "mat2quat": [rotations(6, 4)],
              "axis_angle_to_quat": [rotvecs(6, 5)], "quat_to_axis_angle": [q], "quat2mat": [q],
              "qfix": [np.concatenate([q, -q])]}[name]
    check_vjp(getattr(quaternion, name), getattr(jquat, name), inputs)


def test_qrot_broadcasts_like_jax():
    q, v = quats(4, 6)[:, None], np.random.default_rng(7).normal(size=(4, 5, 3)).astype(np.float32)
    check_vjp(quaternion.qrot, jquat.qrot, [q, v])


@pytest.mark.parametrize("order", ["xyz", "yzx", "zxy", "xzy", "yxz", "zyx"])
def test_euler_conversions_match_jax(order):
    """euler_to_quat, euler_to_quaternion (the reference's axis-name
    convention and its negated even orders) and qeuler in every order, with
    the asin clamp's epsilon."""
    e = np.random.default_rng(8).uniform(-1.2, 1.2, (5, 3)).astype(np.float32)
    check_vjp(lambda x: quaternion.euler_to_quat(x, order), lambda x: jquat.euler_to_quat(x, order), [e])
    check_vjp(lambda x: quaternion.euler_to_quaternion(x, order), lambda x: jquat.euler_to_quaternion(x, order),
              [e])
    q = quats(5, 9)
    for eps in (0.0, 1e-3):
        check_vjp(lambda x: quaternion.qeuler(x, order, eps), lambda x: jquat.qeuler(x, order, eps), [q])


def test_quaternion_numpy_twins_match_jax():
    q, r = quats(5, 10), quats(5, 11)
    v = np.random.default_rng(12).normal(size=(5, 3)).astype(np.float32)
    e = rotvecs(5, 13)
    for got, want in ((quaternion.qmul_np(q, r), jquat.qmul_np(q, r)), (quaternion.qrot_np(q, v), jquat.qrot_np(q, v)),
                      (quaternion.qeuler_np(q, "xyz"), jquat.qeuler_np(q, "xyz")),
                      (quaternion.qfix_np(np.stack([q, -q])), jquat.qfix_np(np.stack([q, -q]))),
                      (quaternion.expmap_to_quaternion_np(e), jquat.expmap_to_quaternion_np(e))):
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        assert rel(got, want) <= VAL_TOL
    with pytest.raises(ValueError):
        quaternion.qeuler(torch.from_numpy(q), "xxy")


def test_mat2quat_near_pi_and_sign():
    """Angles at and near pi (where the trace candidate fails) give w >= 0
    and the JAX package's quaternion."""
    axes = np.random.default_rng(14).normal(size=(6, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angles = np.array([np.pi, np.pi - 1e-4, np.pi - 1e-2, 3.0, 1e-5, 0.0])[:, None]
    R = Rotation.from_rotvec(axes * angles).as_matrix().astype(np.float32)
    got = quaternion.mat2quat(torch.from_numpy(R))
    assert (got[:, 0] >= 0).all()
    assert rel(got, jquat.mat2quat(jnp.asarray(R))) <= VAL_TOL


# -- SO(3) --------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mat", "exp", "left_jacobian", "inv_left_jacobian", "log", "vec", "btrace",
                                  "inverse"])
def test_so3_op_matches_jax(name):
    w = rotvecs(8, 20)
    w[0] = 0.0
    w[1] *= 1e-4  # below every switch point
    inputs = {"log": [rotations(8, 21)], "vec": [np.asarray(jso3.mat(jnp.asarray(w)))],
              "btrace": [rotations(8, 22)], "inverse": [rotations(8, 23)]}.get(name, [w])
    check_vjp(getattr(so3, name), getattr(jso3, name), inputs)


def test_so3_transform_and_generators_match_jax():
    R = rotations(3, 24)
    p = np.random.default_rng(25).normal(size=(3, 7, 3)).astype(np.float32)
    check_vjp(so3.transform, jso3.transform, [R, p])  # points
    check_vjp(so3.transform, jso3.transform, [R, p[:, 0]])  # one vector a rotation
    np.testing.assert_array_equal(so3.genvec().numpy(), np.asarray(jso3.genvec()))
    np.testing.assert_array_equal(so3.genmat().numpy(), np.asarray(jso3.genmat()))


def test_so3_log_near_pi_round_trips():
    """log near and at pi: |w| within [0, pi], exp(log R) = R, and JAX's
    vector (up to the sign an angle of exactly pi leaves free)."""
    axes = np.random.default_rng(26).normal(size=(5, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angles = np.array([np.pi - 1e-3, np.pi - 1e-2, 3.0, 2.0, np.pi])[:, None]
    R = Rotation.from_rotvec(axes * angles).as_matrix().astype(np.float32)
    w = so3.log(torch.from_numpy(R))
    assert (torch.linalg.vector_norm(w, dim=-1) <= np.pi + 1e-5).all()
    np.testing.assert_allclose(so3.exp(w).numpy(), R, rtol=0, atol=5e-6)
    want = np.asarray(jso3.log(jnp.asarray(R)))
    assert rel(w[:4], want[:4]) <= VAL_TOL
    assert min(rel(w[4:], want[4:]), rel(-w[4:], want[4:])) <= VAL_TOL


# -- second derivatives at and near the identity ------------------------------

SECOND = {"so3.exp": (so3.exp, jso3.exp, 3), "se3.exp": (se3.exp, jse3.exp, 6),
          "inv_left_jacobian": (so3.inv_left_jacobian, jso3.inv_left_jacobian, 3)}


@pytest.mark.parametrize("name", sorted(SECOND))
@pytest.mark.parametrize("scale", [0.0, 1e-4, 0.3])
def test_second_derivatives_finite_and_match_jax(name, scale):
    """The Hessian-vector product of <f(w), c> at w = 0, near it and away
    from it (torch.autograd.grad with create_graph) finite and equal to
    JAX's."""
    fn_t, fn_j, d = SECOND[name]
    rng = np.random.default_rng(30)
    w = (scale * rng.normal(size=(4, d))).astype(np.float32)
    c = rng.normal(size=jax.eval_shape(fn_j, jnp.asarray(w)).shape).astype(np.float32)
    v = rng.normal(size=w.shape).astype(np.float32)
    wt = torch.tensor(w, requires_grad=True)
    (g,) = torch.autograd.grad((fn_t(wt) * torch.from_numpy(c)).sum(), wt, create_graph=True)
    (h,) = torch.autograd.grad((g * torch.from_numpy(v)).sum(), wt)

    def jscalar(x):
        return jnp.sum(fn_j(x) * c)

    jg = jax.jit(jax.grad(jscalar))(jnp.asarray(w))
    jh = jax.jit(jax.grad(lambda x: jnp.sum(jax.grad(jscalar)(x) * v)))(jnp.asarray(w))
    assert np.isfinite(g.detach().numpy()).all() and np.isfinite(h.numpy()).all()
    assert rel(g, jg) <= GRAD_TOL
    assert rel(h, jh) <= 1e-4


# -- SE(3) ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mat", "vec", "exp", "log", "inverse", "compose", "to_rt", "from_rt"])
def test_se3_op_matches_jax(name):
    x = twists(6, 40)
    x[0] = 0.0
    g = np.asarray(jse3.exp(jnp.asarray(x)))
    g2 = np.asarray(jse3.exp(jnp.asarray(twists(6, 41))))
    inputs = {"mat": [x], "vec": [np.asarray(jse3.mat(jnp.asarray(x)))], "exp": [x], "log": [g], "inverse": [g],
              "compose": [g, g2], "to_rt": [g], "from_rt": [g[:, :3, :3], g[:, :3, 3]]}[name]
    if name == "to_rt":
        for i in range(2):
            check_vjp(lambda a: se3.to_rt(a)[i], lambda a: jse3.to_rt(a)[i], inputs)
        return
    check_vjp(getattr(se3, name), getattr(jse3, name), inputs)


def test_se3_transform_broadcasts_like_pointnetlk():
    """(1, 6, 1, 4, 4) transforms against (B, 1, N, 3) clouds (PointNetLK's
    finite differences), (B, 1, 4, 4) against (B, N, 3), and (B, 4, 4)
    against (B, N, 3)."""
    g6 = np.asarray(jse3.exp(jnp.asarray(-np.diag(np.full(6, 0.01, np.float32)))))
    gb = np.asarray(jse3.exp(jnp.asarray(twists(2, 42))))
    p = np.random.default_rng(43).normal(size=(2, 9, 3)).astype(np.float32)
    for g, pts in ((g6[None, :, None], p[:, None]), (gb[:, None], p), (gb, p)):
        check_vjp(se3.transform, jse3.transform, [g, pts])
    out = se3.transform(torch.from_numpy(g6[None, :, None]), torch.from_numpy(p[:, None]))
    assert out.shape == (2, 6, 9, 3)


def test_se3_exp_log_round_trip():
    x = twists(16, 44)
    x[:, :3] *= 0.9  # |w| < pi
    x[0] = 0.0
    x[1] *= 1e-5
    back = se3.log(se3.exp(torch.from_numpy(x)))
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=3e-5)
    g = se3.exp(torch.from_numpy(x))
    np.testing.assert_allclose(se3.compose(g, se3.inverse(g)).numpy(), np.broadcast_to(np.eye(4), g.shape),
                               rtol=0, atol=2e-6)


# -- invmat and mean_shift --------------------------------------------------


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_pinv_via_normal_eqs_matches_jax(eps):
    """(J^T J + eps I)^-1 J^T on PointNetLK's (B, K, 6) shape; with eps 0 a
    left inverse of J."""
    J = np.random.default_rng(50).normal(size=(3, 40, 6)).astype(np.float32)
    check_vjp(lambda a: invmat.pinv_via_normal_eqs(a, eps), lambda a: jinvmat.pinv_via_normal_eqs(a, eps), [J],
              val_tol=1e-5, grad_tol=1e-4)
    if not eps:
        P = invmat.pinv_via_normal_eqs(torch.from_numpy(J))
        np.testing.assert_allclose((P @ torch.from_numpy(J)).numpy(), np.broadcast_to(np.eye(6), (3, 6, 6)),
                                   rtol=0, atol=1e-5)


def test_batch_inverse_and_pinv_match_jax():
    rng = np.random.default_rng(51)
    A = (rng.normal(size=(3, 4, 4)) + 4 * np.eye(4)).astype(np.float32)
    check_vjp(invmat.batch_inverse, jinvmat.batch_inverse, [A], val_tol=1e-5, grad_tol=1e-4)
    M = rng.normal(size=(3, 5, 3)).astype(np.float32)
    check_vjp(invmat.batch_pinv, jinvmat.batch_pinv, [M], val_tol=1e-5, grad_tol=1e-4)


def test_mean_shift_and_postprocess_match_jax():
    """The centred clouds, a0 and a1 and the folded transform against JAX;
    folding back the translation of a pair registered in the centred frame
    gives the transform of the original clouds."""
    rng = np.random.default_rng(52)
    t = rng.normal(size=(2, 30, 3)).astype(np.float32) + 2.0
    s = rng.normal(size=(2, 20, 3)).astype(np.float32) - 1.0
    for i in range(4):
        check_vjp(lambda a, b: mean_shift.mean_shift(a, b)[i], lambda a, b: jmean_shift.mean_shift(a, b)[i], [t, s])
    g = np.asarray(jse3.exp(jnp.asarray(twists(2, 53))))
    _, _, a0, a1 = jmean_shift.mean_shift(jnp.asarray(t), jnp.asarray(s))
    a0, a1 = np.asarray(a0), np.asarray(a1)
    check_vjp(mean_shift.postprocess, jmean_shift.postprocess, [g, a0, a1])
    series = np.stack([g, g])  # (iterations, B, 4, 4) against (B, 4, 4)
    got = mean_shift.postprocess(torch.from_numpy(series), torch.from_numpy(a0), torch.from_numpy(a1))
    assert rel(got[1], jmean_shift.postprocess(jnp.asarray(g), jnp.asarray(a0), jnp.asarray(a1))) <= VAL_TOL
    # source = R template + t exactly: the centred problem's transform,
    # folded back, maps source onto template
    R = rotations(2, 54)
    tr = rng.normal(size=(2, 3)).astype(np.float32)
    src = np.einsum("bij,bnj->bni", R, t) + tr[:, None]
    t0, s0, b0, b1 = mean_shift.mean_shift(torch.from_numpy(t), torch.from_numpy(src))
    est0 = se3.from_rt(torch.from_numpy(R).transpose(1, 2), torch.zeros(2, 3))  # s0 -> t0
    est = mean_shift.postprocess(est0, b0, b1)
    np.testing.assert_allclose(se3.transform(est, torch.from_numpy(src)).numpy(), t, rtol=0, atol=2e-5)
