"""The port's slack log-Sinkhorn (K17, ``learning3d_tpu_torch.kernels.sinkhorn``)
and rigid solvers (``utils.rigid``) against the JAX package, on the CPU.

On a CPU tensor ``sinkhorn_log_pallas`` runs its plain version
``sinkhorn_slack_reference``, the twin of the JAX package's XLA oracle
``utils/rigid._sinkhorn_slack_xla``; it is held to that oracle and to the
JAX kernel ``sinkhorn_log_pallas`` in Pallas interpret mode, at the JAX
package's own tolerance between the two (atol 1e-5,
``tests/test_pallas_interpret.py``), its gradient to ``jax.vjp`` of the
oracle. The CUDA kernel is held to the plain version on the card
(``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from learning3d_tpu.kernels import sinkhorn as jsinkhorn
from learning3d_tpu.utils import rigid as jrigid
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import sinkhorn as tsinkhorn
from learning3d_tpu_torch.utils import rigid as trigid

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def affinity(b, j, k, seed, beta=1.0, alpha=0.7, c=16):
    """RPMNet's affinity -beta (d - alpha), d the squared distance of unit
    features (values in [-beta (4 - alpha), beta alpha])."""
    rng = np.random.default_rng(seed)
    f, g = rng.normal(size=(b, j, c)), rng.normal(size=(b, k, c))
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    d = ((f[:, :, None] - g[:, None]) ** 2).sum(-1)
    return (-beta * (d - alpha)).astype(np.float32)


CASES = {
    "square": lambda: (affinity(2, 64, 64, 1), 5),
    "j_lt_k": lambda: (affinity(2, 40, 100, 2, beta=3.0), 5),
    "j_gt_k": lambda: (affinity(3, 90, 33, 3), 5),
    "wide_range": lambda: (affinity(2, 50, 70, 4, beta=10.0), 5),
    "normal": lambda: (np.random.default_rng(5).normal(size=(2, 100, 120)).astype(np.float32), 5),
    "one_iteration": lambda: (affinity(2, 30, 20, 6), 1),
    "no_iteration": lambda: (affinity(1, 8, 9, 7), 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_kernel_and_oracle(case):
    la, n_iters = CASES[case]()
    before = dict(LAUNCHES)
    got = tsinkhorn.sinkhorn_log_pallas(torch.from_numpy(la), n_iters)
    assert LAUNCHES == before
    assert got.shape == la.shape and got.dtype == torch.float32
    oracle = np.asarray(jrigid._sinkhorn_slack_xla(jnp.asarray(la), n_iters))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0, atol=ATOL)
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(jsinkhorn.sinkhorn_log_pallas(jnp.asarray(la), n_iters=n_iters))
    np.testing.assert_allclose(got.numpy(), kernel, rtol=0, atol=ATOL)
    if n_iters == 0:
        np.testing.assert_array_equal(got.numpy(), la)


def test_slack_normalisation():
    """After the column pass every real column sums to 1 over the J rows
    and the slack row; the rows sum to at most 1."""
    la, _ = CASES["j_lt_k"]()
    p = torch.exp(tsinkhorn.sinkhorn_slack_reference(torch.from_numpy(la).double(), 20))
    assert bool((p.sum(1) <= 1 + 1e-9).all()) and bool((p.sum(2) <= 1 + 1e-6).all())


@pytest.mark.parametrize("case", ["square", "j_gt_k"])
def test_plain_version_gradient_matches_jax_vjp(case):
    """The gradient of the plain version, which is the kernel's backward on
    the card, against jax.vjp of the XLA oracle (the JAX custom VJP's
    backward), for a random cotangent: 1e-5 of the largest entry."""
    la, n_iters = CASES[case]()
    ct = np.random.default_rng(8).normal(size=la.shape).astype(np.float32)
    x = torch.from_numpy(la).requires_grad_(True)
    tsinkhorn.sinkhorn_log_pallas(x, n_iters).backward(torch.from_numpy(ct))
    _, vjp = jax.vjp(lambda a: jrigid._sinkhorn_slack_xla(a, n_iters), jnp.asarray(la))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_sinkhorn_log_without_slack_matches_jax():
    la, _ = CASES["square"]()
    got = trigid.sinkhorn_log(torch.from_numpy(la), n_iters=5, slack=False)
    want = np.asarray(jrigid.sinkhorn_log(jnp.asarray(la), n_iters=5, slack=False))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    got = trigid.sinkhorn_log(torch.from_numpy(la), n_iters=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jrigid.sinkhorn_log(jnp.asarray(la), 5)), rtol=0, atol=ATOL)


def random_pose(rng, b):
    q = rng.normal(size=(b, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
                  np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
                  np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)], -2)
    return np.concatenate([R, rng.normal(0, 0.5, (b, 3, 1))], -1).astype(np.float32)


def test_rigid_transforms_match_jax():
    """se3_transform_34 and concat_se3_34 against the JAX functions (1e-6
    of the largest value: f32 products summed in another order)."""
    rng = np.random.default_rng(9)
    T1, T2 = random_pose(rng, 3), random_pose(rng, 3)
    pts = rng.normal(size=(3, 50, 3)).astype(np.float32)
    got = trigid.se3_transform_34(torch.from_numpy(T1), torch.from_numpy(pts)).numpy()
    want = np.asarray(jrigid.se3_transform_34(jnp.asarray(T1), jnp.asarray(pts)))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    got = trigid.concat_se3_34(torch.from_numpy(T1), torch.from_numpy(T2)).numpy()
    want = np.asarray(jrigid.concat_se3_34(jnp.asarray(T1), jnp.asarray(T2)))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("weighted", [True, False])
def test_weighted_kabsch_matches_jax(weighted):
    """The rigid fit of a noisy, weighted correspondence set against the JAX
    solver (both the f32 Jacobi solve of utils/svd3: 1e-5 of the largest
    entry), and a noise-free set recovers its pose."""
    rng = np.random.default_rng(10 + weighted)
    T = random_pose(rng, 4)
    a = rng.normal(size=(4, 60, 3)).astype(np.float32)
    b = (np.einsum("bij,bnj->bni", T[:, :, :3], a) + T[:, None, :, 3]).astype(np.float32)
    noisy = (b + 0.05 * rng.normal(size=b.shape)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (4, 60)).astype(np.float32)
    if weighted:
        got = trigid.weighted_kabsch(*map(torch.from_numpy, (a, noisy, w))).numpy()
        want = np.asarray(jrigid.weighted_kabsch(*map(jnp.asarray, (a, noisy, w))))
        exact = trigid.weighted_kabsch(*map(torch.from_numpy, (a, b, w))).numpy()
    else:
        got = trigid.kabsch(*map(torch.from_numpy, (a, noisy))).numpy()
        want = np.asarray(jrigid.kabsch(*map(jnp.asarray, (a, noisy))))
        exact = trigid.kabsch(*map(torch.from_numpy, (a, b))).numpy()
    assert got.shape == (4, 3, 4)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(exact - T).max() <= 1e-4
