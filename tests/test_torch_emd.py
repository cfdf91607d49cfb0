"""The port's approxmatch EMD (K13, ``learning3d_tpu_torch.kernels.emd``) and
the EMD loss against the JAX package, on the CPU.

On the CPU the port runs K13's plain version ``_emd_fwd_reference``: d^2
from exact per-coordinate differences, the ten levels in order, the match's
row and column sums factored as the CUDA kernels take them. It is held
against the JAX kernel ``_emd_fwd_pallas`` in Pallas interpret mode (as
``tests/test_pallas_interpret.py`` runs it) and against the JAX package's
XLA path ``_emd_fwd_impl`` (d^2 by the matmul expansion), with the JAX
package's own bounds: the cost to rtol 1e-4, g1 and g2 to a mean relative
error below 5%. Those bounds are loose because ratioL = remainL / (K remainR
+ 1e-9) divides by sums that vanish at the sharpest levels (-4^7 d^2): a
sum in another order can move one point's gradient a lot while the cost
barely moves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from learning3d_tpu import losses as jlosses
from learning3d_tpu.kernels import emd as jemd
from learning3d_tpu_torch import kernels as tkernels
from learning3d_tpu_torch import losses as tlosses
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import emd as temd


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def clouds(b, n, m, seed, c=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, n, c)).astype(np.float32), rng.normal(size=(b, m, c)).astype(np.float32)


def assert_emd_close(got, want):
    (c, g1, g2), (wc, wg1, wg2) = [tuple(np.asarray(a) for a in t) for t in (got, want)]
    np.testing.assert_allclose(c, wc, rtol=1e-4)
    for g, w in ((g1, wg1), (g2, wg2)):
        assert g.shape == w.shape
        assert np.abs(g - w).mean() / np.abs(w).mean() < 0.05


def port(x, y):
    before = dict(LAUNCHES)
    out = temd.emd_fwd(torch.from_numpy(x), torch.from_numpy(y))
    assert LAUNCHES == before  # the plain version launches nothing
    return [t.numpy() for t in out]


@pytest.mark.parametrize("n,m", [(128, 128), (128, 96), (100, 200)])
def test_plain_version_matches_jax_kernel_in_interpret_mode(n, m):
    """B=1, one 128-column chunk (as the JAX package's own interpret test),
    then N > M and N < M, where the multipliers differ from 1 and the JAX
    kernel pads the ragged cloud to 128 or 256 with masked rows and
    columns."""
    x, y = clouds(1, n, m, n + m)
    with pltpu.force_tpu_interpret_mode():
        want = jemd._emd_fwd_pallas(jnp.asarray(x), jnp.asarray(y), chunk=128)
    assert_emd_close(port(x, y), want)


@pytest.mark.parametrize("b,n,m", [(2, 64, 64), (3, 90, 40), (2, 33, 100)])
def test_plain_version_matches_jax_xla_path(b, n, m):
    x, y = clouds(b, n, m, 3 * n + m)
    assert_emd_close(port(x, y), jemd._emd_fwd_impl(jnp.asarray(x), jnp.asarray(y)))


def test_off_the_gate_and_other_widths():
    """The JAX gate (N, M <= 4096, 3 channels): past it the port runs the
    plain version on every device, as the JAX package runs _emd_fwd_impl;
    that path takes any channel count."""
    x, y = clouds(2, 40, 50, 21, c=2)
    assert not temd.emd_kernel_ok(torch.from_numpy(x), torch.from_numpy(y))
    assert temd.emd_kernel_ok(torch.zeros(1, 4096, 3), torch.zeros(1, 4096, 3))
    assert not temd.emd_kernel_ok(torch.zeros(1, 4097, 3), torch.zeros(1, 8, 3))
    assert_emd_close(port(x, y), jemd._emd_fwd_impl(jnp.asarray(x), jnp.asarray(y)))
    with pytest.raises(ValueError, match="no kernel"):
        temd.emd_kernel(torch.zeros(1, 8, 3), torch.zeros(1, 8, 3))


def test_plain_version_chunks_the_batch(monkeypatch):
    x, y = (torch.from_numpy(a) for a in clouds(3, 60, 50, 22))
    whole = temd._emd_fwd_reference(x, y)
    monkeypatch.setattr(temd, "CHUNK_BYTES", 4 * 60 * 50)
    for a, b in zip(whole, temd._emd_fwd_reference(x, y)):
        assert torch.equal(a, b)


def test_levels_and_multipliers_match_jax():
    np.testing.assert_array_equal(np.asarray(temd.LEVELS, np.float32), np.asarray(jemd._levels()))
    for n, m in ((100, 100), (100, 30), (30, 100), (7, 50)):
        assert temd._multipliers(n, m) == jemd._multipliers(n, m)


@pytest.mark.parametrize("n,m", [(64, 64), (80, 40)])
def test_emd_loss_mean_and_gradient_match_jax(n, m):
    """emd_loss_mean (mean cost / N) and its gradient, the saved g1, g2
    scaled by the cotangent, against ``jax.value_and_grad`` of the JAX
    loss: the loss to rtol 1e-4 and the gradients to the mean relative
    bound above."""
    x, y = clouds(2, n, m, 5 * n + m)
    want, (gx, gy) = jax.value_and_grad(jlosses.emd_loss_mean, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = (torch.from_numpy(a).requires_grad_(True) for a in (x, y))
    loss = tlosses.emd_loss_mean(tx, ty)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)
    for got, ref in ((tx.grad, gx), (ty.grad, gy)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).mean() / np.abs(ref).mean() < 0.05


def test_emd_loss_backward_scales_the_saved_gradients():
    """d cost_b / d x = g1_b: a cotangent per item scales its own g1, g2."""
    x, y = clouds(2, 30, 30, 23)
    tx, ty = (torch.from_numpy(a).requires_grad_(True) for a in (x, y))
    cost = tkernels.emd_loss(tx, ty)
    w = torch.tensor([2.0, -0.5])
    (cost * w).sum().backward()
    _, g1, g2 = temd._emd_fwd_reference(torch.from_numpy(x), torch.from_numpy(y))
    torch.testing.assert_close(tx.grad, w[:, None, None] * g1, rtol=0, atol=0)
    torch.testing.assert_close(ty.grad, w[:, None, None] * g2, rtol=0, atol=0)


@pytest.mark.parametrize("n,m", [(50, 50), (60, 20)])
def test_approx_match_and_match_cost_match_jax(n, m):
    """The full match matrix: the port takes d^2 from exact differences, the
    JAX package by the matmul expansion; at the sharpest level (-4^7 d^2) a
    rounding of d^2 moves K by 16384 d^2 times it, so the matrices agree to
    1e-3 of their largest entry (1). match_cost against the JAX one on the
    same match to rtol 1e-5, and the cost of the port's match is the
    factored forward's cost (rtol 1e-4)."""
    x, y = clouds(2, n, m, 7 * n + m)
    want = np.asarray(jemd.approx_match(jnp.asarray(x), jnp.asarray(y)))
    got = tkernels.approx_match(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2, n, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    cost = temd.match_cost(got, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(cost, np.asarray(jemd.match_cost(jnp.asarray(got.numpy()), jnp.asarray(x),
                                                                jnp.asarray(y))), rtol=1e-5)
    np.testing.assert_allclose(cost, port(x, y)[0], rtol=1e-4)
