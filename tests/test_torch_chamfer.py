"""The port's Chamfer nearest neighbour (K12, ``learning3d_tpu_torch.kernels.
chamfer``) and the Chamfer loss against the JAX package, on the CPU.

On the CPU the port runs K12's plain version, exact per-coordinate
differences summed (d0*d0 + d1*d1) + d2*d2, each product and sum rounded.
It is held against the JAX kernel ``_nn_oneway_pallas`` in Pallas
interpret mode, against the JAX package's CPU oracle ``_nn_oneway_xla``
(the matmul expansion |x|^2 + |y|^2 - 2 x.y) and against ``jax.grad`` of
the JAX Chamfer loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from learning3d_tpu import losses as jlosses
from learning3d_tpu.kernels import chamfer as jchamfer
from learning3d_tpu_torch import kernels as tkernels
from learning3d_tpu_torch import losses as tlosses
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import chamfer as tchamfer
from torch_port_util import lattice_cloud


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def normal(b, n, seed):
    return np.random.default_rng(seed).normal(size=(b, n, 3)).astype(np.float32)


def two_roundings(x, y):
    """numpy's f32 evaluation of the kernel's arithmetic: every difference,
    product and sum rounded to f32, (d0*d0 + d1*d1) + d2*d2."""
    diff = x[:, :, None, :] - y[:, None, :, :]
    sq = diff * diff
    d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    return d.min(-1), d.argmin(-1)


CASES = {
    "ragged": lambda: (normal(2, 200, 1), normal(2, 136, 2)),
    "ties": lambda: (lattice_cloud(2, 200, seed=3), lattice_cloud(2, 136, seed=4)),
    "one_point": lambda: (normal(2, 1, 5), normal(2, 70, 6)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_kernel_in_interpret_mode(case):
    """Indices equal to the JAX kernel's (tile_n = tile_m = 128, so the
    ragged clouds span two padded tiles and the running minimum crosses a
    tile, with its strict <). Distances: bit-equal to numpy's two-rounding
    evaluation of the same arithmetic, which the TPU kernel's VPU and the
    CUDA kernel compute; XLA's CPU backend, which runs the interpret-mode
    kernel here, fuses the products and sums into FMAs (one rounding, where
    the other two round twice), so against it the distances agree to f32
    rounding (2^-22 of the distance, which is a sum of non-negative terms)
    and bit for bit on the lattice, whose squares and sums are exact."""
    x, y = CASES[case]()
    with pltpu.force_tpu_interpret_mode():
        jd, ji = map(np.asarray, jchamfer._nn_oneway_pallas(jnp.asarray(x), jnp.asarray(y), tile_n=128, tile_m=128))
    before = dict(LAUNCHES)
    td, ti = tchamfer.nn_oneway(torch.from_numpy(x), torch.from_numpy(y))
    assert LAUNCHES == before  # the plain version launches nothing
    assert td.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), ji)
    nd, ni = two_roundings(x, y)
    np.testing.assert_array_equal(td.numpy(), nd)
    np.testing.assert_array_equal(ti.numpy(), ni)
    np.testing.assert_allclose(td.numpy(), jd, rtol=2.0**-22, atol=0)
    if case == "ties":
        np.testing.assert_array_equal(td.numpy(), jd)
        d = ((x[:, :, None, :] - y[:, None, :, :]) ** 2).sum(-1)
        assert ((d == td.numpy()[..., None]).sum(-1) > 1).any()  # tied nearest points, the smaller index kept


def test_plain_version_matches_jax_cpu_oracle():
    """Against ``_nn_oneway_xla``, the JAX package's CPU path: the expansion
    |x|^2 + |y|^2 - 2 x.y cancels terms of size |x|^2 + |y|^2, so its
    distances agree to 1e-5 of that size; the indices agree wherever the
    gap to the second-nearest point is above that rounding."""
    x, y = normal(3, 200, 7), normal(3, 136, 8)
    jd, ji = map(np.asarray, jchamfer._nn_oneway_xla(jnp.asarray(x), jnp.asarray(y)))
    td, ti = (a.numpy() for a in tchamfer.nn_oneway(torch.from_numpy(x), torch.from_numpy(y)))
    y_near = np.take_along_axis(y, ti[..., None].astype(np.int64), axis=1)
    size = (x**2).sum(-1) + (y_near**2).sum(-1)
    assert (np.abs(td - jd) <= 1e-5 * size).all()
    d = ((x[:, :, None, :].astype(np.float64) - y[:, None, :, :]) ** 2).sum(-1)
    two = np.sort(d, axis=-1)[..., :2]
    firm = two[..., 1] - two[..., 0] > 1e-5 * size
    assert firm.mean() > 0.9
    np.testing.assert_array_equal(ti[firm], ji[firm])


def test_plain_version_chunks_the_batch(monkeypatch):
    """Batches go in chunks whose (b, N, M) distances stay under the chunk
    size: the same results with one cloud a chunk; and no (B, N, M, 3)
    tensor: the largest allocation is one (b, N, M) f32 buffer."""
    from torch.profiler import ProfilerActivity, profile

    x, y = torch.from_numpy(normal(3, 256, 9)), torch.from_numpy(normal(3, 300, 10))
    whole = tchamfer._nn_oneway_reference(x, y)
    monkeypatch.setattr(tchamfer, "CHUNK_BYTES", 4 * 256 * 300)
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        chunked = tchamfer._nn_oneway_reference(x, y)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    largest = max(evt.self_cpu_memory_usage for evt in prof.events())
    assert largest <= 256 * 300 * 4, largest


def test_nn_distance_both_directions():
    """Both directions, each the one-way search; inputs of another float
    type are cast to f32 first."""
    x, y = torch.from_numpy(normal(2, 50, 11)), torch.from_numpy(normal(2, 70, 12))
    d1, i1, d2, i2 = tchamfer.nn_distance(x.to(torch.bfloat16), y.to(torch.bfloat16))
    w1, v1 = tchamfer.nn_oneway(x.to(torch.bfloat16).float(), y.to(torch.bfloat16).float())
    w2, v2 = tchamfer.nn_oneway(y.to(torch.bfloat16).float(), x.to(torch.bfloat16).float())
    assert d1.shape == (2, 50) and d2.shape == (2, 70) and d1.dtype == torch.float32
    for a, b in ((d1, w1), (i1, v1), (d2, w2), (i2, v2)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match=r"\(B, N, 3\)"):
        tchamfer.nn_oneway(torch.zeros(2, 5, 2), torch.zeros(2, 5, 2))


@pytest.mark.parametrize("n,m", [(64, 64), (100, 37)])
def test_chamfer_loss_and_gradient_match_jax(n, m):
    """chamfer_distance_loss and its gradient against ``jax.grad`` of the
    JAX loss (whose CPU path selects by ``_nn_oneway_xla``): first both
    sides' nearest neighbours, which must be the same, then the loss and
    both gradients, the replayed gathers and scatter-adds, to 1e-5 of each
    (f32 sums in another order)."""
    x, y = normal(2, n, 13 + n), normal(2, m, 14 + m)
    _, ji1, _, ji2 = map(np.asarray, jchamfer.nn_distance(jnp.asarray(x), jnp.asarray(y)))
    _, ti1, _, ti2 = tchamfer.nn_distance(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(ti1.numpy(), ji1)
    np.testing.assert_array_equal(ti2.numpy(), ji2)
    want, (gx, gy) = jax.value_and_grad(jlosses.chamfer_distance_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = (torch.from_numpy(a).requires_grad_(True) for a in (x, y))
    loss = tlosses.chamfer_distance_loss(tx, ty)
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    for got, ref in ((tx.grad, gx), (ty.grad, gy)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_chamfer_distance_gradient_matches_jax_vjp():
    """The raw two-sided terms' VJP with arbitrary cotangents g1, g2, as
    ``_chamfer_bwd`` replays it: 2 g1 (x - y*) plus the scatter of
    2 g2 (x* - y) into x's rows, and the same for y."""
    x, y = normal(2, 40, 15), normal(2, 60, 16)
    rng = np.random.default_rng(17)
    g1, g2 = rng.normal(size=(2, 40)).astype(np.float32), rng.normal(size=(2, 60)).astype(np.float32)
    _, vjp = jax.vjp(jchamfer.chamfer_distance, jnp.asarray(x), jnp.asarray(y))
    gx, gy = map(np.asarray, vjp((jnp.asarray(g1), jnp.asarray(g2))))
    tx, ty = (torch.from_numpy(a).requires_grad_(True) for a in (x, y))
    d1, d2 = tchamfer.chamfer_distance(tx, ty)
    torch.autograd.backward((d1, d2), (torch.from_numpy(g1), torch.from_numpy(g2)))
    np.testing.assert_allclose(tx.grad.numpy(), gx, rtol=0, atol=1e-5 * np.abs(gx).max())
    np.testing.assert_allclose(ty.grad.numpy(), gy, rtol=0, atol=1e-5 * np.abs(gy).max())


def test_exports_match_the_jax_package():
    """What the JAX package's kernels/ and losses/ export for these parts."""
    assert tkernels.chamfer_distance is tchamfer.chamfer_distance
    assert tkernels.nn_distance is tchamfer.nn_distance
    assert tlosses.ChamferDistanceLoss is tlosses.chamfer_distance_loss
    assert tlosses.EMDLoss is tlosses.emd_loss_mean
    assert "_nn_oneway_pallas" in LAUNCHES and "_emd_fwd_pallas" in LAUNCHES
