"""The port's exact kNN (K8, ``learning3d_tpu_torch.kernels.knn``) and the
kNN entries of ``ops.geometry`` against the JAX package, on the CPU.

On the CPU the port runs K8's plain version ``knn_reference``: C == 3 by
exact per-coordinate differences (d0*d0 + d1*d1) + d2*d2, C != 3 by the
expansion (|q|^2 - 2 q.p) + |p|^2 with each sum taken one channel at a time,
every operation rounded on its own (the arithmetic the CUDA kernel repeats
bit for bit). It is held to the JAX kernel ``knn_pallas`` in Pallas
interpret mode, as ``tests/test_pallas_interpret.py`` runs it (tile_s=64),
and to numpy's f32 evaluation of the same arithmetic. ``ops.geometry.knn``
and ``knn_point`` take the JAX package's CPU path on a CPU tensor; K8's
gate is the JAX package's, with the card in place of the TPU.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from learning3d_tpu.kernels import knn as jknn
from learning3d_tpu.ops import geometry as jgeo
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import knn as tknn
from learning3d_tpu_torch.ops import geometry as tgeo
from torch_port_util import lattice_cloud

# distances against the JAX kernel: at C == 3 both sides take exact
# differences (XLA's CPU backend may fuse a product and a sum into an FMA,
# one rounding where the port rounds twice): 1e-5; at C > 3 the JAX kernel
# takes the cross term from one f32 matmul and the squared norms from
# jnp.sum, whose orders differ from the port's channel by channel sums, on
# distances of ~2C: 1e-4 (both absolute, the JAX package's own test's)
JAX_ATOL = {3: 1e-5, 67: 1e-4, 16: 1e-4}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def normal(b, n, c, seed):
    return np.random.default_rng(seed).normal(size=(b, n, c)).astype(np.float32)


def numpy_knn(q, p, k):
    """numpy's f32 evaluation of K8's arithmetic, every operation rounded,
    and a stable argsort: (sq_dist, idx)."""
    if q.shape[-1] == 3:
        diff = q[:, :, None, :] - p[:, None, :, :]
        sq = diff * diff
        d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    else:
        q_sq, p_sq = q[..., 0] * q[..., 0], p[..., 0] * p[..., 0]
        cross = q[:, :, None, 0] * p[:, None, :, 0]
        for c in range(1, q.shape[-1]):
            q_sq = q_sq + q[..., c] * q[..., c]
            p_sq = p_sq + p[..., c] * p[..., c]
            cross = cross + q[:, :, None, c] * p[:, None, :, c]
        d = (q_sq[:, :, None] - np.float32(2.0) * cross) + p_sq[:, None, :]
    idx = np.argsort(d, axis=-1, kind="stable")[..., :k]
    return np.take_along_axis(d, idx, -1), idx


def jax_kernel(q, p, k):
    with pltpu.force_tpu_interpret_mode():
        d, i = jknn.knn_pallas(jnp.asarray(q), jnp.asarray(p), k, tile_s=64)
    return np.asarray(d), np.asarray(i)


CASES = {
    # (queries, points, k): the JAX package's interpret-mode cases, a cloud
    # against another of another size, and queries that are the points
    "xyz": lambda: (normal(2, 64, 3, 1), normal(2, 200, 3, 2), 5),
    "features": lambda: (normal(2, 64, 67, 3), normal(2, 200, 67, 4), 5),
    "cross_cloud_xyz": lambda: (normal(2, 100, 3, 5), normal(2, 250, 3, 6), 7),
    "cross_cloud_features": lambda: (normal(1, 130, 16, 7), normal(1, 70, 16, 8), 20),
    "self_features": lambda: (lambda x: (x, x, 9))(normal(2, 150, 67, 9)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_kernel_in_interpret_mode(case):
    """Indices equal to the JAX kernel's; distances within JAX_ATOL."""
    q, p, k = CASES[case]()
    d, i = tknn.knn_pallas(torch.from_numpy(q), torch.from_numpy(p), k)
    want_d, want_i = jax_kernel(q, p, k)
    assert d.dtype == torch.float32 and i.dtype == torch.int32 and d.shape == i.shape == (q.shape[0], q.shape[1], k)
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_allclose(d.numpy(), want_d, rtol=0, atol=JAX_ATOL[q.shape[-1]])


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_is_the_kernels_arithmetic(case):
    """Bit-equal to numpy's f32 evaluation of the arithmetic the CUDA kernel
    computes, indices and distances."""
    q, p, k = CASES[case]()
    d, i = tknn.knn_reference(torch.from_numpy(q), torch.from_numpy(p), k)
    want_d, want_i = numpy_knn(q, p, k)
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_array_equal(d.numpy(), want_d)


def test_ties_go_to_the_smaller_index():
    """A lattice cloud (0.25 steps, exact in f32): the k-th neighbors are
    decided by exact distance ties, broken toward the smaller index as
    lax.top_k does; equal to the JAX kernel's, at C == 3 and on the same
    points lifted to 5 channels (zero channels add exact zeros)."""
    x = lattice_cloud(2, 200, seed=3)
    for pts in (x, np.concatenate([x, np.zeros_like(x[..., :2])], -1)):
        d, i = tknn.knn_pallas(torch.from_numpy(pts), torch.from_numpy(pts), 12)
        d, i = d.numpy(), i.numpy()
        tied = d[..., 1:] == d[..., :-1]
        assert tied.any()
        assert (i[..., 1:][tied] > i[..., :-1][tied]).all()
        want_d, want_i = jax_kernel(pts, pts, 12)
        np.testing.assert_array_equal(i, want_i)
        np.testing.assert_array_equal(d, want_d)


def test_negative_distances_sort_first():
    """Near-duplicate feature vectors of large norm: the expansion rounds
    some distances below 0, including a point's distance to its duplicate in
    a self search, where the point's own distance is exactly 0. They sort
    before 0, nearest first, as numpy's evaluation sorts them (the CUDA
    kernel maps each f32 to order-preserving bits for that; the card test
    holds it to this plain version)."""
    rng = np.random.default_rng(11)
    base = (100.0 + rng.normal(size=(2, 40, 24))).astype(np.float32)
    pts = np.concatenate([base, base + rng.normal(0.0, 1e-4, base.shape).astype(np.float32)], axis=1)
    d, i = tknn.knn_pallas(torch.from_numpy(pts), torch.from_numpy(pts), 4)
    want_d, want_i = numpy_knn(pts, pts, 4)
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_array_equal(d.numpy(), want_d)
    assert (d < 0).any()
    assert (np.diff(d.numpy(), axis=-1) >= 0).all()
    self_col = np.arange(pts.shape[1])[None, :, None] == i.numpy()
    assert (d.numpy()[self_col] == 0).all()
    assert (self_col.argmax(-1) > 0).any()  # some point's duplicate comes before the point itself


def test_kernel_limit_messages():
    assert tknn.kernel_limit(128, 20) is None
    assert tknn.kernel_limit(256, 64) is None
    assert tknn.kernel_limit(3, 1) is None
    assert "k <= 64" in tknn.kernel_limit(3, 65)
    assert "1 <= k" in tknn.kernel_limit(3, 0)
    assert "C <= 256" in tknn.kernel_limit(257, 20)
    with pytest.raises(ValueError, match="no kernel for device"):
        tknn.knn_pallas(torch.zeros((1, 8, 3), device="meta"), torch.zeros((1, 8, 3), device="meta"), 2)
    with pytest.raises(ValueError, match="k must be"):
        tknn.knn_pallas(torch.zeros((1, 8, 3)), torch.zeros((1, 8, 3)), 9)
    with pytest.raises(ValueError, match="must be"):
        tknn.knn_pallas(torch.zeros((1, 8, 3)), torch.zeros((1, 8, 4)), 2)
    # a CPU tensor runs the plain version, which has no channel limit
    q = torch.from_numpy(normal(1, 9, 300, 12))
    assert tknn.knn_pallas(q, q, 3)[1].shape == (1, 9, 3)


def test_gate_is_the_jax_packages():
    """K8 where JAX's _use_knn_pallas sends an exact TPU call to its kernel:
    C <= 256, k <= 64, N >= 512, on the card. The gate has no approx term:
    the port selects exactly for approx=True too, so it takes K8 as well."""
    def pts(n, c, dev="cuda"):
        return types.SimpleNamespace(shape=(2, n, c), device=types.SimpleNamespace(type=dev))

    assert tgeo._use_knn_kernel(pts(512, 3), 20)
    assert tgeo._use_knn_kernel(pts(768, 256), 64)
    assert not tgeo._use_knn_kernel(pts(511, 3), 20)
    assert not tgeo._use_knn_kernel(pts(512, 257), 20)
    assert not tgeo._use_knn_kernel(pts(512, 3), 65)
    assert not tgeo._use_knn_kernel(pts(512, 3, "cpu"), 20)


@pytest.mark.parametrize("approx", [False, True])
def test_geometry_knn_matches_jax_at_the_gate_size(approx, monkeypatch):
    """knn(include_self=False) and knn_point on a C=64 cloud of N=512 (the
    gate's size): the plain path on both sides (JAX's CPU backend never
    takes its kernel, the port's CPU tensor never launches K8). approx=True
    selects exactly on the port; lax.approx_min_k is exact on JAX's CPU
    backend. Indices equal, int64; knn_point's distances within 1e-5 of
    their largest (the same expansion, f32 sums in other orders)."""
    monkeypatch.setattr(tknn, "knn_pallas", lambda *a: pytest.fail("K8 on a CPU tensor"))
    x, y = normal(1, 512, 64, 21), normal(1, 300, 64, 22)
    idx = tgeo.knn(torch.from_numpy(x), 10, include_self=False, approx=approx)
    assert idx.dtype == torch.int64 and idx.shape == (1, 512, 10)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jgeo.knn(jnp.asarray(x), 10, include_self=False,
                                                                   approx=approx)))
    d, i = tgeo.knn_point(16, torch.from_numpy(x), torch.from_numpy(y), approx=approx)
    want_d, want_i = jgeo.knn_point(16, jnp.asarray(x), jnp.asarray(y), approx=approx)
    assert i.dtype == torch.int64 and i.shape == (1, 300, 16)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), rtol=0, atol=1e-5 * float(np.abs(want_d).max()))
    assert LAUNCHES["knn_pallas"] == 0


def test_geometry_takes_k8_inside_the_gate(monkeypatch):
    """With the gate open (as on the card), knn and knn_point call K8's
    wrapper with detached operands, a (k + 1)-search for include_self=False,
    and widen its int32 indices to int64, for approx=True as for an exact
    call; on these clouds its selection is the plain path's. The distances
    differ by the expansion's rounding (|x|^2 + |y|^2 ~ 20, so some 2e-6 of
    a squared distance): 1e-5."""
    calls = []

    def wrapper(q, p, k):
        calls.append((q.requires_grad, p.requires_grad, k))
        return tknn.knn_reference(q, p, k)

    x = torch.from_numpy(normal(2, 96, 3, 23)).requires_grad_(True)
    y = torch.from_numpy(normal(2, 40, 3, 24))
    want_idx = tgeo.knn(x, 6, include_self=False)  # the plain path: gate closed on the CPU
    want_d, want_i = tgeo.knn_point(5, x, y)
    monkeypatch.setattr(tgeo, "_use_knn_kernel", lambda points, k: True)
    monkeypatch.setattr(tknn, "knn_pallas", wrapper)
    for approx in (False, True):
        idx = tgeo.knn(x, 6, include_self=False, approx=approx)
        d, i = tgeo.knn_point(5, x, y, approx=approx)
        assert idx.dtype == i.dtype == torch.int64 and not d.requires_grad
        np.testing.assert_array_equal(idx.numpy(), want_idx.numpy())
        np.testing.assert_array_equal(i.numpy(), want_i.numpy())
        np.testing.assert_allclose(d.numpy(), want_d.detach().numpy(), rtol=0, atol=1e-5)
    assert calls == [(False, False, 7), (False, False, 5)] * 2
