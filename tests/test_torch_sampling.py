"""The port's farthest-point sampling (K14) and ball query (K15),
``learning3d_tpu_torch.kernels.sampling``, and the sampling, grouping and
interpolation ops of ``ops.geometry`` against the JAX package, on the CPU.

On the CPU the wrappers run the kernels' plain versions ``fps_reference``
and ``ball_query_reference`` (the arithmetic the CUDA kernels repeat, every
operation rounded on its own), held index for index to the JAX kernels
``fps_pallas`` and ``ball_query_pallas`` in Pallas interpret mode, as
``tests/test_pallas_interpret.py`` runs them. The ops take the JAX
package's CPU path on a CPU tensor and are held to the JAX functions: the
ball query there is the matmul expansion, not the kernel's exact
differences, and the two disagree on points that lie on the radius (shown
below on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from learning3d_tpu.kernels import sampling as jsampling
from learning3d_tpu.ops import geometry as jgeo
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import sampling as tsampling
from learning3d_tpu_torch.ops import geometry as tgeo
from torch_port_util import lattice_cloud


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def normal(b, n, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=(b, n, 3))).astype(np.float32)


def radius_lattice(side=5, h=0.1, offset=0.37, seed=0):
    """A (1, side^3, 3) lattice of step ``h`` (not exact in f32) shifted by
    ``offset``, in a random order: with radius ``h`` every neighbor sits on
    the radius, where rounding decides in or out."""
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    x = (h * g + offset).astype(np.float32)
    return x[np.random.default_rng(seed).permutation(len(x))][None]


def jax_fps(x, npoint, start=None):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jsampling.fps_pallas(jnp.asarray(x), npoint,
                                               start=None if start is None else jnp.asarray(start)))


def jax_ball_query(radius, nsample, x, q):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jsampling.ball_query_pallas(radius, nsample, jnp.asarray(x), jnp.asarray(q), tile_s=64))


FPS_CASES = {
    # (xyz, npoint, start)
    "random": lambda: (normal(2, 200, 1), 40, None),
    "ragged": lambda: (normal(3, 131, 2), 77, None),
    "lattice_ties": lambda: (lattice_cloud(2, 125, seed=3), 60, None),
    "every_point": lambda: (normal(1, 50, 4), 50, None),
    "past_every_point": lambda: (normal(1, 50, 5), 64, None),
    "random_starts": lambda: (normal(3, 150, 6), 30, np.array([7, 149, 0], np.int32)),
}


@pytest.mark.parametrize("case", list(FPS_CASES))
def test_fps_plain_version_matches_jax_kernel_in_interpret_mode(case):
    """Indices equal to the JAX kernel's, first pick ``start``."""
    x, npoint, start = FPS_CASES[case]()
    got = tsampling.fps_pallas(torch.from_numpy(x), npoint, None if start is None else torch.from_numpy(start))
    assert got.dtype == torch.int32 and got.shape == (x.shape[0], npoint)
    np.testing.assert_array_equal(got.numpy(), jax_fps(x, npoint, start))
    np.testing.assert_array_equal(got[:, 0].numpy(), np.zeros(x.shape[0]) if start is None else start)


def test_fps_ties_and_exhaustion():
    """On a lattice (exact distances) equal maxima go to the smaller index;
    past N picks the distances are all 0 and the picks repeat point 0, the
    first index of the maximum, as in the JAX kernel."""
    x = lattice_cloud(1, 27, seed=8)
    got = tsampling.fps_reference(torch.from_numpy(x), 40).numpy()[0]
    assert sorted(got[:27]) == list(range(27))
    assert (got[27:] == 0).all()
    # a tie decided by index: two copies of one point far from the rest
    y = np.zeros((1, 6, 3), np.float32)
    y[0, 2] = y[0, 4] = [5.0, 0.0, 0.0]
    assert tsampling.fps_reference(torch.from_numpy(y), 2).numpy()[0].tolist() == [0, 2]


BQ_CASES = {
    # (radius, nsample, xyz, queries)
    "random": lambda: (0.5, 8, normal(2, 200, 11), normal(2, 200, 11)[:, :64]),
    "ragged": lambda: (0.8, 16, normal(3, 173, 12), normal(3, 37, 13)),
    "nsample_128": lambda: (1.5, 128, normal(2, 300, 14), normal(2, 40, 15)),
    "short_rows": lambda: (0.3, 32, normal(2, 120, 16), normal(2, 120, 16)[:, :50]),
    "lattice": lambda: (0.25, 12, lattice_cloud(2, 200, seed=17), lattice_cloud(2, 200, seed=17)[:, :64]),
    "on_the_radius": lambda: (0.1, 16, radius_lattice(), radius_lattice()[:, :64]),
    "empty_ball": lambda: (0.5, 8, normal(1, 100, 18), np.concatenate([normal(1, 3, 19), np.full((1, 2, 3), 50.0,
                                                                                              np.float32)], 1)),
}


@pytest.mark.parametrize("case", list(BQ_CASES))
def test_ball_query_plain_version_matches_jax_kernel_in_interpret_mode(case):
    """Indices equal to the JAX kernel's: ascending in-ball indices, a short
    row padded with its first, an empty ball N everywhere."""
    radius, nsample, x, q = BQ_CASES[case]()
    got = tsampling.ball_query_pallas(radius, nsample, torch.from_numpy(x), torch.from_numpy(q))
    assert got.dtype == torch.int32 and got.shape == (q.shape[0], q.shape[1], nsample)
    want = jax_ball_query(radius, nsample, x, q)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "empty_ball":
        assert (want[0, 3:] == x.shape[1]).all() and (want[0, :3] < x.shape[1]).all()
    if case == "short_rows":
        assert (want[..., -1] == want[..., 0]).any()


def test_squared_radius_is_the_python_square_rounded_once():
    """r2 is f32(radius ** 2) as the JAX package passes it, not f32(r) *
    f32(r): at r = 0.1 the two differ by an ulp."""
    assert tsampling.squared_radius(0.1) == np.float32(0.1**2)
    assert np.float32(0.1) * np.float32(0.1) != np.float32(0.1**2)


def test_kernel_limit_messages():
    """The CUDA kernels take any npoint and nsample that fit their int32
    indices: the TPU kernels' npoint <= 1024 and nsample <= 128 (VMEM) do
    not hold on the card."""
    assert tsampling.fps_kernel_limit(2048, 1024) is None
    assert tsampling.fps_kernel_limit(2048, 1025) is None
    assert "int32" in tsampling.fps_kernel_limit(2048, 2**31)
    assert "int32" in tsampling.fps_kernel_limit(2**31, 16)
    assert tsampling.ball_query_kernel_limit(2048, 128) is None
    assert tsampling.ball_query_kernel_limit(2048, 129) is None
    assert "int32" in tsampling.ball_query_kernel_limit(2048, 2**31)
    assert "int32" in tsampling.ball_query_kernel_limit(2**31, 16)


@pytest.mark.parametrize("start", [[-1, 0], [0, 40], [5, 2**32]])
def test_fps_start_outside_the_cloud_raises(start):
    """A start outside [0, N) is refused before any pick (a negative one
    would otherwise wrap in torch indexing, one past the end read beyond the
    cloud on the card)."""
    x = torch.from_numpy(normal(2, 40, 23))
    with pytest.raises(ValueError, match=r"start must lie in \[0, 40\)"):
        tsampling.fps_pallas(x, 8, torch.tensor(start, dtype=torch.int64))
    assert tsampling.fps_pallas(x, 8, torch.tensor([0, 39])).shape == (2, 8)


# -- ops.geometry against the JAX package's CPU functions ----------------------

def test_farthest_point_sample_matches_jax():
    """Start 0 without a generator; with one, the start is drawn from it (the
    JAX package draws from a PRNG key: another stream), and the picks are
    those of the JAX scan from the same start. Indices are int64 for
    torch.gather. No kernel launches on a CPU tensor."""
    x = normal(3, 160, 21)
    before = dict(LAUNCHES)
    got = tgeo.farthest_point_sample(torch.from_numpy(x), 48)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgeo.farthest_point_sample(jnp.asarray(x), 48)))
    g = torch.Generator().manual_seed(3)
    start = torch.randint(0, 160, (3,), generator=torch.Generator().manual_seed(3))
    got = tgeo.farthest_point_sample(torch.from_numpy(x), 48, generator=g)
    np.testing.assert_array_equal(got[:, 0].numpy(), start.numpy())
    key = jax.random.PRNGKey(5)
    jstart = np.asarray(jax.random.randint(key, (3,), 0, 160, dtype=jnp.int32))
    want = np.asarray(jgeo.farthest_point_sample(jnp.asarray(x), 48, key=key))
    np.testing.assert_array_equal(tsampling.fps_reference(torch.from_numpy(x), 48, np.array(jstart)).numpy(), want)
    assert LAUNCHES == before


@pytest.mark.parametrize("case", ["random", "ragged", "nsample_128", "short_rows", "lattice", "on_the_radius",
                                  "empty_ball"])
def test_query_ball_point_matches_jax_cpu_path(case):
    """The op on a CPU tensor is the JAX package's CPU path (the matmul
    expansion against radius * radius), index for index, with the in-ball
    count for get_cnt."""
    radius, nsample, x, q = BQ_CASES[case]()
    tx, tq = torch.from_numpy(x), torch.from_numpy(q)
    got = tgeo.query_ball_point(radius, nsample, tx, tq)
    want = np.asarray(jgeo.query_ball_point(radius, nsample, jnp.asarray(x), jnp.asarray(q)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tgeo.ball_query_pad_first(radius, nsample, tx, tq).numpy(), want)
    got, cnt = tgeo.query_ball_point(radius, nsample, tx, tq, get_cnt=True)
    want, want_cnt = jgeo.query_ball_point(radius, nsample, jnp.asarray(x), jnp.asarray(q), get_cnt=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))


def test_ball_query_on_the_radius_kernel_and_cpu_path_differ_on_both_sides():
    """The trap: on the lattice whose neighbors sit on the radius, the
    kernel's exact differences and the CPU path's expansion round the same
    distances apart. The port keeps both sides: its plain version of K15
    follows the JAX kernel, its CPU op the JAX CPU path."""
    radius, nsample, x, q = BQ_CASES["on_the_radius"]()
    kernel = tsampling.ball_query_reference(radius, nsample, torch.from_numpy(x), torch.from_numpy(q)).numpy()
    cpu = tgeo.query_ball_point(radius, nsample, torch.from_numpy(x), torch.from_numpy(q)).numpy()
    rows = (kernel != cpu).any(-1).sum()
    assert rows >= 32, rows  # 51 of 64 rows
    np.testing.assert_array_equal(kernel, jax_ball_query(radius, nsample, x, q))
    np.testing.assert_array_equal(cpu, np.asarray(jgeo.query_ball_point(radius, nsample, jnp.asarray(x),
                                                                        jnp.asarray(q))))


def test_gather_and_grouping_match_jax():
    rng = np.random.default_rng(22)
    pts = rng.normal(size=(2, 50, 5)).astype(np.float32)
    idx = rng.integers(0, 50, (2, 7)).astype(np.int32)
    idx3 = rng.integers(0, 50, (2, 7, 4)).astype(np.int32)
    np.testing.assert_array_equal(tgeo.gather_operation(torch.from_numpy(pts), torch.from_numpy(idx).long()).numpy(),
                                  np.asarray(jgeo.gather_operation(jnp.asarray(pts), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        tgeo.grouping_operation(torch.from_numpy(pts), torch.from_numpy(idx3).long()).numpy(),
        np.asarray(jgeo.grouping_operation(jnp.asarray(pts), jnp.asarray(idx3))))


def test_index_points_raises_on_index_n():
    """A row with an empty ball holds N. JAX's gather fills NaN there
    (``take_along_axis`` out of bounds); the port's ``torch.gather`` raises
    (ROADMAP Queue 3). FlowNet3D cannot reach it: every query is one of the
    points."""
    pts = np.ones((1, 10, 3), np.float32)
    idx = np.array([[[0, 10]]], np.int32)
    assert np.isnan(np.asarray(jgeo.index_points(jnp.asarray(pts), jnp.asarray(idx)))[0, 0, 1]).all()
    with pytest.raises((IndexError, RuntimeError)):
        tgeo.index_points(torch.from_numpy(pts), torch.from_numpy(idx).long())


def coincident_pair(seed):
    """Unknown points of which the first five coincide with known points."""
    rng = np.random.default_rng(seed)
    known = rng.normal(size=(2, 40, 3)).astype(np.float32)
    unknown = rng.normal(size=(2, 30, 3)).astype(np.float32)
    unknown[:, :5] = known[:, 3:8]
    return unknown, known


def test_three_nn_matches_jax():
    """Indices equal to the JAX CPU path's (exact differences) and distances
    within 1e-6 relative: XLA's CPU backend contracts the sum of squares into
    fused multiply-adds where the port rounds each operation, as K8 does (1
    of 180 distances differs, by an ulp); a coincident point gives 0
    exactly."""
    u, k = coincident_pair(23)
    d, i = tgeo.three_nn(torch.from_numpy(u), torch.from_numpy(k))
    jd, ji = jgeo.three_nn(jnp.asarray(u), jnp.asarray(k))
    assert i.dtype == torch.int64
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=0)
    assert (d[:, :5, 0] == 0).all()
    np.testing.assert_array_equal(i[:, :5, 0].numpy(), np.tile(np.arange(3, 8), (2, 1)))


def test_three_nn_at_the_kernel_gate_takes_the_cpu_path():
    """A known cloud of 512 points is inside K8's gate on the card; on a CPU
    tensor the op takes the JAX CPU path, no kernel launch, the same picks."""
    u, k = normal(1, 100, 29), normal(1, 512, 30)
    before = dict(LAUNCHES)
    _, i = tgeo.three_nn(torch.from_numpy(u), torch.from_numpy(k))
    assert LAUNCHES == before
    np.testing.assert_array_equal(i.numpy(), np.asarray(jgeo.three_nn(jnp.asarray(u), jnp.asarray(k))[1]))


def test_three_nn_gradients_match_jax():
    """The gradient of sum(w * dist) with respect to both clouds, against
    jax.grad of the JAX CPU path to 1e-6 of the largest: NaN on both sides at
    the coincident points (sqrt's derivative at 0 times a zero difference),
    finite and equal elsewhere."""
    u, k = coincident_pair(24)
    w = np.random.default_rng(25).normal(size=(2, 30, 3)).astype(np.float32)
    gu, gk = jax.grad(lambda a, b: jnp.sum(jgeo.three_nn(a, b)[0] * w), argnums=(0, 1))(jnp.asarray(u),
                                                                                        jnp.asarray(k))
    tu, tk = torch.from_numpy(u).requires_grad_(True), torch.from_numpy(k).requires_grad_(True)
    (tgeo.three_nn(tu, tk)[0] * torch.from_numpy(w)).sum().backward()
    for got, want in ((tu.grad.numpy(), np.asarray(gu)), (tk.grad.numpy(), np.asarray(gk))):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(want).any()
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-6 * np.abs(want[ok]).max())


def test_three_interpolate_matches_jax():
    """FlowNet3D's propagation: weights from max(dist, 1e-10) with eps 0,
    the interpolated features, and their gradient with respect to the
    features (finite with coincident points: the clamp stops the
    distances' gradient), to 1e-6."""
    u, k = coincident_pair(26)
    feats = np.random.default_rng(27).normal(size=(2, 40, 6)).astype(np.float32)

    def jax_interp(f):
        d, i = jgeo.three_nn(jnp.asarray(u), jnp.asarray(k))
        w = jgeo.three_interpolate_weights(jnp.maximum(d, 1e-10), eps=0.0)
        return jgeo.three_interpolate(f, i, w)

    tf = torch.from_numpy(feats).requires_grad_(True)
    d, i = tgeo.three_nn(torch.from_numpy(u), torch.from_numpy(k))
    w = tgeo.three_interpolate_weights(torch.clamp(d, min=1e-10), eps=0.0)
    got = tgeo.three_interpolate(tf, i, w)
    want = np.asarray(jax_interp(jnp.asarray(feats)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(tgeo.three_interpolate_weights(d).numpy(),
                               np.asarray(jgeo.three_interpolate_weights(jnp.asarray(d.numpy()))), rtol=1e-6)
    ct = np.random.default_rng(28).normal(size=want.shape).astype(np.float32)
    (got * torch.from_numpy(ct)).sum().backward()
    want_g = np.asarray(jax.grad(lambda f: jnp.sum(jax_interp(f) * ct))(jnp.asarray(feats)))
    assert np.isfinite(want_g).all()
    np.testing.assert_allclose(tf.grad.numpy(), want_g, rtol=0, atol=1e-6 * np.abs(want_g).max())


# -- K16: ball_group_pallas (PPFNet's grouping) -------------------------------

def jax_ball_group(radius, nsample, x, q, itself, vals):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jsampling.ball_group_pallas(radius, nsample, jnp.asarray(x), jnp.asarray(q),
                                                      jnp.asarray(itself), jnp.asarray(vals), tile_s=64))


def with_normals(x, seed):
    n = np.random.default_rng(seed).normal(size=x.shape)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return np.concatenate([x, n], -1).astype(np.float32)


def every_point(b, n):
    return np.broadcast_to(np.arange(n, dtype=np.int32), (b, n)).copy()


BG_CASES = {
    # (radius, nsample, xyz, queries, itself, values): nsample * C % 128 == 0, the JAX kernel's lane limit
    "rpmnet_like": lambda: (0.6, 64, normal(2, 200, 40), normal(2, 200, 40), every_point(2, 200),
                            with_normals(normal(2, 200, 40), 41)),
    "short_rows": lambda: (0.3, 64, normal(2, 150, 42), normal(2, 150, 42)[:, :70], every_point(2, 70),
                           with_normals(normal(2, 150, 42), 43)),
    "ragged_c16": lambda: (1.0, 8, normal(3, 131, 44), normal(3, 131, 44), every_point(3, 131),
                           np.random.default_rng(45).normal(size=(3, 131, 16)).astype(np.float32)),
}


@pytest.mark.parametrize("case", list(BG_CASES))
def test_ball_group_plain_version_matches_jax_kernel_in_interpret_mode(case):
    """The plain version against the JAX kernel: the same columns, the
    values to 1e-5 of the largest (the JAX kernel gathers through a bf16
    hi/lo split, ~2^-17 of a value; the port gathers exactly). No launch on
    a CPU tensor."""
    radius, nsample, x, q, itself, vals = BG_CASES[case]()
    before = dict(LAUNCHES)
    got = tsampling.ball_group_pallas(radius, nsample, *map(torch.from_numpy, (x, q, itself, vals)))
    assert LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == (q.shape[0], q.shape[1], nsample, vals.shape[-1])
    want = jax_ball_group(radius, nsample, x, q, itself, vals)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(vals).max()
    if case == "short_rows":  # padded slots hold the center's own values
        pads = (got.numpy()[:, :, -1] == vals[:, :70]).all(-1)
        assert pads.all()


def away_from_the_radius(radius, x, q, margin=1e-5):
    d = ((q[:, :, None, :].astype(np.float64) - x[:, None, :, :]) ** 2).sum(-1)
    return bool((np.abs(d - radius**2) > margin).all())


@pytest.mark.parametrize("case", ["rpmnet_like", "short_rows"])
def test_ball_group_plain_version_matches_jax_oracle(case):
    """Away from the radius (every squared distance 1e-5 from r^2, asserted)
    the plain version is bit-equal to JAX's oracle,
    ``query_ball_point_excluding_self`` + ``index_points`` (exact gathers on
    both sides)."""
    from learning3d_tpu.ops import grouping as jgrouping

    radius, nsample, x, q, itself, vals = BG_CASES[case]()
    assert away_from_the_radius(radius, x, q)
    got = tsampling.ball_group_reference(radius, nsample, *map(torch.from_numpy, (x, q, itself, vals)))
    idx = jgrouping.query_ball_point_excluding_self(radius, nsample, jnp.asarray(x), jnp.asarray(q),
                                                    jnp.asarray(itself))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgeo.index_points(jnp.asarray(vals), idx)))


def test_ball_group_centers_outside_the_cloud():
    """A center index outside [0, N) leaves no column out and pads with
    zeros, as the TPU kernel's one-hot gather does (its one-hot row matches
    no column)."""
    x = normal(1, 64, 46)
    vals = with_normals(x, 47)
    itself = np.array([[-1, 64, 5]], np.int32)
    q = x[:, [0, 1, 5]]
    got = tsampling.ball_group_reference(0.8, 64, *map(torch.from_numpy, (x, q, itself, vals))).numpy()
    want = jax_ball_group(0.8, 64, x, q, itself, vals)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(vals).max()
    assert (got[0, :2, -1] == 0).all()
    d = ((x[0] - x[0, 0]) ** 2).sum(-1)
    inside = np.flatnonzero(d <= np.float32(0.64))
    np.testing.assert_array_equal(got[0, 0, : len(inside), :3], x[0][inside])  # point 0 itself among them
    d = ((x[0] - x[0, 5]) ** 2).sum(-1)
    inside = np.flatnonzero((d <= np.float32(0.64)) & (np.arange(64) != 5))  # point 5 left out
    np.testing.assert_array_equal(got[0, 2, : len(inside), :3], x[0][inside])
    assert (got[0, 2, len(inside) :] == vals[0, 5]).all()


def test_ball_group_kernel_limit_and_argument_checks():
    assert tsampling.ball_group_kernel_limit(1024, 64, 6) is None
    assert "K16" in tsampling.ball_group_kernel_limit(1024, 2**31, 6)
    x = torch.zeros(1, 10, 3)
    with pytest.raises(ValueError):
        tsampling.ball_group_pallas(0.5, 4, x, x, torch.zeros(1, 9, dtype=torch.int32), x)
    with pytest.raises(ValueError):
        tsampling.ball_group_pallas(0.5, 4, x, x, torch.zeros(1, 10), x)
    with pytest.raises(ValueError):
        tsampling.ball_group_pallas(0.5, 4, x, x, torch.zeros(1, 10, dtype=torch.int32), x[:, :5])
