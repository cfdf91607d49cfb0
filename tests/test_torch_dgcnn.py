"""The port's DGCNN slice (kNN, K5's plain version, the DGCNN module)
against the JAX package, on the CPU at a small size.

On the CPU the port's K5 wrapper runs its plain version; the JAX fused
kernel runs in Pallas interpret mode, as tests/test_pallas_interpret.py
runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.experimental.pallas import tpu as pltpu

from learning3d_tpu.kernels import dgcnn_fused as jfused
from learning3d_tpu.models import DGCNN as JDGCNN
from learning3d_tpu.ops import geometry as jgeo
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import dgcnn_fused as tfused
from learning3d_tpu_torch.models import DGCNN
from learning3d_tpu_torch.ops import geometry as tgeo
from learning3d_tpu_torch.utils.jax_import import load_nnx_state
from torch_port_util import as_torch, cloud, lattice_cloud, nnx_flat, randomize_bn, rel_err

EMB = 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def jax_dgcnn(jdtype=None, k=5, seed=0):
    net = JDGCNN(emb_dims=EMB, k=k, dtype=jdtype, rngs=nnx.Rngs(seed))
    randomize_bn(net, np.random.default_rng(seed))
    net.eval()
    return net


def port_dgcnn(jnet, tdtype=None, k=5):
    net = DGCNN(emb_dims=EMB, k=k, dtype=tdtype, device="cpu")
    return load_nnx_state(net, nnx_flat(jnet)).eval()


def folded(jnet):
    pairs = [jfused._fold_bn(c.kernel[...], bn) for c, bn in zip(jnet.convs, jnet.bns)]
    return [np.asarray(w) for w, _ in pairs], [np.asarray(b) for _, b in pairs]


@pytest.mark.parametrize("kind", ["random", "lattice"])
def test_knn_matches_jax(kind):
    """Lattice: every distance is exact in f32 and ties are certain, so the
    indices must be equal (ties to the smaller index on both sides).
    Random: the selected neighbors' exact (float64) distances must equal
    the JAX selection's to 1e-5, a near-tie swap being the only allowed
    difference."""
    x = lattice_cloud(2, 120, seed=3) if kind == "lattice" else cloud(2, 150, seed=3)
    k = 20
    want = np.asarray(jgeo.knn(jnp.asarray(x), k))
    got = tgeo.knn(torch.from_numpy(x), k).numpy()
    assert got.shape == want.shape == (2, x.shape[1], k)
    if kind == "lattice":
        np.testing.assert_array_equal(got, want)
    else:
        d = ((x[:, :, None].astype(np.float64) - x[:, None]) ** 2).sum(-1)
        np.testing.assert_allclose(np.take_along_axis(d, got, -1), np.take_along_axis(d, want, -1), atol=1e-5)
        assert (got[..., 0] == np.arange(x.shape[1])).all()  # the point itself first


def test_knn_drops_self_and_gathers():
    x = cloud(2, 40, seed=4)
    xt = torch.from_numpy(x)
    idx = tgeo.knn(xt, 4, include_self=False)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jgeo.knn(jnp.asarray(x), 4, include_self=False)))
    feats = tgeo.get_graph_feature(xt, k=4)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jgeo.get_graph_feature(jnp.asarray(x), k=4)), atol=1e-6)
    np.testing.assert_array_equal(tgeo.index_points(xt, idx[:, :, 0]).numpy(),
                                  np.asarray(jgeo.index_points(jnp.asarray(x), jnp.asarray(idx[:, :, 0].numpy()))))


def test_square_distance_feature_width_matches_jax():
    """At a feature width (C=64) the channel-by-channel f32 accumulation
    against JAX's HIGHEST-precision einsum: f32 sums in another order,
    rtol 1e-5 (distinct clouds keep every distance far from 0)."""
    rng = np.random.default_rng(14)
    src, dst = rng.normal(size=(2, 60, 64)).astype(np.float32), rng.normal(size=(2, 50, 64)).astype(np.float32)
    want = np.asarray(jgeo.square_distance(jnp.asarray(src), jnp.asarray(dst)))
    got = tgeo.square_distance(torch.from_numpy(src), torch.from_numpy(dst))
    assert got.shape == (2, 60, 50)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


def test_square_distance_holds_no_channel_axis():
    """No (N, M, C) intermediate: at N=M=512, C=64 the largest single
    allocation under the profiler is an (N, M) f32 buffer (1 MiB), where
    the elementwise product over C would be 64 MiB."""
    from torch.profiler import ProfilerActivity, profile

    src, dst = torch.randn(512, 64), torch.randn(512, 64)
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        d = tgeo.square_distance(src, dst)
    assert d.shape == (512, 512)
    largest = max(evt.self_cpu_memory_usage for evt in prof.events())
    assert largest <= 512 * 512 * 4, largest


def test_exact_knn_ties_to_smaller_index():
    """K5's own selection (exact per-coordinate differences) on the lattice
    against a float64 stable argsort."""
    x = lattice_cloud(2, 200, seed=5)
    d = ((x[:, :, None].astype(np.float64) - x[:, None]) ** 2).sum(-1)
    want = np.argsort(d, axis=-1, kind="stable")[..., :20]
    np.testing.assert_array_equal(tfused.exact_knn(torch.from_numpy(x), 20).numpy(), want)


def jax_approx_picks(x, k):
    """The JAX kernel's approx-kNN picks, tile by tile as ``_fused_kernel``
    makes them: the (tile_n, Np) distance tile of the zero-padded queries,
    ``_selection_matrix`` and k rounds of ``_pick_mask``."""
    B, N, _ = x.shape
    tile_n = min(256, -(-N // 128) * 128)
    Np = -(-N // tile_n) * tile_n
    xp = jnp.asarray(np.pad(x, ((0, 0), (0, Np - N), (0, 0))))
    out = np.zeros((B, Np, k), np.int64)
    for b in range(B):
        p = xp[b]
        for t in range(0, Np, tile_n):
            q = p[t:t + tile_n]
            d0, d1, d2 = (q[:, c][:, None] - p[:, c][None, :] for c in range(3))
            d = d0 * d0 + d1 * d1 + d2 * d2
            col = jnp.broadcast_to(jnp.arange(Np, dtype=jnp.int32)[None, :], d.shape)
            sel, masked = jfused._selection_matrix(d, col, N, True)
            m = jnp.min(sel, axis=1)
            for j in range(k):
                eq = jfused._pick_mask(sel, m, col, N, True)
                out[b, t:t + tile_n, j] = np.asarray(jnp.argmax(eq, axis=1))
                sel = jnp.where(eq, masked, sel)
                m = jnp.min(sel, axis=1)
    return out[:, :N]


@pytest.mark.parametrize("n_pts", [200, 256, 320])
def test_approx_selection_matches_jax(n_pts):
    """The port's approx-kNN selection equals the JAX kernel's index for
    index (k=20). N=200 pads the one query tile with origin rows, which
    count toward its maxd; N=320 gives two query tiles of 256 rows, each
    with its own maxd (and so its own scale)."""
    x = cloud(2, n_pts, seed=70 + n_pts)
    got = tfused.approx_knn_indices(torch.from_numpy(x), 20).numpy()
    np.testing.assert_array_equal(got, jax_approx_picks(x, 20))
    scale = tfused.approx_knn_scale(torch.from_numpy(x))
    assert scale.shape == (2, 2 if n_pts == 320 else 1)
    if n_pts == 320:
        assert (scale[:, 0] != scale[:, 1]).any()


@pytest.mark.parametrize("n_pts", [256, 200])
def test_k5_approx_plain_matches_jax_interpret(n_pts):
    """K5's plain version with approx_knn=True against the JAX kernel with
    approx_knn=True in interpret mode, in f32 (the tolerance of the exact
    f32 case below: the same neighbors, f32 sums in another order)."""
    jnet = jax_dgcnn()
    ws, bs = folded(jnet)
    x = cloud(2, n_pts, seed=80 + n_pts)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfused.dgcnn_encode_fused(jnp.asarray(x), jnet.convs, jnet.bns, 5, dot_dtype=jnp.float32,
                                                    approx_knn=True), np.float32)
    got = tfused.dgcnn_encode_kernel(torch.from_numpy(x), as_torch(ws), as_torch(bs), 5, dot_dtype=torch.float32,
                                     approx_knn=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_dgcnn_approx_flag_routes_to_approx_selection():
    """``DGCNN(approx_knn=True)`` in bf16 eval runs K5 (its plain version on
    the CPU) with the approx selection."""
    jnet = jax_dgcnn(jnp.bfloat16)
    net = load_nnx_state(DGCNN(emb_dims=EMB, k=5, dtype=torch.bfloat16, approx_knn=True, device="cpu"),
                         nnx_flat(jnet)).eval()
    assert net.approx_knn
    x = torch.from_numpy(cloud(2, 128, seed=90))
    ws, bs = zip(*(tfused.fold_bn(c, bn) for c, bn in zip(net.convs, net.bns)))
    with torch.inference_mode():
        torch.testing.assert_close(net(x), tfused.dgcnn_encode_reference(x, list(ws), list(bs), 5,
                                                                         approx_knn=True), rtol=0, atol=0)


# f32: the same operands and neighbors, only f32 sums in another order
# (atol as the JAX package's own interpret test). bf16: the same bf16
# roundings, but a sum in another order can round an activation to the
# neighbouring bf16 value (2^-8 relative), which a later stage carries.
@pytest.mark.parametrize("n_pts", [256, 200])
@pytest.mark.parametrize("name,tol", [("f32", None), ("bf16", 2e-2)])
def test_k5_plain_matches_jax_interpret(n_pts, name, tol):
    jnet = jax_dgcnn()
    ws, bs = folded(jnet)
    x = cloud(2, n_pts, seed=n_pts)
    jdt, tdt = (jnp.float32, torch.float32) if name == "f32" else (jnp.bfloat16, torch.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfused.dgcnn_encode_fused(jnp.asarray(x), jnet.convs, jnet.bns, 5, dot_dtype=jdt),
                          np.float32)
    launches = LAUNCHES["dgcnn_encode_fused"]
    got = tfused.dgcnn_encode_kernel(torch.from_numpy(x), as_torch(ws), as_torch(bs), 5, dot_dtype=tdt)
    assert LAUNCHES["dgcnn_encode_fused"] == launches  # the plain version is no launch
    assert got.dtype == tdt and got.shape == (2, n_pts, EMB)
    if tol is None:
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    else:
        assert rel_err(got, want) <= tol


def test_fold_bn_matches_jax():
    jnet = jax_dgcnn()
    tnet = port_dgcnn(jnet)
    for jc, jb, tc, tb in zip(jnet.convs, jnet.bns, tnet.convs, tnet.bns):
        jw, jbias = jfused._fold_bn(jc.kernel[...], jb)
        tw, tbias = tfused.fold_bn(tc, tb)
        np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tbias.detach().numpy(), np.asarray(jbias), rtol=1e-6, atol=1e-6)


# f32: both sides run the unfused path (kNN, gather, conv/BN/ReLU, k-max);
# f32 sums in another order. bf16: the JAX CPU path is the unfused chain
# with every conv and BN step rounded to bf16; the port runs K5's plain
# version (BN folded into f32 weights, as the JAX TPU kernel does): bf16
# roundings in different places through five stages.
@pytest.mark.parametrize("name,tol", [("f32", 1e-5), ("bf16", 3e-2)])
def test_dgcnn_module_matches_jax(name, tol):
    jdt, tdt = (None, None) if name == "f32" else (jnp.bfloat16, torch.bfloat16)
    jnet = jax_dgcnn(jdt, seed=1)
    tnet = port_dgcnn(jnet, tdt)
    x = cloud(2, 100, seed=6)
    want = jnet(jnp.asarray(x))
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x))
    assert got.shape == (2, 100, EMB)
    assert got.dtype == (torch.bfloat16 if name == "bf16" else torch.float32)
    assert rel_err(got, want) <= tol


def test_dgcnn_input_shape_bcn():
    tnet = port_dgcnn(jax_dgcnn())
    bcn = DGCNN(emb_dims=EMB, k=5, input_shape="bcn", device="cpu")
    bcn.load_state_dict(tnet.state_dict())
    bcn.eval()
    x = torch.from_numpy(cloud(1, 30, seed=7))
    with torch.inference_mode():
        np.testing.assert_array_equal(bcn(x.transpose(1, 2)).numpy(), tnet(x).numpy())
    with pytest.raises(ValueError):
        DGCNN(input_shape="nbc", device="cpu")


def test_fused_gate():
    """K5 is taken for eval-mode BN and bf16 convs with N >= k only."""
    net = DGCNN(emb_dims=EMB, k=5, dtype=torch.bfloat16, device="cpu")
    x = torch.zeros(1, 8, 3)
    assert not tfused.dgcnn_fused_ok(x, net.convs, net.bns, 5)  # train mode
    net.eval()
    assert tfused.dgcnn_fused_ok(x, net.convs, net.bns, 5)
    assert not tfused.dgcnn_fused_ok(torch.zeros(1, 4, 3), net.convs, net.bns, 5)
    f32 = DGCNN(emb_dims=EMB, k=5, device="cpu").eval()
    assert not tfused.dgcnn_fused_ok(x, f32.convs, f32.bns, 5)


@pytest.mark.parametrize("n_pts,k,emb,ok", [
    (64, 32, 64, True), (64, 33, 64, False), (40, 40, 64, False), (4096, 20, 64, True),
    (4097, 20, 64, False), (64, 5, 96, False), (8, 9, 64, False),
])
def test_fused_gate_holds_the_kernel_limits(n_pts, k, emb, ok, monkeypatch):
    """The gate admits exactly the shapes the kernel takes (k <= 32,
    k <= N <= 4096, emb % 64 == 0), so no shape it admits reaches the
    kernel's ValueError; a meta tensor stands in for the cloud. A shape it
    turns away takes the unfused chain, whose edge features come from K7's
    entry (recorded here, handing back CPU zeros: a meta tensor has no
    kernel)."""
    from learning3d_tpu_torch.models import dgcnn as tdgcnn

    net = DGCNN(emb_dims=emb, k=k, dtype=torch.bfloat16, device="cpu").eval()
    x = torch.empty(1, n_pts, 3, device="meta")
    assert tfused.dgcnn_fused_ok(x, net.convs, net.bns, k) is ok
    assert (tfused.kernel_limit(n_pts, k, emb) is None) is ok
    if ok:
        ws = [torch.empty(tuple(c.weight.shape[::-1])) for c in net.convs]
        tfused._check_kernel_args(torch.zeros(1, n_pts, 3), ws, [torch.empty(w.shape[1]) for w in ws], k,
                                  torch.bfloat16)
    else:
        calls = []

        def edges(x, k):
            calls.append(k)
            return torch.zeros(*x.shape[:2], k, 6)

        monkeypatch.setattr(tdgcnn, "get_graph_feature_fused", edges)
        assert net(x).shape == (1, n_pts, emb)
        assert calls == [k]


def test_unfused_path_off_the_cpu_raises():
    """Off the CPU the unfused path runs K7's wrapper, which launches the
    kernel on a CUDA tensor and raises on any other device rather than run
    plain torch. A meta tensor stands in for such a device here;
    tests/test_torch_cuda.py checks the card itself."""
    net = DGCNN(emb_dims=EMB, k=5, device="cpu").eval()  # f32: the fused gate is off
    with pytest.raises(ValueError, match="no kernel"):
        net(torch.empty(1, 32, 3, device="meta"))
    ws, bs = (as_torch(a) for a in folded(jax_dgcnn()))
    with pytest.raises(ValueError, match="no kernel"):
        tfused.dgcnn_encode_kernel(torch.empty(1, 32, 3, device="meta"), ws, bs, 5)


@pytest.mark.parametrize("bad", ["dtype", "emb", "k", "dot_dtype"])
def test_kernel_argument_checks(bad):
    """What the CUDA wrapper refuses before any launch."""
    ws, bs = (as_torch(a) for a in folded(jax_dgcnn()))
    x, k, dot = torch.zeros(2, 16, 3), 5, torch.bfloat16
    if bad == "dtype":
        x = x.double()
    elif bad == "emb":
        ws[-1], bs[-1] = ws[-1][:, :40].contiguous(), bs[-1][:40]
    elif bad == "k":
        k = 17
    else:
        dot = torch.float32
    with pytest.raises(ValueError):
        tfused._check_kernel_args(x, ws, bs, k, dot)
