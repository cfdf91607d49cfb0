"""K7 (knn_neighbors) of the port: its plain version against the JAX kernel
in Pallas interpret mode and against a numpy stable argsort, the edge
features against the JAX package's with its TPU guard open, the wrapper's
dispatch and limits, and the DGCNN train-mode forward, its gradients and
its BatchNorm statistics against nnx, on the CPU at a small size.

Where the JAX package would take another branch on the CPU (its
``get_graph_feature_fused`` runs the Pallas kernel only on a TPU), the test
opens that guard (``use_pallas=True``) and runs the kernel in interpret
mode, as tests/test_pallas_interpret.py does.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.experimental.pallas import tpu as pltpu

from learning3d_tpu.kernels import edgeconv as jedge
from learning3d_tpu.models import DGCNN as JDGCNN
from learning3d_tpu.models import dgcnn as jdgcnn_mod
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import edgeconv as tedge
from learning3d_tpu_torch.kernels.dgcnn_fused import exact_knn
from learning3d_tpu_torch.models import DGCNN
from learning3d_tpu_torch.models import dgcnn as tdgcnn_mod
from learning3d_tpu_torch.ops import geometry as tgeo
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from torch_port_util import cloud, lattice_cloud, nnx_flat, randomize_bn

# k = 33 and 64: the selection's list of 64 keys a row (two a lane), on
# the card; "lattice_k64" has exact ties at the 64th neighbor
CASES = {"random": (2, 200, 20), "ragged": (3, 100, 7), "lattice": (2, 120, 20), "k_past_k5": (1, 64, 40),
         "k33": (2, 150, 33), "lattice_k64": (2, 200, 64)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def case_cloud(name):
    b, n, k = CASES[name]
    return (lattice_cloud(b, n, seed=4) if name.startswith("lattice") else cloud(b, n, seed=5)), k


def numpy_knn(x, k):
    """Stable argsort of the exact per-coordinate squared differences,
    summed in the kernel's order (d0*d0 + d1*d1) + d2*d2."""
    d = x[:, :, None, :] - x[:, None, :, :]
    dist = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    return np.argsort(dist, axis=-1, kind="stable")[..., :k]


@pytest.mark.parametrize("name", list(CASES))
def test_k7_plain_matches_jax_interpret_and_numpy(name):
    """The plain version's selection (``exact_knn``) equal to numpy's
    stable argsort (ties to the smaller index:
    the lattice has exact ties at the k-th neighbor); coordinates equal to
    the JAX kernel's in interpret mode (tile_n=128, so N=100 and N=200 are
    ragged), bit for bit: on the CPU its hi/lo one-hot products are exact."""
    x, k = case_cloud(name)
    idx = numpy_knn(x, k)
    np.testing.assert_array_equal(exact_knn(torch.from_numpy(x), k).numpy(), idx)
    want_xyz = np.take_along_axis(x[:, None], idx[..., None], axis=2)
    nbr = tedge.knn_neighbors_reference(torch.from_numpy(x), k)
    np.testing.assert_array_equal(nbr.numpy(), want_xyz)
    np.testing.assert_array_equal(tedge.knn_neighbors_pallas(torch.from_numpy(x), k).numpy(), want_xyz)
    with pltpu.force_tpu_interpret_mode():
        jax_xyz = np.asarray(jedge.knn_neighbors_pallas(jnp.asarray(x), k, tile_n=128))
    np.testing.assert_array_equal(nbr.numpy(), jax_xyz)


def test_lattice_ties_decide_the_kth_neighbor():
    """The lattice case is one where ties matter: some query's k-th and
    (k+1)-th distances are equal, and the smaller index is kept."""
    x, k = case_cloud("lattice")
    d = x[:, :, None, :] - x[:, None, :, :]
    dist = np.sort((d ** 2).sum(-1), axis=-1)
    assert (dist[..., k - 1] == dist[..., k]).any()


def test_lattice_ties_decide_the_64th_neighbor():
    """At k = 64 too, where the kernel's list holds two keys a lane: some
    query's 64th and 65th distances are equal, and the smaller index is
    kept."""
    x, k = case_cloud("lattice_k64")
    d = x[:, :, None, :] - x[:, None, :, :]
    dist = np.sort((d ** 2).sum(-1), axis=-1)
    assert (dist[..., k - 1] == dist[..., k]).any()


@pytest.mark.parametrize("channels", [3, 8])
def test_get_graph_feature_fused_matches_jax(channels):
    """3 channels: the JAX package's fused path with its guard open (K7 in
    interpret mode), equal bit for bit, the center beside each neighbor.
    8 channels: both fall through to ``ops.geometry.get_graph_feature``
    (matmul-expanded distances in f32; 1e-6 for the two frameworks' sums)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 96, channels)).astype(np.float32)
    k = 9
    got = tedge.get_graph_feature_fused(torch.from_numpy(x), k).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jedge.get_graph_feature_fused(jnp.asarray(x), k, use_pallas=True))
    assert got.shape == want.shape == (2, 96, k, 2 * channels)
    if channels == 3:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[..., 3:], np.broadcast_to(x[:, :, None], got[..., 3:].shape))
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got, tgeo.get_graph_feature(torch.from_numpy(x), k).numpy())


def test_k7_wrapper_dispatch_and_limits():
    """A CPU tensor takes the plain version and counts no launch; any other
    device without a kernel raises ValueError; a shape past K7's limit
    raises NotImplementedError naming it, off the CPU, before any launch."""
    x = torch.from_numpy(cloud(2, 50, seed=7))
    before = dict(LAUNCHES)
    edges = tedge.edge_features(x, 6)
    assert LAUNCHES == before
    torch.testing.assert_close(edges, tedge.edge_features_reference(x, 6), rtol=0, atol=0)
    torch.testing.assert_close(edges[..., :3], tedge.knn_neighbors_reference(x, 6), rtol=0, atol=0)
    meta = torch.empty(1, 64, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tedge.knn_neighbors_pallas(meta, 40)
    with pytest.raises(NotImplementedError, match="k <= 64"):
        tedge.knn_neighbors_pallas(torch.empty(1, 128, 3, device="meta"), 65)
    with pytest.raises(NotImplementedError, match="N <= 16384"):
        tedge.edge_features(torch.empty(1, 16385, 3, device="meta"), 20)
    with pytest.raises(NotImplementedError, match="k <= N"):
        tedge.edge_features(torch.empty(1, 8, 3, device="meta"), 9)
    with pytest.raises(ValueError, match=r"\(B, N, 3\)"):
        tedge.edge_features(torch.empty(1, 8, 4, device="meta"), 2)
    assert tedge.kernel_limit(4096, 32) is None and tedge.kernel_limit(16384, 64) is None
    assert tedge.kernel_limit(64, 0) and tedge.kernel_limit(20, 21)
    assert LAUNCHES == before


# -- the DGCNN encoder in train mode ------------------------------------------

def jax_dgcnn(k=5, seed=0, emb=64):
    net = JDGCNN(emb_dims=emb, k=k, rngs=nnx.Rngs(seed))
    randomize_bn(net, np.random.default_rng(seed))
    return net


def flat_grads(grads):
    return nnx_to_torch({".".join(map(str, p)): np.asarray(v.get_value()) for p, v in nnx.to_flat_state(grads)})


@pytest.fixture
def jax_k7(monkeypatch):
    """The JAX DGCNN's edge features through its K7 in interpret mode (the
    guard a TPU would open)."""
    monkeypatch.setattr(jdgcnn_mod, "get_graph_feature_fused",
                        functools.partial(jedge.get_graph_feature_fused, use_pallas=True))
    with pltpu.force_tpu_interpret_mode():
        yield


# f32 on both sides, the same neighbors: the conv sums and the BatchNorm
# statistics in another order. Output 1e-5 of its largest value; each
# parameter gradient 1e-4 of its norm (train-mode BatchNorm's backward
# cancels most of a gradient's terms); running statistics 1e-5.
@pytest.mark.parametrize("k", [5, 40])
def test_dgcnn_train_step_matches_nnx(jax_k7, k, monkeypatch):
    """One train-mode forward and backward of DGCNN (k=40 is past K5's
    limit) in f32: the output, every parameter gradient and the BN running
    statistics after the step, against nnx with K7 in interpret mode; the
    port's edge features go through K7's entry (its plain version here)."""
    jnet = jax_dgcnn(k=k)
    tnet = load_nnx_state(DGCNN(emb_dims=64, k=k, device="cpu"), nnx_flat(jnet))
    x = cloud(2, 64, seed=8)
    w = np.random.default_rng(9).normal(size=(2, 64, 64)).astype(np.float32)
    calls = []
    plain = tedge.edge_features_reference
    monkeypatch.setattr(tedge, "edge_features_reference", lambda *a: calls.append(a[1]) or plain(*a))

    def loss(m):
        o = m(jnp.asarray(x))
        return jnp.sum(o * w), o

    jnet.train()
    (_, out_j), grads = nnx.value_and_grad(loss, has_aux=True)(jnet)  # updates jnet's statistics
    tnet.train()
    out = tnet(torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    assert calls == [k]
    out_j = np.asarray(out_j)
    assert np.abs(out.detach().numpy() - out_j).max() <= 1e-5 * np.abs(out_j).max()
    want = flat_grads(grads)
    params = dict(tnet.named_parameters())
    assert set(params) == set(want)
    for name, p in params.items():
        err = np.linalg.norm(p.grad.numpy() - want[name])
        assert err <= 1e-4 * np.linalg.norm(want[name]), name
    after = nnx_to_torch(nnx_flat(jnet))
    for name, buf in tnet.named_buffers():
        np.testing.assert_allclose(buf.numpy(), after[name], rtol=1e-5, atol=1e-6, err_msg=name)


def test_dgcnn_f32_eval_takes_k7(monkeypatch):
    """f32 eval (K5 takes bf16 only) runs the unfused chain with its edge
    features from K7's entry, on the CPU its plain version."""
    calls = []
    monkeypatch.setattr(tdgcnn_mod, "get_graph_feature_fused",
                        lambda x, k: calls.append(k) or tedge.get_graph_feature_fused(x, k))
    net = load_nnx_state(DGCNN(emb_dims=64, k=5, device="cpu"), nnx_flat(jax_dgcnn())).eval()
    with torch.no_grad():
        out = net(torch.from_numpy(cloud(1, 40, seed=10)))
    assert calls == [5] and out.shape == (1, 40, 64) and torch.isfinite(out).all()
