"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA card (sm_90a) and nvcc; without one they skip. The
JAX package is not needed: run them on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def folded(rng, emb, device):
    dims = [3, 64, 64, 64, 128, emb]
    ws = [torch.from_numpy(rng.normal(0, i**-0.5, (i, o)).astype(np.float32)).to(device)
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.from_numpy(rng.normal(0, 0.1, o).astype(np.float32)).to(device) for o in dims[1:]]
    return ws, bs


# emb 1024: two full channel groups; 640: a full and a partial group;
# 64: one warp n-tile. N: full tiles, a ragged tail, fewer points than a tile.
@pytest.mark.parametrize("batch,n_pts,emb", [(4, 1024, 1024), (3, 1000, 640), (2, 37, 64)])
def test_k1_matches_plain(cuda, batch, n_pts, emb):
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.pointnet_fused import oracle_chain, pointnet_pooled_kernel

    rng = np.random.default_rng(emb)
    ws, bs = folded(rng, emb, cuda)
    x = torch.from_numpy(rng.normal(size=(batch, n_pts, 3)).astype(np.float32)).to(cuda)
    before = LAUNCHES["pointnet_pooled_kernel"]
    got = pointnet_pooled_kernel(x, ws, bs).float()
    want = oracle_chain(x, ws, bs).float()
    torch.cuda.synchronize()
    assert LAUNCHES["pointnet_pooled_kernel"] == before + 1
    # same bf16 operands on both sides; only the f32 summation order differs
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


# The Hopper design's edges: B = 1 (one cloud: the most channel groups), 32
# (groups of 256: one round of blocks) and 256 (groups of 512: four rounds);
# N = 1, 63, 64, 65 (a warpgroup's half of a 128-point tile, one off each
# side) and 1000 (a ragged last tile); emb = 64 (one channel block), 640 and
# 1024.
@pytest.mark.parametrize("batch,n_pts,emb", [(1, 1, 64), (1, 63, 640), (32, 64, 1024), (32, 65, 640),
                                             (32, 1000, 1024), (1, 1000, 64), (256, 1024, 1024), (32, 1024, 64)])
def test_k1_hopper_edges_match_plain(cuda, batch, n_pts, emb):
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.pointnet_fused import oracle_chain, pointnet_pooled_kernel

    rng = np.random.default_rng(batch * 7 + n_pts + emb)
    ws, bs = folded(rng, emb, cuda)
    x = torch.from_numpy(rng.normal(size=(batch, n_pts, 3)).astype(np.float32)).to(cuda)
    before = LAUNCHES["pointnet_pooled_kernel"]
    got = pointnet_pooled_kernel(x, ws, bs).float()
    want = oracle_chain(x, ws, bs).float()
    torch.cuda.synchronize()
    assert LAUNCHES["pointnet_pooled_kernel"] == before + 1
    assert got.shape == (batch, emb) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


@pytest.mark.parametrize("emb", [64, 640, 1024])
def test_k1_pack_is_the_stated_layout(cuda, emb):
    """K1's weight pack writes ``packed_weights``' bytes."""
    from learning3d_tpu_torch.kernels import _build
    from learning3d_tpu_torch.kernels.pointnet_fused import packed_weights

    ws, _ = folded(np.random.default_rng(emb), emb, cuda)
    want = packed_weights(ws)
    img = torch.full_like(want, 0xAB, device=cuda)
    err = _build.library().pointnet_pack_bf16(*(w.data_ptr() for w in ws[1:]), emb, img.data_ptr(),
                                              torch.cuda.current_stream().cuda_stream)
    _build.check(err, "pointnet_pack_bf16")
    torch.cuda.synchronize()
    assert torch.equal(img.cpu(), want)


def test_k1_refuses_bad_arguments(cuda):
    from learning3d_tpu_torch.kernels.pointnet_fused import pointnet_pooled_kernel

    ws, bs = folded(np.random.default_rng(0), 128, cuda)
    with pytest.raises(ValueError):
        pointnet_pooled_kernel(torch.zeros(2, 8, 3, device=cuda), ws, bs, dot_dtype=torch.float32)
    with pytest.raises(ValueError):
        pointnet_pooled_kernel(torch.zeros(2, 8, 3, device=cuda, dtype=torch.float16), ws, bs)


def dgcnn_weights(rng, emb, device):
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, emb)]
    ws = [torch.from_numpy(rng.normal(0, i**-0.5, (i, o)).astype(np.float32)).to(device) for i, o in dims]
    bs = [torch.from_numpy(rng.normal(0, 0.1, o).astype(np.float32)).to(device) for _, o in dims]
    return ws, bs


def lattice_cloud(rng, batch, n_pts):
    """Points of an integer lattice scaled by 0.25 (exact in f32), in a
    random order: exact distance ties decide the k-th neighbor."""
    side = int(np.ceil(n_pts ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return np.stack([0.25 * grid[rng.permutation(len(grid))[:n_pts]] for _ in range(batch)]).astype(np.float32)


# full width at a small batch, a ragged N, a lattice with exact ties, and a
# narrow emb
@pytest.mark.parametrize("case,batch,n_pts,k,emb", [
    ("full", 2, 1024, 20, 512), ("ragged", 3, 1000, 20, 512), ("ties", 2, 1000, 20, 512),
    ("narrow", 2, 100, 7, 64),
])
def test_k5_matches_plain(cuda, case, batch, n_pts, k, emb):
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.dgcnn_fused import dgcnn_encode_kernel, dgcnn_encode_reference

    rng = np.random.default_rng(n_pts + emb)
    ws, bs = dgcnn_weights(rng, emb, cuda)
    x = lattice_cloud(rng, batch, n_pts) if case == "ties" else rng.normal(size=(batch, n_pts, 3))
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    before = LAUNCHES["dgcnn_encode_fused"]
    got = dgcnn_encode_kernel(x, ws, bs, k).float()
    want = dgcnn_encode_reference(x, ws, bs, k).float()
    torch.cuda.synchronize()
    assert LAUNCHES["dgcnn_encode_fused"] == before + 1
    assert got.shape == want.shape == (batch, n_pts, emb)
    # same neighbors and bf16 operands on both sides; only f32 sum orders differ
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


def k5_check(x, ws, bs, k, approx=False):
    """K5 against its plain version: one launch, finite, within 2e-2 of max
    (the same neighbors and bf16 operands; f32 sums in another order)."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.dgcnn_fused import dgcnn_encode_kernel, dgcnn_encode_reference

    before = LAUNCHES["dgcnn_encode_fused"]
    got = dgcnn_encode_kernel(x, ws, bs, k, approx_knn=approx).float()
    want = dgcnn_encode_reference(x, ws, bs, k, approx_knn=approx).float()
    torch.cuda.synchronize()
    assert LAUNCHES["dgcnn_encode_fused"] == before + 1
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


# the Hopper design's edges: k = 1, 20, 32 (the selection's list of 32);
# N = k, 127, 128, 129 (one 128-row block of two warpgroups and a ragged
# second), 1000 and 4096 (the largest cloud); emb 64 (one W5 slab), 128 (a
# full turn of the 2-slab ring) and 1024 (sixteen slabs); exact and approx
@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("k,n_pts,emb", [(1, 1, 64), (1, 127, 1024), (20, 20, 64), (20, 128, 128), (20, 129, 1024),
                                         (20, 1000, 64), (20, 1000, 1024), (32, 32, 1024), (32, 1000, 64),
                                         (32, 4096, 128)])
def test_k5_hopper_edges_match_plain(cuda, k, n_pts, emb, approx):
    rng = np.random.default_rng(1000 * k + n_pts + emb + approx)
    ws, bs = dgcnn_weights(rng, emb, cuda)
    x = torch.from_numpy(rng.normal(size=(1 if n_pts == 4096 else 2, n_pts, 3)).astype(np.float32)).to(cuda)
    k5_check(x, ws, bs, k, approx)


# a lattice's exact distance ties at k = 20 and 32, exact and approximate
@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("k", [20, 32])
def test_k5_lattice_matches_plain(cuda, k, approx):
    rng = np.random.default_rng(50 + k + approx)
    ws, bs = dgcnn_weights(rng, 512, cuda)
    k5_check(torch.from_numpy(lattice_cloud(rng, 2, 1000)).to(cuda), ws, bs, k, approx)


def test_dgcnn_pack_follows_weights_on_card(cuda):
    """The bf16 eval DGCNN runs K5 on its pack, built once: an in-place edit
    of a conv weight and of a BatchNorm statistic rebuild it, and the output
    follows the plain version on the edited weights."""
    from learning3d_tpu_torch.kernels.dgcnn_fused import dgcnn_encode_reference, fold_bn
    from learning3d_tpu_torch.models import DGCNN

    torch.manual_seed(0)
    net = DGCNN(emb_dims=128, k=20, dtype=torch.bfloat16, device=cuda).eval()
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 300, 3)).astype(np.float32)).to(cuda)

    def plain():
        folded = [fold_bn(c, bn) for c, bn in zip(net.convs, net.bns)]
        return dgcnn_encode_reference(x, [w for w, _ in folded], [b for _, b in folded], 20).float()

    with torch.no_grad():
        first, want_first = net(x).float(), plain()
        pack = net.bf16_weights()
        assert net.bf16_weights() is pack
        net.convs[1].weight.mul_(-1.5)
        net.bns[3].running_mean.add_(0.2)
        second, want_second = net(x).float(), plain()
    torch.cuda.synchronize()
    assert net.bf16_weights() is not pack
    for got, want in ((first, want_first), (second, want_second)):
        assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()
    assert not torch.equal(first, second)


# the pointer's shape, the SVD head's (D=512, Dv=3), ragged N and M, small
# odd shapes, and the pointer's and head's in f32 (f32 DCP's calls). The
# edges of the wgmma instance's tiles: key counts that are no multiple of
# the 128-key tile (200, 768, 1000), query counts past or below the 128
# rows of a block (37, 300, 768), PRNet's f32 pointer (768 <-> 1024 keys),
# Dv = 256 in two slabs, D = 80 (a partial 64-column box) with one narrow
# slab, and the head's instance at a ragged shape; that instance's 8-column
# slabs at wider V (D = 512 with Dv = 40, and Dv = 100, no multiple of 8).
@pytest.mark.parametrize("batch,heads,n,m,d,dv,dtype", [
    (2, 4, 1024, 1024, 128, 128, torch.bfloat16), (2, 1, 1024, 1024, 512, 3, torch.bfloat16),
    (2, 4, 1000, 1000, 128, 128, torch.bfloat16), (1, 2, 37, 70, 64, 40, torch.bfloat16),
    (2, 4, 1024, 1024, 128, 128, torch.float32), (2, 1, 1024, 1024, 512, 3, torch.float32),
    (1, 2, 37, 200, 128, 128, torch.bfloat16), (1, 2, 768, 1000, 128, 128, torch.bfloat16),
    (2, 4, 768, 1024, 128, 128, torch.float32), (2, 4, 1024, 768, 128, 128, torch.float32),
    (1, 2, 300, 1000, 256, 256, torch.bfloat16), (1, 2, 130, 70, 80, 8, torch.bfloat16),
    (1, 1, 100, 200, 512, 3, torch.bfloat16), (1, 2, 100, 200, 512, 40, torch.bfloat16),
    (1, 1, 37, 70, 128, 100, torch.bfloat16),
])
def test_k6_matches_plain(cuda, batch, heads, n, m, d, dv, dtype):
    """K6 against its plain version. The output is in q's dtype, as the TPU
    kernel's: on f32 inputs it is f32, not rounded to bf16, and within
    chip_smoke's K6_F32_TOL (the same rounding of the operands and of P; f32
    sums in another order)."""
    import chip_smoke
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.attention import attention_pallas, attention_reference

    rng = np.random.default_rng(n + d)
    q, k = (torch.from_numpy(rng.normal(size=(batch, heads, s, d)).astype(np.float32)).to(cuda, dtype)
            for s in (n, m))
    v = torch.from_numpy(rng.normal(size=(batch, heads, m, dv)).astype(np.float32)).to(cuda, dtype)
    before = LAUNCHES["attention_pallas"]
    got = attention_pallas(q, k, v)
    want = attention_reference(q, k, v).float()
    torch.cuda.synchronize()
    assert LAUNCHES["attention_pallas"] == before + 1
    assert got.dtype == dtype and got.shape == want.shape == (batch, heads, n, dv)
    if dtype == torch.float32:
        assert (got != got.to(torch.bfloat16).float()).any()
    # the same rounding of P on both sides; f32 sums in another order
    tol = chip_smoke.K6_F32_TOL if dtype == torch.float32 else 2e-2
    assert (got.float() - want).abs().max().item() <= tol * want.abs().max().item()


def test_unfused_dgcnn_raises_on_card(cuda):
    """The unfused DGCNN path runs through K7 on the card; past K7's limit
    (k <= 64) it raises NotImplementedError naming the limit instead of
    running plain torch."""
    from learning3d_tpu_torch.models import DGCNN

    net = DGCNN(emb_dims=64, k=65, device=cuda).eval()  # f32: the fused gate is off
    with pytest.raises(NotImplementedError, match="k <= 64"):
        net(torch.zeros(1, 128, 3, device=cuda))


def test_k5_gate_refuses_what_the_kernel_refuses(cuda):
    """k=40 is past K5's k <= 32: the gate turns it away, and the bf16 eval
    DGCNN runs the unfused chain, its edge features from K7 (launched once,
    K5 never), to a finite result. A k past K7's own limit (k <= 64) raises
    NotImplementedError naming that limit."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.models import DGCNN

    net = DGCNN(emb_dims=64, k=40, dtype=torch.bfloat16, device=cuda).eval()
    x = torch.from_numpy(np.random.default_rng(40).normal(size=(2, 128, 3)).astype(np.float32)).to(cuda)
    before = dict(LAUNCHES)
    with torch.no_grad():
        out = net(x)
    torch.cuda.synchronize()
    assert LAUNCHES["knn_neighbors_pallas"] == before["knn_neighbors_pallas"] + 1
    assert LAUNCHES["dgcnn_encode_fused"] == before["dgcnn_encode_fused"]
    assert out.shape == (2, 128, 64) and torch.isfinite(out.float()).all()
    past = DGCNN(emb_dims=64, k=65, dtype=torch.bfloat16, device=cuda).eval()
    with pytest.raises(NotImplementedError, match="k <= 64"):
        past(x)


# the DCP shape, exact ties (lattice), a ragged N, k past K5's limit, K7's
# largest k, and a cloud of exactly k points; k = 32 and 33, where the
# selection's list grows from 32 keys to 64; N = 4096 and 4097 (K5's limit
# and one past it, a ragged last block of rows) and 16384 (K7's limit, the
# shared memory full) and one short of it; lattices with exact ties at the
# k-th neighbor at k = 33 and 64
@pytest.mark.parametrize("case,batch,n_pts,k", [
    ("full", 4, 1024, 20), ("ties", 2, 1000, 20), ("ragged", 3, 1000, 20), ("k40", 2, 1024, 40),
    ("k64", 1, 777, 64), ("n_eq_k", 2, 9, 9), ("k32", 2, 1024, 32), ("k33", 2, 1024, 33),
    ("n4096", 1, 4096, 20), ("n4097", 2, 4097, 40), ("n16384", 1, 16384, 64), ("n16383", 1, 16383, 33),
    ("ties_k33", 2, 1000, 33), ("ties_k64", 2, 1000, 64),
])
def test_k7_matches_plain(cuda, case, batch, n_pts, k):
    """K7's edge features, and the neighbor xyz sliced from them, against
    the plain version, bit for bit: the same exact distances and order, the
    coordinates copied. The cloud's points are distinct, so equal
    coordinates are equal neighbor indices."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.edgeconv import (
        edge_features, edge_features_reference, knn_neighbors_pallas, knn_neighbors_reference)

    rng = np.random.default_rng(n_pts + k)
    ties = case.startswith("ties")
    x = lattice_cloud(rng, batch, n_pts) if ties else rng.normal(size=(batch, n_pts, 3))
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    assert all(torch.unique(c, dim=0).shape[0] == n_pts for c in x)
    if ties:  # some row's k-th and (k+1)-th distances are equal
        dist = torch.sort(((x[:, :, None] - x[:, None]) ** 2).sum(-1), dim=-1).values  # exact on the lattice
        assert bool((dist[..., k - 1] == dist[..., k]).any())
    before = LAUNCHES["knn_neighbors_pallas"]
    edges = edge_features(x, k)
    xyz = knn_neighbors_pallas(x, k)
    torch.cuda.synchronize()
    assert LAUNCHES["knn_neighbors_pallas"] == before + 2
    assert edges.shape == (batch, n_pts, k, 6)
    assert torch.equal(edges, edge_features_reference(x, k))
    assert torch.equal(xyz, knn_neighbors_reference(x, k))


def test_k7_refuses_past_its_limit(cuda):
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.edgeconv import edge_features

    before = LAUNCHES["knn_neighbors_pallas"]
    for n_pts, k, match in ((128, 65, "k <= 64"), (16385, 20, "N <= 16384"), (8, 9, "k <= N"), (8, 0, "1 <= k")):
        with pytest.raises(NotImplementedError, match=match):
            edge_features(torch.zeros(1, n_pts, 3, device=cuda), k)
    with pytest.raises(ValueError, match=r"\(B, N, 3\)"):
        edge_features(torch.zeros(1, 8, 2, device=cuda), 2)
    assert LAUNCHES["knn_neighbors_pallas"] == before


def dcp_state(rng, emb):
    """Numpy-seeded DCP(DGCNN(emb)) weights with non-trivial BN statistics,
    as a flat nnx state."""
    import chip_smoke

    return chip_smoke.random_dcp_state(rng, emb)


def test_dcp_train_step_kernels_match_plain(cuda, tmp_path):
    """One f32 DCP(DGCNN(512)) train step through the Trainer on K7 and K6
    against the same step on their plain versions (chip_smoke's
    plain_versions): the loss, every gradient and the BN running statistics,
    at chip_smoke's tolerances (K7 exact; K6's f32 output, P rounded to
    bf16 in another sum order; the attention's backward through the oracle
    on both sides). The control, K6's output rounded to bf16, must fail
    them."""
    import chip_smoke
    from learning3d_tpu_torch.data import RegistrationData, SyntheticModelNet40, batch_iterator, to_device
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.models import DCP, DGCNN
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    state = dcp_state(np.random.default_rng(12), 512)
    cfg = TrainConfig(task="dcp", batch_size=4, ckpt_dir=str(tmp_path))
    data = RegistrationData("DCP", SyntheticModelNet40(num_points=1024, size=4))
    batch = to_device(next(batch_iterator(data, 4)), cuda)
    before = LAUNCHES["knn_neighbors_pallas"], LAUNCHES["attention_pallas"]
    worst = chip_smoke.step_agreement(lambda: Trainer(cfg, load_nnx_state(DCP(DGCNN(emb_dims=512), device=cuda),
                                                                          state), device=cuda),
                                      batch, chip_smoke.DCP_STEP_TOL, chip_smoke.plain_versions,
                                      chip_smoke.DCP_ZERO_GRADIENT_BIASES, chip_smoke.DCP_NOISE_TOL,
                                      control=chip_smoke.k6_bf16_output)
    # the kernels' run and the control's: K7 twice and K6 seven times each
    assert (LAUNCHES["knn_neighbors_pallas"] - before[0], LAUNCHES["attention_pallas"] - before[1]) == (4, 14)
    assert worst["grad"] <= chip_smoke.DCP_STEP_TOL < worst["control"]["grad"]


def test_dcp_f32_serves_on_card(cuda):
    """f32 DCP(DGCNN(512)) in eval mode, new on the card: the encoder takes
    the unfused chain through K7 (twice a chunk), the pointer and head K6
    (seven times), K5 never; finite outputs, rotations, and r and est_t
    within chip_smoke's DCP_TOL of the same model on the plain versions."""
    import chip_smoke
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.models import DCP, DGCNN
    from learning3d_tpu_torch.serve import InferenceEngine
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    model = load_nnx_state(DCP(DGCNN(emb_dims=512), device=cuda), dcp_state(np.random.default_rng(13), 512)).eval()
    rng = np.random.default_rng(14)
    template, source = (rng.normal(size=(6, 1024, 3)).astype(np.float32) for _ in range(2))
    engine = InferenceEngine(model, batch_size=4, device=cuda)
    reset_launches()
    out = engine(template, source)
    torch.cuda.synchronize()
    assert (LAUNCHES["knn_neighbors_pallas"], LAUNCHES["attention_pallas"], LAUNCHES["dgcnn_encode_fused"]) == \
        (4, 14, 0)
    assert all(np.isfinite(v).all() for v in out.values())
    R = out["est_R"].astype(np.float64)
    assert np.abs(R @ np.swapaxes(R, -1, -2) - np.eye(3)).max() <= chip_smoke.ROT_TOL
    with chip_smoke.plain_versions():
        plain = engine(template, source)
    for key in ("r", "est_t"):
        err = np.abs(out[key] - plain[key]).max()
        assert err <= chip_smoke.DCP_TOL * np.abs(plain[key]).max(), key


def side_by_side(rng, m, d, dv, dtype):
    """q, k, v of B=1, H=2, N=100 with the second head's K and V all inf:
    a kernel that read the second head's rows for the first head's keys
    past M would give 0 * inf = NaN in the first head's P V, though the
    mask makes their p exactly 0."""
    import chip_smoke

    q = torch.from_numpy(rng.normal(size=(1, 2, 100, d)).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.normal(size=(1, 2, m, d)).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.normal(size=(1, 2, m, dv)).astype(np.float32)).to(dtype)
    return chip_smoke.inf_second_head(q, k, v)


# the wgmma instance (D = 128, 256) and the mma.sync one (the head, D = 512)
@pytest.mark.parametrize("d,dv", [(128, 128), (256, 256), (512, 3)])
def test_k6_heads_do_not_read_each_other(cuda, d, dv):
    import chip_smoke
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.attention import attention_pallas, attention_reference

    q, k, v = (t.to(cuda) for t in side_by_side(np.random.default_rng(d), 200, d, dv, torch.bfloat16))
    before = LAUNCHES["attention_pallas"]
    got = attention_pallas(q, k, v)
    want = attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES["attention_pallas"] == before + 1
    chip_smoke.check_first_head(got, want, f"K6 D={d}", 2e-2)


def test_k6_instance_by_shape(cuda):
    """The C entry names the instance it runs for (D, Dv): the wgmma one
    for the pointer's shapes, the mma.sync one for the head's and for V
    rows that no TMA map takes."""
    from learning3d_tpu_torch.kernels import _build

    lib = _build.library()
    for d, dv in ((128, 128), (256, 256), (64, 40), (80, 8)):
        assert lib.attention_bf16_instance(d, dv).decode().startswith("wgmma+TMA"), (d, dv)
    for d, dv in ((512, 3), (128, 3), (512, 128), (128, 100)):
        assert lib.attention_bf16_instance(d, dv).decode().startswith("mma.sync"), (d, dv)


def test_k6_wide_values_raise(cuda):
    """Dv=640 at the pointer's shapes, past K6's Dv <= 512: the attention
    raises NotImplementedError naming K6's limit instead of running the
    plain chain on the card."""
    from learning3d_tpu_torch.utils.transformer import _attention

    q = torch.zeros(1, 1, 256, 128, device=cuda, dtype=torch.bfloat16)
    v = torch.zeros(1, 1, 256, 640, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="Dv <= 512"):
        _attention(q, q, v)


def test_k6_wide_values_match_plain(cuda):
    """Dv=256 (DCP over DGCNN(emb 1024): d_k = 256) runs pass 2 in two
    128-wide slabs; against the plain version, as the other K6 cases."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.attention import attention_pallas, attention_reference

    rng = np.random.default_rng(256)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 4, 1024, 256)).astype(np.float32)).to(cuda, torch.bfloat16)
               for _ in range(3))
    before = LAUNCHES["attention_pallas"]
    got = attention_pallas(q, k, v).float()
    want = attention_reference(q, k, v).float()
    torch.cuda.synchronize()
    assert LAUNCHES["attention_pallas"] == before + 1
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


def test_dcp_emb1024_serves_bf16(cuda):
    """bf16 DCP(DGCNN(emb_dims=1024)): the pointer's attention has Dv = 256,
    which K6 takes now; served through InferenceEngine, finite, rotations."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.models import DCP, DGCNN
    from learning3d_tpu_torch.serve import InferenceEngine

    gen = torch.Generator(device="cpu").manual_seed(0)
    bf16 = torch.bfloat16
    model = DCP(DGCNN(emb_dims=1024, dtype=bf16, generator=gen, device=cuda), dtype=bf16, generator=gen,
                device=cuda).eval()
    rng = np.random.default_rng(1024)
    template, source = (rng.normal(size=(3, 512, 3)).astype(np.float32) for _ in range(2))
    before = LAUNCHES["attention_pallas"]
    out = InferenceEngine(model, batch_size=2, device=cuda)(template, source)
    assert LAUNCHES["attention_pallas"] - before == 2 * 6  # the head (D = 1024) is past K6's gate
    assert out["r"].shape == (3, 512, 1024) and all(np.isfinite(v).all() for v in out.values())
    R = out["est_R"].astype(np.float64)
    assert np.abs(R @ np.swapaxes(R, -1, -2) - np.eye(3)).max() <= 1e-3


def int8_chain(rng, emb, device):
    """Random int8 PointNet stages for K2: (w1, b1, qlayers)."""
    ws, bs = folded(rng, emb, device)
    qlayers = []
    for w, b in zip(ws[1:], bs[1:]):
        s_w = w.abs().amax(0).clamp_min(1e-12) / 127
        qlayers.append((torch.clamp(torch.round(w / s_w), -127, 127).to(torch.int8), s_w, b,
                        float(rng.uniform(0.01, 0.05))))
    return ws[0], bs[0], qlayers


# emb 1024: two channel groups; 640: a partial group; N: full tiles, a
# ragged tail, fewer points than a tile.
@pytest.mark.parametrize("batch,n_pts,emb", [(4, 1024, 1024), (3, 1000, 640), (2, 37, 64)])
def test_k2_matches_plain(cuda, batch, n_pts, emb):
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.pointnet_fused import (
        PointNetInt8Weights, pn_int8_reference, pointnet_pooled_int8_kernel)

    rng = np.random.default_rng(emb + 1)
    pack = PointNetInt8Weights(*int8_chain(rng, emb, cuda))
    x = torch.from_numpy(rng.normal(size=(batch, n_pts, 3)).astype(np.float32)).to(cuda)
    before = LAUNCHES["pointnet_pooled_int8"]
    got = pointnet_pooled_int8_kernel(x, pack)
    want = pn_int8_reference(x, pack)
    torch.cuda.synchronize()
    assert LAUNCHES["pointnet_pooled_int8"] == before + 1
    assert got.dtype == torch.float32 and got.shape == want.shape == (batch, emb)
    # the same int8 products, stage 1's sum in the same order and the same
    # two roundings an epilogue: bit for bit
    assert torch.equal(got, want)


# The Hopper design's edges, every case ragged somewhere: B = 1 (one cloud,
# the most channel groups), 3, 32 (groups of 256: one round of blocks) and
# 256 (one group of 1024: two rounds); N = 1, 127 (a warpgroup's half past
# N), 1000 (a ragged last tile) and 1024; emb = 64 (one channel block), 512
# and 1024 (sixteen blocks: four stage-5 groups a tile).
@pytest.mark.parametrize("batch,n_pts,emb", [(1, 1, 64), (1, 127, 1024), (3, 1000, 512), (3, 1, 1024),
                                             (32, 127, 512), (32, 1000, 1024), (32, 1024, 64), (256, 1024, 1024),
                                             (256, 1000, 512), (256, 127, 64)])
def test_k2_hopper_edges_match_plain(cuda, batch, n_pts, emb):
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.pointnet_fused import (
        PointNetInt8Weights, pn_int8_reference, pointnet_pooled_int8_kernel)

    rng = np.random.default_rng(batch * 7 + n_pts + emb)
    pack = PointNetInt8Weights(*int8_chain(rng, emb, cuda))
    x = torch.from_numpy(rng.normal(size=(batch, n_pts, 3)).astype(np.float32)).to(cuda)
    before = LAUNCHES["pointnet_pooled_int8"]
    got = pointnet_pooled_int8_kernel(x, pack)
    want = pn_int8_reference(x, pack)
    torch.cuda.synchronize()
    assert LAUNCHES["pointnet_pooled_int8"] == before + 1
    assert got.shape == want.shape == (batch, emb)
    assert torch.equal(got, want)


def test_k2_plan_is_the_stated_plan(cuda):
    """The C entry's work split is kernels/pointnet_fused.py's k2_plan."""
    from learning3d_tpu_torch.kernels import _build
    from learning3d_tpu_torch.kernels.pointnet_fused import k2_plan

    lib = _build.library()
    for batch in (1, 3, 32, 100, 256, 600):
        for emb in (64, 512, 640, 1024, 2048):
            assert lib.pointnet_int8_group(batch, emb, 132) == k2_plan(batch, emb, 132)[0], (batch, emb)


@pytest.mark.parametrize("case,batch,n_pts,k,emb", [
    ("full", 2, 1024, 20, 512), ("ragged", 3, 1000, 20, 512), ("ties", 2, 1000, 20, 512),
    ("narrow", 2, 100, 7, 64),
])
def test_k9_matches_plain(cuda, case, batch, n_pts, k, emb):
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.dgcnn_fused import (
        DGCNNInt8Weights, dgcnn_encode_int8_kernel, dgcnn_int8_reference)

    rng = np.random.default_rng(n_pts + emb + 1)
    ws, bs = dgcnn_weights(rng, emb, cuda)
    pack = DGCNNInt8Weights(ws, bs, (0.02, 0.03, 0.03, 0.04))
    x = lattice_cloud(rng, batch, n_pts) if case == "ties" else rng.normal(size=(batch, n_pts, 3))
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    before = LAUNCHES["dgcnn_encode_fused_int8"]
    got = dgcnn_encode_int8_kernel(x, pack, k).float()
    want = dgcnn_int8_reference(x, pack, k).float()
    torch.cuda.synchronize()
    assert LAUNCHES["dgcnn_encode_fused_int8"] == before + 1
    assert got.shape == want.shape == (batch, n_pts, emb)
    # same neighbors and int8 operands; an epilogue may round otherwise
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


def k9_case(rng, batch, n_pts, emb, lattice=False):
    ws, bs = dgcnn_weights(rng, emb, torch.device("cuda"))
    from learning3d_tpu_torch.kernels.dgcnn_fused import DGCNNInt8Weights

    pack = DGCNNInt8Weights(ws, bs, (0.02, 0.03, 0.03, 0.04))
    x = lattice_cloud(rng, batch, n_pts) if lattice else rng.normal(size=(batch, n_pts, 3))
    return torch.from_numpy(x.astype(np.float32)).cuda(), pack


def k9_check(x, pack, k, approx=False):
    """K9 against its plain version: one launch, within 2e-2 of max, and
    bit for bit (the same neighbors, exact integer products, the same
    epilogue roundings)."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.dgcnn_fused import dgcnn_encode_int8_kernel, dgcnn_int8_reference

    before = LAUNCHES["dgcnn_encode_fused_int8"]
    got = dgcnn_encode_int8_kernel(x, pack, k, approx_knn=approx)
    want = dgcnn_int8_reference(x, pack, k, approx_knn=approx)
    torch.cuda.synchronize()
    assert LAUNCHES["dgcnn_encode_fused_int8"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * want.float().abs().max().item()
    assert torch.equal(got, want)
    return got


# the Hopper design's edges: k = 1, 20, 32 (the selection's list of 32);
# N = k, 63, 64, 65 (one 64-row block and a ragged second), 1000 and 4096
# (the largest cloud, its coordinates filling the shared region); emb 64
# (two W5 slabs) and 512
@pytest.mark.parametrize("k,n_pts,emb", [(1, 1, 64), (1, 63, 64), (20, 20, 512), (20, 63, 64), (20, 64, 512),
                                         (20, 65, 512), (20, 1000, 64), (20, 4096, 512), (32, 32, 64),
                                         (32, 65, 512), (32, 1000, 512), (32, 4096, 64)])
def test_k9_hopper_edges_match_plain(cuda, k, n_pts, emb):
    rng = np.random.default_rng(1000 * k + n_pts + emb)
    x, pack = k9_case(rng, 1 if n_pts == 4096 else 2, n_pts, emb)
    k9_check(x, pack, k)


# a lattice's exact distance ties at k = 20 and 32, exact and approximate
@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("k", [20, 32])
def test_k9_lattice_matches_plain(cuda, k, approx):
    x, pack = k9_case(np.random.default_rng(k + approx), 2, 1000, 512, lattice=True)
    k9_check(x, pack, k, approx)


@pytest.mark.parametrize("scale", [1.0, 1e-9])
def test_k9_xw1_quantization_matches_plain(cuda, scale):
    """The wrapper's two-kernel quantization of xw1 against the plain
    version's torch chain (`_xw1_int8`): int8 rows and scale equal, the
    scale's floor of 1e-6 / 127 included (scale 1e-9)."""
    from learning3d_tpu_torch.kernels import _build
    from learning3d_tpu_torch.kernels.dgcnn_fused import _xw1_int8

    rng = np.random.default_rng(int(1 / scale) % 1000)
    x = torch.from_numpy((scale * rng.normal(size=(3, 1000, 3))).astype(np.float32)).to(cuda)
    wn1 = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32)).to(cuda)
    want_q, want_s = _xw1_int8(x, wn1)
    xw1 = torch.matmul(x.to(torch.bfloat16).to(torch.float32), wn1.to(torch.bfloat16).to(torch.float32))
    q = torch.empty(xw1.shape, device=cuda, dtype=torch.int8)
    s = torch.empty((), device=cuda, dtype=torch.float32)
    amax = torch.empty((), device=cuda, dtype=torch.int32)
    _build.check(_build.library().dgcnn_quant_xw1(xw1.data_ptr(), q.data_ptr(), s.data_ptr(), amax.data_ptr(),
                                                   xw1.numel(), torch.cuda.current_stream().cuda_stream),
                 "dgcnn_quant_xw1")
    torch.cuda.synchronize()
    assert torch.equal(s, want_s) and torch.equal(q, want_q)


def test_k9_two_calls_give_equal_bits(cuda):
    from learning3d_tpu_torch.kernels.dgcnn_fused import dgcnn_encode_int8_kernel

    x, pack = k9_case(np.random.default_rng(5), 4, 1024, 512)
    a = dgcnn_encode_int8_kernel(x, pack, 20)
    b = dgcnn_encode_int8_kernel(x, pack, 20)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# the pointer's shape, ragged N and M, D = 256; the edges of the 128-key
# tiles (M = 768 and 1000 with N = 768 and 100), and D = 512, where the
# Q tile and a K stage take 64 KB each and the rings are shallower
@pytest.mark.parametrize("int8_pv", [True, False])
@pytest.mark.parametrize("batch,heads,n,m,d", [(2, 4, 1024, 1024, 128), (1, 2, 1000, 1000, 128), (1, 1, 37, 200, 256),
                                               (1, 2, 768, 768, 128), (1, 1, 100, 1000, 128), (1, 1, 40, 300, 512)])
def test_k10_matches_plain(cuda, int8_pv, batch, heads, n, m, d):
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.attention import attention_int8_kernel, attention_int8_reference

    rng = np.random.default_rng(n + d + int8_pv)
    q, k, v = (torch.from_numpy(rng.integers(-127, 128, (batch, heads, s, d)).astype(np.int8)).to(cuda)
               for s in (n, m, m))
    s_q, s_k, s_v = 0.004, 0.005, 0.03
    before = LAUNCHES["attention_int8"]
    got = attention_int8_kernel(q, k, v, s_q, s_k, s_v, int8_pv).float()
    want = attention_int8_reference(q, k, v, s_q, s_k, s_v, int8_pv).float()
    torch.cuda.synchronize()
    assert LAUNCHES["attention_int8"] == before + 1
    assert got.shape == want.shape == (batch, heads, n, d)
    # exact int8 products; exp, the row sum's order and round(127 p) may
    # differ by an ulp or one step of P
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


@pytest.mark.parametrize("int8_pv", [True, False])
def test_k10_heads_do_not_read_each_other(cuda, int8_pv):
    """B=1, H=2, M=200 with the second head's keys all 127: a kernel that
    read them for the first head's keys past M would move its softmax. The
    hybrid mode's bf16 V can hold inf: through the C entry with the second
    head's V inf, a read of it for the first head's keys past M would give
    0 * inf = NaN there. (The int8 mode's V^T has the keys on its inner
    axis, bounded by Mp; no int8 value is non-finite.)"""
    import chip_smoke
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.attention import attention_int8_kernel, attention_int8_reference

    rng = np.random.default_rng(2 + int8_pv)
    q, k, v = (torch.from_numpy(rng.integers(-127, 128, (1, 2, s, 128)).astype(np.int8)) for s in (100, 200, 200))
    k[:, 1] = 127
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    s_q, s_k, s_v = 0.004, 0.005, 0.03
    before = LAUNCHES["attention_int8"]
    got = attention_int8_kernel(q, k, v, s_q, s_k, s_v, int8_pv).float()
    want = attention_int8_reference(q, k, v, s_q, s_k, s_v, int8_pv).float()
    torch.cuda.synchronize()
    assert LAUNCHES["attention_int8"] == before + 1
    for h in range(2):
        assert (got[:, h] - want[:, h]).abs().max().item() <= 2e-2 * want[:, h].abs().max().item(), h
    if not int8_pv:
        v16 = v.to(torch.bfloat16)
        v16[:, 1] = float("inf")
        chip_smoke.check_first_head(chip_smoke.k10_hybrid_bf16_v(q, k, v16, s_q, s_k, s_v), want, "K10 inf V", 2e-2)


@pytest.mark.parametrize("int8_pv", [True, False])
@pytest.mark.parametrize("m,d", [(1024, 128), (1000, 128), (200, 256), (33, 512)])
def test_k10_values_match_plain(cuda, int8_pv, m, d):
    """K10's V as its P.V reads it, made by attention_int8_values: V^T in
    key_order, zero past M, equal to its plain version int8_pv_values; V
    widened to bf16, equal to torch's."""
    from learning3d_tpu_torch.kernels import _build
    from learning3d_tpu_torch.kernels.attention import PV_KEYS, int8_pv_values

    rng = np.random.default_rng(m + d)
    v = torch.from_numpy(rng.integers(-128, 128, (3, m, d)).astype(np.int8)).to(cuda)
    mp = -(-m // PV_KEYS) * PV_KEYS
    want = int8_pv_values(v.cpu()).to(cuda) if int8_pv else v.to(torch.bfloat16)
    got = torch.full_like(want, 7)
    stream = torch.cuda.current_stream().cuda_stream
    _build.check(_build.library().attention_int8_values(v.data_ptr(), got.data_ptr(), 3, m, mp if int8_pv else m, d,
                                                        int(int8_pv), stream), "attention_int8_values")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def quantized_layer(kind, d, heads, d_ff, batch, n, device, seed):
    """A port encoder or decoder layer with numpy-seeded weights and
    LayerNorm affines, quantized by ``quantize_transformer_layer`` on a
    calibration pass, wrapped as K11's fused layer; and bf16 inputs."""
    from learning3d_tpu_torch import quant
    from learning3d_tpu_torch.utils import transformer

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    cls = transformer._EncoderLayer if kind == "encoder" else transformer._DecoderLayer
    layer = cls(d, heads, d_ff, dtype=torch.bfloat16, generator=gen, device=device).eval()
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if name.endswith((".a", ".b")):
                p.copy_(torch.from_numpy(rng.normal(1.0 if name.endswith(".a") else 0.0, 0.1, p.shape)
                                         .astype(np.float32)))
    x, mem = (torch.from_numpy(rng.normal(size=(batch, n, d)).astype(np.float32)).to(device, torch.bfloat16)
              for _ in range(2))
    args = (x,) if kind == "encoder" else (x, mem)
    return quant.quantize_transformer_layer(layer, lambda lyr: lyr(*args)), args


def assert_tie_flip_close(got, want, atol=2e-4, max_abs=0.08, frac=0.01):
    """The JAX package's K11 tolerance (tests/test_transformer_int8.py): an
    f32 sum in another order flips round(x / s) at a .5 tie, rarely."""
    d = (got.float() - want.float()).abs()
    assert d.max().item() < max_abs, d.max().item()
    assert (d > atol).float().mean().item() < frac, (d > atol).float().mean().item()


# the DCP pointer's shape (B cut to 4), a wider head (d=1024, one head:
# d_k = 1024, the largest the gate admits) and N=512
@pytest.mark.parametrize("int8_pv", [True, False])
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
@pytest.mark.parametrize("batch,n,d,heads,d_ff", [(4, 1024, 512, 4, 1024), (2, 256, 1024, 1, 512),
                                                  (2, 512, 256, 2, 200)])
def test_k11_matches_plain(cuda, kind, int8_pv, batch, n, d, heads, d_ff):
    from learning3d_tpu_torch import quant
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels import transformer_int8 as k11

    assert k11.fused_layer_ok(n, d, heads)
    layer, args = quantized_layer(kind, d, heads, d_ff, batch, n, cuda, seed=n + d)
    wrap = (quant.QuantEncoderLayerFused if kind == "encoder" else quant.QuantDecoderLayerFused)(layer, int8_pv)
    name = f"{kind}_layer_int8"
    before = LAUNCHES[name]
    with torch.inference_mode():
        got = wrap(*args)
        ref = getattr(k11, f"{name}_reference")
        want = ref(*args, wrap.weights(), wrap.scales, n_heads=heads, int8_pv=int8_pv)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (batch, n, d)
    assert_tie_flip_close(got, want)


def k11_pack(rng, d, d_ff, heads, device):
    """A decoder layer's FusedLayerWeights on random int8 weights and f32
    scale, bias and LayerNorm vectors, with its plain weight dict."""
    from learning3d_tpu_torch.kernels import transformer_int8 as k11

    def mat(i, o):
        return torch.from_numpy(rng.integers(-127, 128, (i, o)).astype(np.int8)).to(device)

    def vec(c, lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, c).astype(np.float32)).to(device)

    w = {}
    for p in ("", "x"):
        for m in ("q", "k", "v", "o"):
            w[f"{p}w{m}"], w[f"{p}sw{m}"], w[f"{p}b{m}"] = mat(d, d), vec(d, 1e-4, 1e-3), vec(d, -0.1, 0.1)
    w["w1"], w["sw1"], w["b1"] = mat(d, d_ff), vec(d_ff, 1e-4, 1e-3), vec(d_ff, -0.1, 0.1)
    w["w2"], w["sw2"], w["b2"] = mat(d_ff, d), vec(d, 1e-4, 1e-3), vec(d, -0.1, 0.1)
    for i in (1, 2, 3):
        w[f"ln{i}a"], w[f"ln{i}b"] = vec(d, 0.9, 1.1), vec(d, -0.1, 0.1)
    sc = k11.LayerScales(0.03, 0.05, 0.05, 0.04, 0.006, 0.03, 0.02, s_y2=0.03, s_mem=0.03, s_q2=0.05, s_k2=0.05,
                         s_v2=0.04, s_att2=0.006)
    return k11.FusedLayerWeights(w, sc, heads, decoder=True), w, sc


def int8_tensor(rng, shape, device, lo=-127, hi=128):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int8)).to(device)


# S2 against its plain counterpart, bit for bit, in each epilogue: Q|K|V and
# the cross K|V (requant), FF1 (ReLU + requant; d_ff 200 is padded to 256),
# Wo on a bf16 residual to f32 and FF2 on an f32 residual to bf16 (dequant +
# bias + residual); ragged rows (B N % 128 != 0)
@pytest.mark.parametrize("rows", [2 * 1024, 3 * 333])
@pytest.mark.parametrize("stage", ["qkv", "xkv", "ff1", "o", "ff2"])
def test_k11_gemm_matches_plain(cuda, stage, rows):
    from learning3d_tpu_torch.kernels import transformer_int8 as k11

    rng = np.random.default_rng(rows + len(stage))
    d, d_ff = 512, 200
    pack, w, sc = k11_pack(rng, d, d_ff, 4, cuda)
    n_in = {"ff2": pack.ff2_w.shape[1]}.get(stage, d)
    a = int8_tensor(rng, (1, rows, n_in), cuda, 0 if stage == "ff2" else -127)
    x = torch.from_numpy(rng.normal(size=(1, rows, d)).astype(np.float32)).to(cuda)
    with torch.inference_mode():
        if stage in ("qkv", "xkv"):
            p = "" if stage == "qkv" else "x"
            names = ("q", "k", "v") if stage == "qkv" else ("k", "v")
            s_x = sc.s_y if stage == "qkv" else sc.s_mem
            s_out = {"q": sc.s_q, "k": sc.s_k, "v": sc.s_v} if stage == "qkv" else {"k": sc.s_k2, "v": sc.s_v2}
            got = k11._gemm(a, pack, stage, k11._REQUANT)
            want = torch.cat([k11._proj(a, s_x, w[f"{p}w{m}"], w[f"{p}sw{m}"], w[f"{p}b{m}"], s_out[m])
                              for m in names], dim=-1)
        elif stage == "ff1":
            got = k11._gemm(a, pack, "ff1", k11._RELU_REQUANT)
            assert not got[..., d_ff:].any()  # the padded hidden units are 0
            got = got[..., :d_ff]
            h = k11._gemm_i8(a, w["w1"])
            want = k11._quant(torch.relu(h * (k11.f32_scalar(sc.s_ff, h) * w["sw1"]) + w["b1"]), sc.s_h)
        elif stage == "o":
            res = x.to(torch.bfloat16)
            got = k11._gemm(a, pack, "o", k11._RESIDUAL, res=res, out_dtype=torch.float32)
            o = k11._gemm_i8(a, w["wo"])
            want = (res.float() + o * (k11.f32_scalar(sc.s_att, o) * w["swo"])) + w["bo"]
        else:
            got = k11._gemm(a, pack, "ff2", k11._RESIDUAL, res=x, out_dtype=torch.bfloat16)
            o = k11._gemm_i8(a[..., :d_ff], w["w2"])
            want = ((x + o * (k11.f32_scalar(sc.s_h, o) * w["sw2"])) + w["b2"]).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


# S3 against attend_heads, bit for bit, in both P.V modes: the DCP pointer's
# heads (d_k 128) on the Q|K|V buffer, d_k 256 (the wgmma instances' widest),
# d_k 1024 (the mma.sync instance), a ragged N, and the decoder's
# cross-attention (q2 of stride d against K|V of stride 2d) with M != N
@pytest.mark.parametrize("int8_pv", [True, False])
@pytest.mark.parametrize("case,batch,n,m,d,heads", [
    ("pointer", 2, 1024, 1024, 512, 4), ("dk256", 2, 512, 512, 512, 2), ("dk1024", 1, 256, 256, 1024, 1),
    ("ragged", 2, 300, 300, 512, 4), ("cross", 2, 300, 777, 512, 4), ("cross_dk256", 1, 200, 1000, 512, 2)])
def test_k11_attention_matches_plain(cuda, int8_pv, case, batch, n, m, d, heads):
    from learning3d_tpu_torch.kernels import transformer_int8 as k11

    rng = np.random.default_rng(n + m + d + heads + int8_pv)
    d_k = d // heads
    s_q, s_k, s_v, s_att = 0.05, 0.05, 0.04, 0.004
    att = (s_q * s_k / d_k**0.5, s_v, s_att)
    if case.startswith("cross"):
        q = int8_tensor(rng, (batch, n, d), cuda, -40, 41)
        kv = int8_tensor(rng, (batch, m, 2 * d), cuda, -40, 41)
        qh, kh, vh = q, kv[..., :d], kv[..., d:]
        args = (q, kv, d, 0, d)
    else:
        kv = int8_tensor(rng, (batch, n, 3 * d), cuda, -40, 41)
        qh, kh, vh = kv[..., :d], kv[..., d:2 * d], kv[..., 2 * d:]
        args = (kv, kv, d, d, 2 * d)
    with torch.inference_mode():
        got = k11._attention(*args, heads, att, int8_pv)
        split = [t.reshape(batch, t.shape[1], heads, d_k).transpose(1, 2) for t in (qh, kh, vh)]
        o = k11.attend_heads(*split, att[0], s_v, int8_pv)
        want = k11._quant(o.transpose(1, 2).reshape(batch, n, d), s_att)
    torch.cuda.synchronize()
    instance = k11.attention_instance(d_k, int8_pv)
    assert ("mma.sync" in instance) == (d_k > k11.SM90_MAX_DK), instance
    assert got.shape == want.shape == (batch, n, d)
    assert (want != 0).float().mean().item() > 0.2  # the attention output reaches past the quant's zero
    assert torch.equal(got, want), (instance, (got != want).sum().item())


def test_k11_head_map_is_the_kernels(cuda):
    """The head map that S3 encodes (C) is the one transformer_int8.head_map
    states and the CPU tests pin."""
    import ctypes

    from learning3d_tpu_torch.kernels import _build
    from learning3d_tpu_torch.kernels import transformer_int8 as k11

    for args in ((1536, 1024, 32, 4, 128, 128), (512, 300, 2, 2, 256, 64), (1024, 777, 3, 4, 128, 128)):
        out = (ctypes.c_longlong * 11)()
        ld, rows, batch, heads, d_k, box_rows = args
        assert _build.library().layer_head_map(d_k, heads, rows, batch, ld, box_rows, out) == 0
        want = k11.head_map(ld, rows, batch, heads, d_k, box_rows)
        assert tuple(out[:4]) == want["dims"] and tuple(out[4:7]) == want["strides"]
        assert tuple(out[7:]) == want["box"]


@pytest.mark.parametrize("case,batch,n_pts", [("full", 2, 1024), ("ragged", 3, 1000), ("two_tiles", 2, 320)])
def test_k5_k9_approx_match_plain(cuda, case, batch, n_pts):
    """K5 and K9 with approx_knn=True against their plain versions: the
    keys are distinct, so the same neighbors; K5's and K9's tolerances."""
    from learning3d_tpu_torch.kernels.dgcnn_fused import (
        DGCNNInt8Weights, approx_knn_indices, dgcnn_encode_int8_kernel, dgcnn_encode_kernel, dgcnn_encode_reference,
        dgcnn_int8_reference)

    rng = np.random.default_rng(n_pts + 7)
    ws, bs = dgcnn_weights(rng, 512, cuda)
    pack = DGCNNInt8Weights(ws, bs, (0.02, 0.03, 0.03, 0.04))
    x = torch.from_numpy(rng.normal(size=(batch, n_pts, 3)).astype(np.float32)).to(cuda)
    for got, want in ((dgcnn_encode_kernel(x, ws, bs, 20, approx_knn=True),
                       dgcnn_encode_reference(x, ws, bs, 20, approx_knn=True)),
                      (dgcnn_encode_int8_kernel(x, pack, 20, approx_knn=True),
                       dgcnn_int8_reference(x, pack, 20, approx_knn=True))):
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= 2e-2 * want.float().abs().max().item()
    assert approx_knn_indices(x, 20).shape == (batch, n_pts, 20)


def pool_inputs(rng, batch, n_pts, emb, dtype, device, repeat=None):
    """ReLU'd activations (many zeros, so a few critical points win many
    channels, as in PointNet) and weights of the fused tail. ``repeat``: every
    point is a copy of one of the first ``repeat`` points (exact ties)."""
    x = np.maximum(rng.normal(size=(batch, n_pts, 128)), 0.0).astype(np.float32)
    if repeat:
        x = x[:, np.arange(n_pts) % repeat]
    w = rng.normal(0, 128**-0.5, (128, emb)).astype(np.float32)
    c = rng.normal(0, 0.1, emb).astype(np.float32)
    return [torch.from_numpy(a).to(device).to(dt) for a, dt in ((x, dtype), (w, dtype), (c, dtype))]


# the same operands on both sides; f32 sums in another order (and for f32
# the kernel's hi/lo bf16 split, about 2^-16 of each product)
POOL_TOL = 1e-4


# The Hopper design's edges besides: B = 67 and 133, not a multiple of the
# persistent grid's blocks a channel group (a last round of clouds that
# leaves blocks idle); N = 999, a ragged last tile of 64 (f32) or 128 (bf16)
# points; E = 128 (one channel group, two Gram quadrants a warpgroup), 384
# (a full and a half group) and 2048 (four groups)
@pytest.mark.parametrize("case,batch,n_pts,emb,dtype", [
    ("full", 4, 1024, 1024, torch.bfloat16), ("f32", 4, 1024, 1024, torch.float32),
    ("ragged", 3, 1000, 256, torch.bfloat16), ("tiny", 2, 37, 128, torch.float32),
    ("ties", 2, 300, 128, torch.bfloat16), ("rounds", 67, 256, 1024, torch.bfloat16),
    ("rounds_f32", 133, 130, 512, torch.float32), ("ragged_f32", 3, 999, 384, torch.float32),
    ("e128", 5, 999, 128, torch.bfloat16), ("e2048", 3, 512, 2048, torch.bfloat16),
    ("e2048_f32", 2, 200, 2048, torch.float32)])
def test_k3_matches_plain(cuda, case, batch, n_pts, emb, dtype):
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.poolgrad import pool_stats, pool_stats_reference

    rng = np.random.default_rng(n_pts + emb)
    x, w, c = pool_inputs(rng, batch, n_pts, emb, dtype, cuda, repeat=7 if case == "ties" else None)
    before = LAUNCHES["pool_stats_pallas"]
    got = pool_stats(x, w, c)
    want = pool_stats_reference(x, w, c)
    torch.cuda.synchronize()
    assert LAUNCHES["pool_stats_pallas"] == before + 1
    mx, mn, amax, amin, G, cs = got
    scale = max(want[0].abs().max().item(), want[1].abs().max().item())
    for g, r in ((mx, want[0]), (mn, want[1])):
        assert (g - r).abs().max().item() <= POOL_TOL * scale
    for g, r in ((G, want[4]), (cs, want[5])):
        assert (g - r).abs().max().item() <= POOL_TOL * r.abs().max().item()
    z = torch.matmul(x.float(), w.float()) + c.float()
    for ai, ref in ((amax, want[0]), (amin, want[1])):
        assert ai.dtype == torch.int32 and int(ai.min()) >= 0 and int(ai.max()) < n_pts
        at = torch.gather(z, 1, ai.long()[:, None, :])[:, 0]
        assert (at - ref).abs().max().item() <= POOL_TOL * scale
    if case == "ties":  # equal rows give bitwise-equal z: the first copy wins
        assert int(amax.max()) < 7 and int(amin.max()) < 7


@pytest.mark.parametrize("case,batch,n_pts,emb,dtype", [
    ("k3_picks", 4, 1024, 1024, torch.bfloat16), ("k3_picks_f32", 4, 1024, 1024, torch.float32),
    ("ragged", 3, 1000, 256, torch.bfloat16), ("one_point", 2, 512, 1024, torch.bfloat16),
    ("one_point_f32", 2, 100, 640, torch.float32), ("ragged_tile", 4, 1000, 1024, torch.bfloat16),
    ("e4096", 2, 300, 4096, torch.bfloat16), ("waves", 300, 1024, 1024, torch.bfloat16),
    ("waves_f32", 300, 1024, 1024, torch.float32)])
def test_k4_matches_plain(cuda, case, batch, n_pts, emb, dtype):
    """Indices from a real K3 run (many channels share a critical point),
    and every channel on one point; dense dx_sp with zero rows elsewhere.
    N = 1000 ends in a partial row tile (104 of 128 rows), E = 4096 is the
    C entry's limit, and 300 clouds take several waves of dx blocks and a
    partial last group of the dW warps' clouds in flight."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.poolgrad import pool_bwd, pool_bwd_reference, pool_stats

    rng = np.random.default_rng(n_pts + emb + 1)
    x, w, c = pool_inputs(rng, batch, n_pts, emb, dtype, cuda)
    if case.startswith("one_point"):
        idx = torch.full((batch, emb), 5, dtype=torch.int32, device=cuda)
    else:
        idx = pool_stats(x, w, c)[2]
    dsel = torch.from_numpy(rng.normal(size=(batch, emb)).astype(np.float32)).to(cuda)
    before = LAUNCHES["pool_bwd_pallas"]
    dx, dw = pool_bwd(idx, dsel, w, x)
    want_dx, want_dw = pool_bwd_reference(idx, dsel, w, x)
    torch.cuda.synchronize()
    assert LAUNCHES["pool_bwd_pallas"] == before + 1
    assert dx.shape == (batch, n_pts, 128) and dw.shape == (128, emb)
    assert (dx - want_dx).abs().max().item() <= POOL_TOL * want_dx.abs().max().item()
    assert (dw - want_dw).abs().max().item() <= POOL_TOL * want_dw.abs().max().item()
    touched = torch.zeros(batch, n_pts, dtype=torch.bool, device=cuda)
    touched.scatter_(1, idx.long(), True)
    assert bool((dx[~touched] == 0).all())


@pytest.mark.parametrize("emb,dtype", [(128, torch.bfloat16), (1024, torch.bfloat16), (384, torch.float32)])
def test_k3_pack_is_the_stated_layout(cuda, emb, dtype):
    """K3's weight pack writes ``stats_weight_image``'s bytes."""
    from learning3d_tpu_torch.kernels import _build
    from learning3d_tpu_torch.kernels.poolgrad import stats_weight_image

    w = pool_inputs(np.random.default_rng(emb), 1, 1, emb, dtype, cuda)[1]
    img = torch.empty(stats_weight_image(w).numel(), device=cuda, dtype=torch.uint8)
    lib = _build.library()
    err = lib.pool_stats_pack(w.data_ptr(), int(dtype == torch.float32), emb, img.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    _build.check(err, "pool_stats_pack")
    torch.cuda.synchronize()
    assert torch.equal(img.cpu(), stats_weight_image(w))


def test_k4_schedule_is_the_stated_schedule(cuda):
    """The C entry's dx_sp schedule is kernels/poolgrad.py's BWD_ROW_TILE,
    BWD_WARPS and BWD_KEY_BATCH, which the CPU emulation runs."""
    from learning3d_tpu_torch.kernels import _build
    from learning3d_tpu_torch.kernels.poolgrad import BWD_KEY_BATCH, BWD_ROW_TILE, BWD_WARPS

    lib = _build.library()
    assert [lib.pool_bwd_schedule(i) for i in range(4)] == [BWD_ROW_TILE, BWD_WARPS, BWD_KEY_BATCH, -1]


def test_k3_k4_refuse_what_they_do_not_take(cuda):
    from learning3d_tpu_torch.kernels.poolgrad import pool_bwd, pool_stats

    x = torch.zeros(2, 16, 256, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(256, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="K == 128"):
        pool_stats(x, w, torch.zeros(128, device=cuda))
    x, w = x[..., :128].contiguous(), torch.zeros(128, 4224, device=cuda, dtype=torch.bfloat16)
    idx = torch.zeros(2, 4224, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="E <= 4096"):
        pool_bwd(idx, torch.zeros(2, 4224, device=cuda), w, x)
    with pytest.raises(ValueError, match="both bf16 or both f32"):
        pool_stats(x, w.float(), torch.zeros(4224, device=cuda))


def k3_misplaced(x, W, c):
    """The control of the classifier step's check: K3 with the argmax and
    argmin of every 64th channel moved to the next point (1.6% of the
    picks), as a kernel that broke its selection on some channels would."""
    from learning3d_tpu_torch.kernels.poolgrad import pool_stats

    mx, mn, amax, amin, G, colsum = pool_stats(x, W, c)
    bad = torch.zeros_like(amax, dtype=torch.bool)
    bad[:, ::64] = True
    n_pts = x.shape[1]
    return mx, mn, torch.where(bad, (amax + 1) % n_pts, amax), torch.where(bad, (amin + 1) % n_pts, amin), G, colsum


# One step on K3/K4 against the same step on their plain versions,
# per-tensor relative error. bf16: K3 picks the same points as its plain
# version (no argmax or argmin differed in 12 weight draws of this case,
# tools/torch_cls_step_gaps.py on the H100), but sums z, G and the column
# sum in another f32 order; the Gram-matrix variance (E[z^2] - mean^2)
# cancels, the BN output is rounded to bf16 (2^-8) and the head's BN, the
# log-softmax and the backward carry it on. The plain version with exact
# (f64) sums lies as far from the f32 plain version (0.01% to 5.2% over the
# draws, median 1.5%) as the kernels do (0.1% to 6.5%, median 1.9%): the
# tolerance sits above that spread, and the control (k3_misplaced) must
# fail it. f32: K3's bf16 hi/lo split (2^-16 of a product) against the
# plain version's f32 products can pick another point for a channel whose
# two largest values lie that close, moving that channel's gradient (some
# 0.5% of an encoder gradient's norm at this size)
CLS_STEP_TOL = {torch.bfloat16: 8e-2, torch.float32: 2e-2}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_train_step_kernels_match_plain(cuda, dtype, monkeypatch):
    """One forward and backward of the PointNet-1024 classifier in train mode
    on K3/K4 against the same step on their plain versions: loss, every
    gradient and the BN running statistics; a control with misplaced K3
    picks must fail the same check."""
    from learning3d_tpu_torch.kernels import LAUNCHES, poolgrad
    from learning3d_tpu_torch.models import Classifier, PointNet
    from learning3d_tpu_torch.train import tasks
    from learning3d_tpu_torch.utils import layers

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(32, 512, 3)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, 40, 32)).to(cuda)
    dt = None if dtype == torch.float32 else dtype
    # seeded weights, so that every run tests the same step
    # (tools/torch_cls_step_gaps.py runs this case over many seeds)
    gen = torch.Generator().manual_seed(0)
    base = Classifier(PointNet(emb_dims=1024, use_bn=True, dtype=dt, generator=gen, device=cuda), 40, dtype=dt,
                      generator=gen, device=cuda)
    variants = {"kernels": (poolgrad.pool_stats, poolgrad.pool_bwd, (1, 1)),
                "plain": (poolgrad.pool_stats_reference, poolgrad.pool_bwd_reference, (0, 0)),
                "control": (k3_misplaced, poolgrad.pool_bwd, (1, 1))}
    runs = {}
    for name, (stats, bwd, want_launches) in variants.items():
        model = Classifier(PointNet(emb_dims=1024, use_bn=True, dtype=dt, device=cuda), 40, dtype=dt, device=cuda,
                           dropout_generator=torch.Generator(device=cuda).manual_seed(3))
        model.load_state_dict(base.state_dict())
        monkeypatch.setattr(layers, "pool_stats", stats)
        monkeypatch.setattr(layers, "pool_bwd", bwd)
        before = (LAUNCHES["pool_stats_pallas"], LAUNCHES["pool_bwd_pallas"])
        loss, _ = tasks.classification(model.train(), (x, y))
        loss.backward()
        torch.cuda.synchronize()
        launched = (LAUNCHES["pool_stats_pallas"] - before[0], LAUNCHES["pool_bwd_pallas"] - before[1])
        assert launched == want_launches
        runs[name] = (loss.float().item(), {n: p.grad for n, p in model.named_parameters()},
                      {n: b.clone() for n, b in model.named_buffers()})
    tol = CLS_STEP_TOL[dtype]
    # biases with no gradient in exact arithmetic: those feeding a train-mode
    # BatchNorm (the batch mean takes them out) and the last encoder BN's
    # (the head's bn1 takes a shift common to every cloud out again): their
    # rounding noise is held to 5% of the layer's weight gradient
    zero_grad = {f"feature_model.convs.{i}.bias" for i in range(5)} | {
        "feature_model.bns.4.bias", "linear1.bias", "linear2.bias"}

    def failures(run, ref):
        (lk, gk, bk), (lp, gp, bp) = run, ref
        failed = {} if abs(lk - lp) <= tol * abs(lp) else {"loss": abs(lk - lp) / abs(lp)}
        for name, g in gk.items():
            err = (g - gp[name]).norm().item()
            if name in zero_grad:
                rel, limit = err / gp[name.rsplit(".", 1)[0] + ".weight"].norm().item(), 5e-2
            else:
                rel, limit = err / gp[name].norm().item(), tol
            if not rel <= limit:
                failed[name] = rel
        for name, b in bk.items():
            if not (b - bp[name]).abs().max().item() <= tol * bp[name].abs().max().item() + 1e-6:
                failed[name] = (b - bp[name]).abs().max().item()
        return failed

    failed = failures(runs["kernels"], runs["plain"])
    assert not failed, failed
    assert failures(runs["control"], runs["plain"]), "the control passed"


# -- K12 (chamfer nearest neighbour) and K13 (approxmatch EMD) ---------------

# random clouds; a ragged pair (N, M not multiples of any tile); a lattice
# with exact distance ties (to the smaller index); one point against many
# and many against one; multistart's shape (K=8 starts x B=32 pairs)
@pytest.mark.parametrize("case,batch,n,m", [
    ("random", 4, 1024, 1024), ("ragged", 3, 1000, 136), ("ties", 2, 1000, 700), ("one_x", 2, 1, 517),
    ("one_y", 2, 300, 1), ("multistart", 256, 1024, 1024), ("fine", 2, 1024, 16384)])
def test_k12_matches_plain(cuda, case, batch, n, m):
    """Bit-equal distances and equal indices: both sides sum the exact
    per-coordinate differences' squares in one order with no FMA, and keep
    the first of equal minima."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.chamfer import _nn_oneway_reference, nn_oneway

    rng = np.random.default_rng(n + m)
    if case == "ties":
        x, y = lattice_cloud(rng, batch, n), lattice_cloud(rng, batch, m)
    else:
        x, y = (rng.normal(size=(batch, k, 3)).astype(np.float32) for k in (n, m))
    x, y = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    before = LAUNCHES["_nn_oneway_pallas"]
    d, i = nn_oneway(x, y)
    want_d, want_i = _nn_oneway_reference(x, y)
    torch.cuda.synchronize()
    assert LAUNCHES["_nn_oneway_pallas"] == before + 1
    assert d.dtype == torch.float32 and i.dtype == torch.int32 and d.shape == (batch, n)
    assert torch.equal(d, want_d)
    assert torch.equal(i, want_i)
    if case == "ties":  # the lattice really has tied nearest neighbours
        dd = ((x[:, :, None, :] - y[:, None, :, :]) ** 2).sum(-1)
        assert int((dd == d[..., None]).sum(-1).max()) > 1


def test_k12_refuses_bad_arguments(cuda):
    from learning3d_tpu_torch.kernels.chamfer import nn_oneway

    with pytest.raises(ValueError, match=r"\(B, N, 3\)"):
        nn_oneway(torch.zeros(1, 8, 2, device=cuda), torch.zeros(1, 8, 2, device=cuda))
    with pytest.raises(ValueError, match="at least one point"):
        nn_oneway(torch.zeros(1, 0, 3, device=cuda), torch.zeros(1, 8, 3, device=cuda))
    with pytest.raises(ValueError, match="on"):
        nn_oneway(torch.zeros(1, 8, 3, device=cuda), torch.zeros(1, 8, 3))


def test_chamfer_loss_gradient_kernels_match_plain(cuda, monkeypatch):
    """chamfer_distance_loss forward and backward on K12 against the same
    on its plain version: the same argmins, so the same loss; the backward
    is the same torch code on both sides, with scatter-adds whose atomics
    add in another order (1e-6 of each gradient's max)."""
    from learning3d_tpu_torch.kernels import LAUNCHES, chamfer
    from learning3d_tpu_torch.losses import chamfer_distance_loss

    rng = np.random.default_rng(5)
    x_np, y_np = rng.normal(size=(4, 1024, 3)).astype(np.float32), rng.normal(size=(4, 2048, 3)).astype(np.float32)
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(chamfer, "nn_oneway", chamfer._nn_oneway_reference)
        x, y = (torch.from_numpy(a).to(cuda).requires_grad_(True) for a in (x_np, y_np))
        before = LAUNCHES["_nn_oneway_pallas"]
        loss = chamfer_distance_loss(x, y)
        loss.backward()
        torch.cuda.synchronize()
        assert LAUNCHES["_nn_oneway_pallas"] - before == (0 if plain else 2)
        runs.append((loss.item(), x.grad, y.grad))
    (lk, gxk, gyk), (lp, gxp, gyp) = runs
    assert lk == lp
    for g, r in ((gxk, gxp), (gyk, gyp)):
        assert (g - r).abs().max().item() <= 1e-6 * r.abs().max().item()


def emd_close(got, want):
    """K13 against its plain version: the cost to rtol 1e-4, g1 and g2 to a
    mean relative error below 5% (the JAX package's own bound for its kernel
    against _emd_fwd_impl): ratioL = remainL / (K remainR + 1e-9) divides by
    sums that vanish at the sharpest levels, so a sum in another order can
    move one point's gradient a lot while the cost barely moves."""
    (c, g1, g2), (wc, wg1, wg2) = got, want
    assert bool(torch.isfinite(c).all() and torch.isfinite(g1).all() and torch.isfinite(g2).all())
    assert ((c - wc).abs() <= 1e-4 * wc.abs()).all(), ((c - wc).abs() / wc.abs()).max().item()
    for g, w in ((g1, wg1), (g2, wg2)):
        assert g.shape == w.shape
        assert ((g - w).abs().mean() / w.abs().mean()).item() < 0.05


# PCN's coarse EMD (B=32, N=M=1024: clusters of 16 CTAs of 64 rows); N > M and N < M (the
# multipliers); the gate's limit, 4096 points (the largest resident
# clouds, a cluster of 16); B=1 at PCN's size (16 CTAs of 64 rows); ragged
# N and M that no cluster size divides, both ways, at clusters of 16, 8 and
# 2; fewer points than CTAs (CTAs that own no row)
@pytest.mark.parametrize("case,batch,n,m", [
    ("pcn", 32, 1024, 1024), ("n_gt_m", 3, 1000, 300), ("n_lt_m", 2, 250, 1000), ("max", 1, 4096, 4096),
    ("b1", 1, 1024, 1024), ("ragged", 5, 1001, 777), ("ragged_lt", 9, 333, 1237), ("ragged_b40", 40, 517, 263),
    ("tiny", 2, 5, 11)])
def test_k13_matches_plain(cuda, case, batch, n, m):
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.emd import _emd_fwd_reference, emd_fwd

    rng = np.random.default_rng(n * 7 + m)
    x, y = (torch.from_numpy(rng.normal(size=(batch, k, 3)).astype(np.float32)).to(cuda) for k in (n, m))
    before = LAUNCHES["_emd_fwd_pallas"]
    got = emd_fwd(x, y)
    want = _emd_fwd_reference(x, y)
    torch.cuda.synchronize()
    assert LAUNCHES["_emd_fwd_pallas"] == before + 1
    emd_close(got, want)


# (case, B, N, M, the C entry's plan: cluster size * 100 + instance)
@pytest.mark.parametrize("case,batch,n,m,planned", [
    ("v64", 4, 1024, 1024, 1600), ("v64_ragged", 3, 1000, 300, 1600), ("v64_cluster_4", 2, 250, 100, 400),
    ("one_cta", 2, 50, 33, 100), ("v128", 3, 2048, 300, 1601), ("v128_ragged", 2, 1500, 1999, 1601),
    ("v256", 1, 4096, 4096, 1602), ("v256_ragged", 2, 2049, 3001, 1602)])
def test_k13_variants_match_plain(cuda, case, batch, n, m, planned):
    """Every instance of csrc/emd.cu (up to 64, 128 and 256 rows a CTA),
    each at the shapes for which ``plan`` chooses it, and clusters of 16, 4
    and 1 (one CTA holds both clouds)."""
    from learning3d_tpu_torch.kernels import _build
    from learning3d_tpu_torch.kernels.emd import _emd_fwd_reference, emd_kernel

    assert _build.library().emd_plan(n, m) == planned
    rng = np.random.default_rng(n * 11 + m)
    x, y = (torch.from_numpy(rng.normal(size=(batch, k, 3)).astype(np.float32)).to(cuda) for k in (n, m))
    want = _emd_fwd_reference(x, y)
    got = emd_kernel(x, y)
    torch.cuda.synchronize()
    emd_close(got, want)


def test_k13_is_deterministic(cuda):
    """No atomics: two calls give the same bits."""
    from learning3d_tpu_torch.kernels.emd import emd_kernel

    rng = np.random.default_rng(3)
    x, y = (torch.from_numpy(rng.normal(size=(32, 1024, 3)).astype(np.float32)).to(cuda) for _ in range(2))
    a, b = emd_kernel(x, y), emd_kernel(x, y)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_k13_plan_is_the_stated_plan(cuda):
    """The C entry's cluster size and instance (cluster * 100 + instance)
    follow the rule tests/test_torch_k13_layout.py emulates: the smallest
    power of two up to 16 (the largest cluster an H100 holds) that leaves a
    CTA at most 64 of the larger cloud's points, then the instance by the
    rows a CTA owns (up to 64, 128, 256)."""
    from learning3d_tpu_torch.kernels import _build

    lib = _build.library()
    stated = {(1, 1): 100, (5, 11): 100, (64, 1): 100, (65, 1): 200, (250, 300): 800, (300, 1): 800,
              (777, 1024): 1600, (1000, 300): 1600, (1024, 1024): 1600, (1025, 4): 1601, (2048, 300): 1601,
              (2049, 1): 1602, (1, 4096): 1602, (4096, 4096): 1602}
    assert {k: lib.emd_plan(*k) for k in stated} == stated


def test_k13_gate(cuda):
    """Past the JAX package's gate (N or M > 4096) the plain version runs on
    the card, as the JAX package runs _emd_fwd_impl on its accelerator; the
    kernel's own entry raises there."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.emd import emd_fwd, emd_kernel

    x = torch.zeros(1, 4097, 3, device=cuda)
    y = torch.ones(1, 8, 3, device=cuda)
    before = LAUNCHES["_emd_fwd_pallas"]
    cost, g1, g2 = emd_fwd(x, y)
    assert LAUNCHES["_emd_fwd_pallas"] == before and bool(torch.isfinite(cost).all())
    with pytest.raises(NotImplementedError, match="4096"):
        emd_kernel(x, y)


def test_emd_loss_gradient_on_card(cuda):
    """emd_loss_mean's backward is the saved g1, g2 scaled by the cost's
    cotangent (mean / N): against the plain version's."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.emd import _emd_fwd_reference
    from learning3d_tpu_torch.losses import emd_loss_mean

    rng = np.random.default_rng(13)
    x, y = (torch.from_numpy(rng.normal(size=(4, 512, 3)).astype(np.float32)).to(cuda).requires_grad_(True)
            for _ in range(2))
    before = LAUNCHES["_emd_fwd_pallas"]
    loss = emd_loss_mean(x, y)
    loss.backward()
    assert LAUNCHES["_emd_fwd_pallas"] == before + 1
    cost, g1, g2 = _emd_fwd_reference(x.detach(), y.detach())
    assert abs(loss.item() - (cost.mean() / 512).item()) <= 1e-4 * abs(loss.item())
    emd_close((cost, x.grad * 4 * 512, y.grad * 4 * 512), (cost, g1, g2))


def ipcrnet_bf16(cuda, seed=0):
    from learning3d_tpu_torch.models import PointNet, iPCRNet

    g = torch.Generator().manual_seed(seed)
    bf16 = torch.bfloat16
    return iPCRNet(PointNet(emb_dims=1024, dtype=bf16, generator=g, device=cuda), dtype=bf16, generator=g,
                   device=cuda).eval()


def test_ipcrnet_bf16_and_multistart_on_card(cuda):
    """bf16 iPCRNet(PointNet(1024)) in eval: one forward runs K1 nine times
    (the template, then the source in each of 8 iterations); multistart with
    8 starts one forward at batch 8 B (K1 nine times) and K12 twice. Finite
    outputs, est_R rotations to the bf16 rounding of its 8 steps
    (chip_smoke's bf16_rotation_tol), and chip_smoke's gates against the
    plain versions (ipcrnet_agreement: K12's rescoring bit-equal; one step
    within IPCRNET_TOL, with its reason)."""
    import chip_smoke
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.serve import multistart_register, multistart_scores, rotation_starts

    model = ipcrnet_bf16(cuda)
    rng = np.random.default_rng(21)
    template, source = (torch.from_numpy(rng.normal(size=(4, 1024, 3)).astype(np.float32)).to(cuda) for _ in range(2))
    with torch.inference_mode():
        before = dict(LAUNCHES)
        out = model(template, source)
        assert LAUNCHES["pointnet_pooled_kernel"] - before["pointnet_pooled_kernel"] == 9
        ms = multistart_register(model, template, source, rotation_starts(8))
        torch.cuda.synchronize()
        assert LAUNCHES["pointnet_pooled_kernel"] - before["pointnet_pooled_kernel"] == 18
        assert LAUNCHES["_nn_oneway_pallas"] - before["_nn_oneway_pallas"] == 2
        scores = multistart_scores(model, template, source, rotation_starts(8))[1]
        assert torch.equal(scores.min(0).values, ms["chamfer"]) and torch.equal(scores.argmin(0), ms["start_idx"])
        agree = chip_smoke.ipcrnet_agreement(model, template, source, rotation_starts(8), "card test")
    assert agree["rescored_bit_equal"]
    assert all(bool(torch.isfinite(v.float()).all()) for v in out.values())
    assert chip_smoke.rotation_error(out["est_R"].cpu()) <= chip_smoke.bf16_rotation_tol(8)


def k8_case(name, rng):
    """(queries, points, k) of a K8 card case, as numpy."""
    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    if name == "xyz":
        x = normal(2, 1024, 3)
        return x, x, 20
    if name == "features":
        x = normal(2, 768, 128)
        return x, x, 20
    if name == "cross_cloud":
        return normal(2, 300, 3), normal(2, 2048, 3), 16
    if name == "ragged":
        return normal(2, 777, 67), normal(2, 1000, 67), 20
    if name == "wide":
        return normal(1, 100, 256), normal(1, 600, 256), 64
    if name == "ties":
        side = 10
        grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
        x = np.stack([0.25 * grid[rng.permutation(len(grid))] for _ in range(2)]).astype(np.float32)
        return x, x, 27
    # near-duplicate features of large norm: some distances below 0
    base = 100.0 + normal(2, 300, 24)
    x = np.concatenate([base, base + 1e-4 * normal(2, 300, 24)], axis=1)
    return x, x, 8


@pytest.mark.parametrize("name", ["xyz", "features", "cross_cloud", "ragged", "wide", "ties", "negative"])
def test_k8_matches_plain(cuda, name):
    """K8 against its plain version on the card: indices equal and distances
    bit-equal (the same f32 operations, each rounded on its own), one
    launch; the negative case holds distances below 0, sorted first."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.knn import knn_pallas, knn_reference

    q, p, k = (torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray) else a
               for a in k8_case(name, np.random.default_rng(len(name))))
    before = LAUNCHES["knn_pallas"]
    d, i = knn_pallas(q, p, k)
    want_d, want_i = knn_reference(q, p, k)
    torch.cuda.synchronize()
    assert LAUNCHES["knn_pallas"] == before + 1
    assert d.dtype == torch.float32 and i.dtype == torch.int32 and d.shape == (q.shape[0], q.shape[1], k)
    assert torch.equal(i, want_i)
    assert torch.equal(d, want_d)
    if name == "negative":
        assert bool((d < 0).any())


def k8_check(q, p, k):
    """One K8 launch against its plain version: indices equal, distances
    bit-equal; returns the indices."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.knn import knn_pallas, knn_reference

    before = LAUNCHES["knn_pallas"]
    d, i = knn_pallas(q, p, k)
    want_d, want_i = knn_reference(q, p, k)
    torch.cuda.synchronize()
    assert LAUNCHES["knn_pallas"] == before + 1
    assert d.shape == i.shape == (q.shape[0], q.shape[1], k)
    assert torch.equal(i, want_i)
    assert torch.equal(d, want_d)
    return i


# The smallest lists (N = k) at every list width (k = 1, 20: one lane a
# position; 64: two) and channel path (C = 1, 4-byte copies; 3, exact
# differences; 4, one 16-byte copy; 67, a ragged last chunk; 256, eight
# chunks), one query.
@pytest.mark.parametrize("c_dim", [1, 3, 4, 67, 256])
@pytest.mark.parametrize("k", [1, 20, 64])
def test_k8_smallest_lists_match_plain(cuda, k, c_dim):
    rng = np.random.default_rng(100 * k + c_dim)
    q = torch.from_numpy(rng.normal(size=(2, 1, c_dim)).astype(np.float32)).to(cuda)
    p = torch.from_numpy(rng.normal(size=(2, k, c_dim)).astype(np.float32)).to(cuda)
    k8_check(q, p, k)


# S one off the 64-row query tile, N one off the 128-point tile, C one off
# the 32-channel chunk, each on both sides.
@pytest.mark.parametrize("n_q,n_p,c_dim", [(63, 127, 31), (65, 129, 33), (64, 128, 32), (63, 129, 3),
                                           (65, 127, 64), (129, 255, 33)])
def test_k8_tile_edges_match_plain(cuda, n_q, n_p, c_dim):
    rng = np.random.default_rng(n_q * n_p + c_dim)
    q = torch.from_numpy(rng.normal(size=(3, n_q, c_dim)).astype(np.float32)).to(cuda)
    p = torch.from_numpy(rng.normal(size=(3, n_p, c_dim)).astype(np.float32)).to(cuda)
    k8_check(q, p, 20)
    k8_check(q, p, 40)


# Every point equal: every distance ties, so the picks are 0 .. k-1 in order.
@pytest.mark.parametrize("c_dim,k", [(3, 20), (64, 20), (128, 64), (7, 33)])
def test_k8_all_tied_picks_the_first_k(cuda, c_dim, k):
    x = torch.full((2, 1000, c_dim), 0.37, device=cuda)
    i = k8_check(x, x, k)
    assert torch.equal(i, torch.arange(k, device=cuda, dtype=torch.int32).expand(2, 1000, k))


def test_k8_refuses_what_it_does_not_take(cuda):
    from learning3d_tpu_torch.kernels.knn import knn_pallas

    x = torch.zeros((1, 600, 3), device=cuda)
    with pytest.raises(NotImplementedError, match="k <= 64"):
        knn_pallas(x, x, 65)
    w = torch.zeros((1, 600, 257), device=cuda)
    with pytest.raises(NotImplementedError, match="C <= 256"):
        knn_pallas(w, w, 4)
    with pytest.raises(ValueError, match="k must be"):
        knn_pallas(x[:, :8], x[:, :8], 9)


def test_geometry_knn_launches_k8_inside_the_gate(cuda):
    """ops.geometry.knn and knn_point launch K8 where the JAX package's gate
    sends an exact call to its kernel (N >= 512, C <= 256, k <= 64), with
    the kernel's selection, and for approx=True as well (the port selects
    exactly); below N = 512 they take the plain path."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.knn import knn_reference
    from learning3d_tpu_torch.ops.geometry import knn, knn_point

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 512, 64)).astype(np.float32)).to(cuda).requires_grad_(True)
    y = torch.from_numpy(rng.normal(size=(2, 100, 64)).astype(np.float32)).to(cuda)
    before = LAUNCHES["knn_pallas"]
    idx = knn(x, 20, include_self=False)
    d, i = knn_point(8, x, y)
    assert LAUNCHES["knn_pallas"] == before + 2
    assert idx.dtype == i.dtype == torch.int64
    assert torch.equal(idx, knn_reference(x, x, 21)[1][..., 1:].long())
    want_d, want_i = knn_reference(y, x, 8)
    assert torch.equal(i, want_i.long()) and torch.equal(d, torch.sqrt(torch.clamp(want_d, min=0.0)))
    knn(x[:, :511], 20)
    assert LAUNCHES["knn_pallas"] == before + 2
    assert torch.equal(knn(x, 20, include_self=False, approx=True), idx)
    assert torch.equal(knn_point(8, x, y, approx=True)[1], i)
    assert LAUNCHES["knn_pallas"] == before + 4


def test_prnet_runs_k8_on_card(cuda, monkeypatch):
    """PRNet (emb 64, so the pointer stays off K6's gate) at N >= 512 in
    train and eval mode: 16 K8 launches a forward (4 stages x (the template
    + 3 source passes)); with K8's plain version in its place every output
    is bit-equal (the same neighbors, then the same torch ops)."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels import knn as knn_mod
    from learning3d_tpu_torch.models import PRNet

    rng = np.random.default_rng(6)
    torch.manual_seed(0)
    model = PRNet(emb_dims=64, num_keypoints=256, num_subsampled_points=600, generator=torch.Generator().manual_seed(1))
    source = torch.from_numpy(rng.normal(size=(2, 600, 3)).astype(np.float32)).to(cuda)
    template = torch.from_numpy(rng.normal(size=(2, 700, 3)).astype(np.float32)).to(cuda)
    igt = torch.eye(4, device=cuda).expand(2, 4, 4)
    for mode in ("train", "eval"):
        getattr(model, mode)()
        state = {k: v.clone() for k, v in model.state_dict().items()}
        before = LAUNCHES["knn_pallas"]
        got = model(source, template, igt=igt)
        torch.cuda.synchronize()
        assert LAUNCHES["knn_pallas"] == before + 16
        model.load_state_dict(state)  # the same BN statistics for the plain run
        with monkeypatch.context() as m:
            m.setattr(knn_mod, "knn_pallas", knn_mod.knn_reference)
            want = model(source, template, igt=igt)
        for key in want:
            assert torch.equal(got[key], want[key]), key


# -- K14 (fps_pallas) and K15 (ball_query_pallas): FlowNet3D ---------------------

def radius_lattice(side=5, h=0.1, offset=0.37, seed=0):
    """A lattice of step h (not exact in f32) shifted by offset, in a random
    order: with radius h every neighbor lies on the radius."""
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    x = (h * g + offset).astype(np.float32)
    return x[np.random.default_rng(seed).permutation(len(x))][None]


def k14_case(name, rng):
    """(xyz, npoint, start) of one case: FlowNet3D's shapes at B=4, a ragged
    cloud, every point picked, exact ties, random starts, and a cloud past
    the shared-memory size (the global scratch), npoint past the TPU
    kernel's 1024."""
    shapes = {"sa1": (4, 2048, 1024), "sa2": (4, 1024, 256), "sa3": (4, 256, 64), "sa4": (4, 64, 16),
              "ragged": (3, 1000, 777), "every_point": (2, 1024, 1024), "scratch": (1, 20000, 64),
              "npoint_1500": (2, 3000, 1500)}
    if name in shapes:
        b, n, p = shapes[name]
        return rng.normal(size=(b, n, 3)).astype(np.float32), p, None
    if name == "ties":
        return lattice_cloud(rng, 2, 1000), 300, None
    return rng.normal(size=(3, 700, 3)).astype(np.float32), 200, rng.integers(0, 700, 3).astype(np.int32)


@pytest.mark.parametrize("name", ["sa1", "sa2", "sa3", "sa4", "ragged", "every_point", "scratch", "ties",
                                  "random_starts", "npoint_1500"])
def test_k14_matches_plain(cuda, name):
    """K14 against its plain version on the card: indices equal, one launch."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.sampling import fps_pallas, fps_reference

    x, npoint, start = k14_case(name, np.random.default_rng(len(name)))
    x = torch.from_numpy(x).to(cuda)
    start = None if start is None else torch.from_numpy(start).to(cuda)
    before = LAUNCHES["fps_pallas"]
    got = fps_pallas(x, npoint, start)
    want = fps_reference(x, npoint, start)
    torch.cuda.synchronize()
    assert LAUNCHES["fps_pallas"] == before + 1
    assert got.dtype == torch.int32 and got.shape == (x.shape[0], npoint)
    assert torch.equal(got, want)


def k14_check(x, npoint, start=None):
    """K14 against its plain version through the wrapper: indices equal, one
    launch."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.sampling import fps_pallas, fps_reference

    before = LAUNCHES["fps_pallas"]
    got = fps_pallas(x, npoint, start)
    want = fps_reference(x, npoint, start)
    torch.cuda.synchronize()
    assert LAUNCHES["fps_pallas"] == before + 1
    assert got.dtype == torch.int32 and got.shape == (x.shape[0], npoint)
    assert torch.equal(got, want)
    return got


# The edges of the register tiles at each N's own block size
# (fps_default_threads): 1 and 2 points a thread at 32 threads (32/33, up to
# 64); 1, 2 and 4 at 128 (65, 128/129, 256/257, up to 512); 4 at 256
# (513-1024); 16 at 128 (1025-2048) and at 256 (2049-4096); 8 at 1024
# (4097-8192); then shared memory (8193-12288) and past it the global scratch
# (12289).
@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 257, 511, 512, 513, 1023, 1024,
                               1025, 2047, 2048, 2049, 4095, 4096, 4097, 8191, 8192, 8193, 12288, 12289])
def test_k14_register_tile_edges_match_plain(cuda, n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=(2, n, 3)).astype(np.float32)).to(cuda)
    k14_check(x, min(n, 96), torch.from_numpy(rng.integers(0, n, 2).astype(np.int32)).to(cuda))


# every point picked (npoint = N), and past it: the picks then repeat the
# first index whose distance is 0
@pytest.mark.parametrize("n", [1, 33, 257])
@pytest.mark.parametrize("extra", [0, 7])
def test_k14_every_point_matches_plain(cuda, n, extra):
    x = torch.from_numpy(np.random.default_rng(n + extra).normal(size=(3, n, 3)).astype(np.float32)).to(cuda)
    got = k14_check(x, n + extra)
    assert (got[:, :n].sort(-1).values == torch.arange(n, device=cuda, dtype=torch.int32)).all()


@pytest.mark.parametrize("batch", [1, 40])
def test_k14_batch_sizes_match_plain(cuda, batch):
    rng = np.random.default_rng(batch)
    x = torch.from_numpy(rng.normal(size=(batch, 1024, 3)).astype(np.float32)).to(cuda)
    k14_check(x, 256, torch.from_numpy(rng.integers(0, 1024, batch).astype(np.int32)).to(cuda))


# a lattice with exact ties at a one-warp and a 256-thread size, a cloud of
# equal points (start, then index 0 for ever: every distance is 0), random
# starts
@pytest.mark.parametrize("name", ["lattice_64", "lattice_2048", "equal_points", "random_starts"])
def test_k14_degenerate_clouds_match_plain(cuda, name):
    rng = np.random.default_rng(len(name))
    start = None
    if name.startswith("lattice"):
        n = int(name.split("_")[1])
        x, npoint = lattice_cloud(rng, 2, n), n // 2
    elif name == "equal_points":
        x, npoint = np.full((2, 500, 3), 0.375, np.float32), 20
        start = torch.tensor([7, 499], dtype=torch.int32, device=cuda)
    else:
        x, npoint = rng.normal(size=(8, 2048, 3)).astype(np.float32), 1024
        start = torch.from_numpy(rng.integers(0, 2048, 8).astype(np.int32)).to(cuda)
    got = k14_check(torch.from_numpy(x).to(cuda), npoint, start)
    if name == "equal_points":
        assert got[:, 0].tolist() == [7, 499] and (got[:, 1:] == 0).all()


def k15_case(name, rng):
    """(radius, nsample, xyz, queries): FlowNet3D's four ball queries at B=4
    (the queries FPS samples of the cloud), a ragged one, nsample = 128 and
    300 (past the TPU kernel's 128), the on-the-radius lattice and a row
    whose ball is empty."""
    shapes = {"sa1": (0.5, 16, 2048, 1024), "sa2": (1.0, 16, 1024, 256), "sa3": (2.0, 8, 256, 64),
              "sa4": (4.0, 8, 64, 16), "ragged": (0.7, 16, 1000, 333), "nsample_128": (1.5, 128, 2048, 100),
              "nsample_300": (2.0, 300, 2048, 100), "n20000": (0.1, 32, 20000, 541),
              "query_ball_point": (0.5, 16, 2048, 1024)}
    if name in shapes:
        r, ns, n, s = shapes[name]
        x = rng.normal(size=(4, n, 3)).astype(np.float32)
        return r, ns, x, x[:, rng.permutation(n)[:s]].copy()
    if name == "late_balls":  # the first 1100 points far away: balls fill after many rounds
        x = rng.normal(size=(4, 2048, 3)).astype(np.float32)
        x[:, :1100] += 50.0
        return 0.4, 16, x, x[:, 1100 + rng.permutation(948)[:200]].copy()
    if name == "on_the_radius":
        x = radius_lattice()
        return 0.1, 16, x, x[:, :64].copy()
    x = rng.normal(size=(2, 500, 3)).astype(np.float32)
    return 0.3, 8, x, np.concatenate([x[:, :10], np.full((2, 3, 3), 40.0, np.float32)], axis=1)


@pytest.mark.parametrize("name", ["sa1", "sa2", "sa3", "sa4", "ragged", "nsample_128", "nsample_300",
                                  "on_the_radius", "empty_ball", "late_balls", "n20000", "query_ball_point"])
def test_k15_matches_plain(cuda, name):
    """K15 against its plain version on the card: indices equal, one
    launch; the int64 instance gives the same indices; an empty ball gives
    N everywhere; balls that fill only past the first 1100 points; N =
    20,000; ``ops.geometry.query_ball_point`` takes K15's int64 indices in
    one launch."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.sampling import ball_query_pallas, ball_query_reference
    from learning3d_tpu_torch.ops.geometry import query_ball_point

    r, ns, x, q = k15_case(name, np.random.default_rng(len(name)))
    x, q = torch.from_numpy(x).to(cuda), torch.from_numpy(q).to(cuda)
    before = LAUNCHES["ball_query_pallas"]
    got = ball_query_pallas(r, ns, x, q)
    want = ball_query_reference(r, ns, x, q)
    torch.cuda.synchronize()
    assert LAUNCHES["ball_query_pallas"] == before + 1
    assert got.dtype == torch.int32 and got.shape == (q.shape[0], q.shape[1], ns)
    assert torch.equal(got, want)
    wide = query_ball_point(r, ns, x, q) if name == "query_ball_point" else ball_query_pallas(r, ns, x, q,
                                                                                                  dtype=torch.int64)
    torch.cuda.synchronize()
    assert LAUNCHES["ball_query_pallas"] == before + 2
    assert wide.dtype == torch.int64 and torch.equal(wide, got.long())
    if name == "empty_ball":
        assert bool((got[:, 10:] == x.shape[1]).all()) and bool((got[:, :10] < x.shape[1]).all())
    if name == "late_balls":
        assert int(got.min()) >= 1100


def test_k15_reads_points_past_int32_offsets(cuda):
    """A cloud of 720M points (8.6 GB): the two in-ball points lie past
    index 2**31 / 3, where a point's float offset no longer fits int32."""
    from learning3d_tpu_torch.kernels.sampling import ball_query_pallas

    n = 720_000_000
    x = torch.full((1, n, 3), 100.0, device=cuda)
    x[0, n - 7] = x[0, n - 2] = 0.0
    got = ball_query_pallas(0.5, 2, x, torch.zeros((1, 1, 3), device=cuda))
    torch.cuda.synchronize()
    assert got.tolist() == [[[n - 7, n - 2]]]


def test_k15_rounds_are_the_stated_rounds(cuda):
    """The C entry's rounds a scan loads before their ballots are
    kernels/sampling.py's BALL_QUERY_ROUNDS, which the CPU emulation runs."""
    from learning3d_tpu_torch.kernels import _build
    from learning3d_tpu_torch.kernels.sampling import BALL_QUERY_ROUNDS

    assert _build.library().ball_query_rounds() == BALL_QUERY_ROUNDS


def test_k14_k15_refuse_past_their_limits(cuda):
    from learning3d_tpu_torch.kernels.sampling import ball_query_pallas, fps_pallas

    """Past their int32 indices the wrappers raise before they allocate or
    launch; a start outside [0, N) is refused on the card as on the CPU."""
    from learning3d_tpu_torch.kernels import LAUNCHES

    x = torch.zeros((2, 2000, 3), device=cuda)
    before = dict(LAUNCHES)
    with pytest.raises(NotImplementedError, match="int32"):
        fps_pallas(x, 2**31)
    with pytest.raises(NotImplementedError, match="int32"):
        ball_query_pallas(0.5, 2**31, x, x[:, :10])
    with pytest.raises(ValueError):
        fps_pallas(x[..., :2], 10)
    for start in ([0, 2000], [-1, 3]):
        with pytest.raises(ValueError, match=r"start must lie in \[0, 2000\)"):
            fps_pallas(x, 10, torch.tensor(start, device=cuda))
    assert LAUNCHES == before


def test_geometry_gates_launch_k14_k15_k8(cuda):
    """ops.geometry launches K14 and K15 for every CUDA tensor, npoint 1025
    and nsample 129 included (past the JAX package's TPU gates, which are
    its kernels' VMEM limits), raises for get_cnt on the card, and launches
    K8 in three_nn where the known cloud has >= 512 points (JAX's gate).
    three_nn's distances recomputed from K8's picks equal the dense path's
    bit for bit."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.ops.geometry import farthest_point_sample, query_ball_point, three_nn

    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(2, 1500, 3)).astype(np.float32)).to(cuda)
    before = dict(LAUNCHES)
    idx = farthest_point_sample(x, 1024)
    assert idx.dtype == torch.int64 and LAUNCHES["fps_pallas"] == before["fps_pallas"] + 1
    from learning3d_tpu_torch.kernels.sampling import ball_query_reference, fps_reference

    wide = farthest_point_sample(x, 1025)
    assert LAUNCHES["fps_pallas"] == before["fps_pallas"] + 2
    assert torch.equal(wide, fps_reference(x, 1025).long())
    q = x[:, :100]
    got = query_ball_point(0.5, 128, x, q)
    assert got.dtype == torch.int64 and LAUNCHES["ball_query_pallas"] == before["ball_query_pallas"] + 1
    wide = query_ball_point(2.0, 129, x, q)
    assert LAUNCHES["ball_query_pallas"] == before["ball_query_pallas"] + 2
    assert torch.equal(wide, ball_query_reference(2.0, 129, x, q).long())
    with pytest.raises(NotImplementedError, match="get_cnt"):
        query_ball_point(0.5, 16, x, q, get_cnt=True)
    assert LAUNCHES["ball_query_pallas"] == before["ball_query_pallas"] + 2
    u = torch.from_numpy(rng.normal(size=(2, 700, 3)).astype(np.float32)).to(cuda).requires_grad_(True)
    d, i = three_nn(u, x[:, :512])
    assert LAUNCHES["knn_pallas"] == before["knn_pallas"] + 1
    d_plain, i_plain = three_nn(u, x[:, :511])
    assert LAUNCHES["knn_pallas"] == before["knn_pallas"] + 1
    d.sum().backward()
    assert u.grad is not None and bool(torch.isfinite(u.grad).all())
    from learning3d_tpu_torch.kernels.knn import knn_reference
    want_d, want_i = knn_reference(u.detach(), x[:, :512], 3)
    assert torch.equal(i, want_i.long()) and torch.equal(d.detach(), torch.sqrt(want_d))


def test_flownet_runs_k14_k15_k8_on_card(cuda, monkeypatch):
    """FlowNet3D() at B=2, N=2048 in train and eval mode: K14 6, K15 6 and
    K8 once a forward; with the three kernels' plain versions in their place
    every flow is bit-equal (the same indices, then the same torch ops)."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels import knn as knn_mod
    from learning3d_tpu_torch.kernels import sampling
    from learning3d_tpu_torch.models import FlowNet3D

    rng = np.random.default_rng(10)
    model = FlowNet3D(generator=torch.Generator().manual_seed(2))
    pc1 = rng.normal(size=(2, 2048, 3)).astype(np.float32)
    pc2 = pc1 + 0.05 * rng.normal(size=pc1.shape).astype(np.float32)
    inputs = [torch.from_numpy(a).to(cuda) for a in (pc1, pc2, np.zeros_like(pc1), np.zeros_like(pc1))]
    for mode in ("train", "eval"):
        getattr(model, mode)()
        state = {k: v.clone() for k, v in model.state_dict().items()}
        before = dict(LAUNCHES)
        got = model(*inputs)
        torch.cuda.synchronize()
        assert {k: LAUNCHES[k] - before[k] for k in ("fps_pallas", "ball_query_pallas", "knn_pallas")} == {
            "fps_pallas": 6, "ball_query_pallas": 6, "knn_pallas": 1}
        assert got.shape == (2, 2048, 3) and bool(torch.isfinite(got).all())
        model.load_state_dict(state)  # the same BN statistics for the plain run
        with monkeypatch.context() as m:
            m.setattr(knn_mod, "knn_pallas", knn_mod.knn_reference)
            m.setattr(sampling, "fps_pallas", sampling.fps_reference)
            m.setattr(sampling, "ball_query_pallas", sampling.ball_query_reference)
            want = model(*inputs)
        assert torch.equal(got, want)


# -- K16 (ball_group_pallas) and K17 (sinkhorn_log_pallas): RPMNet ---------------

def unit_cloud(rng, b, n):
    """Points with unit normals spread through the unit ball, as
    SyntheticModelNet40's normalised clouds are: (B, N, 6)."""
    x = rng.uniform(-1.0, 1.0, (b, n, 3))
    nrm = rng.normal(size=(b, n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return np.concatenate([x, nrm], -1).astype(np.float32)


def k16_case(name, rng, device):
    """(radius, nsample, xyz, new_xyz, itself, values) of a K16 case."""
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    if name == "on_the_radius":
        g = np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing="ij"), -1).reshape(-1, 3)
        x = (0.1 * g + 0.37).astype(np.float32)[rng.permutation(len(g))][None]
        v = np.concatenate([x, rng.normal(size=x.shape).astype(np.float32)], -1)
        return 0.1, 16, dev(x), dev(x), dev(np.arange(125, dtype=np.int32)[None]), dev(v)
    if name.startswith("c") and name[1:].isdigit():  # C = 1, 3, 7: rows off the 16-byte grid; 40: slot by slot
        c = int(name[1:])
        pc = unit_cloud(rng, 2, 1000)
        v = rng.normal(size=(2, 1000, c)).astype(np.float32)
        it = np.broadcast_to(np.arange(1000, dtype=np.int32), (2, 1000)).copy()
        return 0.3, 37, dev(pc[..., :3]), dev(pc[..., :3]), dev(it), dev(v)
    if name == "s_ne_n":  # 777 queries off the cloud among 1000 points, centers in and out of range
        pc = unit_cloud(rng, 3, 1000)
        q = unit_cloud(rng, 3, 777)[..., :3]
        it = rng.integers(-5, 1005, (3, 777)).astype(np.int32)
        return 0.3, 64, dev(pc[..., :3]), dev(q), dev(it), dev(pc)
    b, n, ns = {"rpmnet": (2, 1024, 64), "nsample_8": (2, 1024, 8), "ragged": (3, 1000, 64),
                "small": (2, 20, 40), "outside": (2, 300, 64), "chunked": (2, 20000, 64),
                "nsample_200": (2, 1024, 200), "long_rows": (2, 1024, 300)}[name]
    pc = unit_cloud(rng, b, n)
    itself = np.broadcast_to(np.arange(n, dtype=np.int32), (b, n)).copy()
    if name == "outside":  # center indices outside [0, N): nothing left out, zeros padded
        itself[:, ::7] = -1
        itself[:, 3::7] = n
    radius = {"small": 0.9, "chunked": 0.1, "long_rows": 0.9}.get(name, 0.3)
    return radius, ns, dev(pc[..., :3]), dev(pc[..., :3]), dev(itself), dev(pc)


@pytest.mark.parametrize("name", ["rpmnet", "nsample_8", "ragged", "small", "outside", "on_the_radius", "chunked",
                                  "nsample_200", "long_rows", "c1", "c3", "c7", "c40", "s_ne_n"])
def test_k16_matches_plain(cuda, name):
    """K16 gives its plain version's values exactly: RPMNet's grouping (N =
    S = 1024, r 0.3, nsample 64, C = 6), nsample 8 (outside the TPU gate's
    nsample * 6 % 128 == 0), N = 1000 (not a multiple of 32), nsample past
    N, center indices outside [0, N), a lattice on the radius; N = 20,000
    (18 shared-memory chunks of 1120 points, every query's row open across
    them), nsample 200 with C = 6 (1200-float rows), nsample 300 in balls of
    ~390 points (the 256-slot list full mid-scan: rows written in pieces),
    C = 1, 3 and 7 (rows of 37 C floats off the 16-byte grid), C = 40 (slot
    by slot), and 777 queries off a 1000-point cloud (S != N)."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.sampling import ball_group_pallas, ball_group_reference

    case = k16_case(name, np.random.default_rng(len(name)), cuda)
    before = LAUNCHES["ball_group_pallas"]
    got = ball_group_pallas(*case)
    want = ball_group_reference(*case)
    torch.cuda.synchronize()
    assert LAUNCHES["ball_group_pallas"] == before + 1
    assert got.shape == want.shape == case[3].shape[:2] + (case[1], case[5].shape[-1])
    assert torch.equal(got, want)
    if name == "outside":
        assert bool((got[:, ::7, -1] == 0).all())


def test_k16_chunk_is_the_stated_chunk(cuda):
    """The C entry's chunk of the staged cloud is kernels/sampling.py's
    ball_group_chunk."""
    from learning3d_tpu_torch.kernels import _build
    from learning3d_tpu_torch.kernels.sampling import ball_group_chunk

    lib = _build.library()
    for n in (1, 20, 1000, 1024, 1121, 20000):
        for c in (1, 3, 6, 7, 64, 400):
            points, values = ball_group_chunk(n, c)
            assert lib.ball_group_chunk(n, c) == (points if values else -points), (n, c)


def test_k16_queries_are_the_stated_queries(cuda):
    """The C entry's queries a block are kernels/sampling.py's
    ball_group_queries."""
    from learning3d_tpu_torch.kernels import _build
    from learning3d_tpu_torch.kernels.sampling import ball_group_queries

    lib = _build.library()
    for batch in (1, 2, 16, 64):
        for s in (1, 100, 541, 1024, 4096):
            assert lib.ball_group_queries(batch, s, 132) == ball_group_queries(batch, s, 132), (batch, s)


def test_k16_refuses_past_its_limits(cuda):
    from learning3d_tpu_torch.kernels.sampling import ball_group_pallas

    x = torch.zeros(1, 40, 3, device=cuda)
    it = torch.zeros(1, 10, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="K16"):
        ball_group_pallas(0.5, 2**31, x, x[:, :10], it, x)
    with pytest.raises(ValueError):
        ball_group_pallas(0.5, 8, x, x[:, :10], it[:, :5], x)
    with pytest.raises(ValueError):
        ball_group_pallas(0.5, 8, x, x[:, :10], it.float(), x)


def k17_case(name, rng, device):
    """(log_alpha, n_iters): affinities of RPMNet's range, -beta (d - alpha)
    with d the squared distance of unit features, or a wide random range."""
    b, j, k, n_iters, beta = {"rpmnet": (2, 1024, 1024, 5, 1.0), "j_ne_k": (3, 300, 517, 5, 3.0),
                              "small": (2, 5, 7, 5, 1.0), "one_iter": (2, 64, 96, 1, 1.0),
                              "no_iter": (2, 33, 40, 0, 1.0), "wide": (2, 257, 255, 5, 10.0),
                              "one_row": (1, 1, 45, 5, 1.0), "ragged": (1, 47, 83, 5, 1.0),
                              "ragged_one_iter": (1, 47, 83, 1, 1.0), "ragged_no_iter": (1, 47, 83, 0, 1.0),
                              "wide_rows": (1, 20, 1500, 5, 1.0), "wide_rows_odd": (2, 19, 1027, 5, 3.0)}[name]
    f = rng.normal(size=(b, j, 32))
    g = rng.normal(size=(b, k, 32))
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    d = ((f[:, :, None] - g[:, None]) ** 2).sum(-1)
    return torch.from_numpy((-beta * (d - 0.7)).astype(np.float32)).to(device), n_iters


# The kernel keeps row and column potentials; the plain version rewrites the
# matrix pass after pass, in another order: at RPMNet's shape they lie 4e-6
# apart on log values down to -10 (each within 4e-6 of the f64 result).
# 1e-5 absolute is the JAX package's own tolerance between its kernel and
# its XLA oracle (tests/test_pallas_interpret.py).
K17_ATOL = 1e-5


# RPMNet's shape; J != K; tiny; one and no iteration; a wide range; the
# sweep's edges: B = 1 with one row, J and K no multiple of 16 or 32 with 5,
# 1 and 0 iterations, and K past the 1024 columns a sweep block stages (K %
# 4 == 0: 16-byte copies; K % 4 != 0: 4-byte copies)
@pytest.mark.parametrize("name", ["rpmnet", "j_ne_k", "small", "one_iter", "no_iter", "wide", "one_row", "ragged",
                                  "ragged_one_iter", "ragged_no_iter", "wide_rows", "wide_rows_odd"])
def test_k17_matches_plain(cuda, name):
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.sinkhorn import sinkhorn_log_pallas, sinkhorn_slack_reference

    la, n_iters = k17_case(name, np.random.default_rng(len(name)), cuda)
    before = LAUNCHES["sinkhorn_log_pallas"]
    got = sinkhorn_log_pallas(la, n_iters)
    want = sinkhorn_slack_reference(la, n_iters)
    torch.cuda.synchronize()
    assert LAUNCHES["sinkhorn_log_pallas"] == before + 1
    assert got.shape == la.shape and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    if n_iters == 0:
        assert torch.equal(got, la)
    assert (got - want).abs().max().item() <= K17_ATOL


def test_k17_backward_recomputes_through_plain(cuda):
    """The gradient of K17 is the plain version's VJP at the same input (one
    kernel launch, no launch in the backward)."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.sinkhorn import sinkhorn_log_pallas, sinkhorn_slack_reference

    la, _ = k17_case("j_ne_k", np.random.default_rng(5), cuda)
    w = torch.from_numpy(np.random.default_rng(6).normal(size=la.shape).astype(np.float32)).to(cuda)
    x = la.clone().requires_grad_(True)
    before = LAUNCHES["sinkhorn_log_pallas"]
    (torch.exp(sinkhorn_log_pallas(x, 5)) * w).sum().backward()
    assert LAUNCHES["sinkhorn_log_pallas"] == before + 1
    y = la.clone().requires_grad_(True)
    (torch.exp(sinkhorn_slack_reference(y, 5)) * w).sum().backward()
    # the same recompute; only exp(out) differs by the forward's 1e-5
    torch.testing.assert_close(x.grad, y.grad, rtol=1e-4, atol=1e-4 * y.grad.abs().max().item())


def test_k17_entry_refuses_another_sweep_height(cuda):
    """The C entry checks that the caller sized the partials for its sweep
    blocks' rows (``SWEEP_ROWS``)."""
    from learning3d_tpu_torch.kernels import _build
    from learning3d_tpu_torch.kernels.sinkhorn import SWEEP_ROWS

    a = torch.zeros((1, 40, 40), device=cuda)
    out = torch.empty_like(a)
    u, v = (torch.empty((1, 40), device=cuda, dtype=torch.float64) for _ in range(2))
    part = torch.empty((2, 1, 40, 40), device=cuda, dtype=torch.float64)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.library()
    args = [t.data_ptr() for t in (a, out, u, v, part)] + [1, 40, 40, 5]
    assert lib.sinkhorn_slack(*args, SWEEP_ROWS // 2, stream) != 0
    assert lib.sinkhorn_slack(*args, SWEEP_ROWS, stream) == 0
    torch.cuda.synchronize()


def test_k17_refuses_bad_arguments(cuda):
    from learning3d_tpu_torch.kernels.sinkhorn import sinkhorn_kernel_limit, sinkhorn_log_pallas

    with pytest.raises(ValueError):
        sinkhorn_log_pallas(torch.zeros(4, 4, device=cuda))
    with pytest.raises(ValueError):
        sinkhorn_log_pallas(torch.zeros(1, 4, 4, device=cuda), -1)
    assert sinkhorn_kernel_limit(3, 2**30, 8) is not None and sinkhorn_kernel_limit(16, 1024, 1024) is None


def test_rpmnet_runs_k16_k17_on_card(cuda, monkeypatch):
    """RPMNet(PPFNet(emb 32)) at B=2, N=1024 with normals: K16 3 and K17 2
    launches a forward; against the same model on the plain versions est_T
    and transformed_source lie within 1e-4 of max and the feature residual r
    within 1e-5 absolute (the difference of two sets of unit features: its
    own max is small where the clouds are alike) (K16 exact, K17 1e-5); one
    tasks.rpmnet step's gradients on the kernels against the plain versions'
    within 1e-3 (K17's forward gap carried through two Kabsch solves)."""
    from learning3d_tpu_torch.kernels import LAUNCHES, sampling, sinkhorn
    from learning3d_tpu_torch.models import PPFNet, RPMNet
    from learning3d_tpu_torch.train import tasks

    rng = np.random.default_rng(11)
    gen = torch.Generator().manual_seed(3)
    model = RPMNet(feature_model=PPFNet(emb_dims=32, generator=gen), generator=gen)
    template = torch.from_numpy(unit_cloud(rng, 2, 1024)).to(cuda)
    source = template.clone()
    source[..., :3] = source[..., :3] + 0.02
    igt = torch.eye(4, device=cuda).expand(2, 4, 4).clone()
    igt[:, :3, 3] = 0.02

    def run():
        model.zero_grad()
        loss, aux = tasks.rpmnet(model, (template, source, igt))
        loss.backward()
        return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}

    before = dict(LAUNCHES)
    with torch.no_grad():
        got = model(template, source)
    assert {k: LAUNCHES[k] - before[k] for k in ("ball_group_pallas", "sinkhorn_log_pallas")} == {
        "ball_group_pallas": 3, "sinkhorn_log_pallas": 2}
    loss, grads = run()
    with monkeypatch.context() as m:
        m.setattr(sampling, "ball_group_pallas", sampling.ball_group_reference)
        m.setattr(sinkhorn, "sinkhorn_log_pallas", sinkhorn.sinkhorn_slack_reference)
        with torch.no_grad():
            want = model(template, source)
        want_loss, want_grads = run()
    for key in ("est_T", "r", "transformed_source"):
        assert bool(torch.isfinite(got[key]).all())
        scale = 0.1 if key == "r" else want[key].abs().max().item()
        assert (got[key] - want[key]).abs().max().item() <= 1e-4 * scale, key
    assert abs(loss.item() - want_loss.item()) <= 1e-4 * abs(want_loss.item())
    for name, g in grads.items():
        assert bool(torch.isfinite(g).all()), name
        ref = want_grads[name].norm().item()
        assert (g - want_grads[name]).norm().item() <= 1e-3 * max(ref, 1e-12), name


def test_masknet_bf16_pools_the_source_on_k1(cuda):
    """bf16 MaskNet(PointNet(1024)) in eval, chip_smoke's served draw: one
    forward launches K1 once (the source's pool; the template's per-point
    pass and PointNetMask's MLP are plain), the mask within chip_smoke's
    LK_MASK_TOL of the same model on the plain versions, the control
    k1_half_cloud outside it; the picks in lax.top_k's order of the mask."""
    import chip_smoke
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.models import MaskNet, PointNet
    from learning3d_tpu_torch.models.masknet import top_indices
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    state = chip_smoke.random_masknet_state(np.random.default_rng(31))
    state["maskNet.out.kernel"] *= chip_smoke.MASK_OUT_SCALE
    bf16 = torch.bfloat16
    model = load_nnx_state(MaskNet(PointNet(emb_dims=1024, use_bn=True, dtype=bf16, device=cuda), dtype=bf16,
                                   device=cuda), state).eval()
    rng = np.random.default_rng(32)
    template = torch.from_numpy(rng.normal(size=(4, 1024, 3)).astype(np.float32)).to(cuda)
    source = template[:, :768] + 0.01
    with torch.inference_mode():
        before = LAUNCHES["pointnet_pooled_kernel"]
        masked, mask = model(template, source)
        torch.cuda.synchronize()
        assert LAUNCHES["pointnet_pooled_kernel"] - before == 1
        with chip_smoke.plain_versions():
            plain = model(template, source)[1]
        with chip_smoke.k1_half_cloud():
            control = model(template, source)[1]
    assert mask.dtype == bf16 and masked.shape == (4, 768, 3)
    assert (mask.float() - plain.float()).abs().max().item() <= chip_smoke.LK_MASK_TOL
    assert (control.float() - plain.float()).abs().max().item() > chip_smoke.LK_MASK_TOL
    idx = top_indices(mask, 768)
    assert torch.equal(masked, torch.gather(template, 1, idx[..., None].expand(-1, -1, 3)))


@pytest.mark.parametrize("family", ["pointnetlk", "masknet"])
def test_lk_and_masknet_train_steps_match_plain(cuda, tmp_path, family):
    """One f32 train step through the Trainer on K3/K4 against the same
    step on their plain versions (chip_smoke's step_agreement, B=8): for
    PointNetLK K3 twice (the warm-up's template and source, forward only)
    and K4 never, within LK_STEP_TOL with the control k3_last_tile_dropped;
    for MaskNet (bce) K3 and K4 once each, within MASK_STEP_TOL with the
    control k3_misplaced. Launches counted over the kernels' run and the
    control's."""
    import chip_smoke
    from learning3d_tpu_torch.data import batch_iterator, to_device
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.models import MaskNet, PointNet, PointNetLK
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    rng = np.random.default_rng(33)
    if family == "pointnetlk":
        state, model = chip_smoke.random_pnlk_state(rng), PointNetLK
        data, tol, control, zero = (chip_smoke.lk_pairs(8), chip_smoke.LK_STEP_TOL, chip_smoke.k3_last_tile_dropped,
                                    chip_smoke.LK_ZERO_GRADIENT_BIASES)
        want = (4, 0)
    else:
        state, model = chip_smoke.random_masknet_state(rng), MaskNet
        data, tol, control, zero = (chip_smoke.lk_pairs(8, masknet=True), chip_smoke.MASK_STEP_TOL,
                                    chip_smoke.k3_misplaced, chip_smoke.MASK_ZERO_GRADIENT_BIASES)
        want = (2, 2)
    cfg = TrainConfig(task=family, batch_size=8, masknet_loss="bce", ckpt_dir=str(tmp_path))
    batch = to_device(next(batch_iterator(data, 8)), cuda)
    before = LAUNCHES["pool_stats_pallas"], LAUNCHES["pool_bwd_pallas"]
    worst = chip_smoke.step_agreement(
        lambda: Trainer(cfg, load_nnx_state(model(PointNet(emb_dims=1024, use_bn=True, device=cuda), device=cuda),
                                            state), device=cuda),
        batch, tol, chip_smoke.plain_poolgrad, zero, chip_smoke.LK_NOISE_TOL, control=control)
    assert (LAUNCHES["pool_stats_pallas"] - before[0], LAUNCHES["pool_bwd_pallas"] - before[1]) == want
    assert worst["grad"] <= tol


def test_segmentation_trains_on_card_without_a_kernel(cuda, tmp_path):
    """Segmentation(PointNet(1024, global_feat=False)) in f32: one step
    through the Trainer launches no kernel, its loss is finite and every
    weight and running statistic moves."""
    import chip_smoke
    from learning3d_tpu_torch.data import SyntheticPartSegmentation, batch_iterator, to_device
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.models import PointNet, Segmentation
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    model = load_nnx_state(Segmentation(PointNet(emb_dims=1024, use_bn=True, global_feat=False, device=cuda), 40,
                                        device=cuda), chip_smoke.random_segmentation_state(np.random.default_rng(34)))
    tr = Trainer(TrainConfig(task="segmentation", batch_size=4, ckpt_dir=str(tmp_path)), model, device=cuda)
    tr._ensure_optimizer(1)
    before = dict(LAUNCHES)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    loss, _ = tr.train_step(to_device(next(batch_iterator(SyntheticPartSegmentation(num_points=1024, size=4), 4)),
                                      cuda))
    torch.cuda.synchronize()
    assert LAUNCHES == before
    assert np.isfinite(float(loss))
    assert all(not torch.equal(v, state[k]) for k, v in model.state_dict().items()
               if k.endswith("weight") or "running" in k)
    tr.close()


# -- PointConv, CurveNet and the DGCNN classifier (K8, K14, K15, K5, K7) ---------

def cls_cloud(rng, b, n):
    """Points in the unit ball with surface-like clusters, as
    SyntheticModelNet40's normalised clouds: (B, N, 3)."""
    centers = rng.uniform(-0.7, 0.7, (b, 16, 3))
    pick = rng.integers(0, 16, (b, n))
    x = np.take_along_axis(centers, pick[..., None], 1) + 0.08 * rng.normal(size=(b, n, 3))
    return x.astype(np.float32)


@pytest.mark.parametrize("n,npoint", [(1024, 512), (512, 128), (1024, 256), (256, 64), (512, 600)])
def test_k14_matches_plain_at_classifier_shapes(cuda, n, npoint):
    """PointConv's 1024 -> 512 -> 128 and CurveNet's 1024 -> 256 -> 64 at
    B=32, and npoint > N (a PointConv at N=512 asks sa1 for 512, a smaller
    cloud for more): every point once in the scan's order, then the first
    of the all-zero distances, index for index."""
    from learning3d_tpu_torch.kernels.sampling import fps_pallas, fps_reference

    x = torch.from_numpy(cls_cloud(np.random.default_rng(n + npoint), 32, n)).to(cuda)
    got, want = fps_pallas(x, npoint), fps_reference(x, npoint)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if npoint > n:
        assert all(len(set(row[:n].tolist())) == n for row in got.cpu())


@pytest.mark.parametrize("s,n,k", [(1024, 1024, 21), (512, 1024, 32), (128, 512, 64)])
def test_k8_matches_plain_at_classifier_shapes(cuda, s, n, k):
    """CurveNet's self kNN (21 of 1024) and PointConv's (32 of 1024 for 512
    FPS queries, 64 of 512 for 128) at B=32: indices equal, distances
    bit-equal."""
    from learning3d_tpu_torch.kernels.knn import knn_pallas, knn_reference
    from learning3d_tpu_torch.kernels.sampling import fps_pallas
    from learning3d_tpu_torch.ops.geometry import index_points

    p = torch.from_numpy(cls_cloud(np.random.default_rng(s + k), 32, n)).to(cuda)
    q = p if s == n else index_points(p, fps_pallas(p, s).long()).contiguous()
    (d, i), (want_d, want_i) = knn_pallas(q, p, k), knn_reference(q, p, k)
    torch.cuda.synchronize()
    assert torch.equal(i, want_i) and torch.equal(d, want_d)


@pytest.mark.parametrize("n,s,radius", [(1024, 256, 0.1), (256, 64, 0.2)])
def test_k15_matches_plain_at_curvenet_shapes(cuda, n, s, radius):
    """CurveNet's masked max pools at B=32: 20 members of each FPS center's
    ball, 256 among 1024 (r 0.1) and 64 among 256 (r 0.2), in both index
    types."""
    from learning3d_tpu_torch.kernels.sampling import ball_query_pallas, ball_query_reference, fps_pallas
    from learning3d_tpu_torch.ops.geometry import index_points

    p = torch.from_numpy(cls_cloud(np.random.default_rng(n), 32, n)).to(cuda)
    q = index_points(p, fps_pallas(p, s).long()).contiguous()
    for dtype in (torch.int32, torch.int64):
        got = ball_query_pallas(radius, 20, p, q, dtype=dtype)
        want = ball_query_reference(radius, 20, p, q, dtype=dtype)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want)


def test_pointconv_and_curvenet_run_their_kernels_on_card(cuda, monkeypatch):
    """PointConvDensityClsSsg (classifier) and CurveNet at B=2, N=1024 in
    train and eval mode: K14 2 and K8 2 a PointConv forward, K8 1, K14 2
    and K15 2 a CurveNet forward (one kNN at 1024 points); with the plain
    versions in their place every output is bit-equal (the same indices,
    then the same torch ops, the walk's picks included)."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels import knn as knn_mod
    from learning3d_tpu_torch.kernels import sampling
    from learning3d_tpu_torch.models import CurveNet, PointConvDensityClsSsg

    x = torch.from_numpy(cls_cloud(np.random.default_rng(3), 2, 1024)).to(cuda)
    names = ("fps_pallas", "ball_query_pallas", "knn_pallas")
    for model, want_launches in ((PointConvDensityClsSsg(classifier=True, generator=torch.Generator().manual_seed(4)),
                                  {"fps_pallas": 2, "ball_query_pallas": 0, "knn_pallas": 2}),
                                 (CurveNet(generator=torch.Generator().manual_seed(5)),
                                  {"fps_pallas": 2, "ball_query_pallas": 2, "knn_pallas": 1})):
        for mode in ("train", "eval"):
            getattr(model, mode)()
            for m in model.modules():  # equal dropout masks on both runs: none
                if hasattr(m, "rate"):
                    m.rate = 0.0
            state = {k: v.clone() for k, v in model.state_dict().items()}
            before = dict(LAUNCHES)
            got = model(x)
            torch.cuda.synchronize()
            assert {k: LAUNCHES[k] - before[k] for k in names} == want_launches
            assert got.shape == (2, 40) and bool(torch.isfinite(got).all())
            model.load_state_dict(state)
            with monkeypatch.context() as m:
                m.setattr(knn_mod, "knn_pallas", knn_mod.knn_reference)
                m.setattr(sampling, "fps_pallas", sampling.fps_reference)
                m.setattr(sampling, "ball_query_pallas", sampling.ball_query_reference)
                want = model(x)
            assert torch.equal(got, want)


def test_dgcnn_classifier_runs_k5_and_k7_on_card(cuda):
    """Classifier(DGCNN(1024)) at B=4, N=1024: bf16 eval on K5 (once), its
    logits within 5e-2 of max of K5's plain version's; f32 train mode on K7
    (once)."""
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels import dgcnn_fused
    from learning3d_tpu_torch.models import DGCNN, Classifier
    from learning3d_tpu_torch.models import dgcnn as dgcnn_mod

    x = torch.from_numpy(cls_cloud(np.random.default_rng(6), 4, 1024)).to(cuda)
    bf16 = Classifier(DGCNN(1024, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(7)),
                      dtype=torch.bfloat16, generator=torch.Generator().manual_seed(8)).eval()
    before = dict(LAUNCHES)
    with torch.inference_mode():
        got = bf16(x).float()
        torch.cuda.synchronize()
        assert LAUNCHES["dgcnn_encode_fused"] - before["dgcnn_encode_fused"] == 1
        kernel = dgcnn_mod.dgcnn_encode_packed
        dgcnn_mod.dgcnn_encode_packed = lambda x, pack, k, approx_knn=False: dgcnn_fused.dgcnn_encode_reference(
            x.float(), pack.ws, pack.bs, k, approx_knn=approx_knn)
        try:
            want = bf16(x).float()
        finally:
            dgcnn_mod.dgcnn_encode_packed = kernel
    assert (got - want).abs().max().item() <= 5e-2 * want.abs().max().item()
    f32 = Classifier(DGCNN(1024, generator=torch.Generator().manual_seed(7)), generator=torch.Generator().manual_seed(8))
    before = LAUNCHES["knn_neighbors_pallas"]
    out = f32.train()(x)
    out.sum().backward()
    assert LAUNCHES["knn_neighbors_pallas"] - before == 1 and bool(torch.isfinite(out).all())
