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


# the pointer's shape, the SVD head's (D=512, Dv=3), ragged N and M, small
# odd shapes, and the pointer's and head's in f32 (f32 DCP's calls)
@pytest.mark.parametrize("batch,heads,n,m,d,dv,dtype", [
    (2, 4, 1024, 1024, 128, 128, torch.bfloat16), (2, 1, 1024, 1024, 512, 3, torch.bfloat16),
    (2, 4, 1000, 1000, 128, 128, torch.bfloat16), (1, 2, 37, 70, 64, 40, torch.bfloat16),
    (2, 4, 1024, 1024, 128, 128, torch.float32), (2, 1, 1024, 1024, 512, 3, torch.float32),
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
# largest k, and a cloud of exactly k points
@pytest.mark.parametrize("case,batch,n_pts,k", [
    ("full", 4, 1024, 20), ("ties", 2, 1000, 20), ("ragged", 3, 1000, 20), ("k40", 2, 1024, 40),
    ("k64", 1, 777, 64), ("n_eq_k", 2, 9, 9),
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
    x = lattice_cloud(rng, batch, n_pts) if case == "ties" else rng.normal(size=(batch, n_pts, 3))
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    assert all(torch.unique(c, dim=0).shape[0] == n_pts for c in x)
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
    # the same int8 products; stage 1's f32 sum or an epilogue may round
    # otherwise and move a requantized activation by one step
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


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


@pytest.mark.parametrize("int8_pv", [True, False])
@pytest.mark.parametrize("batch,heads,n,m,d", [(2, 4, 1024, 1024, 128), (1, 2, 1000, 1000, 128), (1, 1, 37, 200, 256)])
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


@pytest.mark.parametrize("case,batch,n_pts,emb,dtype", [
    ("full", 4, 1024, 1024, torch.bfloat16), ("f32", 4, 1024, 1024, torch.float32),
    ("ragged", 3, 1000, 256, torch.bfloat16), ("tiny", 2, 37, 128, torch.float32),
    ("ties", 2, 300, 128, torch.bfloat16)])
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
    ("one_point_f32", 2, 100, 640, torch.float32)])
def test_k4_matches_plain(cuda, case, batch, n_pts, emb, dtype):
    """Indices from a real K3 run (many channels share a critical point),
    and every channel on one point; dense dx_sp with zero rows elsewhere."""
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


# PCN's coarse EMD (B=32, N=M=1024); N > M and N < M (the multipliers);
# the gate's limit, 4096 points
@pytest.mark.parametrize("case,batch,n,m", [
    ("pcn", 32, 1024, 1024), ("n_gt_m", 3, 1000, 300), ("n_lt_m", 2, 250, 1000), ("max", 1, 4096, 4096)])
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
