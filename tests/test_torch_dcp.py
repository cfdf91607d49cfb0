"""The port's DCP slice (Kabsch solver, SVD head, DCP, weight import,
dict serving) against the JAX package, on the CPU at a small size.

On the CPU the port's kernel wrappers run their plain versions: K5's in
bf16 eval, K6's where the attention gate holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from learning3d_tpu.models import DCP as JDCP
from learning3d_tpu.models import DGCNN as JDGCNN
from learning3d_tpu.ops import se3 as jse3
from learning3d_tpu.ops import transforms as jtransforms
from learning3d_tpu.utils import svd as jsvd
from learning3d_tpu.utils import svd3 as jsvd3
from learning3d_tpu_torch.kernels import attention as tattn
from learning3d_tpu_torch.models import DCP, DGCNN
from learning3d_tpu_torch.models.dcp import MLPHead
from learning3d_tpu_torch.ops import se3 as tse3
from learning3d_tpu_torch.ops import transforms as ttransforms
from learning3d_tpu_torch.serve import InferenceEngine
from learning3d_tpu_torch.utils import svd as tsvd
from learning3d_tpu_torch.utils import svd3 as tsvd3
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from torch_port_util import cloud, nnx_flat, randomize_bn, rel_err

EMB, K = 64, 5
KEYS = ("est_R", "est_t", "est_R_", "est_t_", "est_T", "r", "transformed_source")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def jax_dcp(jdtype=None, emb=EMB, k=K, seed=0):
    jm = JDCP(JDGCNN(emb_dims=emb, k=k, dtype=jdtype, rngs=nnx.Rngs(seed)), dtype=jdtype, rngs=nnx.Rngs(seed + 1))
    randomize_bn(jm, np.random.default_rng(seed))
    jm.eval()
    return jm


def port_dcp(jm, tdtype=None, emb=EMB, k=K):
    tm = DCP(DGCNN(emb_dims=emb, k=k, dtype=tdtype, device="cpu"), dtype=tdtype, device="cpu")
    return load_nnx_state(tm, nnx_flat(jm)).eval()


def covariance(kind, seed=20):
    """Two random, rank-1 or zero 3x3 cross-covariances."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.normal(size=(2, 3, 3)).astype(np.float32)
    if kind == "rank1":
        u, w = rng.normal(size=(2, 2, 3))
        return np.einsum("bi,bj->bij", u, w).astype(np.float32)
    return np.zeros((2, 3, 3), np.float32)


@pytest.mark.parametrize("kind", ["random", "rank1", "zero"])
def test_kabsch_matches_jax(kind):
    """Every result is a proper rotation (to 1e-5) that attains the Kabsch
    maximum tr(R H) = s1 + s2 + sign(det H) s3 (to 1e-5 of s1). For random
    H the rotation is unique and equals the JAX solver's to f32 rounding
    through 6 Jacobi sweeps (2e-5); for rank-1 H any rotation about the
    singular axis attains the maximum, and the two solvers may pick
    different ones; for H = 0 both fall back to the same fixed frame."""
    H = covariance(kind)
    want = np.asarray(jsvd3.kabsch_rotation_3x3(jnp.asarray(H)))
    got = tsvd3.kabsch_rotation_3x3(torch.from_numpy(H)).numpy()
    eye = np.broadcast_to(np.eye(3), got.shape)
    np.testing.assert_allclose(got @ np.swapaxes(got, -1, -2), eye, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
    s = np.linalg.svd(H.astype(np.float64), compute_uv=False)
    best = s[:, 0] + s[:, 1] + np.sign(np.linalg.det(H.astype(np.float64))) * s[:, 2]
    np.testing.assert_allclose(np.trace(got @ H, axis1=-2, axis2=-1), best, atol=1e-5 * max(1.0, s.max()))
    if kind != "rank1":
        np.testing.assert_allclose(got, want, atol=2e-5)


def test_eigh3x3_matches_jax():
    rng = np.random.default_rng(21)
    a = rng.normal(size=(5, 3, 3)).astype(np.float32)
    A = a @ np.swapaxes(a, -1, -2)
    jl, jv = map(np.asarray, jsvd3.eigh3x3(jnp.asarray(A)))
    tl, tv = tsvd3.eigh3x3(torch.from_numpy(A))
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), jv, atol=1e-5)


def test_procrustes_recovers_rigid_motion():
    """Exact correspondences: the solver returns the motion, as the JAX one."""
    rng = np.random.default_rng(22)
    src = rng.normal(size=(2, 50, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(2, 3, 3)))
    R = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)
    t = rng.normal(size=(2, 3)).astype(np.float32)
    dst = np.einsum("bij,bnj->bni", R, src) + t[:, None]
    tR, tt = tsvd.procrustes_from_correspondence(torch.from_numpy(src), torch.from_numpy(dst))
    jR, jt = jsvd.procrustes_from_correspondence(jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_allclose(tR.numpy(), R, atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), t, atol=1e-5)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)


def test_se3_and_transform_match_jax():
    rng = np.random.default_rng(23)
    R, t = rng.normal(size=(2, 3, 3)).astype(np.float32), rng.normal(size=(2, 3)).astype(np.float32)
    pts = rng.normal(size=(2, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(tse3.from_rt(torch.from_numpy(R), torch.from_numpy(t)).numpy(),
                                  np.asarray(jse3.from_rt(jnp.asarray(R), jnp.asarray(t))))
    np.testing.assert_allclose(
        ttransforms.transform_point_cloud(*map(torch.from_numpy, (pts, R, t))).numpy(),
        np.asarray(jtransforms.transform_point_cloud(jnp.asarray(pts), jnp.asarray(R), jnp.asarray(t))),
        atol=1e-6)


# f32: the same path on both sides (unfused DGCNN, plain attention, Jacobi
# Kabsch); f32 sums in another order, 1e-5 of each key's largest value.
# bf16: JAX's CPU path runs the unfused DGCNN with every conv and BN step
# rounded to bf16, the port K5's plain version (BN folded into f32
# weights); the embeddings (and r) carry bf16 roundings in different places
# through the encoder and the pointer (5e-2), and the poses computed from
# them in f32 move less (3e-2).
TOLS = {"f32": {key: 1e-5 for key in KEYS}, "bf16": {**{key: 3e-2 for key in KEYS}, "r": 5e-2}}


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_dcp_matches_jax(name):
    jdt, tdt = (None, None) if name == "f32" else (jnp.bfloat16, torch.bfloat16)
    jm = jax_dcp(jdt)
    tm = port_dcp(jm, tdt)
    template, source = cloud(2, 100, seed=2), cloud(2, 100, seed=1)
    want = jm(jnp.asarray(template), jnp.asarray(source))
    with torch.inference_mode():
        got = tm(torch.from_numpy(template), torch.from_numpy(source))
    assert set(got) == set(want) == set(KEYS)
    for key in KEYS:
        assert got[key].shape == want[key].shape, key
        assert rel_err(got[key], want[key]) <= TOLS[name][key], key


def test_dcp_at_the_kernel_gate_matches_jax(monkeypatch):
    """At the real width (emb=512: D=128 per pointer head, D=512 in the
    head) and N=256 the attention gate holds: all seven attention calls go
    through K6's plain version, the encoder through K5's. The JAX CPU path
    is the unfused chain; bf16 tolerances as above."""
    calls = []
    plain = tattn.attention_reference
    monkeypatch.setattr(tattn, "attention_reference", lambda *a: calls.append(1) or plain(*a))
    jm = jax_dcp(jnp.bfloat16, emb=512, seed=3)
    tm = port_dcp(jm, torch.bfloat16, emb=512)
    template, source = cloud(1, 256, seed=4), cloud(1, 256, seed=5)
    want = jm(jnp.asarray(template), jnp.asarray(source))
    with torch.inference_mode():
        got = tm(torch.from_numpy(template), torch.from_numpy(source))
    assert len(calls) == 7
    for key in KEYS:
        assert rel_err(got[key], want[key]) <= TOLS["bf16"][key], key


def test_dcp_options():
    assert isinstance(DCP(DGCNN(emb_dims=EMB, k=K, device="cpu"), head="mlp", device="cpu").head, MLPHead)
    with pytest.raises(ValueError):
        DCP(DGCNN(emb_dims=EMB, k=K, device="cpu"), head="linear", device="cpu")
    with pytest.raises(ValueError):
        DCP(DGCNN(emb_dims=EMB, k=K, device="cpu"), pointer_="lstm", device="cpu")
    tm = DCP(DGCNN(emb_dims=EMB, k=K, device="cpu"), pointer_="identity", device="cpu").eval()
    template, source = map(torch.from_numpy, (cloud(1, 40, seed=6), cloud(1, 40, seed=7)))
    with torch.inference_mode():
        out = tm(template, source)
        tmpl_emb = tm.encode(template)
        again = tm.register_encoded(template, tmpl_emb, source)
        bcn = DCP(tm.emb_nn, pointer_="identity", input_shape="bcn", device="cpu").eval()
        out_bcn = bcn(template.transpose(1, 2), source.transpose(1, 2))
    for key in KEYS:
        torch.testing.assert_close(again[key], out[key], rtol=0, atol=0)
        torch.testing.assert_close(out_bcn[key], out[key], rtol=0, atol=0)


def test_load_nnx_state_round_trips_dcp():
    """Bias-free convs, BN statistics under emb_nn.bns.* and the LayerNorm
    a/b all map; a state read back maps to the same values."""
    flat = nnx_flat(jax_dcp())
    state = port_dcp(jax_dcp()).state_dict()
    mapped = nnx_to_torch(flat)
    assert set(state) == set(mapped)
    for key, value in state.items():
        np.testing.assert_array_equal(value.numpy(), mapped[key])
    assert "emb_nn.convs.0.bias" not in state
    np.testing.assert_array_equal(state["emb_nn.convs.4.weight"].numpy(), flat["emb_nn.convs.4.kernel"].T)
    np.testing.assert_array_equal(state["emb_nn.bns.2.running_var"].numpy(), flat["emb_nn.bns.2.var"])
    np.testing.assert_array_equal(state["pointer.dec_layers.0.norm3.a"].numpy(), flat["pointer.dec_layers.0.norm3.a"])


@pytest.mark.parametrize("fault", ["missing", "unexpected"])
def test_load_nnx_state_raises_for_dcp(fault):
    flat = nnx_flat(jax_dcp())
    if fault == "missing":
        del flat["pointer.enc_norm.b"]
    else:
        flat["emb_nn.convs.0.bias"] = np.zeros(64, np.float32)
    with pytest.raises(KeyError):
        load_nnx_state(DCP(DGCNN(emb_dims=EMB, k=K, device="cpu"), device="cpu"), flat)


@pytest.mark.parametrize("n", [2, 5])
def test_inference_engine_dict_results(n):
    """Dict results: each key sliced to the real rows, bf16 returned as f32
    numpy, concatenated across chunks (batch 2: n=5 is two full chunks and
    a padded tail); ``output_key`` picks one key."""
    tm = port_dcp(jax_dcp(jnp.bfloat16), torch.bfloat16)
    template, source = cloud(n, 40, seed=8), cloud(n, 40, seed=9)
    out = InferenceEngine(tm, batch_size=2, device="cpu")(template, source)
    with torch.inference_mode():
        want = tm(torch.from_numpy(template), torch.from_numpy(source))
    assert set(out) == set(KEYS)
    for key in KEYS:
        assert out[key].dtype == np.float32 and out[key].shape[0] == n, key
        np.testing.assert_array_equal(out[key], want[key].float().numpy())
    est_r = InferenceEngine(tm, batch_size=2, output_key="est_R", device="cpu")(template, source)
    np.testing.assert_array_equal(est_r, out["est_R"])


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_dcp_mlp_head_matches_jax(mode):
    """DCP(head="mlp") in f32 against the JAX model with its weights and BN
    statistics carried across (some BN scales negative): every output to
    1e-4 of its largest value (f32 sums in other orders; in train mode the
    head's BatchNorm takes its statistics over the 4 pooled rows), and in
    train mode the head's running statistics after the forward."""
    jm = JDCP(JDGCNN(emb_dims=EMB, k=K, rngs=nnx.Rngs(3)), head="mlp", rngs=nnx.Rngs(4))
    randomize_bn(jm, np.random.default_rng(3))
    tm = load_nnx_state(DCP(DGCNN(emb_dims=EMB, k=K, device="cpu"), head="mlp", device="cpu"), nnx_flat(jm))
    getattr(jm, mode)()
    getattr(tm, mode)()
    template, source = cloud(4, 48, seed=30), cloud(4, 48, seed=31)
    want = jm(jnp.asarray(template), jnp.asarray(source))
    got = tm(torch.from_numpy(template), torch.from_numpy(source))
    for key in KEYS:
        assert rel_err(got[key], want[key]) <= 1e-4, key
    R = got["est_R"].detach().numpy()
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2), np.broadcast_to(np.eye(3), R.shape), atol=1e-5)
    if mode == "train":
        after = nnx_to_torch(nnx_flat(jm))
        for name, buf in tm.named_buffers():
            if name.startswith("head."):
                np.testing.assert_allclose(buf.numpy(), after[name], rtol=1e-5, atol=1e-6, err_msg=name)
