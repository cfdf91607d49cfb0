"""The port's int8 DCP serving (learning3d_tpu_torch.quant, K9's and K10's
plain versions, DGCNN.int8_scales) against the JAX package, on the CPU at a
small size.

Weights and inputs are made with numpy from a seed; quantized state crosses
through ``jax_import.load_quant_dcp`` (the int8 variables, the Python-float
scales and the encoder's ``int8_scales``), so that both sides run their
integer math with identical scales. JAX's K9 runs in Pallas interpret mode;
its K10 is reached through ``attention_int8_oracle``, which is what
``attention_int8`` runs off its accelerator. On the CPU the port's wrappers
run their plain versions.

Tolerances: integer math on identical inputs and scales is pinned exactly;
where a float epilogue may round otherwise, the int8 tie-flip profile
(``assert_tie_flip_profile``: fewer than 1% of the elements beyond f32
rounding, none beyond a few quant steps); the bf16 DCP result dict at the
bf16 slice's tolerances (3e-2 of each key's largest value, 5e-2 for r).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.experimental.pallas import tpu as pltpu

import learning3d_tpu.models.dgcnn as jdgcnn_mod
from learning3d_tpu import quant as jquant
from learning3d_tpu.kernels import attention as jattn
from learning3d_tpu.kernels import dgcnn_fused as jfused
from learning3d_tpu.models import DCP as JDCP
from learning3d_tpu.models import DGCNN as JDGCNN
from learning3d_tpu.utils import transformer as jtr
from learning3d_tpu_torch import quant as tquant
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import attention as tattn
from learning3d_tpu_torch.kernels import dgcnn_fused as tfused
from learning3d_tpu_torch.models import DCP, DGCNN
from learning3d_tpu_torch.serve import InferenceEngine
from learning3d_tpu_torch.utils import transformer as ttr
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, load_quant_dcp
from torch_port_util import (
    assert_tie_flip_profile, cloud, lattice_cloud, nnx_flat, quant_block_scales, quant_dcp_scales, randomize_bn, rel_err,
)

EMB, K = 64, 5
KEYS = ("est_R", "est_t", "est_R_", "est_t_", "est_T", "r", "transformed_source")
TOLS = {**{key: 3e-2 for key in KEYS}, "r": 5e-2}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def jax_dgcnn(seed=0):
    net = JDGCNN(emb_dims=EMB, k=K, rngs=nnx.Rngs(seed))
    randomize_bn(net, np.random.default_rng(seed))
    net.eval()
    return net


def port_dgcnn(jnet):
    return load_nnx_state(DGCNN(emb_dims=EMB, k=K, device="cpu"), nnx_flat(jnet)).eval()


@pytest.mark.parametrize("n_pts", [100, 64])
def test_calibrate_dgcnn_int8_matches_jax(n_pts):
    """The four static stage scales, rtol 1e-5 (BN folding may round a
    weight by one ulp; the percentile repeats XLA's arithmetic)."""
    jnet = jax_dgcnn()
    x = cloud(2, n_pts, seed=40)
    want = jfused.calibrate_dgcnn_int8(jnet.convs, jnet.bns, K, jnp.asarray(x))
    got = tfused.calibrate_dgcnn_int8(port_dgcnn(jnet).convs, port_dgcnn(jnet).bns, K, torch.from_numpy(x))
    assert len(got) == 4 and all(isinstance(s, float) for s in got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# K9's plain version against the JAX kernel in interpret mode with the same
# scales: the same neighbors, the same int8 rows; tie-flip profile (an f32
# epilogue or BN fold may round otherwise). N=100 pads inside the JAX
# kernel; the lattice decides its k-th neighbors by exact distance ties.
@pytest.mark.parametrize("case,batch,n_pts", [("random", 1, 128), ("ragged", 2, 100), ("ties", 1, 125)])
def test_k9_plain_matches_jax_interpret(case, batch, n_pts):
    jnet = jax_dgcnn()
    tnet = port_dgcnn(jnet)
    x = lattice_cloud(batch, n_pts, seed=41) if case == "ties" else cloud(batch, n_pts, seed=41)
    scales = jfused.calibrate_dgcnn_int8(jnet.convs, jnet.bns, K, jnp.asarray(x))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfused.dgcnn_encode_fused_int8(jnp.asarray(x), jnet.convs, jnet.bns, K, scales), np.float32)
    got = tfused.dgcnn_encode_fused_int8(torch.from_numpy(x), list(tnet.convs), list(tnet.bns), K, scales)
    assert got.dtype == torch.bfloat16 and got.shape == (batch, n_pts, EMB)
    assert_tie_flip_profile(got.float().numpy(), want)


@pytest.mark.parametrize("n_pts", [128, 100])
def test_k9_approx_plain_matches_jax_interpret(n_pts):
    """K9's plain version with approx_knn=True against the JAX kernel with
    approx_knn=True in interpret mode; the same scales, the tie-flip
    profile as the exact case."""
    jnet = jax_dgcnn()
    tnet = port_dgcnn(jnet)
    x = cloud(2, n_pts, seed=44 + n_pts)
    scales = jfused.calibrate_dgcnn_int8(jnet.convs, jnet.bns, K, jnp.asarray(x))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfused.dgcnn_encode_fused_int8(jnp.asarray(x), jnet.convs, jnet.bns, K, scales,
                                                         approx_knn=True), np.float32)
    got = tfused.dgcnn_encode_fused_int8(torch.from_numpy(x), list(tnet.convs), list(tnet.bns), K, scales,
                                         approx_knn=True)
    assert_tie_flip_profile(got.float().numpy(), want)


def test_dgcnn_int8_scales_route_to_k9():
    """Setting ``int8_scales`` builds K9's weights once and routes the eval
    forward of a bf16 DGCNN to K9 (its plain version on the CPU); clearing
    it goes back to K5."""
    jnet = jax_dgcnn()
    tnet = load_nnx_state(DGCNN(emb_dims=EMB, k=K, dtype=torch.bfloat16, device="cpu"), nnx_flat(jnet)).eval()
    x = torch.from_numpy(cloud(2, 64, seed=42))
    scales = tfused.calibrate_dgcnn_int8(tnet.convs, tnet.bns, K, x)
    tnet.int8_scales = scales
    assert isinstance(tnet.int8_weights, tfused.DGCNNInt8Weights)
    with torch.inference_mode():
        got = tnet(x)
        want = tfused.dgcnn_int8_reference(x, tnet.int8_weights, K)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    tnet.int8_scales = None
    assert tnet.int8_weights is None
    with torch.inference_mode():
        torch.testing.assert_close(tnet(x), tfused.dgcnn_encode_fused(x, list(tnet.convs), list(tnet.bns), K))


# K10's plain version against JAX's oracle: the int8 products are exact on
# both sides, but the two libraries' f32 exp may differ in the last ulp,
# which can flip round(127 p) or the output's bf16 rounding: tie-flip
# profile. M=200 is not a multiple of 64.
@pytest.mark.parametrize("int8_pv", [True, False])
@pytest.mark.parametrize("m", [200, 256])
def test_k10_plain_matches_jax_oracle(int8_pv, m):
    rng = np.random.default_rng(43 + m)
    q = rng.integers(-127, 128, (2, 2, 64, 128)).astype(np.int8)
    k, v = (rng.integers(-127, 128, (2, 2, m, 128)).astype(np.int8) for _ in range(2))
    s_q, s_k, s_v = 0.004, 0.005, 0.03
    want = np.asarray(jattn.attention_int8_oracle(*map(jnp.asarray, (q, k, v)), s_q, s_k, s_v, int8_pv=int8_pv))
    got = tattn.attention_int8(*map(torch.from_numpy, (q, k, v)), s_q, s_k, s_v, int8_pv=int8_pv)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 2, 64, 128)
    assert_tie_flip_profile(got.float().numpy(), np.asarray(want, np.float32))


def test_k10_gate_and_wrapper():
    """The guard is the JAX package's without its platform test; the wrapper
    runs no kernel off the card."""
    def ok(d, m):
        return tattn.attention_int8_ok(torch.empty(1, 1, 8, d, device="meta"), torch.empty(1, 1, m, d, device="meta"))

    assert ok(128, 128) and ok(512, 4096) and ok(256, 1000)
    assert not ok(64, 256) and not ok(640, 256) and not ok(128, 127) and not ok(128, 4097)
    q = torch.zeros(1, 1, 8, 128, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tattn.attention_int8_kernel(q, q, q, 0.1, 0.1, 0.1)


def test_k10_entry_takes_the_kernel_wherever_jax_does(monkeypatch):
    """Over a grid of (D, M), JAX's ``attention_int8`` (told it runs on a
    TPU, its ``pallas_call`` stubbed to report the launch) takes its kernel
    exactly where the port's entry, given a meta tensor standing in for a
    CUDA one, reaches K10's wrapper; the entry offers no other output dtype
    that could route round the kernel."""
    class Launched(Exception):
        pass

    def pallas_call(*args, **kwargs):
        raise Launched

    monkeypatch.setattr(jattn.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jattn.pl, "pallas_call", pallas_call)
    for d in (64, 128, 256, 512, 640):
        for m in (127, 128, 1000, 4096, 4097):
            q = np.zeros((1, 1, 8, d), np.int8)
            kv = jnp.zeros((1, 1, m, d), jnp.int8)
            try:
                jattn.attention_int8(jnp.asarray(q), kv, kv, 0.1, 0.1, 0.1)
                jax_kernel = False
            except Launched:
                jax_kernel = True
            tq, tkv = torch.empty(q.shape, dtype=torch.int8, device="meta"), torch.empty(kv.shape, dtype=torch.int8,
                                                                                          device="meta")
            try:
                tattn.attention_int8(tq, tkv, tkv, 0.1, 0.1, 0.1)
                port_kernel = False
            except ValueError as e:
                assert "no kernel" in str(e)
                port_kernel = True
            assert port_kernel == jax_kernel, (d, m)
    meta = torch.empty(1, 1, 8, 128, dtype=torch.int8, device="meta")
    with pytest.raises(TypeError):
        tattn.attention_int8(meta, meta, meta, 0.1, 0.1, 0.1, out_dtype=torch.float32)


def jax_mha_quantized(d=128, h=4, n=64, m=96, int8_pv=False):
    """A JAX MultiHeadedAttention, its QuantMHA for self- and for
    cross-attention (each calibrated as the JAX package's test does), and
    the inputs."""
    rng = np.random.default_rng(44)
    x = (rng.normal(size=(2, n, d)) * 0.5).astype(np.float32)
    mem = (rng.normal(size=(2, m, d)) * 0.5).astype(np.float32)
    mha = jtr.MultiHeadedAttention(h, d, rngs=nnx.Rngs(0))
    out = {}
    for name, args in (("self", (x, x, x)), ("cross", (x, mem, mem))):
        recs = {a: jquant._AmaxRecorder(getattr(mha, a)) for a in ("wq", "wk", "wv", "wo")}
        for a, r in recs.items():
            setattr(mha, a, r)
        jargs = [jnp.asarray(args[0])] * 3 if name == "self" else [jnp.asarray(x), jnp.asarray(mem), jnp.asarray(mem)]
        mha(*jargs)
        for a, r in recs.items():
            setattr(mha, a, r.inner)
        out[name] = jquant.QuantMHA(mha, recs["wq"], recs["wk"], recs["wv"], recs["wo"], int8_pv=int8_pv)
    return mha, out, x, mem


@pytest.mark.parametrize("int8_pv", [True, False])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_quant_mha_matches_jax(kind, int8_pv):
    """QuantMHA on carried-over int8 state and scales: the same integer
    products and epilogue order; tie-flip profile on the output."""
    _, jq, x, mem = jax_mha_quantized(int8_pv=int8_pv)
    jm = jq[kind]
    tm = tquant.QuantMHA(jm.h, jm.d_k, {k: torch.from_numpy(np.array(v)) for k, v in nnx_flat(jm).items()},
                         quant_block_scales(jm), int8_pv=int8_pv)
    tx = torch.from_numpy(x)
    targs = (tx, tx, tx) if kind == "self" else (tx, torch.from_numpy(mem), torch.from_numpy(mem))
    want = jm(*(jnp.asarray(a.numpy()) for a in targs)) if kind == "cross" else jm(*([jnp.asarray(x)] * 3))
    with torch.inference_mode():
        got = tm(*targs)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert_tie_flip_profile(got.numpy(), np.asarray(want))


def test_quant_mha_calibration_matches_jax():
    """The port's own surgery (recorders, scales, merged K|V weights) on the
    port twin of the same float MHA: scales rtol 1e-5, weights exact,
    output in the tie-flip profile."""
    mha, jq, x, _ = jax_mha_quantized()
    tmha = load_nnx_state(ttr.MultiHeadedAttention(4, 128, device="cpu"), nnx_flat(mha))
    recs = {a: tquant._AmaxRecorder(getattr(tmha, a)) for a in ("wq", "wk", "wv", "wo")}
    for a, r in recs.items():
        setattr(tmha, a, r)
    tx = torch.from_numpy(x)
    with torch.inference_mode():
        tmha(tx, tx, tx)
    for a, r in recs.items():
        setattr(tmha, a, r.inner)
    tq = tquant.QuantMHA.from_float(tmha, recs["wq"], recs["wk"], recs["wv"], recs["wo"])
    jm = jq["self"]
    for name, value in quant_block_scales(jm).items():
        np.testing.assert_allclose(getattr(tq, name), value, rtol=1e-5)
    for name in ("wq_q", "wkv_q", "wo_q"):
        np.testing.assert_array_equal(getattr(tq, name).numpy(), np.asarray(getattr(jm, name)[...]))
    with torch.inference_mode():
        got = tq(tx, tx, tx)
    assert_tie_flip_profile(got.numpy(), np.asarray(jm(*([jnp.asarray(x)] * 3))))


def test_quant_ff_matches_jax():
    """QuantFF on carried-over state, and the port's own calibration."""
    rng = np.random.default_rng(45)
    x = rng.normal(size=(2, 40, 64)).astype(np.float32)
    ff = jtr.FeedForward(64, 128, rngs=nnx.Rngs(2))
    recs = {a: jquant._AmaxRecorder(getattr(ff, a)) for a in ("w1", "w2")}
    for a, r in recs.items():
        setattr(ff, a, r)
    ff(jnp.asarray(x))
    for a, r in recs.items():
        setattr(ff, a, r.inner)
    jq = jquant.QuantFF(ff, recs["w1"], recs["w2"])
    want = np.asarray(jq(jnp.asarray(x)))
    tq = tquant.QuantFF({k: torch.from_numpy(np.array(v)) for k, v in nnx_flat(jq).items()}, quant_block_scales(jq))
    with torch.inference_mode():
        got = tq(torch.from_numpy(x))
    assert_tie_flip_profile(got.numpy(), want)
    tff = load_nnx_state(ttr.FeedForward(64, 128, device="cpu"), nnx_flat(ff))
    layer = torch.nn.Module()
    layer.self_attn, layer.ff = ttr.MultiHeadedAttention(4, 64, device="cpu"), tff
    tquant.quantize_transformer_layer(layer, lambda lyr: (lyr.ff(torch.from_numpy(x)),
                                                          lyr.self_attn(*[torch.from_numpy(x)] * 3)))
    assert isinstance(layer.ff, tquant.QuantFF)
    np.testing.assert_allclose([layer.ff.s_in, layer.ff.s_h], [jq.s_in, jq.s_h], rtol=1e-5)


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_quantize_transformer_layer_matches_jax(kind):
    """Per-layer surgery on both sides (each its own calibration on the same
    weights and inputs): every block swapped, scales rtol 1e-5, the layer's
    output in the tie-flip profile."""
    rng = np.random.default_rng(46)
    x, mem = (rng.normal(size=(2, 32, 128)).astype(np.float32) for _ in range(2))
    jcls, tcls = (jtr._EncoderLayer, ttr._EncoderLayer) if kind == "encoder" else (jtr._DecoderLayer, ttr._DecoderLayer)
    jl = jcls(128, 4, 256, rngs=nnx.Rngs(3))
    tl = load_nnx_state(tcls(128, 4, 256, device="cpu"), nnx_flat(jl))
    jargs = (jnp.asarray(x),) if kind == "encoder" else (jnp.asarray(x), jnp.asarray(mem))
    targs = tuple(torch.from_numpy(np.asarray(a)) for a in jargs)
    jquant.quantize_transformer_layer(jl, lambda lyr: lyr(*jargs))
    tquant.quantize_transformer_layer(tl, lambda lyr: lyr(*targs))
    blocks = ("self_attn", "ff") if kind == "encoder" else ("self_attn", "cross_attn", "ff")
    for name in blocks:
        jb, tb = getattr(jl, name), getattr(tl, name)
        assert isinstance(tb, tquant.QuantMHA if name != "ff" else tquant.QuantFF)
        for s, value in quant_block_scales(jb).items():
            np.testing.assert_allclose(getattr(tb, s), value, rtol=1e-5)
    with torch.inference_mode():
        got = tl(*targs)
    assert_tie_flip_profile(got.numpy(), np.asarray(jl(*jargs)))


def jax_dcp(seed=0):
    jm = JDCP(JDGCNN(emb_dims=EMB, k=K, dtype=jnp.bfloat16, rngs=nnx.Rngs(seed)), dtype=jnp.bfloat16,
              rngs=nnx.Rngs(seed + 1))
    randomize_bn(jm, np.random.default_rng(seed))
    jm.eval()
    return jm


def port_dcp(jm):
    tm = DCP(DGCNN(emb_dims=EMB, k=K, dtype=torch.bfloat16, device="cpu"), dtype=torch.bfloat16, device="cpu")
    return load_nnx_state(tm, nnx_flat(jm)).eval()


@pytest.fixture(scope="module")
def int8_dcp():
    """A bf16 JAX DCP, its quantize_dcp(int8_pv=True, fused_layers=False)
    clone, the port twin of the clone, the port's own quantized clone and
    the calibration and test clouds."""
    jm = jax_dcp()
    tm = port_dcp(jm)
    calib_t, calib_s = cloud(2, 64, seed=47), cloud(2, 64, seed=48)
    jq = jquant.quantize_dcp(jm, jnp.asarray(calib_t), jnp.asarray(calib_s), int8_pv=True, fused_layers=False)
    tq = load_quant_dcp(tm, nnx_flat(jq), quant_dcp_scales(jq), jq.emb_nn.int8_scales, int8_pv=True)
    own = tquant.quantize_dcp(tm, torch.from_numpy(calib_t), torch.from_numpy(calib_s), int8_pv=True,
                              fused_layers=False)
    return jm, jq, tm, tq, own, (cloud(2, 64, seed=49), cloud(2, 64, seed=50))


def jax_int8_forward(monkeypatch, jq, template, source):
    """JAX's int8 DCP with its K9 on the path: the encoder's guard opened
    (it tests for a TPU) and the kernel in Pallas interpret mode."""
    monkeypatch.setattr(jdgcnn_mod, "dgcnn_fused_ok", lambda *a: True)
    with pltpu.force_tpu_interpret_mode():
        return jq(jnp.asarray(template), jnp.asarray(source))


def test_int8_dcp_matches_jax(int8_dcp, monkeypatch):
    """The slice: int8 DCP's result dict against JAX's clone on the same
    state (JAX's K9 in interpret mode, K10 through its oracle), and the
    port's own quantized clone against it too, at the bf16 slice's
    tolerances; K9 (2) and K10 (6) reached through their plain versions."""
    _, jq, _, tq, own, (template, source) = int8_dcp
    calls = {"k9": 0, "k10": 0}
    k9, k10 = tfused.dgcnn_int8_reference, tattn.attention_int8_reference
    monkeypatch.setattr(tfused, "dgcnn_int8_reference", lambda *a: calls.__setitem__("k9", calls["k9"] + 1) or k9(*a))
    monkeypatch.setattr(tattn, "attention_int8_reference",
                        lambda *a: calls.__setitem__("k10", calls["k10"] + 1) or k10(*a))
    want = jax_int8_forward(monkeypatch, jq, template, source)
    with torch.inference_mode():
        got = tq(torch.from_numpy(template), torch.from_numpy(source))
        mine = own(torch.from_numpy(template), torch.from_numpy(source))
    assert calls == {"k9": 4, "k10": 12}
    assert set(got) == set(KEYS)
    for key in KEYS:
        assert got[key].shape == want[key].shape, key
        assert rel_err(got[key], want[key]) <= TOLS[key], key
        assert rel_err(mine[key], want[key]) <= TOLS[key], key


def test_quantize_dcp_structure(int8_dcp):
    """Every pointer block is swapped in the clone and the original is
    untouched; the encoder carries scales equal to JAX's (rtol 1e-5)."""
    _, jq, tm, _, own, _ = int8_dcp
    for layer in list(own.pointer.enc_layers) + list(own.pointer.dec_layers):
        assert isinstance(layer.self_attn, tquant.QuantMHA) and isinstance(layer.ff, tquant.QuantFF)
    assert isinstance(own.pointer.dec_layers[0].cross_attn, tquant.QuantMHA)
    assert not isinstance(tm.pointer.enc_layers[0].self_attn, tquant.QuantMHA)
    assert tm.emb_nn.int8_scales is None
    np.testing.assert_allclose(own.emb_nn.int8_scales, jq.emb_nn.int8_scales, rtol=1e-5)


def test_approx_knn_flag_survives_quantize_dcp(int8_dcp):
    """``DGCNN(approx_knn=True)``: quantize_dcp's clone keeps the flag, and
    its encoder runs K9's approx selection (the plain version here)."""
    _, _, tm, _, _, (template, _) = int8_dcp
    tm.emb_nn.approx_knn = True
    try:
        calib = torch.from_numpy(cloud(2, 64, seed=47)), torch.from_numpy(cloud(2, 64, seed=48))
        clone = tquant.quantize_dcp(tm, *calib, int8_pv=True, fused_layers=True)
    finally:
        tm.emb_nn.approx_knn = False
    assert clone.emb_nn.approx_knn
    x = torch.from_numpy(template)
    with torch.inference_mode():
        want = tfused.dgcnn_int8_reference(x, clone.emb_nn.int8_weights, K, True)
        torch.testing.assert_close(clone.emb_nn(x), want, rtol=0, atol=0)


def test_fused_layers_compose_on_cpu_and_raise_elsewhere(int8_dcp):
    """fused_layers=True off JAX's gate ``fused_layer_ok`` (d=64 with 4
    heads here): each layer composes its blocks, on every device, as the JAX
    package does, so the result equals fused_layers=False. On the gate a CPU tensor runs K11's plain version
    (tests/test_torch_transformer_int8.py) and any tensor off the CPU other
    than a CUDA one (a meta tensor here) raises naming K11a/K11b, never
    composing in place of the kernel."""
    _, _, tm, _, own, (template, source) = int8_dcp
    calib = torch.from_numpy(cloud(2, 64, seed=47)), torch.from_numpy(cloud(2, 64, seed=48))
    fused = tquant.quantize_dcp(tm, *calib, int8_pv=True, fused_layers=True)
    assert isinstance(fused.pointer.enc_layers[0], tquant.QuantEncoderLayerFused)
    with torch.inference_mode():
        a = fused(torch.from_numpy(template), torch.from_numpy(source))
        b = own(torch.from_numpy(template), torch.from_numpy(source))
    for key in KEYS:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)

    rng = np.random.default_rng(53)
    x, mem = (torch.from_numpy(rng.normal(size=(1, 256, 256)).astype(np.float32)) for _ in range(2))
    enc = tquant.quantize_transformer_layer(ttr._EncoderLayer(256, 2, 512, device="cpu"), lambda lyr: lyr(x))
    dec = tquant.quantize_transformer_layer(ttr._DecoderLayer(256, 2, 512, device="cpu"), lambda lyr: lyr(x, mem))
    enc, dec = tquant.QuantEncoderLayerFused(enc), tquant.QuantDecoderLayerFused(dec)
    meta = torch.empty(1, 256, 256, device="meta")
    with pytest.raises(NotImplementedError, match="K11a"):
        enc(meta)
    with pytest.raises(NotImplementedError, match="K11b"):
        dec(meta, meta)


def test_inference_engine_serves_int8_dcp(int8_dcp):
    """The int8 clone through InferenceEngine at batch 2 on 3 pairs (a full
    chunk and a tail padded with a zero pair): each key equals a direct
    forward of the same padded chunks. The padding cannot raise the
    encoder's whole-batch xw1 scale (zeros)."""
    _, _, _, tq, _, _ = int8_dcp
    template, source = cloud(3, 64, seed=51), cloud(3, 64, seed=52)
    out = InferenceEngine(tq, batch_size=2, device="cpu")(template, source)
    pad = lambda a: torch.from_numpy(np.concatenate([a, np.zeros_like(a[:1])]))  # noqa: E731
    with torch.inference_mode():
        chunks = [tq(pad(template)[i : i + 2], pad(source)[i : i + 2]) for i in (0, 2)]
    for key in KEYS:
        want = torch.cat([c[key] for c in chunks])[:3].float().numpy()
        assert out[key].shape[0] == 3
        np.testing.assert_array_equal(out[key], want)
    assert LAUNCHES["dgcnn_encode_fused_int8"] == 0 and LAUNCHES["attention_int8"] == 0
