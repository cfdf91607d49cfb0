"""The port's int8 PTQ of the PointNet classifier (learning3d_tpu_torch.quant
and K2's plain version) against the JAX package, on the CPU at a small size.

Weights and inputs are made with numpy from a seed and cross as numpy
arrays; quantized state crosses through ``jax_import.load_quant_pointnet``
so that both sides run their integer math with identical scales. On the
CPU the port's K2 wrapper runs its plain version; the JAX kernel runs in
Pallas interpret mode, as tests/test_pallas_interpret.py runs it.

Tolerances follow the int8 tie-flip profile: where both sides run the same
plain math with the same scales the integers are pinned exactly; where a
float epilogue may round otherwise (another f32 sum order, or XLA fusing a
multiply-add), an element may sit one int8 step off, so the float outputs
are held to f32 rounding (1e-5 of the largest value) on all but fewer than
1% of their elements and, on those, to a few quant steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.experimental.pallas import tpu as pltpu

from learning3d_tpu import quant as jquant
from learning3d_tpu.kernels import pointnet_fused as jfused
from learning3d_tpu.models import Classifier as JClassifier
from learning3d_tpu.models import PointNet as JPointNet
from learning3d_tpu_torch import quant as tquant
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import pointnet_fused as tfused
from learning3d_tpu_torch.models import Classifier, PointNet
from learning3d_tpu_torch.ops import int8 as tint8
from learning3d_tpu_torch.serve import InferenceEngine
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, load_quant_pointnet
from torch_port_util import assert_tie_flip_profile, cloud, nnx_flat, quant_pointnet_arrays, randomize_bn

EMB, CLASSES = 128, 40


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def jax_classifier(seed=0):
    jm = JClassifier(JPointNet(emb_dims=EMB, use_bn=True, rngs=nnx.Rngs(seed)), CLASSES, rngs=nnx.Rngs(seed + 1))
    randomize_bn(jm, np.random.default_rng(seed))
    jm.eval()
    return jm


def port_classifier(jm):
    tm = Classifier(PointNet(emb_dims=EMB, use_bn=True, device="cpu"), CLASSES, device="cpu")
    return load_nnx_state(tm, nnx_flat(jm)).eval()


@pytest.fixture(scope="module")
def quantized():
    """A JAX-quantized classifier, its port twin on the same state, and the
    calibration batch."""
    jm = jax_classifier()
    x = cloud(3, 200)
    jqm = jquant.quantize_pointnet_classifier(jm, jnp.asarray(x))
    return jm, jqm, load_quant_pointnet(quant_pointnet_arrays(jqm), device="cpu"), x


def test_quantize_weight_matches_jax():
    """Per-column scales and int8 weights, exact."""
    w = np.random.default_rng(30).normal(size=(64, 48)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column takes the 1e-12 floor
    jq, js = map(np.asarray, jquant.quantize_weight(jnp.asarray(w)))
    tq, ts = tquant.quantize_weight(torch.from_numpy(w))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)


def test_quantize_activation_matches_jax():
    """Round half to even and the +-127 clamp, exact: the inputs include
    exact halves (x / 0.5 = k + 0.5) and values past the clamp."""
    rng = np.random.default_rng(31)
    x = np.concatenate([rng.normal(0.0, 20.0, 500), (np.arange(-80, 80) + 0.5) * 0.5, [1e3, -1e3]]).astype(np.float32)
    for s in (0.5, 0.037):
        want = np.asarray(jquant.quantize_activation(jnp.asarray(x), s))
        np.testing.assert_array_equal(tquant.quantize_activation(torch.from_numpy(x), s).numpy(), want)
        np.testing.assert_array_equal(tquant._requant(torch.from_numpy(x), s).numpy(), want)


@pytest.mark.parametrize("n,p", [(1000, 99.99), (65536, 99.9), (12345, 50.0), (327680, 99.9)])
def test_act_scale_matches_jax(n, p):
    """The percentile of |x| and the scale, rtol 1e-5 (the port repeats
    XLA's float32 index arithmetic, so they are equal in practice)."""
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    want = float(jquant._act_scale(jnp.asarray(x), p))
    got = tquant._act_scale(torch.from_numpy(x), p)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_percentile_beyond_two_to_the_24():
    """More values than ``torch.quantile`` takes (2^24): no error, and the
    order statistic numpy finds at the same float32 index."""
    n = (1 << 24) + 4097
    x = np.abs(np.random.default_rng(32).normal(size=n)).astype(np.float32)
    got = tint8.percentile(torch.from_numpy(x), 99.99).item()
    want = np.percentile(x, 99.99)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_quantize_pointnet_classifier_matches_jax(quantized):
    """The port's own calibration on the port model against JAX's on the
    JAX model: scales rtol 1e-5; weights exact, except where BN folding
    rounds a weight to the other side of a rounding tie (at most a handful,
    one step)."""
    jm, jqm, _, x = quantized
    tqm = tquant.quantize_pointnet_classifier(port_classifier(jm), torch.from_numpy(x))
    for jl, tl in zip(list(jqm.enc) + list(jqm.head), list(tqm.enc) + list(tqm.head)):
        np.testing.assert_allclose(tl.s_x.item(), float(jl.s_x), rtol=1e-5)
        np.testing.assert_allclose(tl.s_w.numpy(), np.asarray(jl.s_w), rtol=1e-5)
        diff = np.abs(tl.w_q.numpy().astype(np.int32) - np.asarray(jl.w_q).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).sum() <= 4
    with torch.inference_mode():
        got = tquant.quant_forward(tqm, torch.from_numpy(x)).numpy()
    assert_tie_flip_profile(got, np.asarray(jquant.quant_forward(jqm, jnp.asarray(x))))


def test_quant_forward_matches_jax(quantized):
    """The plain int8 forward on carried-over state: the same int8 products
    and the same epilogues; tie-flip profile."""
    _, jqm, tqm, _ = quantized
    x = cloud(2, 150, seed=33)
    with torch.inference_mode():
        got = tquant.quant_forward(tqm, torch.from_numpy(x)).numpy()
    assert got.shape == (2, CLASSES)
    assert_tie_flip_profile(got, np.asarray(jquant.quant_forward(jqm, jnp.asarray(x))))


@pytest.mark.parametrize("n_pts", [200, 97])
def test_k2_plain_matches_jax_interpret(quantized, n_pts):
    """K2's plain version against JAX's pointnet_pooled_int8 in Pallas
    interpret mode, with the same qlayers: the pooled (B, emb) f32 feature;
    tie-flip profile (stage 1's three-term f32 sum may round otherwise).
    N=97 is padded inside the JAX kernel."""
    _, jqm, tqm, _ = quantized
    x = cloud(3, n_pts, seed=34)
    jql = [(q.w_q, q.s_w, q.b, float(q.s_x)) for q in jqm.enc]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfused.pointnet_pooled_int8(jnp.asarray(x), jqm.w1, jqm.b1, jql))
    tql = [(q.w_q, q.s_w, q.b, float(q.s_x)) for q in tqm.enc]
    got = tfused.pointnet_pooled_int8(torch.from_numpy(x), tqm.w1, tqm.b1, tql)
    assert got.dtype == torch.float32 and got.shape == (3, EMB)
    assert_tie_flip_profile(got.numpy(), want)


def test_fused_entry_matches_jax(quantized):
    """make_fused_quant_forward (K2's plain version here) against JAX's with
    its K2 in interpret mode: logits, tie-flip profile; and K2 is not
    launched on the CPU."""
    _, jqm, tqm, _ = quantized
    x = cloud(2, 128, seed=35)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jquant.make_fused_quant_forward(jqm)(jnp.asarray(x)))
    before = LAUNCHES["pointnet_pooled_int8"]
    fused = tquant.make_fused_quant_forward(tqm)
    assert isinstance(fused, torch.nn.Module)
    with torch.inference_mode():
        got = fused(torch.from_numpy(x)).numpy()
    assert LAUNCHES["pointnet_pooled_int8"] == before
    assert_tie_flip_profile(got, want)


@pytest.mark.parametrize("entry", ["plain", "fused"])
def test_inference_engine_serves_int8_classifier(quantized, entry):
    """Both int8 entries through InferenceEngine at batch 2 on 5 clouds (two
    full chunks and a tail padded with a zero cloud): the rows equal a
    direct forward of the same (padded) chunks."""
    _, _, tqm, _ = quantized
    model = tqm if entry == "plain" else tquant.make_fused_quant_forward(tqm)
    x = cloud(5, 64, seed=36)
    out = InferenceEngine(model, batch_size=2, device="cpu")(x)
    assert out.shape == (5, CLASSES) and out.dtype == np.float32
    padded = torch.from_numpy(np.concatenate([x, np.zeros_like(x[:1])]))
    with torch.inference_mode():
        want = torch.cat([model(padded[i : i + 2]) for i in range(0, 6, 2)])[:5].numpy()
    np.testing.assert_array_equal(out, want)


def test_k2_wrapper_refuses_other_devices(quantized):
    _, _, tqm, _ = quantized
    pack = tquant.make_fused_quant_forward(tqm).pack
    with pytest.raises(ValueError, match="no kernel"):
        tfused.pointnet_pooled_int8_kernel(torch.empty(1, 8, 3, device="meta"), pack)
