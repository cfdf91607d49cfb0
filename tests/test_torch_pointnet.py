"""The port's PointNet classifier slice (learning3d_tpu_torch) against the
JAX package, on the CPU at a small size.

Inputs and weights are made with numpy from a seed and handed to both
sides as numpy arrays. On the CPU the port's kernel wrapper runs its plain
version (``oracle_chain``); the JAX fused kernel runs in Pallas interpret
mode, as tests/test_pallas_interpret.py runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.experimental.pallas import tpu as pltpu

from learning3d_tpu.kernels import pointnet_fused as jfused
from learning3d_tpu.models import Classifier as JClassifier
from learning3d_tpu.models import PointNet as JPointNet
from learning3d_tpu.utils import layers as jlayers
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import pointnet_fused as tfused
from learning3d_tpu_torch.models import Classifier, PointNet
from learning3d_tpu_torch.serve import InferenceEngine
from learning3d_tpu_torch.utils import layers as tlayers
from learning3d_tpu_torch.utils.jax_import import load_nnx_state

EMB, CLASSES = 128, 40
DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def nnx_flat(module):
    """The JAX side of the weight transfer: dotted nnx paths -> numpy."""
    return {
        ".".join(map(str, path)): np.asarray(v.get_value())
        for path, v in nnx.to_flat_state(nnx.state(module))
        if "rngs" not in path
    }


def randomize_bn(module, rng):
    """Non-trivial running stats and affine, with some negative scales so
    the min branch of the fused BN-ReLU-max pool is taken too."""
    for path, v in nnx.to_flat_state(nnx.state(module)):
        shape = v.get_value().shape
        if path[-1] == "mean":
            v.set_value(jnp.asarray(rng.normal(0.0, 0.3, shape), jnp.float32))
        elif path[-1] == "var":
            v.set_value(jnp.asarray(rng.uniform(0.5, 2.0, shape), jnp.float32))
        elif path[-1] == "scale":
            sign = rng.choice([-1.0, 1.0], shape, p=[0.2, 0.8])
            v.set_value(jnp.asarray(sign * rng.uniform(0.5, 1.5, shape), jnp.float32))


def jax_classifier(jdtype, seed=0):
    rng = np.random.default_rng(seed)
    jm = JClassifier(
        JPointNet(emb_dims=EMB, use_bn=True, dtype=jdtype, rngs=nnx.Rngs(seed)),
        CLASSES, dtype=jdtype, rngs=nnx.Rngs(seed + 1),
    )
    randomize_bn(jm, rng)
    jm.eval()
    return jm


def port_classifier(jm, tdtype):
    tm = Classifier(PointNet(emb_dims=EMB, use_bn=True, dtype=tdtype, device="cpu"), CLASSES,
                    dtype=tdtype, device="cpu")
    load_nnx_state(tm, nnx_flat(jm))
    return tm.eval()


def folded_numpy(seed=0):
    """BN-folded chain weights of a JAX PointNet with randomized stats."""
    net = JPointNet(emb_dims=EMB, use_bn=True, rngs=nnx.Rngs(seed))
    randomize_bn(net, np.random.default_rng(seed))
    net.eval()
    folded = [jfused.fold_conv_bn(c, bn) for c, bn in zip(net.convs, net.bns)]
    return [np.asarray(w) for w, _ in folded], [np.asarray(b) for _, b in folded]


def cloud(b, n, seed=1):
    return np.random.default_rng(seed).normal(size=(b, n, 3)).astype(np.float32)


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def as_torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# f32: same operands, only the summation order differs. bf16: both round
# the same operands, but an f32 sum in another order can round an
# intermediate activation to the neighbouring bf16 value (2^-8 relative).
@pytest.mark.parametrize("name,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_oracle_chain_matches_jax(name, tol):
    ws, bs = folded_numpy()
    x = cloud(3, 200)
    jdt = jnp.float32 if name == "f32" else jnp.bfloat16
    tdt = torch.float32 if name == "f32" else torch.bfloat16
    want = jfused.oracle_chain(jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs], jdt)
    got = tfused.oracle_chain(torch.from_numpy(x), as_torch(ws), as_torch(bs), tdt)
    assert got.dtype == tdt and got.shape == (3, EMB)
    assert rel_err(got.float(), want) <= tol


@pytest.mark.parametrize("name,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_port_k1_matches_jax_k1_interpret(name, tol):
    """The JAX fused kernel (Pallas interpret mode) against the port's K1
    wrapper on a CPU tensor, at B=3, N=256, emb=128."""
    ws, bs = folded_numpy()
    x = cloud(3, 256, seed=8)
    jdt = jnp.float32 if name == "f32" else jnp.bfloat16
    tdt = torch.float32 if name == "f32" else torch.bfloat16
    with pltpu.force_tpu_interpret_mode():
        want = jfused.pointnet_pooled_kernel(
            jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs], dot_dtype=jdt
        )
    launches = LAUNCHES["pointnet_pooled_kernel"]
    got = tfused.pointnet_pooled_kernel(torch.from_numpy(x), as_torch(ws), as_torch(bs), dot_dtype=tdt)
    assert LAUNCHES["pointnet_pooled_kernel"] == launches  # the plain version is no launch
    assert rel_err(got.float(), want) <= tol


def test_fold_conv_bn_matches_jax():
    jm = jax_classifier(None)
    tm = port_classifier(jm, None)
    for jc, jb, tc, tb in zip(jm.feature_model.convs, jm.feature_model.bns,
                              tm.feature_model.convs, tm.feature_model.bns):
        jw, jbias = jfused.fold_conv_bn(jc, jb)
        tw, tbias = tfused.fold_conv_bn(tc, tb)
        np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tbias.detach().numpy(), np.asarray(jbias), rtol=1e-6, atol=1e-6)
    tw, tbias = tfused.fold_conv_bn(tm.feature_model.convs[0], None)
    np.testing.assert_array_equal(tw.detach().numpy(), np.asarray(jm.feature_model.convs[0].kernel[...]))


# f32: 1e-4 of the largest logit (f32 sums in another order through 8
# layers). bf16: the JAX CPU path rounds every conv output and every BN
# step to bf16 while the port folds BN into f32 weights for its fused
# chain, as the JAX TPU kernel does; eight layers of 2^-8 roundings in
# different places stay within 3e-2 of the largest value.
BF16_SLICE_TOL = 3e-2
SLICE_TOL = {"f32": 1e-4, "bf16": BF16_SLICE_TOL}


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_classifier_logits_match_jax(name):
    jdt, tdt = DTYPES[name]
    jm = jax_classifier(jdt)
    tm = port_classifier(jm, tdt)
    x = cloud(3, 200, seed=2)
    want = jm(jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert got.shape == (3, CLASSES)
    assert rel_err(got.float(), want) <= SLICE_TOL[name]


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_pooled_features_match_jax(name):
    jdt, tdt = DTYPES[name]
    jm = jax_classifier(jdt)
    tm = port_classifier(jm, tdt)
    x = cloud(2, 160, seed=3)
    want = jm.feature_model.pooled_features(jnp.asarray(x))
    with torch.inference_mode():
        got = tm.feature_model.pooled_features(torch.from_numpy(x))
    assert got.shape == (2, EMB)
    assert rel_err(got.float(), want) <= SLICE_TOL[name]


@pytest.mark.parametrize("global_feat", [True, False])
def test_pointnet_point_features_match_jax(global_feat):
    net = JPointNet(emb_dims=64, use_bn=True, global_feat=global_feat, rngs=nnx.Rngs(4))
    randomize_bn(net, np.random.default_rng(4))
    net.eval()
    port = PointNet(emb_dims=64, use_bn=True, global_feat=global_feat, device="cpu")
    load_nnx_state(port, nnx_flat(net)).eval()
    x = cloud(2, 50, seed=5)
    want = net(jnp.asarray(x))
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-5


def test_input_shape_bcn():
    port = PointNet(emb_dims=64, input_shape="bcn", device="cpu").eval()
    x = torch.from_numpy(cloud(2, 40))
    bnc = PointNet(emb_dims=64, device="cpu").eval()
    bnc.load_state_dict(port.state_dict())
    with torch.inference_mode():
        np.testing.assert_allclose(port(x.transpose(1, 2)).numpy(), bnc(x).numpy(), rtol=1e-6)
    with pytest.raises(ValueError):
        PointNet(input_shape="nbc", device="cpu")


def test_mlp1d_and_pooling_match_jax():
    jm = jlayers.MLP1d([3, 16, 8], rngs=nnx.Rngs(6))
    randomize_bn(jm, np.random.default_rng(6))
    jm.eval()
    tm = tlayers.MLP1d([3, 16, 8], device="cpu")
    load_nnx_state(tm, nnx_flat(jm)).eval()
    x = cloud(2, 30, seed=7)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
        for kind in ("max", "mean"):
            pooled = tlayers.Pooling(kind)(got).numpy()
            want = jlayers.Pooling(kind)(jm(jnp.asarray(x)))
            assert rel_err(pooled, want) <= 1e-5
    assert rel_err(got, jm(jnp.asarray(x))) <= 1e-5


def test_fused_backward_matches_oracle_grads():
    """The autograd Function's backward recomputes through oracle_chain:
    its gradients equal differentiating oracle_chain directly."""
    ws, bs = folded_numpy()
    x0 = torch.from_numpy(cloud(2, 64, seed=9))
    grads = []
    for run in ("fused", "oracle"):
        x = x0.clone().requires_grad_(True)
        w = [t.clone().requires_grad_(True) for t in as_torch(ws)]
        if run == "fused":
            out = tfused._FusedBF16.apply(x, *w, *as_torch(bs))
        else:
            out = tfused.oracle_chain(x, w, as_torch(bs), torch.bfloat16)
        out.float().sum().backward()
        grads.append([x.grad] + [t.grad for t in w])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("n", [3, 4, 10])
def test_inference_engine_pads_and_concatenates(n):
    """Tail padding and multi-chunk concatenation against one direct
    forward of all clouds (batch_size 4: n=3 is one padded chunk, n=4 one
    full chunk, n=10 two full chunks and a padded tail)."""
    jm = jax_classifier(jnp.bfloat16, seed=3)
    tm = port_classifier(jm, torch.bfloat16)
    x = cloud(n, 64, seed=10)
    out = InferenceEngine(tm, batch_size=4, device="cpu")(x)
    with torch.inference_mode():
        want = tm(torch.from_numpy(x)).float().numpy()
    assert out.shape == (n, CLASSES) and out.dtype == np.float32
    np.testing.assert_array_equal(out, want)


def test_inference_engine_rejects_mismatched_inputs():
    engine = InferenceEngine(PointNet(emb_dims=64, device="cpu"), batch_size=4, device="cpu")
    with pytest.raises(ValueError):
        engine(cloud(3, 16), cloud(2, 16))


@pytest.mark.parametrize("fault", ["missing", "misshaped", "unexpected"])
def test_load_nnx_state_raises(fault):
    flat = nnx_flat(jax_classifier(None))
    if fault == "missing":
        del flat["feature_model.bns.2.var"]
        err = KeyError
    elif fault == "misshaped":
        flat["linear2.kernel"] = flat["linear2.kernel"][:, :-1]
        err = ValueError
    else:
        flat["linear4.kernel"] = np.zeros((3, 3), np.float32)
        err = KeyError
    model = Classifier(PointNet(emb_dims=EMB, use_bn=True, device="cpu"), CLASSES, device="cpu")
    with pytest.raises(err):
        load_nnx_state(model, flat)


def test_load_nnx_state_skips_rngs_and_transposes():
    jm = jax_classifier(None)
    flat = nnx_flat(jm)
    flat["dropout1.rngs.count"] = np.zeros((), np.uint32)
    tm = Classifier(PointNet(emb_dims=EMB, use_bn=True, device="cpu"), CLASSES, device="cpu")
    load_nnx_state(tm, flat)
    np.testing.assert_array_equal(tm.linear1.weight.detach().numpy(), flat["linear1.kernel"].T)
    np.testing.assert_array_equal(tm.bn1.running_var.numpy(), flat["bn1.var"])


def test_fused_gate():
    """K1 is taken only for eval-mode BN, bf16 compute and 3-channel clouds."""
    bf16 = PointNet(emb_dims=EMB, use_bn=True, dtype=torch.bfloat16, device="cpu")
    x = torch.zeros(1, 8, 3)
    assert not tfused.pointnet_fused_ok(x, bf16.convs, bf16.bns)  # train mode
    bf16.eval()
    assert tfused.pointnet_fused_ok(x, bf16.convs, bf16.bns)
    assert not tfused.pointnet_fused_ok(torch.zeros(1, 8, 6), bf16.convs, bf16.bns)
    f32 = PointNet(emb_dims=EMB, use_bn=True, device="cpu").eval()
    assert not tfused.pointnet_fused_ok(x, f32.convs, f32.bns)
    with pytest.raises(NotImplementedError):
        PointNet(emb_dims=EMB, use_bn=True, device="cpu").pooled_features(x)


@pytest.mark.parametrize("bad", ["dtype", "emb", "x_shape", "dot_dtype"])
def test_kernel_argument_checks(bad):
    """What the CUDA wrapper refuses before any launch."""
    ws, bs = (as_torch(a) for a in folded_numpy())
    x = torch.zeros(2, 16, 3)
    dot = torch.bfloat16
    if bad == "dtype":
        x = x.double()
    elif bad == "emb":
        ws[-1], bs[-1] = ws[-1][:, :100].contiguous(), bs[-1][:100]
    elif bad == "x_shape":
        x = torch.zeros(2, 16, 4)
    else:
        dot = torch.float32
    with pytest.raises(ValueError):
        tfused._check_kernel_args(x, ws, bs, dot)
