"""K3 (pool_stats) and K4 (pool_bwd) of the port, and the train-mode fused
PointNet tail around them, against the JAX package on the CPU.

Inputs are made with numpy from a seed. The JAX kernels run in Pallas
interpret mode; on the CPU the port's wrappers run their plain versions. The
Gram-matrix autograd Function is held against ``jax.vjp`` of the JAX
package's custom VJP (its XLA branch, as the JAX CPU backend runs it) and,
independently, against torch autograd of the naive chain in f64.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.experimental.pallas import tpu as pltpu

from learning3d_tpu.kernels import poolgrad as jpool
from learning3d_tpu.utils import layers as jlayers
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import poolgrad as tpool
from learning3d_tpu_torch.utils import layers as tlayers
from learning3d_tpu_torch.utils.jax_import import load_nnx_state
from torch_port_util import nnx_flat

K = 128
DT = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def tail_inputs(b, n, e, seed, repeat=None):
    """ReLU'd activations (many zeros: a few critical points win many
    channels), conv5's W (K, E) and c, as f32 numpy; ``repeat``: every
    point copies one of the first ``repeat`` points (exact ties in z)."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=(b, n, K)), 0.0).astype(np.float32)
    if repeat:
        x = x[:, np.arange(n) % repeat]
    w = rng.normal(0.0, K**-0.5, (K, e)).astype(np.float32)
    c = rng.normal(0.0, 0.1, e).astype(np.float32)
    return x, w, c


def both(arrays, name):
    """The same values on both sides, rounded to the case's dtype."""
    jdt, tdt = DT[name]
    return [jnp.asarray(a, jdt) for a in arrays], [torch.from_numpy(a).to(tdt) for a in arrays]


def rel(got, want, scale=None):
    """max |got - want| over max |want|, or over ``scale`` where given."""
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (scale or max(np.abs(want).max(), 1e-30)))


def bias_scale(weight_grad):
    """The bias in front of a train-mode BatchNorm has no gradient in exact
    arithmetic (the batch mean takes it out): its rounding noise is held to
    the largest entry of its layer's weight gradient."""
    w = weight_grad.detach().double().numpy() if isinstance(weight_grad, torch.Tensor) else np.asarray(weight_grad)
    return float(np.abs(w).max())


# z from the same operands on both sides (bf16 products are exact in f32);
# only the f32 summation order differs
STATS_TOL = 1e-5


@pytest.mark.parametrize("name", ["bf16", "f32"])
@pytest.mark.parametrize("case,b,n,e", [("tile", 2, 256, 128), ("ragged", 3, 100, 256), ("ties", 2, 64, 128)])
def test_k3_plain_matches_jax_kernel(name, case, b, n, e):
    """pool_stats_reference against pool_stats_pallas in interpret mode; N=100
    is ragged against the TPU kernel's 512-row tiles, and in ``ties`` every
    point copies one of the first 5, so exact ties pin first-index."""
    (jx, jw, jc), (tx, tw, tc) = both(tail_inputs(b, n, e, seed=n + e, repeat=5 if case == "ties" else None), name)
    with pltpu.force_tpu_interpret_mode():
        want = jpool.pool_stats_pallas(jx, jw, jc)
    launches = LAUNCHES["pool_stats_pallas"]
    got = tpool.pool_stats(tx, tw, tc)
    assert LAUNCHES["pool_stats_pallas"] == launches  # the plain version is no launch
    mx, mn, amax, amin, G, cs = got
    assert mx.shape == (b, e) and amax.dtype == torch.int32 and G.shape == (K, K) and cs.shape == (K,)
    for g, w in ((mx, want[0]), (mn, want[1]), (G, want[4]), (cs, want[5])):
        assert rel(g, w) <= STATS_TOL
    np.testing.assert_array_equal(amax.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(amin.numpy(), np.asarray(want[3]))
    if case == "ties":
        assert int(amax.max()) < 5 and int(amin.max()) < 5


def test_k3_plain_takes_the_first_of_equal_values():
    """Exact ties inside and across the TPU kernel's tiles: the smaller
    point index wins."""
    x = np.zeros((1, 600, K), np.float32)
    x[0, [3, 100, 550], 0] = 2.0  # the max of channel 0 three times, two tiles apart
    w = np.zeros((K, 128), np.float32)
    w[0, 0] = 1.0
    mx, mn, amax, amin, _, _ = tpool.pool_stats_reference(torch.from_numpy(x), torch.from_numpy(w), torch.zeros(128))
    assert float(mx[0, 0]) == 2.0 and int(amax[0, 0]) == 3 and int(amin[0, 0]) == 0
    with pltpu.force_tpu_interpret_mode():
        want = jpool.pool_stats_pallas(jnp.asarray(x), jnp.asarray(w), jnp.zeros(128))
    assert int(want[2][0, 0]) == 3 and int(want[3][0, 0]) == 0


# bf16: both sides multiply bf16(dsel) by bf16 W for dx and bf16 x by f32
# dsel for dW, exactly in f32; only the f32 sum order differs. f32: the TPU
# kernel splits every operand into bf16 hi + lo (about 2^-16 of a product),
# the plain version multiplies in f32.
BWD_TOL = {"bf16": 1e-5, "f32": 1e-4}


@pytest.mark.parametrize("name", ["bf16", "f32"])
@pytest.mark.parametrize("case,b,n,e", [("k3_picks", 2, 256, 256), ("ragged", 3, 100, 128), ("dups", 2, 64, 128)])
def test_k4_plain_matches_jax_kernel(name, case, b, n, e):
    """pool_bwd_reference against pool_bwd_pallas in interpret mode, with the
    indices of a K3 run (critical points shared by many channels), or with
    every channel on one of 3 points (``dups``)."""
    x, w, c = tail_inputs(b, n, e, seed=3 * n + e)
    rng = np.random.default_rng(e)
    dsel = rng.normal(size=(b, e)).astype(np.float32)
    if case == "dups":
        idx = rng.integers(0, 3, (b, e)).astype(np.int32)
    else:
        idx = tpool.pool_stats_reference(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(c))[2].numpy()
    assert len(np.unique(idx)) < e  # duplicates are the normal case
    (jw, jx), (tw, tx) = both((w, x), name)
    with pltpu.force_tpu_interpret_mode():
        want_dx, want_dw = jpool.pool_bwd_pallas(jnp.asarray(idx), jnp.asarray(dsel), jw, jx)
    launches = LAUNCHES["pool_bwd_pallas"]
    dx, dw = tpool.pool_bwd(torch.from_numpy(idx), torch.from_numpy(dsel), tw, tx)
    assert LAUNCHES["pool_bwd_pallas"] == launches
    assert dx.shape == (b, n, K) and dw.shape == (K, e) and dx.dtype == dw.dtype == torch.float32
    assert rel(dx, want_dx) <= BWD_TOL[name]
    assert rel(dw, want_dw) <= BWD_TOL[name]
    untouched = np.ones((b, n), bool)
    untouched[np.arange(b)[:, None], idx] = False
    assert not dx.numpy()[untouched].any()


def test_k4_plain_rounds_dsel_for_dx_only_with_bf16_weights():
    """With bf16 W, dx takes bf16(dsel) (the TPU kernel's one-hot tile is
    cast to bf16) while dW takes dsel in f32."""
    idx = torch.zeros(1, 128, dtype=torch.int32)
    dsel = torch.full((1, 128), 1.0 + 2.0**-12)  # not a bf16 value
    w = torch.ones(K, 128, dtype=torch.bfloat16)
    x = torch.ones(1, 4, K, dtype=torch.bfloat16)
    dx, dw = tpool.pool_bwd_reference(idx, dsel, w, x)
    assert float(dx[0, 0, 0]) == 128.0 and float(dw[0, 0]) == 1.0 + 2.0**-12
    dx32, _ = tpool.pool_bwd_reference(idx, dsel, w.float(), x.float())
    assert float(dx32[0, 0, 0]) == 128.0 * (1.0 + 2.0**-12)


def test_gates_match_jax():
    for n in (1, 100, 1024):
        for e in (64, 128, 200, 256, 1024):
            for k in (64, 128, 256):
                assert tpool.pool_stats_ok(n, e, k) == jpool.pool_stats_ok(n, e, k)
                assert tpool.pool_bwd_ok(n, e, k) == jpool.pool_bwd_ok(n, e, k)


@pytest.mark.parametrize("bad,err,match", [
    ("k256", NotImplementedError, "K3 .* K == 128"), ("e100", ValueError, "shapes"),
    ("mixed", ValueError, "both bf16 or both f32"), ("f16", ValueError, "both bf16 or both f32")])
def test_k3_argument_checks(bad, err, match):
    """What the CUDA wrapper refuses before any launch."""
    x, w, c = torch.zeros(2, 16, K, dtype=torch.bfloat16), torch.zeros(K, 128, dtype=torch.bfloat16), torch.zeros(128)
    if bad == "k256":
        x, w = torch.zeros(2, 16, 256, dtype=torch.bfloat16), torch.zeros(256, 128, dtype=torch.bfloat16)
    elif bad == "e100":
        c = torch.zeros(100)
    elif bad == "mixed":
        w = w.float()
    else:
        x, w = x.half(), w.half()
    with pytest.raises(err, match=match):
        tpool._check_stats_args(x, w, c)
        tpool._kernel_dtype(x, w)


@pytest.mark.parametrize("bad,err,match", [
    ("e4224", NotImplementedError, "E <= 4096"), ("idx64", ValueError, "int32"), ("shape", ValueError, "shapes")])
def test_k4_argument_checks(bad, err, match):
    e = 4224 if bad == "e4224" else 128
    idx = torch.zeros(2, e, dtype=torch.int64 if bad == "idx64" else torch.int32)
    dsel = torch.zeros(2, e if bad != "shape" else e + 1)
    w, x = torch.zeros(K, e, dtype=torch.bfloat16), torch.zeros(2, 16, K, dtype=torch.bfloat16)
    with pytest.raises(err, match=match):
        tpool._check_bwd_args(idx, dsel, w, x)


def test_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on a card reaches no plain version."""
    x = torch.empty(1, 8, K, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tpool.pool_stats(x, torch.empty(K, 128, device="meta"), torch.empty(128, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        tpool.pool_bwd(torch.empty(1, 128, dtype=torch.int32, device="meta"), torch.empty(1, 128, device="meta"),
                       torch.empty(K, 128, device="meta"), x)


# -- the Gram-matrix autograd Function ----------------------------------

def function_inputs(b, n, k, e, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, k)).astype(np.float32)
    w = rng.normal(0.0, k**-0.5, (k, e)).astype(np.float32)
    c = rng.normal(0.0, 0.3, e).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, e).astype(np.float32) * rng.choice([-1.0, 1.0], e, p=[0.3, 0.7])
    beta = rng.normal(0.0, 0.2, e).astype(np.float32)
    cot = [rng.normal(size=(b, e)).astype(np.float32), rng.normal(size=e).astype(np.float32),
           rng.normal(size=e).astype(np.float32)]
    return (x, w, c, gamma.astype(np.float32), beta), cot


# f32 on both sides; the statistics come from the Gram matrix on both sides
# (JAX's XLA branch, the port's K3 plain version), f32 sums in another order
FUNCTION_TOL = 2e-4


@pytest.mark.parametrize("k,e", [(128, 128), (128, 256), (8, 12)])
def test_function_matches_jax_vjp(k, e):
    """Forward (out, batch mean, batch var) and the VJP (dx, dW, dc, dgamma,
    dbeta) against ``jax.vjp`` of ``_linear_bn_relu_maxpool_train`` in f32,
    with cotangents on all three outputs. (128, *) is inside JAX's kernel
    gate, where the port runs K3's and K4's plain versions; (8, 12) is off
    it, the XLA branch's math on both sides. Some gammas are negative, so
    the min branch is taken."""
    inputs, cot = function_inputs(3, 40, k, e, seed=k + e)
    eps = 1e-5
    outs, vjp = jax.vjp(lambda *a: jlayers._linear_bn_relu_maxpool_train(*a, eps), *map(jnp.asarray, inputs))
    jgrads = vjp(tuple(map(jnp.asarray, cot)))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    touts = tlayers._LinearBnReluMaxpoolTrain.apply(*targs, eps)
    tgrads = torch.autograd.grad(touts, targs, [torch.from_numpy(a) for a in cot])
    for g, w in zip(touts, outs):
        assert rel(g, w) <= FUNCTION_TOL
    for i, (g, w) in enumerate(zip(tgrads, jgrads)):
        assert rel(g, w, bias_scale(jgrads[1]) if i == 2 else None) <= FUNCTION_TOL


def naive_tail(x, w, c, gamma, beta, eps):
    """amax over points of relu(bn_train(x @ W + c)), plain autograd."""
    z = x @ w + c
    mean = z.mean((0, 1))
    var = (z * z).mean((0, 1)) - mean * mean
    return torch.amax(torch.relu((z - mean) * torch.rsqrt(var + eps) * gamma + beta), dim=1)


@pytest.mark.parametrize("dtype,k,e,tol", [
    (torch.float64, 8, 12, 1e-10),     # off the gate: the XLA branch's formulas, exact to f64 rounding
    (torch.float64, 128, 128, 1e-10),  # f64 statistics never take the kernels
    (torch.float32, 128, 128, 2e-4)])  # inside the gate: K3/K4 plain versions, f32 against f64
def test_function_matches_naive_autograd(dtype, k, e, tol):
    """The Gram-matrix forward and backward against torch autograd of the
    naive chain in f64: the output and the gradients of x, W, c, gamma and
    beta under a random cotangent."""
    inputs, cot = function_inputs(2, 50, k, e, seed=7 * k + e)
    ref_in = [torch.from_numpy(a).double().requires_grad_(True) for a in inputs]
    ref = naive_tail(*ref_in, 1e-5)
    ref_g = torch.autograd.grad(ref, ref_in, torch.from_numpy(cot[0]).double())
    got_in = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in inputs]
    got = tlayers._LinearBnReluMaxpoolTrain.apply(*got_in, 1e-5)[0]
    got_g = torch.autograd.grad(got, got_in, torch.from_numpy(cot[0]).to(dtype))
    assert rel(got, ref.detach()) <= tol
    for i, (g, r) in enumerate(zip(got_g, ref_g)):
        assert rel(g, r, bias_scale(ref_g[1]) if i == 2 else None) <= tol


def test_linear_bn_relu_maxpool_in_bf16_returns_dw_in_bf16():
    """A bf16 linear: the Function receives the weight and bias rounded to
    bf16 and returns dW in bf16, so the f32 parameter's gradient is a bf16
    value, as in JAX (nnx.Linear's promote_dtype)."""
    lin = tlayers.Linear(K, 128, dtype=torch.bfloat16, device="cpu")
    bn = tlayers.BatchNorm(128, dtype=torch.bfloat16, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 64, K)).astype(np.float32))
    out = tlayers.linear_bn_relu_maxpool(x, lin, bn)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 128)
    out.float().square().sum().backward()
    assert lin.weight.grad.dtype == torch.float32
    assert torch.equal(lin.weight.grad, lin.weight.grad.to(torch.bfloat16).float())
    assert not torch.equal(bn.running_mean, torch.zeros(128))  # the EMA ran outside the Function


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_linear_bn_relu_maxpool_matches_jax_module(name):
    """The module entry in train mode (K=E=128, inside the gate) against the
    JAX package's ``linear_bn_relu_maxpool`` in f32 (its XLA branch) and,
    in bf16, with its TPU guard opened (the kernels in interpret mode):
    output, the linear's and the BatchNorm's gradients and dx, and the
    running statistics."""
    jdt, tdt = DT[name]
    jdt = None if name == "f32" else jdt
    tdt = None if name == "f32" else tdt
    jlin = nnx.Linear(K, 128, dtype=jdt, rngs=nnx.Rngs(1))
    jbn = nnx.BatchNorm(128, use_running_average=False, momentum=0.9, dtype=jdt, rngs=nnx.Rngs(2))
    jbn.scale[...] = jnp.asarray(np.random.default_rng(3).choice([-0.7, 1.2], 128), jnp.float32)
    tlin = tlayers.Linear(K, 128, dtype=tdt, device="cpu")
    tbn = tlayers.BatchNorm(128, dtype=tdt, device="cpu")
    load_nnx_state(tlin, nnx_flat(jlin))
    load_nnx_state(tbn, nnx_flat(jbn))
    x = np.maximum(np.random.default_rng(4).normal(size=(2, 96, K)), 0).astype(np.float32)
    wts = np.random.default_rng(5).normal(size=128).astype(np.float32)

    def jloss(lin, bn, x):
        return jnp.sum(jlayers.linear_bn_relu_maxpool(x, lin, bn).astype(jnp.float32) * wts)

    with tpu_guard() if name == "bf16" else contextlib.nullcontext():
        (gl, gb, gx) = nnx.grad(jloss, argnums=(0, 1, 2))(jlin, jbn, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tlayers.linear_bn_relu_maxpool(tx, tlin, tbn)
    (out.float() * torch.from_numpy(wts)).sum().backward()
    tol = 1e-4 if name == "f32" else 2e-2  # bf16: outputs and dx rounded to bf16 on both sides
    assert rel(tx.grad, gx) <= tol
    assert rel(tlin.weight.grad.t(), gl.kernel[...]) <= tol
    assert rel(tlin.bias.grad, gl.bias[...], bias_scale(gl.kernel[...])) <= tol
    assert rel(tbn.weight.grad, gb.scale[...]) <= tol
    assert rel(tbn.bias.grad, gb.bias[...]) <= tol
    assert rel(tbn.running_mean, jbn.mean[...]) <= 1e-5
    assert rel(tbn.running_var, jbn.var[...]) <= 1e-5


class _TpuBackend:
    """``jax`` as the JAX package's utils/layers module sees it, except that
    ``default_backend()`` answers "tpu": this opens the guard in front of
    K3/K4 (``utils/layers.py:126,188``) without touching the package; the
    kernels then run in Pallas interpret mode."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


class tpu_guard:
    """Open the JAX package's TPU guard around the fused tail (as
    tests/test_torch_quant_dcp.py stubs ``jax.default_backend``, here only
    as ``utils/layers`` sees it) and run its Pallas kernels in interpret
    mode."""

    def __enter__(self):
        self._saved = jlayers.jax
        jlayers.jax = _TpuBackend()
        self._interpret = pltpu.force_tpu_interpret_mode()
        self._interpret.__enter__()
        return self

    def __exit__(self, *exc):
        self._interpret.__exit__(*exc)
        jlayers.jax = self._saved
        return False
