"""The port's attention (K6's plain version and the JAX oracle) and the
Transformer pointer against the JAX package, on the CPU at a small size.

On the CPU the port's K6 wrapper runs its plain version; the JAX kernel
runs in Pallas interpret mode, as tests/test_pallas_interpret.py runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.experimental.pallas import tpu as pltpu

from learning3d_tpu.kernels import attention as jattn
from learning3d_tpu.utils import transformer as jtr
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import attention as tattn
from learning3d_tpu_torch.utils import transformer as ttr
from learning3d_tpu_torch.utils.jax_import import load_nnx_state
from torch_port_util import nnx_flat, rel_err


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def qkv(b, h, n, m, d, dv, seed=10):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, n, d)).astype(np.float32), rng.normal(size=(b, h, m, d)).astype(np.float32),
            rng.normal(size=(b, h, m, dv)).astype(np.float32))


# The JAX kernel (interpret mode) against the port's plain version of it:
# the same roundings (bf16 operands, f32 scores, unnormalized P rounded to
# bf16); f32 sums in another order can move an element of P by one bf16
# step (2^-8 of it). M=200 exercises the key padding, Dv=3 the head's xyz
# values.
@pytest.mark.parametrize("dv", [128, 3])
def test_k6_plain_matches_jax_interpret(dv):
    q, k, v = qkv(2, 2, 256, 200, 128, dv)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jattn.attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)), np.float32)
    launches = LAUNCHES["attention_pallas"]
    got = tattn.attention_pallas(*map(torch.from_numpy, (q, k, v)))
    assert LAUNCHES["attention_pallas"] == launches  # the plain version is no launch
    assert got.shape == (2, 2, 256, dv) and got.dtype == torch.float32
    assert rel_err(got, want) <= 1e-2


# The JAX oracle normalizes P before its bf16 cast: the port's oracle
# repeats that, to f32 summation order (a bf16 step of P at most).
@pytest.mark.parametrize("dv", [16, 3])
def test_oracle_matches_jax(dv):
    q, k, v = qkv(2, 2, 40, 50, 32, dv, seed=11)
    want = np.asarray(jattn.attention_oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = tattn.attention_oracle(*map(torch.from_numpy, (q, k, v)))
    assert rel_err(got, want) <= 1e-2


def test_plain_version_rounds_unnormalized_p():
    """The plain version differs from the oracle only by where P is rounded:
    within a bf16 step of the output's scale, and not equal."""
    q, k, v = map(torch.from_numpy, qkv(1, 2, 64, 64, 32, 8, seed=12))
    ref, ora = tattn.attention_reference(q, k, v), tattn.attention_oracle(q, k, v)
    assert rel_err(ref, ora.numpy()) <= 1e-2
    assert not torch.equal(ref, ora)


def test_attention_fused_grads_match_oracle():
    q0, k0, v0 = map(torch.from_numpy, qkv(1, 2, 32, 48, 16, 8, seed=13))
    grads = []
    for fn in (tattn.attention_fused, tattn.attention_oracle):
        q, k, v = (t.clone().requires_grad_(True) for t in (q0, k0, v0))
        fn(q, k, v).sum().backward()
        grads.append([q.grad, k.grad, v.grad])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_gate():
    """K6 is taken at the pointer's and the head's shapes only."""
    def ok(n, m, d, dv):
        return tattn.attention_pallas_ok(torch.empty(1, 1, n, d, device="meta"),
                                         torch.empty(1, 1, m, d, device="meta"),
                                         torch.empty(1, 1, m, dv, device="meta"))

    assert ok(1024, 1024, 128, 128) and ok(1024, 1024, 512, 3) and ok(256, 256, 256, 64)
    assert not ok(255, 1024, 128, 128)  # N < 256
    assert not ok(1024, 200, 128, 128)  # M < 256
    assert not ok(1024, 1024, 64, 64)  # D not a multiple of 128
    assert not ok(1024, 1024, 640, 64)  # D > 512
    assert ok(1024, 1024, 128, 256)  # any Dv, as JAX's gate


def test_wide_values_raise_off_the_cpu():
    """Dv > MAX_DV (512) at the kernel's shapes: on the CPU the plain
    version runs; off the CPU (a meta tensor stands in for a CUDA one here;
    tests/test_torch_cuda.py checks the card) ``_attention`` raises
    NotImplementedError naming the limit instead of leaving the kernel's
    path. Dv=256 (DCP over DGCNN(emb 1024)) is inside the limit."""
    assert tattn.MAX_DV == 512
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 1, 256, 256, 128, 640, seed=12))
    got = ttr._attention(q, k, v)
    torch.testing.assert_close(got, tattn.attention_reference(q, k, v), rtol=0, atol=0)
    meta = [torch.empty(t.shape, device="meta") for t in (q, k, v)]
    with pytest.raises(NotImplementedError, match="Dv <= 512"):
        ttr._attention(*meta)
    tattn.check_value_width(meta[0], torch.empty(1, 1, 256, 256, device="meta"))  # Dv=256 passes


@pytest.mark.parametrize("bad", ["rank", "k_shape", "d_odd", "dv_wide"])
def test_kernel_argument_checks(bad):
    q, k, v = torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 9, 32), torch.zeros(1, 2, 9, 4)
    if bad == "rank":
        q = q[0]
    elif bad == "k_shape":
        k = k[..., :16]
    elif bad == "d_odd":
        q, k = q[..., :24], k[..., :24]
    else:
        v = torch.zeros(1, 2, 9, tattn.MAX_DV + 1)  # 513: past K6's Dv <= 512
    with pytest.raises(ValueError):
        tattn._check_kernel_args(q, k, v)


@pytest.mark.parametrize("name,tol", [("f32", 1e-6), ("bf16", 1e-2)])
def test_layer_norm_matches_jax(name, tol):
    """Unbiased std, eps on the std, f32 statistics, the stream's dtype out."""
    jdt, tdt = (jnp.float32, torch.float32) if name == "f32" else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(14)
    jln = jtr.AnnotatedLayerNorm(48, rngs=nnx.Rngs(0))
    jln.a[...] = jnp.asarray(rng.normal(1.0, 0.2, 48), jnp.float32)
    jln.b[...] = jnp.asarray(rng.normal(0.0, 0.2, 48), jnp.float32)
    tln = load_nnx_state(ttr.AnnotatedLayerNorm(48, device="cpu"), nnx_flat(jln))
    x = rng.normal(2.0, 3.0, (2, 10, 48)).astype(np.float32)
    want = jln(jnp.asarray(x, jdt))
    got = tln(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    assert rel_err(got, want) <= tol


def test_multi_head_attention_matches_jax():
    """f32, below the kernel's gate: the plain chain on both sides."""
    jm = jtr.MultiHeadedAttention(4, 64, rngs=nnx.Rngs(1))
    tm = load_nnx_state(ttr.MultiHeadedAttention(4, 64, device="cpu"), nnx_flat(jm))
    rng = np.random.default_rng(15)
    x, mem = rng.normal(size=(2, 30, 64)).astype(np.float32), rng.normal(size=(2, 40, 64)).astype(np.float32)
    want = jm(jnp.asarray(x), jnp.asarray(mem), jnp.asarray(mem))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), torch.from_numpy(mem), torch.from_numpy(mem))
    assert rel_err(got, want) <= 1e-5


def test_plain_attention_scales_by_rounded_sqrt():
    """Below the gate in bf16 the scores are divided by sqrt(d_k) taken in
    bf16 (11.3125 for d_k=128, not 11.3137), as the JAX package does."""
    q, k, v = qkv(1, 2, 20, 30, 128, 16, seed=16)
    want = jtr._attention(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))
    got = ttr._attention(*(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) <= 2e-2
    assert float(torch.sqrt(torch.tensor(128, dtype=torch.bfloat16))) == 11.3125


# f32 through one encoder and one decoder layer, both passes, at d=64 (the
# plain attention chain on both sides).
def test_transformer_matches_jax():
    jm = jtr.Transformer(64, ff_dims=96, n_heads=4, rngs=nnx.Rngs(2))
    rng = np.random.default_rng(17)
    for path, v in nnx.to_flat_state(nnx.state(jm)):
        if path[-1] in ("a", "b"):
            v.set_value(jnp.asarray(rng.normal(1.0 if path[-1] == "a" else 0.0, 0.2, 64), jnp.float32))
    tm = load_nnx_state(ttr.Transformer(64, ff_dims=96, n_heads=4, device="cpu"), nnx_flat(jm))
    src, tgt = rng.normal(size=(2, 2, 30, 64)).astype(np.float32)
    want = jm(jnp.asarray(src), jnp.asarray(tgt))
    with torch.inference_mode():
        got = tm(torch.from_numpy(src), torch.from_numpy(tgt))
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-5
    assert ttr.Identity()(1, 2) == (1, 2)
