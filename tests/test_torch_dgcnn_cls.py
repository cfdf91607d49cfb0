"""The port's Classifier(DGCNN) (``examples/train.py``'s dgcnn-cls
configuration) against the JAX package's, on the CPU at N <= 256: the
logits in f32 and bf16 eval mode (the port's bf16 DGCNN runs K5's plain
version, JAX's CPU the unfused chain), in train mode, and one
classification step's loss and gradients (the port's unfused chain on K7's
plain version). Weights cross as numpy through ``load_nnx_state``; inputs
are made with numpy from seeds; dropout is fed rate 0 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from learning3d_tpu.data import dataloaders as jdata
from learning3d_tpu.models import DGCNN as JDGCNN
from learning3d_tpu.models import Classifier as JClassifier
from learning3d_tpu.train import tasks as jtasks
from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.models import DGCNN, Classifier
from learning3d_tpu_torch.train import tasks
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from torch_port_util import hold_to_jax, max_rel, nnx_flat, randomize_bn

B, N, EMB, K = 2, 200, 64, 20


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def batch(seed=0):
    data = jdata.SyntheticModelNet40(num_points=N, size=B, seed=seed)
    return (np.stack([data[i][0] for i in range(B)]).astype(np.float32),
            np.array([data[i][1] for i in range(B)], np.int32).reshape(B))


def jax_cls(seed, jdtype=None):
    jm = JClassifier(JDGCNN(emb_dims=EMB, k=K, dtype=jdtype, rngs=nnx.Rngs(seed)), dtype=jdtype,
                     rngs=nnx.Rngs(seed + 1))
    randomize_bn(jm, np.random.default_rng(seed + 2))
    jm.dropout1.rate = jm.dropout2.rate = 0.0
    return jm


def port_cls(flat, tdtype=None):
    tm = load_nnx_state(Classifier(DGCNN(emb_dims=EMB, k=K, dtype=tdtype, device="cpu"), dtype=tdtype,
                                   device="cpu"), flat)
    tm.dropout1.rate = tm.dropout2.rate = 0.0
    return tm


@pytest.fixture(scope="module")
def jax_f32():
    return jax_cls(0)


# f32 eval: 1e-5 of max. Train mode: the port's f64 to JAX's f64 (F64_TOL),
# its f32 no further from JAX's f64 than twice JAX's own plus
# TRAIN_F32_TOL (train-mode BatchNorms over two clouds' rows lose digits in
# both packages)
TOL, F64_TOL, TRAIN_F32_TOL = 1e-5, 1e-5, 1e-4


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_dgcnn_classifier_matches_jax(jax_f32, mode):
    jm = nnx.clone(jax_f32)
    getattr(jm, mode)()
    x, _ = batch(1)
    got, want = hold_to_jax(port_cls(nnx_flat(jm)), jm, mode, x, tol=TOL, f64_tol=F64_TOL,
                            train_f32_tol=TRAIN_F32_TOL)
    assert got.shape == (B, 40)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))


# bf16 eval: the port runs K5's plain version (BN folded into f32 weights,
# bf16 products), JAX's CPU the unfused chain with every conv and BN step
# rounded to bf16: bf16 roundings in other places through five stages and
# the head, as in tests/test_torch_dgcnn.py (3e-2 there on the features).
# Measured on these clouds: the logits 8.3e-3 of max
BF16_TOL = 3e-2


def test_dgcnn_classifier_bf16_matches_jax():
    jm = jax_cls(3, jnp.bfloat16)
    jm.eval()
    x, _ = batch(4)
    want = np.asarray(nnx.jit(lambda m, a: m(a))(jm, jnp.asarray(x)), np.float32)
    tm = port_cls(nnx_flat(jm), torch.bfloat16).eval()
    launches = dict(LAUNCHES)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert LAUNCHES == launches  # K5's plain version is no launch
    assert got.dtype == torch.bfloat16 and got.shape == (B, 40)
    assert max_rel(got.float(), want) <= BF16_TOL
    np.testing.assert_array_equal(got.float().argmax(-1).numpy(), want.argmax(-1))


def jax_grads(jm, data, x64):
    """JAX's eager task gradients (its jitted DGCNN gradients on the CPU are
    off, ROADMAP Queue 3 item 1)."""
    with jax.enable_x64(x64):
        dt = np.float64 if x64 else np.float32
        (loss, _), grads = nnx.value_and_grad(
            lambda m: jtasks.classification(m, (jnp.asarray(data[0].astype(dt)), jnp.asarray(data[1])), None),
            has_aux=True)(nnx.clone(jm))
        return float(loss), nnx_to_torch({".".join(map(str, p)): np.asarray(v.get_value(), np.float64)
                                          for p, v in nnx.to_flat_state(grads)})


def port_grads(flat, data, dtype):
    model = port_cls(flat).train().to(dtype)
    loss, _ = tasks.classification(model, (torch.from_numpy(data[0]).to(dtype), torch.from_numpy(data[1])))
    loss.backward()
    return loss.item(), {n: p.grad.double().numpy() for n, p in model.named_parameters()}


def grad_gaps(grads, want):
    """Each gradient's gap over its norm; the biases in front of a
    train-mode BatchNorm (the head's first two: the batch mean takes them
    out) over their layer's weight gradient."""
    def ref(n):
        return n.rsplit(".", 1)[0] + ".weight" if n in ("linear1.bias", "linear2.bias") else n

    assert set(grads) == set(want)
    return {n: float(np.linalg.norm(g - want[n]) / max(np.linalg.norm(want[ref(n)]), 1e-30)) for n, g in grads.items()}


def whole_gap(grads, want):
    names = sorted(want)
    a, b = (np.concatenate([g[n].ravel() for n in names]) for g in (grads, want))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# one step: the port's f64 loss and gradients to JAX's eager f64 ones
# (LOSS_TOL, GRAD_TOL of each tensor's norm); its f32 gradients, as one
# vector, no further from JAX's f64 than twice JAX's own f32 plus F32_SLACK
LOSS_TOL, GRAD_TOL, F32_SLACK = 1e-6, 1e-5, 1e-3


def test_dgcnn_classifier_step_matches_jax(jax_f32):
    jm = nnx.clone(jax_f32)
    jm.train()
    data = batch(5)
    flat = nnx_flat(jm)
    loss64, g64 = jax_grads(jm, data, True)
    _, g32 = jax_grads(jm, data, False)
    got_loss, got64 = port_grads(flat, data, torch.float64)
    assert abs(got_loss - loss64) <= LOSS_TOL * abs(loss64)
    gaps = grad_gaps(got64, g64)
    assert max(gaps.values()) <= GRAD_TOL, max(gaps.items(), key=lambda kv: kv[1])
    _, got32 = port_grads(flat, data, torch.float32)
    assert whole_gap(got32, g64) <= 2 * whole_gap(g32, g64) + F32_SLACK
    # the control: the step on clouds of k = 19 neighbours
    control = port_cls(flat).train().double()
    for m in control.modules():
        if isinstance(m, DGCNN):
            m.k = K - 1
    loss, _ = tasks.classification(control, (torch.from_numpy(data[0]).double(), torch.from_numpy(data[1])))
    loss.backward()
    assert max(grad_gaps({n: p.grad.numpy() for n, p in control.named_parameters()}, g64).values()) > GRAD_TOL
