"""K17's pass order on the CPU: ``sweep_schedule`` (below: the CUDA kernel's
schedule in torch, each iteration one sweep of row blocks that form their
rows' u from the last v and then their columns' partial (m, s), a merge of
the partials into v, and the output pass) against the JAX kernel
``sinkhorn_log_pallas`` in Pallas interpret mode and against the plain
version ``sinkhorn_slack_reference``, at the JAX package's own tolerance
between its kernel and its XLA oracle (atol 1e-5). The cases take J != K,
J not a multiple of the sweep's rows, one row block, one iteration and
none."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from learning3d_tpu.kernels import sinkhorn as jsinkhorn
from learning3d_tpu_torch.kernels import sinkhorn as tsinkhorn

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def sweep_schedule(log_alpha, n_iters=5, rows=tsinkhorn.SWEEP_ROWS):
    """``csrc/sinkhorn.cu``'s schedule: potentials u (rows) and v (columns)
    from 0, kept in f64; each iteration one sweep, in which every block of
    ``rows`` rows forms u[i] = lse(0, {a[i,k] - v[k]}_k) (the max, then the
    sum of exponentials) and then each column's partial (m, s) of a[i,k] -
    u[i] over the block's rows (m at least 0, the slack row's entry), and a
    merge of the partials into v = lse(0, partials), at their largest max;
    out = (a - u) - v rounded once to the input's type, all in f64 as in
    the kernel. (Where a row fits one chunk the kernel shifts a column's
    partials by max(0, the last v), an upper bound of a[i,k] - u[i], instead
    of the block's max: the same sums.)"""
    a = log_alpha.double()
    B, J, K = a.shape
    u = a.new_zeros((B, J))
    v = a.new_zeros((B, K))
    for _ in range(n_iters):
        pm, ps = [], []
        for i0 in range(0, J, rows):
            blk = a[:, i0 : i0 + rows]
            x = blk - v[:, None, :]
            m = torch.clamp_min(x.amax(2), 0.0)
            s = torch.exp(-m) + torch.exp(x - m[..., None]).sum(2)
            u[:, i0 : i0 + rows] = m + torch.log(s)
            y = blk - u[:, i0 : i0 + rows, None]
            cm = torch.clamp_min(y.amax(1), 0.0)
            pm.append(cm)
            ps.append(torch.exp(y - cm[:, None]).sum(1))
        m = torch.clamp_min(torch.stack(pm).amax(0), 0.0)
        s = torch.exp(-m) + sum(cs * torch.exp(cm - m) for cm, cs in zip(pm, ps))
        v = m + torch.log(s)
    return ((a - u[..., None]) - v[:, None, :]).to(log_alpha.dtype)


def affinity(b, j, k, seed, beta=1.0, alpha=0.7, c=16):
    """RPMNet's affinity -beta (d - alpha), d the squared distance of unit
    features."""
    rng = np.random.default_rng(seed)
    f, g = rng.normal(size=(b, j, c)), rng.normal(size=(b, k, c))
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    d = ((f[:, :, None] - g[:, None]) ** 2).sum(-1)
    return (-beta * (d - alpha)).astype(np.float32)


CASES = {  # (B, J, K, n_iters, beta): J a multiple of 16 or not, J != K, a lone block, a wide range
    "square": (2, 64, 64, 5, 1.0),
    "ragged_j": (2, 37, 50, 5, 3.0),
    "j_gt_k": (1, 90, 33, 5, 1.0),
    "one_block": (1, 9, 20, 5, 1.0),
    "one_iteration": (2, 40, 24, 1, 1.0),
    "no_iteration": (1, 19, 21, 0, 1.0),
    "wide": (1, 48, 70, 5, 10.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_schedule_matches_jax_kernel_and_plain_version(case):
    b, j, k, n_iters, beta = CASES[case]
    la = affinity(b, j, k, len(case), beta=beta)
    got = sweep_schedule(torch.from_numpy(la), n_iters)
    assert got.shape == la.shape and got.dtype == torch.float32
    plain = tsinkhorn.sinkhorn_slack_reference(torch.from_numpy(la), n_iters)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=ATOL)
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(jsinkhorn.sinkhorn_log_pallas(jnp.asarray(la), n_iters=n_iters))
    np.testing.assert_allclose(got.numpy(), kernel, rtol=0, atol=ATOL)
    if n_iters == 0:
        np.testing.assert_array_equal(got.numpy(), la)


@pytest.mark.parametrize("rows", [1, 5, 16, 64])
def test_schedule_is_the_same_function_for_any_block(rows):
    """The row blocks only split the column sums: in f64 every block size
    gives the plain version's result to rounding."""
    la = torch.from_numpy(affinity(2, 45, 38, 3)).double()
    want = tsinkhorn.sinkhorn_slack_reference(la, 5)
    got = sweep_schedule(la, 5, rows=rows)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
