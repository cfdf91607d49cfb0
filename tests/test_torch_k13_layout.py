"""K13's schedule on the card (``csrc/emd.cu``), stated in torch on the CPU
and held to the JAX kernel ``_emd_fwd_pallas`` in Pallas interpret mode and
to the JAX package's XLA path ``_emd_fwd_impl``, at
``tests/test_torch_emd.py``'s tolerances (cost rtol 1e-4, g1 and g2 to a
mean relative error below 5%).

The schedule (``schedule`` below) is the kernel's: ``plan``'s cluster of
CTAs a cloud (the C entry ``plan``'s rule, which
``tests/test_torch_cuda.py::test_k13_plan_is_the_stated_plan`` holds the
card's to), each owning ``cluster_slices`` of the rows and columns; a
first row pass (ratioL of level 0), then a column pass and a row pass a
level, each computing its rows' or columns' values from the state at the
start of the pass (what the other CTAs wrote arrives through the cluster
barrier); K in the row pass as the fourth power of the next level's by two
squarings (K' = 1 from -0.25 to 0), exponentials as ex2 of (level log2 e)
d^2 flushed below 2^-126; 1 / C as rsqrt(max(d^2, 1e-20)) and C as
max(d^2, 1e-20) times it; every sum of a row or column over the other cloud
as 4 lanes each summing every 4th point in order (the kernel's FMAs as one
rounding), met by the xor-shuffle tree; the cost as each CTA's rows summed
by its threads in order, a tree over the threads, then the CTAs' partials
in rank order. The kernel rounds the exponential and the reciprocal square
root by the card's approximations (within 2 ulp), which torch's exp2 and
rsqrt stand in for.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from learning3d_tpu.kernels import emd as jemd
from learning3d_tpu_torch.kernels import emd as temd
from test_torch_emd import assert_emd_close, clouds

SPLIT = 4  # threads a row or column
ROWS_TARGET = 64  # rows (and columns) a CTA owns where the cluster allows
THREADS = (128, 256, 512)  # the threads of csrc/emd.cu's instances, up to 64, 128, 256 rows a CTA
LOG2E = np.float32(1.4426950408889634)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def plan(n, m, limit=16):
    """(cluster size, instance) of an (N, M) call: the smallest power of
    two up to ``limit`` (the largest cluster an H100 holds) that leaves each
    CTA at most ROWS_TARGET of the larger cloud's points, whatever B; the
    instance (0, 1, 2) by the rows a CTA then owns."""
    big = max(n, m)
    s = 1
    while s < limit and -(-big // s) > ROWS_TARGET:
        s *= 2
    rows = -(-big // s)
    return s, 0 if rows <= 64 else 1 if rows <= 128 else 2


def cluster_slices(n, s):
    """[(first, count)] of the rows (or columns) each CTA of a cluster of
    ``s`` owns: ceil(n / s) each, in rank order, the last ones shorter or
    empty."""
    per = -(-n // s)
    return [(min(n, r * per), max(0, min(n - r * per, per))) for r in range(s)]


def fma(acc, a, b):
    """acc + a * b with one rounding (the kernel's FFMA)."""
    return (acc.double() + a.double() * b.double()).float()


def ex2(lv, d2):
    """ex2.approx.ftz((lv log2 e) d2): the product rounded to f32, the
    power exact, results below 2^-126 flushed to 0."""
    lv2 = torch.tensor(np.float32(lv) * LOG2E, dtype=torch.float32)
    r = torch.exp2(lv2 * d2)
    return torch.where(r < 2.0**-126, torch.zeros_like(r), r)


def lane_sums(terms, fused=None):
    """The kernel's sum over the last axis: lane l of 4 sums the terms at
    l, l + 4, ... in order (as FMAs of ``fused`` = (a, b) where given), then
    the lanes meet as (s0 + s2) + (s1 + s3)."""
    n = terms.shape[-1] if fused is None else fused[0].shape[-1]
    lanes = []
    for lane in range(SPLIT):
        acc = torch.zeros(terms.shape[:-1] if fused is None else fused[0].shape[:-1])
        for j in range(lane, n, SPLIT):
            acc = acc + terms[..., j] if fused is None else fma(acc, fused[0][..., j], fused[1][..., j])
        lanes.append(acc)
    return (lanes[0] + lanes[2]) + (lanes[1] + lanes[3])


def schedule(x, y, cluster=None, stale_exchange=False):
    """K13's schedule on x (B, N, 3), y (B, M, 3) f32 -> (cost, g1, g2).
    ``stale_exchange``: the control, a row pass that reads the previous
    level's ratioR (an exchange that came too late)."""
    B, N, _ = x.shape
    M = y.shape[1]
    s, variant = plan(N, M)
    s = cluster or s
    mult_l, mult_r = temd._multipliers(N, M)
    d2 = temd._sqdist(x, y)  # (d0 d0 + d1 d1) + d2 d2, the kernel's bits
    dm = torch.clamp(d2, min=1e-20)
    ic = torch.rsqrt(dm)
    c = dm * ic
    lv = temd.LEVELS
    remain = torch.full((B, N), mult_l)
    rr = torch.full((B, M), mult_r)
    ratio_r = torch.zeros(B, M)
    cost_row = torch.zeros(B, N)
    g1, g2 = torch.zeros_like(x), torch.zeros_like(y)
    # the first row pass: ratioL of level 0
    ka = lane_sums(None, (ex2(lv[0], d2), rr[:, None, :].expand(B, N, M)))
    ratio_l = remain / (ka + temd._EPS)
    for j, level in enumerate(lv):
        # column pass: column sums over the rows (the n axis moved last)
        k = ex2(level, d2) if level != 0.0 else torch.ones_like(d2)
        kl = (k * ratio_l[:, :, None]).transpose(1, 2)  # (B, M, N)
        klc = kl * ic.transpose(1, 2)
        col = lane_sums(kl)
        colc = lane_sums(klc)
        colx = torch.stack([lane_sums(None, (klc, x[:, None, :, i].expand_as(klc))) for i in range(3)], -1)
        sumr = rr * col
        old_ratio_r = ratio_r
        ratio_r = torch.clamp(rr / (sumr + temd._EPS), max=1.0) * rr
        g2 = g2 + (y * (ratio_r * colc)[..., None] - ratio_r[..., None] * colx)
        rr = torch.clamp(rr - sumr, min=0.0)
        # row pass: K from the next level's exponential, squared twice
        rt = old_ratio_r if stale_exchange else ratio_r
        if j + 1 < len(lv) - 1:
            e = ex2(lv[j + 1], d2)
            e2 = e * e
            k, kn = e2 * e2, e
        elif j + 1 == len(lv) - 1:
            k, kn = ex2(level, d2), torch.ones_like(d2)
        else:
            k, kn = torch.ones_like(d2), None
        kr = k * rt[:, None, :]
        krc = kr * ic
        row = lane_sums(kr)
        rowc = lane_sums(None, (kr, c))
        rowic = lane_sums(krc)
        rowy = torch.stack([lane_sums(None, (krc, y[:, None, :, i].expand_as(krc))) for i in range(3)], -1)
        cost_row = cost_row + ratio_l * rowc
        rs = ratio_l * rowic
        g1 = g1 + (x * rs[..., None] - ratio_l[..., None] * rowy)
        remain = torch.clamp(remain - ratio_l * row, min=0.0)
        if kn is not None:
            ka = lane_sums(None, (kn, rr[:, None, :].expand(B, N, M)))
            ratio_l = remain / (ka + temd._EPS)
    return cluster_cost(cost_row, s, THREADS[variant]), g1, g2


def cluster_cost(cost_row, s, threads):
    """Each CTA's rows summed by its threads (thread t: rows t, t + threads,
    ... in order), a tree over the threads, then the partials in rank
    order."""
    total = torch.zeros(cost_row.shape[0])
    for first, count in cluster_slices(cost_row.shape[1], s):
        tree = torch.zeros(cost_row.shape[0], threads)
        for t in range(min(threads, count)):
            acc = torch.zeros(cost_row.shape[0])
            for r in range(t, count, threads):
                acc = acc + cost_row[:, first + r]
            tree[:, t] = acc
        w = threads // 2
        while w:
            tree[:, :w] = tree[:, :w] + tree[:, w : 2 * w]
            w //= 2
        total = total + tree[:, 0]
    return total


def test_plan_and_slices():
    """The cluster covers the larger cloud in slices of at most 64 points a
    CTA up to 16 CTAs, every row and column owned once, in rank order."""
    assert plan(1024, 1024) == (16, 0)
    assert plan(100, 200) == (4, 0) and plan(50, 50) == (1, 0)
    assert plan(2048, 77) == (16, 1) and plan(4096, 1) == (16, 2)
    for n in (1, 5, 63, 64, 65, 777, 1001, 4096):
        for s in (1, 2, 4, 8, 16):
            slices = cluster_slices(n, s)
            assert len(slices) == s
            owned = [r for first, count in slices for r in range(first, first + count)]
            assert owned == list(range(n))
            assert max(count for _, count in slices) == -(-n // s)


def test_plan_is_the_kernels():
    """The constants this emulation plans with are the kernel source's: the
    rows a CTA, the largest cluster, and the instances' threads and threads
    a row, in kV64, kV128, kV256 order."""
    src = (Path(temd.__file__).parent / "csrc" / "emd.cu").read_text()
    assert re.findall(r"constexpr int kRowsTarget = (\d+);", src) == [str(ROWS_TARGET)]
    assert re.findall(r"constexpr int kMaxCluster = (\d+);", src) == ["16"]
    instances = re.findall(r"\{emd_cluster_kernel<(\d+), (\d+), \d+, \d+>, (\d+)\}", src)
    assert [(int(t), int(k)) for t, k, _ in instances] == [(t, SPLIT) for t in THREADS]
    assert all(t == u for t, _, u in instances)


def test_cluster_cost_is_a_fixed_order():
    """The cost's sum over a CTA's rows and the ranks, on rows whose sum
    depends on its order: the same value for every split, within f32
    rounding of the exact sum, and bit for bit from run to run."""
    rows = torch.from_numpy(np.random.default_rng(1).lognormal(0.0, 3.0, (2, 777)).astype(np.float32))
    exact = rows.double().sum(1)
    for s in (1, 4, 16):
        got = cluster_cost(rows, s, 128)
        assert torch.equal(got, cluster_cost(rows, s, 128))
        np.testing.assert_allclose(got.double().numpy(), exact.numpy(), rtol=1e-5)


# (B, N, M, cluster): N = M at one 128-point chunk of the JAX kernel, N > M
# and N < M (the multipliers), ragged sizes that no cluster divides, B=1,
# and a cluster of 1 (one CTA holds both clouds)
CASES = [(1, 128, 128, None), (2, 128, 96, None), (1, 100, 200, None), (3, 77, 131, None), (2, 131, 77, 4),
         (1, 50, 50, 1), (2, 128, 128, 1)]


@pytest.mark.parametrize("b,n,m,cluster", CASES)
def test_schedule_matches_jax_kernel_in_interpret_mode(b, n, m, cluster):
    x, y = clouds(b, n, m, 7 * n + m)
    got = schedule(torch.from_numpy(x), torch.from_numpy(y), cluster)
    with pltpu.force_tpu_interpret_mode():
        want = jemd._emd_fwd_pallas(jnp.asarray(x), jnp.asarray(y), chunk=128)
    assert_emd_close([t.numpy() for t in got], want)


@pytest.mark.parametrize("b,n,m,cluster", CASES)
def test_schedule_matches_jax_xla_path(b, n, m, cluster):
    x, y = clouds(b, n, m, 11 * n + m)
    got = schedule(torch.from_numpy(x), torch.from_numpy(y), cluster)
    assert_emd_close([t.numpy() for t in got], jemd._emd_fwd_impl(jnp.asarray(x), jnp.asarray(y)))
    if cluster is None:  # the plain version, the kernel's oracle on the card, within the same bounds
        assert_emd_close([t.numpy() for t in got], temd._emd_fwd_reference(torch.from_numpy(x), torch.from_numpy(y)))


def test_schedule_control_fails():
    """A row pass that reads the previous level's ratioR (an exchange after
    the barrier instead of before it) fails the agreement."""
    x, y = clouds(2, 128, 96, 3)
    want = jemd._emd_fwd_impl(jnp.asarray(x), jnp.asarray(y))
    with pytest.raises(AssertionError):
        assert_emd_close([t.numpy() for t in schedule(torch.from_numpy(x), torch.from_numpy(y),
                                                      stale_exchange=True)], want)
