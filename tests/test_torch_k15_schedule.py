"""K15's scan (``csrc/ball_query.cu``), emulated on the CPU: a warp a query,
BALL_QUERY_ROUNDS rounds of 32 points loaded (lane l the point j0 + 32 r +
l, clamped into the cloud) before any is tested, each round's ballot putting
the in-ball lanes' indices at the row's count so far plus the in-ball lanes
below, the early stop once the query has nsample, and the padding with the
first in-ball index (N where the ball is empty). The emulation must give
``ball_query_reference``'s indices, write every slot of every row exactly
once, and read no point past the round in which the query filled its ball."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from learning3d_tpu_torch.kernels.sampling import (
    BALL_QUERY_ROUNDS, ball_query_pallas, ball_query_reference, squared_radius)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


LANES = np.arange(32)


def emulate(radius, nsample, xyz, new_xyz, rounds=BALL_QUERY_ROUNDS):
    """The kernel's scan in numpy: (idx (B, S, nsample) int64, points read a
    query (B, S))."""
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    r2 = np.float32(squared_radius(radius))
    out = np.full((B, S, nsample), -1, np.int64)  # -1: never written
    read = np.zeros((B, S), np.int64)

    def put(row, pos, value):
        assert row[pos] == -1, "a slot written twice"
        row[pos] = value

    for b in range(B):
        pts = xyz[b]
        for s in range(S):
            qx, qy, qz = new_xyz[b, s]
            row = out[b, s]
            found, first = 0, N
            for j0 in range(0, N, 32 * rounds):
                if found >= nsample:
                    break
                ins = []
                for r in range(rounds):  # every round's loads first, clamped into the cloud
                    j = j0 + 32 * r + LANES
                    p = np.minimum(j, N - 1)
                    d0, d1, d2 = qx - pts[p, 0], qy - pts[p, 1], qz - pts[p, 2]
                    d = (d0 * d0 + d1 * d1) + d2 * d2  # f32, each operation rounded
                    ins.append((j < N) & (d <= r2))
                    read[b, s] += int((j < N).sum())
                for r, m in enumerate(ins):  # then the ballots
                    if not m.any():
                        continue
                    jb = j0 + 32 * r
                    if found == 0:
                        first = jb + int(np.flatnonzero(m)[0])
                    for lane in np.flatnonzero(m):
                        pos = found + int(m[:lane].sum())  # popcount of the in-ball lanes below
                        if pos < nsample:
                            put(row, pos, jb + lane)
                    found += int(m.sum())
            for pos in range(min(found, nsample), nsample):
                put(row, pos, first)
    return out, read


def needed(radius, nsample, xyz, new_xyz):
    """Points each query must read: up to its nsample-th in-ball point, all N
    where fewer lie in the ball."""
    d = ((new_xyz[:, :, None, :] - xyz[:, None, :, :]) ** 2)
    d = (d[..., 0] + d[..., 1]) + d[..., 2]
    count = np.cumsum(d <= np.float32(squared_radius(radius)), axis=-1)
    reached = count >= nsample
    return np.where(reached.any(-1), reached.argmax(-1) + 1, xyz.shape[1])


def check(radius, nsample, xyz, new, rounds=BALL_QUERY_ROUNDS):
    got, read = emulate(radius, nsample, xyz, new, rounds)
    assert (got >= 0).all(), "a slot of a row was never written"
    want = ball_query_reference(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(new)).numpy()
    np.testing.assert_array_equal(got, want)
    need = needed(radius, nsample, xyz, new)
    assert (read >= need).all() and (read < need + 32 * rounds).all(), "read past the round that filled the ball"
    return got


def cloud(rng, b, n, s, scale=1.0):
    xyz = (scale * rng.uniform(-1.0, 1.0, (b, n, 3))).astype(np.float32)
    return xyz, xyz[:, rng.permutation(n)[:s]].copy()


@pytest.mark.parametrize("rounds", [1, 2, 4, 8])
def test_ragged_shapes_under_every_round_count(rounds):
    """N = 300 (not a multiple of 32 rounds' points) and S = 37, one to
    eight rounds loaded before their ballots."""
    rng = np.random.default_rng(rounds)
    xyz, new = cloud(rng, 2, 300, 37)
    check(0.5, 16, xyz, new, rounds)


@pytest.mark.parametrize("rounds", [1, BALL_QUERY_ROUNDS])
def test_balls_that_fill_late(rounds):
    """The first 300 points lie far from every query: every ball fills only
    after many rounds, and the first in-ball index lies past them."""
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-1.0, 1.0, (2, 500, 3)).astype(np.float32)
    xyz[:, :300] += 10.0
    new = xyz[:, 300 + rng.permutation(200)[:24]].copy()
    got = check(0.6, 16, xyz, new, rounds)
    assert got.min() >= 300


def test_empty_balls_give_n_everywhere():
    """Queries far from the cloud: no point in the ball, N in every slot,
    every point read; the others as usual."""
    rng = np.random.default_rng(3)
    xyz, new = cloud(rng, 2, 200, 10)
    new = np.concatenate([new, np.full((2, 3, 3), 40.0, np.float32)], axis=1)
    got = check(0.3, 8, xyz, new)
    assert (got[:, 10:] == 200).all() and (got[:, :10] < 200).all()


def test_nsample_300_pads_with_the_first_index():
    """nsample 300 (past the TPU kernel's 128) against 250 points: every
    ball holds fewer, so every row is padded with its first index after a
    scan of the whole cloud."""
    rng = np.random.default_rng(4)
    xyz, new = cloud(rng, 2, 250, 9)
    got = check(1.0, 300, xyz, new)
    assert (got[..., -1] == got[..., 0]).all()


def test_points_on_the_radius():
    """A lattice of spacing 0.1 queried at radius 0.1: neighbours at exactly
    the radius are in the ball by the same rounding as the plain version."""
    g = np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing="ij"), -1).reshape(-1, 3)
    lat = (0.1 * g + 0.37).astype(np.float32)[None]
    check(0.1, 16, lat, lat[:, :64].copy())


def test_dense_cloud_stops_in_the_first_round():
    """A dense cloud where every query fills nsample = 8 in its first 32
    points: one round's ballot fills the row, and no query reads past the
    first load of rounds."""
    rng = np.random.default_rng(5)
    xyz, new = cloud(rng, 2, 256, 32, scale=0.1)
    _, read = emulate(0.5, 8, xyz, new)
    assert (read == 32 * BALL_QUERY_ROUNDS).all()
    check(0.5, 8, xyz, new)


def test_rounds_are_the_kernels():
    """BALL_QUERY_ROUNDS, which this emulation runs, is the kernel
    source's kRounds."""
    import learning3d_tpu_torch.kernels as kernels

    src = (Path(kernels.__file__).parent / "csrc" / "ball_query.cu").read_text()
    assert re.findall(r"constexpr int kRounds = (\d+);", src) == [str(BALL_QUERY_ROUNDS)]


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_wrapper_dtypes_on_the_cpu(dtype):
    """The wrapper's int32 and int64 indices (the plain version on a CPU
    tensor) are the same indices; other dtypes are refused."""
    rng = np.random.default_rng(7)
    xyz, new = (torch.from_numpy(a) for a in cloud(rng, 2, 100, 20))
    got = ball_query_pallas(0.5, 16, xyz, new, dtype=dtype)
    assert got.dtype == dtype
    assert torch.equal(got.long(), ball_query_reference(0.5, 16, xyz, new).long())
    with pytest.raises(ValueError, match="int32 or int64"):
        ball_query_pallas(0.5, 16, xyz, new, dtype=torch.float32)
