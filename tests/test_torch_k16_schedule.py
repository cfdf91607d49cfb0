"""K16's schedule (``csrc/ball_group.cu``), emulated on the CPU: a block's
queries against its cloud staged in chunks, BALL_GROUP_ROUNDS ballot rounds
of 32 points an iteration kept as round masks, expanded into a warp's index
list (a lane a round, ranks from the rounds' counts and the in-ball lanes
below), each row written from the list by the whole warp in pieces
(4-byte stores to the first 16-byte boundary of the device address, 16-byte
stores whose (slot, channel) is stepped without a division, 4-byte stores
after; slot by slot past BALL_GROUP_GATHER_C channels), the padding from the
centre's values, and the block's early stop once every query has its row.
The emulation, with small chunks and lists that force every piece of the
schedule, must give ``ball_group_reference``'s values and write every float
of every row, reading only list entries written for the query and values of
the staged chunk."""

import numpy as np
import pytest
import torch

from learning3d_tpu_torch.kernels.sampling import (
    BALL_GROUP_GATHER_C, BALL_GROUP_LIST, BALL_GROUP_ROUNDS, ball_group_chunk, ball_group_queries,
    ball_group_reference, squared_radius)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


LANES = np.arange(32)


class Writer:
    """A query's row, written from the warp's list: slot < cnt takes the
    values of point lst[slot - s_lo] (which must lie in the staged chunk
    where the values are staged), the others the centre's."""

    def __init__(self, out, base, values, c, lst, chunk, stats):
        self.out, self.base, self.values, self.c = out, base, values, c
        self.lst, self.chunk, self.stats = lst, chunk, stats
        self.s_lo, self.cnt, self.centre = 0, 0, None

    def value(self, slot, k):
        if slot < self.cnt:
            point = self.lst[slot - self.s_lo]
            assert point >= 0, "a list entry not written for this query"
            if self.chunk is not None:
                assert self.chunk[0] <= point < self.chunk[1], "a value outside the staged chunk"
            return self.values[point, k]
        assert self.centre is not None
        return self.centre[k]

    def write(self, a, b):
        """Slots a..b-1: row floats [a C, b C)."""
        if b <= a:
            return
        c = self.c
        self.stats["pieces"] += 1
        if c > BALL_GROUP_GATHER_C:  # slot by slot, lanes over the channels
            for slot in range(a, b):
                for k in range(c):
                    self.put(slot * c + k, self.value(slot, k))
            return
        n, start = (b - a) * c, self.base + a * c
        head = min((4 - start % 4) % 4, n)
        for lane in range(head):
            self.put(a * c + lane, self.value(a + lane // c, lane % c))
        vec = (n - head) // 4
        dq, dr = divmod(128, c)
        for lane in LANES:
            e = head + 4 * lane
            q, k = divmod(e, c)
            for v in range(lane, vec, 32):
                assert (start + head + 4 * v) % 4 == 0  # a 16-byte store
                for i in range(4):
                    qi, ki = q, k + i
                    while ki >= c:
                        ki -= c
                        qi += 1
                    assert (qi * c + ki) == head + 4 * v + i
                    self.put(a * c + head + 4 * v + i, self.value(a + qi, ki))
                q, k = q + dq, k + dr
                if k >= c:
                    k, q = k - c, q + 1
                self.stats["vector_floats"] += 4
        t0 = head + 4 * vec
        for lane in range(n - t0):
            qt, kt = divmod(t0 + lane, c)
            self.put(a * c + t0 + lane, self.value(a + qt, kt))
        self.lst[: min(b - self.s_lo, len(self.lst))] = -1  # written: spent

    def put(self, f, v):
        assert np.isnan(self.out[self.base + f]), "a float written twice"
        self.out[self.base + f] = v


def emulate(radius, nsample, xyz, new_xyz, itself, values, chunk=None, lst_len=BALL_GROUP_LIST, queries=None,
            warps=8):
    """The kernel's schedule in numpy: (out (B, S, nsample, C), stats)."""
    B, N, _ = xyz.shape
    S, C = new_xyz.shape[1], values.shape[-1]
    queries = queries or ball_group_queries(B, S)
    r2 = np.float32(squared_radius(radius))
    P, staged = ball_group_chunk(N, C)
    P = chunk if chunk is not None else P
    rowlen = nsample * C
    out = np.full(B * S * rowlen, np.nan, np.float32)
    stats = {"pieces": 0, "vector_floats": 0, "chunks": [], "chunk_writes": 0, "windows": 0}
    for b in range(B):
        lists = [np.full(lst_len, -1, np.int64) for _ in range(warps)]
        for s0 in range(0, S, queries):
            found = [0] * queries
            s_lo = [0] * queries
            n_staged = 0
            for c0 in range(0, N, P):
                cn = min(P, N - c0)
                last = c0 + cn >= N
                cx = xyz[b, c0 : c0 + cn].T  # x | y | z of the chunk
                n_staged += 1
                any_open = False
                for w in range(warps):
                    for qi in range(w, queries, warps):
                        if s0 + qi >= S:
                            break
                        if found[qi] < 0:
                            continue
                        q = b * S + s0 + qi
                        qx, qy, qz = new_xyz[b, s0 + qi]
                        me = int(itself[b, s0 + qi])
                        wr = Writer(out, q * rowlen, values[b], C, lists[w], (c0, c0 + cn) if staged else None,
                                    stats)
                        cnt = first = found[qi]
                        masks = []  # each round's in-ball lanes
                        for j0 in range(c0, c0 + cn, 32 * BALL_GROUP_ROUNDS):  # the rounds of an iteration
                            if cnt >= nsample:
                                break
                            for j in (j0 + 32 * r + LANES for r in range(BALL_GROUP_ROUNDS)):
                                ok = (j < c0 + cn) & (j != me)
                                p = np.minimum(j - c0, cn - 1)
                                d0, d1, d2 = qx - cx[0, p], qy - cx[1, p], qz - cx[2, p]
                                d = (d0 * d0 + d1 * d1) + d2 * d2  # f32, each operation rounded
                                masks.append(ok & (d <= r2))
                                cnt += int(masks[-1].sum())
                        wr.cnt = min(cnt, nsample)
                        finish = cnt >= nsample or last
                        end = nsample if finish else wr.cnt
                        if finish:
                            has_self = 0 <= me < N
                            wr.centre = values[b, me] if has_self else np.zeros(C, np.float32)
                        lst = lists[w]
                        for lo in range(s_lo[qi], end, lst_len):  # a list's worth of slots at a time
                            hi = min(lo + lst_len, end)
                            rank0 = first  # the list: 32 rounds a pass, a lane a round
                            for r0 in range(0, len(masks), 32):
                                if rank0 >= min(hi, wr.cnt):
                                    break
                                counts = np.array([m.sum() for m in masks[r0 : r0 + 32]])
                                for lane, m in enumerate(masks[r0 : r0 + 32]):
                                    rank = rank0 + int(counts[:lane].sum())  # the rounds before (a warp scan)
                                    for bit in np.flatnonzero(m):
                                        if lo <= rank < min(hi, wr.cnt):
                                            lst[rank - lo] = c0 + 32 * (r0 + lane) + bit
                                        rank += 1
                                rank0 += int(counts.sum())
                            wr.s_lo = lo
                            wr.write(lo, hi)
                            stats["windows"] += 1
                        if finish:
                            found[qi] = -1
                        else:
                            stats["chunk_writes"] += 1
                            found[qi], s_lo[qi] = cnt, wr.cnt
                            any_open = True
                if not any_open:
                    break
            stats["chunks"].append(n_staged)
    return out.reshape(B, S, nsample, C), stats


def case(rng, b, n, s, c, itself=None, scale=1.0):
    xyz = (scale * rng.uniform(-1.0, 1.0, (b, n, 3))).astype(np.float32)
    new = xyz[:, :s].copy() if s <= n else (scale * rng.uniform(-1.0, 1.0, (b, s, 3))).astype(np.float32)
    vals = rng.normal(size=(b, n, c)).astype(np.float32)
    if itself is None:
        itself = np.broadcast_to(np.arange(s, dtype=np.int32) % n, (b, s)).copy()
    return xyz, new, itself, vals


def check(radius, nsample, xyz, new, itself, vals, **schedule):
    got, stats = emulate(radius, nsample, xyz, new, itself, vals, **schedule)
    want = ball_group_reference(radius, nsample, *(torch.from_numpy(a) for a in (xyz, new, itself, vals))).numpy()
    assert not np.isnan(got).any(), "a float of a row was never written"
    np.testing.assert_array_equal(got, want)
    return stats


@pytest.mark.parametrize("c", [1, 3, 6, 7])
def test_chunk_boundary_inside_a_ball(c):
    """Chunks of 64 points: balls of radius 0.9 span several chunks, each
    query's count and first unwritten slot carry over and its listed slots
    are written before the chunk leaves shared memory; C = 1, 3, 6, 7 (rows
    of 16 C floats: unaligned starts for odd C)."""
    rng = np.random.default_rng(c)
    xyz, new, itself, vals = case(rng, 2, 200, 40, c)
    stats = check(0.9, 16, xyz, new, itself, vals, chunk=64)
    assert stats["chunk_writes"] > 0 and max(stats["chunks"]) > 1


def test_nsample_above_the_in_ball_count_pads_with_the_centre():
    """nsample 60 against a radius of 0.3: most rows are padded with the
    centre's values, through several chunks."""
    rng = np.random.default_rng(11)
    xyz, new, itself, vals = case(rng, 2, 150, 33, 6)
    check(0.3, 60, xyz, new, itself, vals, chunk=64)


@pytest.mark.parametrize("c", [6, 7])
def test_rows_past_the_list_are_written_in_pieces(c):
    """nsample 200 against a list of 16 slots: ~45 of 120 points in a ball
    of 0.9 listed and written 16 at a time, then the padding in pieces of
    16 slots, odd C off the 16-byte grid."""
    rng = np.random.default_rng(20 + c)
    xyz, new, itself, vals = case(rng, 2, 120, 20, c)
    stats = check(0.9, 200, xyz, new, itself, vals, lst_len=16)
    assert stats["windows"] == 2 * 20 * -(-200 // 16) and stats["vector_floats"] > 0


def test_wide_values_go_slot_by_slot():
    """C = 40 (past BALL_GROUP_GATHER_C): slot by slot, lanes over the
    channels."""
    rng = np.random.default_rng(40)
    xyz, new, itself, vals = case(rng, 1, 100, 20, 40)
    check(0.5, 12, xyz, new, itself, vals, chunk=32)


def test_centres_outside_the_cloud_pad_with_zeros():
    """Center indices -1 and N: nothing left out of the ball, zeros padded;
    S != N (more queries than points)."""
    rng = np.random.default_rng(3)
    xyz, new, itself, vals = case(rng, 2, 90, 100, 6)
    itself[:, ::7], itself[:, 3::7] = -1, 90
    check(0.4, 20, xyz, new, itself, vals, chunk=32)


def test_fewer_queries_than_points_and_the_default_schedule():
    """S < N with the kernel's own chunk and list (one chunk: 300 points of
    C = 6 fit), 70 queries over nine blocks of eight and over three of 32."""
    rng = np.random.default_rng(4)
    xyz, new, itself, vals = case(rng, 1, 300, 70, 6)
    assert check(0.3, 64, xyz, new, itself, vals)["chunks"] == [1] * 9
    assert check(0.3, 64, xyz, new, itself, vals, queries=32)["chunks"] == [1] * 3


def test_the_block_stops_once_every_query_has_its_row():
    """A dense cloud where every query finds nsample in its first chunk: each
    block stages one chunk of four."""
    rng = np.random.default_rng(5)
    xyz, new, itself, vals = case(rng, 2, 256, 32, 3, scale=0.1)
    stats = check(0.5, 8, xyz, new, itself, vals, chunk=64)
    assert stats["chunks"] == [1] * 8  # 2 clouds x 4 blocks of 8 queries


def test_queries_statement():
    """RPMNet's 16 x 1024 queries go 16 a block (1024 blocks fill 132 SMs'
    four resident blocks where 32 a block would not); few queries go one a
    warp."""
    assert ball_group_queries(16, 1024) == 16
    assert ball_group_queries(64, 1024) == 32
    assert ball_group_queries(2, 541) == 8


def test_chunk_statement():
    """RPMNet's cloud (1024 points, C = 6: 36 KB) is one chunk; 20,000 points
    take chunks of 1120; past 32 points' worth of values only the
    coordinates are staged."""
    assert ball_group_chunk(1024, 6) == (1024, True)
    assert ball_group_chunk(20000, 6) == (1120, True)
    assert ball_group_chunk(20000, 400) == (3392, False)
