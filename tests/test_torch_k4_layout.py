"""K4's dx_sp schedule (``csrc/poolgrad.cu``), emulated on the CPU: a block
takes BWD_ROW_TILE rows of one cloud, its BWD_WARPS warps each a contiguous
range of 32-key rounds of e, and compacts the keys whose row lies in the tile
into one list in ascending e (a ballot a round, each warp's count, the
warps' offsets, each key at its offset plus the in-tile lanes below it); a
row's warp then takes its keys from that list by ballot, in lane order,
until it has the row's count, BWD_KEY_BATCH at a time. Every row of a tile
must receive exactly its keys in ascending e (the order of the kernel's and
the plain version's chains), and the rows summed from those lists must give
``pool_bwd_reference``'s dx_sp."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from learning3d_tpu_torch.kernels.poolgrad import (
    BWD_KEY_BATCH, BWD_ROW_TILE, BWD_WARPS, MAX_E_BWD, pool_bwd_reference)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


LANES = np.arange(32)


def compact(idx, r0, rows, warps=BWD_WARPS):
    """A block's list: (entries (row << 12 | e), count a row)."""
    E = idx.shape[0]
    seg = -(-(-(-E // 32)) // warps)  # 32-key rounds a warp
    assert E <= MAX_E_BWD  # a list entry keeps e in its low 12 bits
    rel = idx.astype(np.int64) - r0  # the row less r0; outside [0, rows): not in this tile

    def rounds(w):
        for k in range(seg):
            e = (w * seg + k) * 32 + LANES
            ok = e < E
            yield e, ok & (rel[np.minimum(e, E - 1)] >= 0) & (rel[np.minimum(e, E - 1)] < rows)

    counts = [sum(int(m.sum()) for _, m in rounds(w)) for w in range(warps)]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    entries = np.full(offsets[-1], -1, np.int64)
    cnt = np.zeros(BWD_ROW_TILE, np.int64)
    for w in range(warps):
        off = offsets[w]
        for e, m in rounds(w):
            for lane in np.flatnonzero(m):
                pos = off + int(m[:lane].sum())
                assert entries[pos] == -1, "a list slot written twice"
                entries[pos] = (rel[e[lane]] << 12) | e[lane]
                cnt[rel[e[lane]]] += 1
            off += int(m.sum())
    assert (entries >= 0).all()
    return entries, cnt


def row_keys(entries, cnt, r):
    """Row r's keys as its warp takes them: rounds of 32 list entries, a
    ballot of those on row r, their e in lane order, BWD_KEY_BATCH loads at
    a time, until it has cnt[r]."""
    keys, i0 = [], 0
    while len(keys) < cnt[r]:
        ent = np.where(i0 + LANES < len(entries), entries[np.minimum(i0 + LANES, len(entries) - 1)], -1)
        mask = list(np.flatnonzero((ent >= 0) & ((ent >> 12) == r)))
        while mask:
            batch, mask = mask[:BWD_KEY_BATCH], mask[BWD_KEY_BATCH:]
            keys.extend(int(ent[lane] & 0xFFF) for lane in batch)
        i0 += 32
    assert len(keys) == cnt[r]
    return keys


def emulate(idx, n_pts):
    """Every row's keys, tile by tile: {(cloud, row): [e, ...]}."""
    out = {}
    for b in range(idx.shape[0]):
        for r0 in range(0, n_pts, BWD_ROW_TILE):
            rows = min(BWD_ROW_TILE, n_pts - r0)
            entries, cnt = compact(idx[b], r0, rows)
            assert list(entries & 0xFFF) == sorted(entries & 0xFFF), "the list is not in ascending e"
            for r in range(rows):
                out[b, r0 + r] = row_keys(entries, cnt, r)
    return out


def check(idx, n_pts):
    got = emulate(idx, n_pts)
    for (b, n), keys in got.items():
        assert keys == list(np.flatnonzero(idx[b] == n)), f"row {n} of cloud {b}"
    return got


def dx_from_lists(lists, idx, dsel, w, n_pts):
    """dx_sp summed row by row from the lists, in their order (f64)."""
    dx = np.zeros((idx.shape[0], n_pts, w.shape[0]))
    for (b, n), keys in lists.items():
        for e in keys:
            dx[b, n] += float(dsel[b, e]) * w[:, e].astype(np.float64)
    return dx


@pytest.mark.parametrize("n_pts,e_total", [(1000, 1024), (300, 1000), (256, 4096)])
def test_every_row_gets_its_keys_in_ascending_e(n_pts, e_total):
    """Ragged N (1000: a last tile of 104 rows; 300: 44), a row-tile
    boundary (256: two full tiles), E = 1000 (a partial last round) and 4096
    (the C entry's limit: 16 rounds a warp); keys drawn from a few critical
    rows, as the max pool picks them, and a few outside [0, N)."""
    rng = np.random.default_rng(n_pts + e_total)
    hot = rng.choice(n_pts, 24, replace=False)
    idx = np.where(rng.random((2, e_total)) < 0.7, rng.choice(hot, (2, e_total)),
                   rng.integers(0, n_pts, (2, e_total))).astype(np.int32)
    idx[0, ::97] = -1
    idx[1, ::89] = n_pts
    lists = check(idx, n_pts)
    assert sum(map(len, lists.values())) == int(((idx >= 0) & (idx < n_pts)).sum())


def test_keys_on_both_sides_of_a_tile_boundary():
    """Keys on rows BWD_ROW_TILE - 1 and BWD_ROW_TILE (the last of one tile,
    the first of the next) interleaved in e."""
    idx = np.where(np.arange(512) % 2 == 0, BWD_ROW_TILE - 1, BWD_ROW_TILE)[None].astype(np.int32)
    lists = check(idx, 2 * BWD_ROW_TILE)
    assert lists[0, BWD_ROW_TILE - 1] == list(range(0, 512, 2)) and lists[0, BWD_ROW_TILE] == list(range(1, 512, 2))


@pytest.mark.parametrize("e_total", [1024, 4096])
def test_all_keys_on_one_row(e_total):
    """Every channel picks row 5: one row takes all E keys in ascending e;
    every other row of the tile none."""
    idx = np.full((1, e_total), 5, np.int32)
    lists = check(idx, 200)
    assert lists[0, 5] == list(range(e_total)) and all(not v for k, v in lists.items() if k != (0, 5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rows_summed_from_the_lists_give_the_plain_dx(dtype):
    """The lists carry every key once: dx_sp summed from them (f64) lies
    within f32 rounding of the plain version's, with r(dsel) in bf16 for
    bf16 W, and every row without a key is 0."""
    rng = np.random.default_rng(8)
    B, N, K, E = 2, 300, 128, 384
    idx = rng.integers(0, N // 4, (B, E)).astype(np.int32)
    dsel = rng.normal(size=(B, E)).astype(np.float32)
    w = torch.from_numpy(rng.normal(0, K**-0.5, (K, E)).astype(np.float32)).to(dtype)
    x = torch.zeros(B, N, K, dtype=dtype)
    want, _ = pool_bwd_reference(torch.from_numpy(idx), torch.from_numpy(dsel), w, x)
    coef = torch.from_numpy(dsel).to(dtype).float().numpy()
    got = dx_from_lists(emulate(idx, N), idx, coef, w.float().numpy(), N)
    np.testing.assert_allclose(got, want.numpy().astype(np.float64), rtol=0, atol=1e-5 * float(want.abs().max()))
    assert (got[:, N // 4 :] == 0).all()


@pytest.mark.parametrize("name,value", [("kRowTile", BWD_ROW_TILE), ("kWarps", BWD_WARPS), ("kRowKeys", BWD_KEY_BATCH)])
def test_schedule_is_the_kernels(name, value):
    """The constants this emulation runs are the kernel source's."""
    import learning3d_tpu_torch.kernels as kernels

    src = (Path(kernels.__file__).parent / "csrc" / "poolgrad.cu").read_text()
    assert re.findall(rf"constexpr int {name} = (\d+);", src) == [str(value)]
