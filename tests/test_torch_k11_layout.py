"""What K11's wrappers lay out on the host side for its kernels, on the CPU:
the head maps through which S3 reads Q, K and V in place from the
projection buffers (``head_map``), the V^T scratch of its int8 P.V instance
(``values_scratch_shape``), and the packed weights that S2's TMA loads read
K-major (``FusedLayerWeights``)."""

import numpy as np
import pytest
import torch

from learning3d_tpu_torch.kernels import attention as tattn
from learning3d_tpu_torch.kernels import transformer_int8 as k11


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def through_map(buf, offset, m):
    """The elements a head map reads from the contiguous int8 buffer ``buf``
    with its base ``offset`` bytes on: (batch, rows, heads, d_k)."""
    d_k, heads, rows, batch = m["dims"]
    s1, s2, s3 = m["strides"]
    return torch.as_strided(buf.reshape(-1), (batch, rows, heads, d_k), (s3, s2, s1, 1), offset)


def split_heads(t, heads):
    """``_attend``'s split of (B, N, d) into heads, before the transpose."""
    return t.reshape(t.shape[0], t.shape[1], heads, t.shape[2] // heads)


# self-attention reads Q, K and V from the Q|K|V buffer (row stride 3d);
# cross-attention Q from q2 (stride d) and K, V from the K|V buffer (2d)
@pytest.mark.parametrize("batch,n,d,heads", [(2, 1024, 512, 4), (3, 300, 512, 2), (1, 256, 1024, 1)])
def test_head_maps_read_each_head_in_place(batch, n, d, heads):
    rng = np.random.default_rng(n + d)
    qkv = torch.from_numpy(rng.integers(-127, 128, (batch, n, 3 * d)).astype(np.int8))
    for i in range(3):
        m = k11.head_map(3 * d, n, batch, heads, d // heads, 128)
        assert torch.equal(through_map(qkv, i * d, m), split_heads(qkv[..., i * d:(i + 1) * d], heads))
    q2 = torch.from_numpy(rng.integers(-127, 128, (batch, n, d)).astype(np.int8))
    assert torch.equal(through_map(q2, 0, k11.head_map(d, n, batch, heads, d // heads, 128)), split_heads(q2, heads))
    kv = torch.from_numpy(rng.integers(-127, 128, (batch, 2 * n + 1, 2 * d)).astype(np.int8))
    m = k11.head_map(2 * d, 2 * n + 1, batch, heads, d // heads, 64)
    for i in range(2):
        assert torch.equal(through_map(kv, i * d, m), split_heads(kv[..., i * d:(i + 1) * d], heads))


@pytest.mark.parametrize("ld,rows,batch,heads,d_k,box_rows", [(1536, 1024, 32, 4, 128, 128),
                                                                (1024, 777, 2, 2, 256, 64)])
def test_head_map_fits_tma(ld, rows, batch, heads, d_k, box_rows):
    """What the TMA encoding needs: byte strides that are multiples of 16, a
    box of one 128-byte swizzle row (128 int8 columns) of at most 256 rows
    inside one head and item, and heads that do not overlap."""
    m = k11.head_map(ld, rows, batch, heads, d_k, box_rows)
    assert all(s % 16 == 0 for s in m["strides"])
    assert m["box"] == (128, 1, box_rows, 1) and box_rows <= 256
    assert d_k % m["box"][0] == 0 and m["strides"][0] == d_k and heads * d_k <= ld


@pytest.mark.parametrize("m", [1, 200, 777, 1024])
def test_values_scratch_is_k10s_vt_of_each_head(m):
    """The V^T scratch holds, for batch item b and head h, K10's V^T in
    key_order of that head's V: int8_pv_values of the heads side by side."""
    rng = np.random.default_rng(m)
    batch, heads, d = 2, 4, 512
    kv = torch.from_numpy(rng.integers(-127, 128, (batch, m, 2 * d)).astype(np.int8))
    v = split_heads(kv[..., d:], heads).transpose(1, 2).reshape(batch * heads, m, d // heads)
    vt = tattn.int8_pv_values(v)
    assert tuple(vt.shape) == k11.values_scratch_shape(batch, heads, m, d // heads)
    assert vt.shape[-1] % tattn.PV_KEYS == 0 and vt.shape[-1] >= m


def test_packed_weights_are_k_major():
    """S2's B operand: each GEMM's weight as (out, in) int8, contiguous, rows
    a multiple of 16 bytes (TMA), Q|K|V and K|V concatenated by output
    column, the hidden width padded to a multiple of 128 with zeros."""
    rng = np.random.default_rng(0)
    d, d_ff = 256, 200
    w = {}
    for p in ("", "x"):
        for mm in ("q", "k", "v", "o"):
            w[f"{p}w{mm}"] = torch.from_numpy(rng.integers(-127, 128, (d, d)).astype(np.int8))
            w[f"{p}sw{mm}"] = torch.from_numpy(rng.uniform(1e-4, 1e-3, d).astype(np.float32))
            w[f"{p}b{mm}"] = torch.zeros(d)
    w["w1"] = torch.from_numpy(rng.integers(-127, 128, (d, d_ff)).astype(np.int8))
    w["w2"] = torch.from_numpy(rng.integers(-127, 128, (d_ff, d)).astype(np.int8))
    w["sw1"], w["b1"] = torch.full((d_ff,), 1e-3), torch.zeros(d_ff)
    w["sw2"], w["b2"] = torch.full((d,), 1e-3), torch.zeros(d)
    for i in (1, 2, 3):
        w[f"ln{i}a"], w[f"ln{i}b"] = torch.ones(d), torch.zeros(d)
    pack = k11.FusedLayerWeights(w, k11.LayerScales(*(0.02,) * 7), 2, decoder=True)
    assert torch.equal(pack.qkv_w, torch.cat([w["wq"], w["wk"], w["wv"]], dim=1).t())
    assert torch.equal(pack.xkv_w, torch.cat([w["xwk"], w["xwv"]], dim=1).t())
    assert torch.equal(pack.ff1_w[:d_ff], w["w1"].t()) and not pack.ff1_w[d_ff:].any()
    assert torch.equal(pack.ff2_w[:, :d_ff], w["w2"].t()) and not pack.ff2_w[:, d_ff:].any()
    for name in ("qkv", "xq", "xkv", "ff1"):  # the requant GEMMs' reciprocals of their output scales
        so, sr = getattr(pack, name + "_so"), getattr(pack, name + "_sr")
        assert torch.equal(sr, 1.0 / so) and sr.dtype == torch.float32
    for name in ("qkv", "o", "xq", "xkv", "xo", "ff1", "ff2"):
        wt = getattr(pack, name + "_w")
        assert wt.dtype == torch.int8 and wt.is_contiguous() and wt.shape[0] % 128 == 0 and wt.shape[1] % 16 == 0


def quant_by_reciprocal(y, s):
    """S2's requant (csrc/transformer_int8.cu ``requant_epilogue``) in numpy
    f32: round(y * r) with r = 1 / s, and the IEEE quotient where y * r lies
    within 2^-15 of a half-integer; also which elements those were."""
    f32 = np.float32
    r = f32(1.0) / s
    x = np.clip((y * r).astype(f32), f32(-127), f32(127))
    u = (x + f32(12582912.0)).astype(f32)
    near = np.abs((x - (u - f32(12582912.0)).astype(f32)).astype(f32)) > f32(0.5 - 2.0**-15)
    exact = np.clip(np.rint((y / s).astype(f32)), -127, 127)
    return np.where(near, exact, u.view(np.int32) - 0x4B400000), near


@pytest.mark.parametrize("s", [0.02, 0.0057, 1.0, 0.3333, 1.9e-3])
def test_quant_by_reciprocal_is_quant(s):
    """S2's requant equals quant = clip(rint(y / s)) (the plain version's IEEE
    quotient) everywhere, near every half-integer and past the clamp; the
    division decides a few elements in 10^5 of random y."""
    rng = np.random.default_rng(int(s * 1e4))
    s = np.float32(s)
    y = (rng.normal(size=1_000_000) * 60 * s).astype(np.float32)
    halves = (np.arange(-130, 131) + np.float32(0.5)).astype(np.float32) * s
    ties = np.concatenate([np.nextafter(halves, np.float32(sign * np.inf)) for sign in (-1, 1)] + [halves])
    for ys in (y, ties, np.float32([0.0, -0.0, 1e-30, -1e-30, 1e30, -1e30])):
        got, near = quant_by_reciprocal(ys.astype(np.float32), s)
        want = np.clip(np.rint((ys / s).astype(np.float32)), -127, 127)
        assert np.array_equal(got, want)
    _, near = quant_by_reciprocal(y, s)
    assert near.mean() < 1e-4
