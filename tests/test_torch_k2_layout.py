"""What K2's weight image lays out and how its stages hand over, on the CPU:
``k2_image`` (the bytes ``csrc/pointnet_int8.cu``'s wgmma products read,
built once per model by ``PointNetInt8Weights``) against a numpy statement,
element by element, of wgmma's K-major int8 operand with the 128-byte
swizzle and the contracted index key-ordered; a numpy emulation of the
kernel's chain, thread by thread through the accumulator and A-fragment
layouts of int8 wgmma, against the plain version; and ``k2_plan``'s group
choice."""

import numpy as np
import pytest
import torch

from learning3d_tpu_torch.kernels.pointnet_fused import (
    K2_W234_BYTES, PointNetInt8Weights, k2_image, k2_plan, pn_int8_reference)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def swizzled_offset(row, k):
    """Byte k (0..127) of 128-byte row `row` of a swizzled image."""
    return row * 128 + (((k // 16) ^ (row % 8)) * 16) + k % 16


def key_channel(p):
    """The channel at position p of a key-ordered contracted index: in each
    16-channel group, positions 4t..4t+3 hold channels 2t, 2t+1, 2t+8, 2t+9."""
    grp, r = divmod(p, 16)
    t, i = divmod(r, 4)
    return 16 * grp + 2 * t + (i if i < 2 else 8 + i - 2)


def numpy_image(w2t, w3t, w4t, w5t):
    """The image element by element from the (out, in) int8 weights (as
    uint8 bytes)."""
    emb = w5t.shape[0]
    img = np.zeros(K2_W234_BYTES + 128 * emb, np.uint8)
    for n in range(128):
        for p in range(64):
            img[swizzled_offset(n, p)] = w4t[n, key_channel(p)]
            if n < 64:
                img[swizzled_offset(n, 64 + p)] = w2t[n, p]
            else:
                img[swizzled_offset(n, 64 + p)] = w3t[n - 64, key_channel(p)]
    for n in range(emb):
        for p in range(128):
            img[K2_W234_BYTES + swizzled_offset(n, p)] = w5t[n, key_channel(p)]
    return img


def int8_pack(rng, emb):
    """A PointNetInt8Weights of random folded weights and scales."""
    dims = [3, 64, 64, 64, 128, emb]
    ws = [torch.from_numpy(rng.normal(0, i**-0.5, (i, o)).astype(np.float32)) for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.from_numpy(rng.normal(0, 0.1, o).astype(np.float32)) for o in dims[1:]]
    qlayers = []
    for w, b in zip(ws[1:], bs[1:]):
        s_w = w.abs().amax(0).clamp_min(1e-12) / 127
        qlayers.append((torch.clamp(torch.round(w / s_w), -127, 127).to(torch.int8), s_w, b,
                        float(rng.uniform(0.01, 0.05))))
    return PointNetInt8Weights(ws[0], bs[0], qlayers)


@pytest.mark.parametrize("emb", [64, 192])
def test_k2_image_matches_numpy_statement(emb):
    pack = int8_pack(np.random.default_rng(emb), emb)
    wts = [wt.numpy().view(np.uint8) for wt, _ in pack.stages()]
    assert pack.img.dtype == torch.uint8 and pack.img.shape == (K2_W234_BYTES + 128 * emb,)
    np.testing.assert_array_equal(pack.img.numpy(), numpy_image(*wts))
    assert torch.equal(k2_image([wt for wt, _ in pack.stages()]), pack.img)


def test_image_follows_load_state_dict():
    """The state dict holds the weights, not the image derived from them:
    loading another pack's weights rebuilds ``img``."""
    src, dst = int8_pack(np.random.default_rng(1), 64), int8_pack(np.random.default_rng(2), 64)
    assert "img" not in src.state_dict()
    dst.load_state_dict(src.state_dict())
    assert torch.equal(dst.img, src.img)


# ---- the kernel's chain, emulated thread by thread -------------------------

MAGIC = np.float32(12582912.0)


def requant(z, inv):
    """requant_bits' low byte: min(relu(z) * inv, 127) + 1.5 * 2^23, in f32."""
    v = np.minimum(np.maximum(z, np.float32(0)) * inv, np.float32(127)).astype(np.float32)
    return ((v + MAGIC).astype(np.float32).view(np.uint32) & 0xFF).astype(np.int64)


def epilogue(acc, s, b):
    return (acc.astype(np.float32) * s).astype(np.float32) + b


def unswizzle(img, rows):
    """(rows * 128,) swizzled bytes -> the (rows, 128) logical int8 rows."""
    idx = np.array([[swizzled_offset(r, k) for k in range(128)] for r in range(rows)])
    return img[idx].view(np.int8).astype(np.int64)


def thread_grid():
    """(warp, g, t) of a warpgroup's 128 threads, as broadcastable arrays."""
    w, g, t = np.meshgrid(np.arange(4), np.arange(8), np.arange(4), indexing="ij")
    return w[..., None], g[..., None], t[..., None]


def accumulator(d, idx):
    """The values of accumulator registers ``idx`` (an array over the last
    axis) in every thread: acc[4j + e] is D[16w + g + 8(e >> 1), 8j + 2t +
    (e & 1)]."""
    w, g, t = thread_grid()
    j, e = idx // 4, idx % 4
    return d[16 * w + g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1)]


PACK = np.array([[0, 1, 4, 5], [2, 3, 6, 7], [8, 9, 12, 13], [10, 11, 14, 15]])  # chunk c: + 16c


def hand_off(q, chunks):
    """The next stage's A operand (64, 32 chunks) as the threads hold it:
    register r of chunk c takes the bytes of accumulators 16c + PACK[r]
    (requantized ``q``), and A-fragment register r byte i is A[16w + g + 8(r
    & 1), 32c + 16(r >> 1) + 4t + i]."""
    w, g, t = thread_grid()
    a = np.zeros((64, 32 * chunks), np.int64)
    for c in range(chunks):
        for r in range(4):
            vals = accumulator(q, 16 * c + PACK[r])  # (4, 8, 4, 4): the four bytes
            a[16 * w + g + 8 * (r & 1), 32 * c + 16 * (r >> 1) + 4 * t + np.arange(4)] = vals
    return a


def h4_tile(q4):
    """The warpgroup's h4 tile (64 points x 128 bytes, swizzled) as stage 4's
    threads store it: for 16-channel group h and rows g + 8r, the word of
    accumulators 8h + 2r + {0, 1, 4, 5} at row * 128 + ((h ^ row % 8) << 4)
    + 4t; returned unswizzled."""
    w, g, t = thread_grid()
    tile = np.zeros(64 * 128, np.uint8)
    for h in range(8):
        for r in range(2):
            vals = accumulator(q4, 8 * h + 2 * r + np.array([0, 1, 4, 5]))
            row = 16 * w + g + 8 * r
            tile[row * 128 + ((h ^ (row % 8)) << 4) + 4 * t + np.arange(4)] = vals.astype(np.uint8)
    return unswizzle(tile, 64)


def bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def emulate(x, pack):
    """K2's chain as its threads compute it, from the image: (B, emb) f32."""
    img = pack.img.numpy()
    emb = pack.wt3.shape[0]
    top = unswizzle(img[:K2_W234_BYTES], 128)
    w4, w2, w3 = top[:, :64], top[:64, 64:], top[64:, 64:]
    w5 = unswizzle(img[K2_W234_BYTES:], emb)
    w1, b1 = bf16(pack.w1.numpy()), pack.b1.numpy()
    (s2, s3, s4, s5) = [swb.numpy() for _, swb in pack.stages()]
    inv = [np.float32(v) for v in pack.inv_s]
    B, N, _ = x.shape
    out = np.zeros((B, emb), np.float32)
    for b in range(B):
        best = np.full(emb, np.iinfo(np.int64).min)
        for p0 in range(0, N, 64):  # a warpgroup's half of a 128-point tile
            xs = np.zeros((64, 3), np.float32)
            valid = min(64, N - p0)
            xs[:valid] = bf16(x[b, p0 : p0 + valid])
            z = xs[:, :1] * w1[0]  # x0 w0, then two fmaf of exact products: one rounding each
            z = (z + (xs[:, 1:2] * w1[1]).astype(np.float32)).astype(np.float32)
            z = (z + (xs[:, 2:3] * w1[2]).astype(np.float32)).astype(np.float32)
            a = requant(z + b1, inv[0])  # natural order: stage 1 forms W2's fragments channel by channel
            q = requant(epilogue(a @ w2.T, s2[0], s2[1]), inv[1])
            q = requant(epilogue(hand_off(q, 2) @ w3.T, s3[0], s3[1]), inv[2])
            q4 = requant(epilogue(hand_off(q, 2) @ w4.T, s4[0], s4[1]), inv[3])
            d5 = w5 @ h4_tile(q4).T  # (emb, 64): channels x points
            best = np.maximum(best, d5[:, :valid].max(1))
        out[b] = np.maximum(epilogue(best, s5[0], s5[1]), 0)
    return out


@pytest.mark.parametrize("batch,n_pts,emb", [(2, 100, 64), (3, 1, 128), (1, 256, 64), (4, 65, 64)])
def test_emulated_chain_is_the_plain_version(batch, n_pts, emb):
    """The key-ordered hand-off and h4 tile through the image's permuted
    weights give the plain version's output exactly at ragged shapes."""
    rng = np.random.default_rng(batch * 1000 + n_pts + emb)
    pack = int8_pack(rng, emb)
    x = rng.normal(size=(batch, n_pts, 3)).astype(np.float32)
    want = pn_int8_reference(torch.from_numpy(x), pack).numpy()
    np.testing.assert_array_equal(emulate(x, pack), want)


def test_fp32_pipe_requant_matches_round_half_even():
    """requant_bits: adding 1.5 * 2^23 to min(relu(z) * inv, 127) leaves
    min(round-half-even(relu(z) * inv), 127) in the low byte, clamped first
    so the trick stays below 2^22."""
    z = np.concatenate([np.arange(-3, 130, 0.25), np.arange(0, 128) + 0.5, [1e9, 3e38, 126.49999, 126.5, 127.5]])
    z = z.astype(np.float32)
    want = np.minimum(np.rint(np.maximum(z, 0)), 127).astype(np.int64)
    np.testing.assert_array_equal(requant(z, np.float32(1.0)), want)


@pytest.mark.parametrize("batch,emb,want", [(256, 1024, (1024, 1, 132)), (32, 1024, (256, 4, 32)),
                                            (1, 64, (64, 1, 1))])
def test_k2_plan(batch, emb, want):
    """One group of 1024 at B=256 (stages 1-4 once a cloud, two rounds of
    132 blocks); four of 256 at B=32 (128 blocks in one round)."""
    assert k2_plan(batch, emb, 132) == want
