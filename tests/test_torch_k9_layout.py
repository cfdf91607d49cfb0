"""What K9's weight images lay out, and the arithmetic tricks of its
epilogues, on the CPU: ``k9_images`` (the bytes ``csrc/dgcnn_int8.cu``'s
wgmma products read, built once per model by ``DGCNNInt8Weights``) against a
numpy statement, element by element, of wgmma's K-major operands with the
128-byte swizzle; ``key_order`` against the accumulator and A-fragment
layouts of int8 wgmma; and the FP32-pipe roundings (1.5 * 2^23) against
numpy's."""

import numpy as np
import pytest
import torch

from learning3d_tpu_torch.kernels.dgcnn_fused import DGCNNInt8Weights, k9_images, key_order


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


def numpy_images(w2t, w3t, w4t, w5t):
    """The three images element by element from the (out, in) int8 weights."""
    w23 = np.zeros(16384, np.uint8)
    for n in range(128):
        for p in range(64):
            if n < 64:
                w23[swizzled_offset(n, p)] = w2t[n, p]
            w23[swizzled_offset(n, 64 + p)] = w3t[n, key_channel(p)]
    w4 = np.zeros(32768, np.uint8)
    for n in range(256):
        for p in range(128):
            w4[swizzled_offset(n, p)] = w4t[n, key_channel(p)]
    emb = w5t.shape[0]
    w5 = np.zeros(512 * emb, np.uint8)
    for n in range(emb):
        for p in range(512):
            ch = p if p < 64 else key_channel(p)
            slab, row, box = n // 32, n % 32, p // 128
            w5[slab * 16384 + box * 4096 + swizzled_offset(row, p % 128)] = w5t[n, ch]
    return w23, w4, w5


def int8_weights(rng, emb):
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, emb)]
    ws = [torch.from_numpy(rng.normal(0, i**-0.5, (i, o)).astype(np.float32)) for i, o in dims]
    bs = [torch.from_numpy(rng.normal(0, 0.1, o).astype(np.float32)) for _, o in dims]
    return DGCNNInt8Weights(ws, bs, (0.02, 0.03, 0.03, 0.04))


@pytest.mark.parametrize("emb", [64, 96])
def test_k9_images_match_numpy_statement(emb):
    pack = int8_weights(np.random.default_rng(emb), emb)
    wts = [wt.numpy().view(np.uint8) for wt, _ in pack.stages()]
    want = numpy_images(*wts)
    for got, w, size in zip((pack.img23, pack.img4, pack.img5), want, (16384, 32768, 512 * emb)):
        assert got.dtype == torch.uint8 and got.shape == (size,)
        np.testing.assert_array_equal(got.numpy(), w)
    assert all(torch.equal(a, b) for a, b in zip(k9_images([wt for wt, _ in pack.stages()]),
                                                  (pack.img23, pack.img4, pack.img5)))


def test_derived_buffers_follow_load_state_dict():
    """The state dict holds the weights, not what is derived from them:
    loading another pack's weights rebuilds ``wn1_bf16`` and the images."""
    src, dst = int8_weights(np.random.default_rng(1), 64), int8_weights(np.random.default_rng(2), 64)
    assert not {"wn1_bf16", "img23", "img4", "img5"} & set(src.state_dict())
    dst.load_state_dict(src.state_dict())
    for name in ("wn1_bf16", "img23", "img4", "img5"):
        assert torch.equal(getattr(dst, name), getattr(src, name)), name


def test_key_order_is_where_the_accumulators_land():
    """int8 wgmma m64nN: thread t of a quad holds accumulator 4j + e at
    column 8j + 2t + (e & 1) (rows g, g + 8 by e >> 1); A fragment register
    r of a 32-wide k-step holds k = 4t..4t+3 (r < 2) or 16 + 4t.. (r >= 2)
    of row g (r even) or g + 8 (r odd). s8_pack_p puts accumulators
    16c + {0,1,4,5}, {2,3,6,7}, {8,9,12,13}, {10,11,14,15} into registers
    0..3 of chunk c: the channel each position then holds is key_order."""
    order = key_order(128).tolist()
    regs = [(0, 1, 4, 5), (2, 3, 6, 7), (8, 9, 12, 13), (10, 11, 14, 15)]
    for c in range(4):
        for t in range(4):
            for r, accs in enumerate(regs):
                for byte, a in enumerate(accs):
                    j, e = divmod(16 * c + a, 4)
                    channel = 8 * j + 2 * t + (e & 1)
                    row_half = e >> 1
                    assert row_half == r % 2
                    k = 32 * c + (4 * t if r < 2 else 16 + 4 * t) + byte
                    assert order[k] == channel
    assert sorted(order) == list(range(128))


def test_key_ordered_products_are_the_plain_products():
    """Each stage's product as the kernel takes it (A in key order from the
    previous accumulators, B the un-swizzled image rows) is the plain
    int8 product."""
    rng = np.random.default_rng(9)
    pack = int8_weights(rng, 64)
    w23 = pack.img23.numpy().reshape(128, 128)
    w4 = pack.img4.numpy().reshape(256, 128)
    unswizzle = lambda img: np.stack([img[n, [((k // 16) ^ (n % 8)) * 16 + k % 16 for k in range(128)]]  # noqa: E731
                                      for n in range(img.shape[0])]).view(np.int8).astype(np.int64)
    b23, b4 = unswizzle(w23), unswizzle(w4)
    z1 = rng.integers(0, 128, (64, 64))
    z2 = rng.integers(0, 128, (64, 64))
    z3 = rng.integers(0, 128, (64, 128))
    wt = [w.numpy().astype(np.int64) for w, _ in pack.stages()]
    k64, k128 = key_order(64).numpy(), key_order(128).numpy()
    np.testing.assert_array_equal(z1 @ b23[:64, :64].T, z1 @ wt[0].T)
    np.testing.assert_array_equal(z2[:, k64] @ b23[:, 64:].T, z2 @ wt[1].T)
    np.testing.assert_array_equal(z3[:, k128] @ b4.T, z3 @ wt[2].T)


def test_fp32_pipe_conversions_match_numpy():
    """requant_bits: adding 1.5 * 2^23 to min(relu(z) * inv, 127) leaves
    round-half-even of it in the low byte; e1_word: a byte's v + 128 in the
    low byte of 1.5 * 2^23, less 1.5 * 2^23 + 128, is v."""
    magic = np.float32(12582912.0)
    x = np.concatenate([np.arange(0, 130, 0.25), np.arange(0, 128) + 0.5, [1e9, 126.49999, 126.5, 127.5]])
    x = x.astype(np.float32)
    low = (np.minimum(x, np.float32(127)) + magic).view(np.uint32) & 0xFF
    np.testing.assert_array_equal(low, np.minimum(np.rint(x), 127).astype(np.uint32))
    b = np.arange(256, dtype=np.uint32)
    signed = b.astype(np.uint8).view(np.int8).astype(np.float32)
    bits = ((b ^ 0x80) | 0x4B400000).view(np.float32)
    np.testing.assert_array_equal(bits - np.float32(12582912.0 + 128), signed)
