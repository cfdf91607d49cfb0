"""What K1's weight pack lays out, on the CPU: ``packed_weights`` (the
torch statement of the bytes ``csrc/pointnet_fused.cu``'s pack writes, which
a card test holds the kernel to) against a numpy statement, element by
element, of wgmma's K-major operands with the 128-byte swizzle."""

import numpy as np
import pytest
import torch

from learning3d_tpu_torch.kernels.pointnet_fused import W234_BYTES, packed_weights


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def bf16_bits(w):
    """f32 numpy -> the uint16 bits of its round-to-nearest-even bf16."""
    return torch.from_numpy(w).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def numpy_image(ws):
    """The image element by element: W^T row n (an output channel), input
    channel k, at byte n * 128 + ((k // 8) ^ (n % 8)) * 16 + (k % 8) * 2 of
    its 64-wide box; W2^T, W3^T, W4^T from 0, 8192, 16384; W5^T from 32768 in
    blocks of 64 rows, input channels 0..63 in the block's first box and
    64..127 in its second."""
    emb = ws[4].shape[1]
    img = np.zeros(W234_BYTES + 256 * emb, np.uint8)

    def put(base, n, k, bits):
        off = base + n * 128 + (((k // 8) ^ (n % 8)) * 16) + (k % 8) * 2
        img[off] = bits & 0xFF
        img[off + 1] = bits >> 8

    for base, w in ((0, ws[1]), (8192, ws[2]), (16384, ws[3])):
        bits = bf16_bits(w)
        for k in range(w.shape[0]):
            for n in range(w.shape[1]):
                put(base, n, k, int(bits[k, n]))
    bits = bf16_bits(ws[4])
    for k in range(128):
        for n in range(emb):
            base = W234_BYTES + (n // 64) * 16384 + (k // 64) * 8192
            put(base, n % 64, k % 64, int(bits[k, n]))
    return img


@pytest.mark.parametrize("emb", [64, 192])
def test_packed_weights_match_numpy_statement(emb):
    rng = np.random.default_rng(emb)
    dims = [3, 64, 64, 64, 128, emb]
    ws = [rng.normal(size=(i, o)).astype(np.float32) for i, o in zip(dims[:-1], dims[1:])]
    got = packed_weights([torch.from_numpy(w) for w in ws])
    assert got.dtype == torch.uint8 and got.shape == (W234_BYTES + 256 * emb,)
    np.testing.assert_array_equal(got.numpy(), numpy_image(ws))


def test_packed_rows_unswizzle_to_the_transposed_weights():
    """Every 128-byte row of the image, its 16-byte chunks put back by
    c ^ (row % 8), is its output channel's bf16 weights in input order."""
    rng = np.random.default_rng(3)
    dims = [3, 64, 64, 64, 128, 128]
    ws = [torch.from_numpy(rng.normal(size=(i, o)).astype(np.float32)) for i, o in zip(dims[:-1], dims[1:])]
    img = packed_weights(ws).view(torch.bfloat16).reshape(-1, 8, 8)  # rows x chunks x values
    rows = torch.arange(img.shape[0])
    logical = torch.arange(8)[None, :] ^ (rows % 8)[:, None]
    unswizzled = torch.empty_like(img)
    unswizzled[rows[:, None], logical] = img
    unswizzled = unswizzled.reshape(-1, 64)
    want = [w.t().to(torch.bfloat16) for w in ws[1:4]]
    w5t = ws[4].t().to(torch.bfloat16)  # (128 channels, 128 k)
    want.append(torch.cat([w5t[64 * b: 64 * b + 64, 64 * h: 64 * h + 64] for b in range(2) for h in range(2)]))
    assert torch.equal(unswizzled, torch.cat(want))
