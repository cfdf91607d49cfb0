"""What K3's weight pack lays out, on the CPU: ``stats_weight_image`` (the
torch statement of the bytes ``csrc/poolgrad.cu``'s pack writes, which a
card test holds the kernel to) against a numpy statement, element by
element, of wgmma's K-major operand with the 128-byte swizzle, for bf16
weights and for f32 weights' hi and lo images."""

import numpy as np
import pytest
import torch

from learning3d_tpu_torch.kernels.poolgrad import IMAGE_ROW_BYTES, stats_weight_image


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def bf16_bits(w):
    """f32 numpy -> the uint16 bits of its round-to-nearest-even bf16 (finite
    values), in numpy alone."""
    bits = w.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def bits_to_f32(b):
    return (b.astype(np.uint32) << 16).view(np.float32)


def numpy_image(w, f32):
    """The image element by element: W^T row n (an output channel), input
    channel k, at byte (n // 64) * 16384 + (k // 64) * 8192 + (n % 64) * 128
    + (((k % 64) // 8) ^ (n % 8)) * 16 + (k % 8) * 2 of its part; the hi part
    (bf16(W)) first, for f32 W the lo part (bf16(W - hi)) 256 E bytes on."""
    K, E = w.shape
    hi = bf16_bits(w)
    parts = [hi] + ([bf16_bits(w - bits_to_f32(hi))] if f32 else [])
    img = np.zeros(IMAGE_ROW_BYTES * E * len(parts), np.uint8)
    for p, bits in enumerate(parts):
        for k in range(K):
            for n in range(E):
                off = p * IMAGE_ROW_BYTES * E + (n // 64) * 16384 + (k // 64) * 8192 + (n % 64) * 128 \
                    + (((k % 64) // 8) ^ (n % 8)) * 16 + (k % 8) * 2
                img[off] = int(bits[k, n]) & 0xFF
                img[off + 1] = int(bits[k, n]) >> 8
    return img


@pytest.mark.parametrize("emb,dtype", [(64, torch.bfloat16), (192, torch.bfloat16), (128, torch.float32)])
def test_stats_weight_image_matches_numpy_statement(emb, dtype):
    rng = np.random.default_rng(emb)
    w = rng.normal(0, 128**-0.5, (128, emb)).astype(np.float32)
    wt = torch.from_numpy(w).to(dtype)
    got = stats_weight_image(wt)
    f32 = dtype == torch.float32
    assert got.dtype == torch.uint8 and got.shape == (IMAGE_ROW_BYTES * emb * (2 if f32 else 1),)
    np.testing.assert_array_equal(got.numpy(), numpy_image(wt.float().numpy(), f32))


def test_hi_and_lo_images_sum_to_the_weights():
    """The f32 image's hi and lo parts, unswizzled, add up to W within
    2^-16 of each weight (the split the kernel multiplies through)."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(0, 128**-0.5, (128, 128)).astype(np.float32))
    img = stats_weight_image(w).view(torch.bfloat16).float().reshape(2, -1, 8, 8)  # parts x rows x chunks x values
    rows = torch.arange(img.shape[1])
    logical = torch.arange(8)[None, :] ^ (rows % 8)[:, None]
    flat = torch.empty_like(img)
    flat[:, rows[:, None], logical] = img
    # rows (block, box, row) -> W^T (channel, k)
    parts = flat.reshape(2, -1, 2, 64, 64).permute(0, 1, 3, 2, 4).reshape(2, 128, 128)
    assert torch.equal(parts[0], w.t().to(torch.bfloat16).float())
    assert ((parts[0] + parts[1]) - w.t()).abs().max().item() <= 2**-16 * w.abs().max().item()
