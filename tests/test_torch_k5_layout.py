"""What K5's weight pack lays out, and how its chain hands one stage's
accumulators to the next, on the CPU: the bf16 images of
``DGCNNBf16Weights`` (the bytes ``csrc/dgcnn_fused.cu``'s wgmma products
read) against a numpy statement, element by element, of wgmma's K-major
operands with the 128-byte swizzle; ``xw1_order`` against the A-fragment
layout; the f32-accumulator-to-bf16-A-fragment handover emulated in numpy,
which must be the identity over the contracted index; and the DGCNN
module's pack, rebuilt after an in-place update, an optimizer step, a
running-statistics update and ``load_state_dict``, and kept when nothing
changed."""

import numpy as np
import pytest
import torch

from learning3d_tpu_torch.kernels.dgcnn_fused import DGCNNBf16Weights, xw1_order
from learning3d_tpu_torch.models import DGCNN


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def swizzled_offset(row, byte):
    """Byte `byte` (0..127) of 128-byte row `row` of a swizzled image."""
    return row * 128 + (((byte // 16) ^ (row % 8)) * 16) + byte % 16


def bf16_bits(w):
    """f32 (numpy) -> the uint16 bits of its bf16 rounding (torch's)."""
    return torch.from_numpy(w).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def numpy_image(wt, block_rows):
    """The image of (R, K) bf16 bits, element by element: block q of
    block_rows rows, box b of 64 contracted values, row n, value kk at byte
    2 kk of the swizzled 128-byte row."""
    R, K = wt.shape
    boxes = K // 64
    out = np.zeros(R * K * 2, np.uint8)
    for n in range(R):
        q, rr = divmod(n, block_rows)
        for kk in range(K):
            b, c = divmod(kk, 64)
            base = (q * boxes + b) * block_rows * 128
            for half in range(2):
                out[base + swizzled_offset(rr, 2 * c + half)] = (int(wt[n, kk]) >> (8 * half)) & 0xFF
    return out


def folded(rng, emb):
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, emb)]
    ws = [torch.from_numpy(rng.normal(0, i**-0.5, (i, o)).astype(np.float32)) for i, o in dims]
    bs = [torch.from_numpy(rng.normal(0, 0.1, o).astype(np.float32)) for _, o in dims]
    return ws, bs


@pytest.mark.parametrize("emb", [64, 128])
def test_k5_images_match_numpy_statement(emb):
    ws, bs = folded(np.random.default_rng(emb), emb)
    pack = DGCNNBf16Weights(ws, bs)
    wts = [bf16_bits(w.numpy().T.copy()) for w in ws[1:]]
    want = np.concatenate([numpy_image(wt, wt.shape[0]) for wt in wts[:3]])
    assert pack.img.dtype == torch.uint8 and pack.img.shape == (8192 + 16384 + 65536,)
    np.testing.assert_array_equal(pack.img.numpy(), want)
    assert pack.img5.shape == (1024 * emb,)
    np.testing.assert_array_equal(pack.img5.numpy(), numpy_image(wts[3], 64))
    np.testing.assert_array_equal(pack.wn1.numpy(), ws[0][:3].numpy()[:, xw1_order().numpy()])
    np.testing.assert_array_equal(pack.wc1.numpy(), ws[0][3:].numpy())


def test_xw1_order_gives_each_thread_its_fragment_words():
    """Thread t of a quad reads positions 16t..16t+15; its word w (positions
    16t + 2w, + 1) must hold the A-fragment pair of k-step w // 2, register
    pair w % 2: channels 16 (w // 2) + 8 (w % 2) + 2t and + 1."""
    order = xw1_order().tolist()
    assert sorted(order) == list(range(64))
    for t in range(4):
        for w in range(8):
            kk, half = divmod(w, 2)
            assert order[16 * t + 2 * w : 16 * t + 2 * w + 2] == [16 * kk + 8 * half + 2 * t + e for e in (0, 1)]


def accumulator_at(warp, lane, i):
    """(row, column) of accumulator i of thread (warp, lane) in an f32 wgmma
    m64nN: d[4j + e] at row 16 warp + g + 8 (e >> 1), column 8j + 2t + (e & 1)."""
    g, t = divmod(lane, 4)
    j, e = divmod(i, 4)
    return 16 * warp + g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1)


def a_fragment_at(warp, lane, kk, r, half):
    """(row, k) of bf16 `half` of A-fragment register r of k-step kk (m64k16,
    registers): row 16 warp + g + 8 (r & 1), k 16 kk + 8 (r >> 1) + 2t +
    half."""
    g, t = divmod(lane, 4)
    return 16 * warp + g + 8 * (r & 1), 16 * kk + 8 * (r >> 1) + 2 * t + half


@pytest.mark.parametrize("n", [64, 128])
def test_accumulators_are_the_next_a_fragments(n):
    """The chain packs accumulators 8 kk + 2r, + 1 into register r of
    k-step kk (``to_frags``): in every thread that pair is the A element of
    the same row whose contracted index is the accumulator's column."""
    for warp in range(4):
        for lane in range(32):
            for kk in range(n // 16):
                for r in range(4):
                    for half in range(2):
                        assert accumulator_at(warp, lane, 8 * kk + 2 * r + half) == \
                            a_fragment_at(warp, lane, kk, r, half)


def test_emulated_stages_are_the_plain_stages():
    """Stages 2-4 as the kernel runs them in numpy: each thread's bf16
    fragments from the last stage's accumulators (``to_frags``: bias, ReLU,
    bf16), the products against the un-swizzled images; the result is the
    plain chain's, bit for bit, where both sum in f64."""
    rng = np.random.default_rng(3)
    ws, bs = folded(rng, 64)
    pack = DGCNNBf16Weights(ws, bs)
    img = pack.img.numpy()

    def unswizzle(raw, rows, k):  # an image of one block of `rows` rows -> (rows, k) f32
        boxes = k // 64
        out = np.zeros((rows, k), np.float32)
        for b in range(boxes):
            box = raw[b * rows * 128 : (b + 1) * rows * 128].reshape(rows, 128)
            for n in range(rows):
                row = box[n, [((c // 16) ^ (n % 8)) * 16 + c % 16 for c in range(128)]]
                out[n, 64 * b : 64 * b + 64] = (row.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        return out

    b2, b3, b4 = (unswizzle(img[o : o + n], r, k) for o, n, r, k in
                  ((0, 8192, 64, 64), (8192, 16384, 128, 64), (24576, 65536, 256, 128)))
    bf = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16).float().numpy()  # noqa: E731
    e1 = bf(np.maximum(rng.normal(size=(64, 64)), 0))

    def fragments(acc, bias):  # thread by thread: each accumulator pair into its A-fragment register
        slots = [(w, ln, kk, r, h) for w in range(4) for ln in range(32) for kk in range(acc.shape[1] // 16)
                 for r in range(4) for h in range(2)]
        src = np.array([accumulator_at(w, ln, 8 * kk + 2 * r + h) for w, ln, kk, r, h in slots])
        dst = np.array([a_fragment_at(w, ln, kk, r, h) for w, ln, kk, r, h in slots])
        out = np.full_like(acc, np.nan)
        out[dst[:, 0], dst[:, 1]] = bf(np.maximum(acc[src[:, 0], src[:, 1]] + bias[src[:, 1]], 0))
        return out

    want, got = e1, e1
    for w, b, img_rows in zip(ws[1:4], bs[1:4], (b2, b3, b4)):
        wb = bf(w.numpy())
        want = bf(np.maximum((want.astype(np.float64) @ wb).astype(np.float32) + b.numpy(), 0))
        got = fragments((got.astype(np.float64) @ img_rows.T.astype(np.float64)).astype(np.float32), b.numpy())
        np.testing.assert_array_equal(got, want)


def dgcnn(seed):
    torch.manual_seed(seed)
    net = DGCNN(emb_dims=64, k=5, device="cpu").eval()
    with torch.no_grad():
        for bn in net.bns:
            bn.running_mean.normal_(0, 0.1)
            bn.running_var.uniform_(0.5, 1.5)
    return net


def same_pack(a, b):
    return all(torch.equal(x, y) for x, y in zip([a.img, a.img5, a.wn1, a.wc1, *a.ws, *a.bs],
                                                 [b.img, b.img5, b.wn1, b.wc1, *b.ws, *b.bs]))


def test_pack_is_kept_while_nothing_changes():
    net = dgcnn(0)
    pack = net.bf16_weights()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 32, 3)).astype(np.float32))
    with torch.no_grad():
        net(x)
    assert net.bf16_weights() is pack and net.bf16_weights() is pack


def test_pack_follows_in_place_updates():
    net = dgcnn(1)
    pack = net.bf16_weights()
    with torch.no_grad():
        net.convs[2].weight.mul_(2.0)
    new = net.bf16_weights()
    assert new is not pack and same_pack(new, DGCNNBf16Weights.from_modules(net.convs, net.bns))
    with torch.no_grad():
        net.bns[4].running_var.add_(0.25)
    assert net.bf16_weights() is not new
    assert same_pack(net.bf16_weights(), DGCNNBf16Weights.from_modules(net.convs, net.bns))


def test_pack_follows_an_optimizer_step_and_running_statistics():
    net = dgcnn(2)
    pack = net.bf16_weights()
    opt = torch.optim.SGD(net.parameters(), lr=0.1)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 32, 3)).astype(np.float32))
    net.train()
    net(x).square().mean().backward()
    opt.step()
    net.eval()
    new = net.bf16_weights()
    assert new is not pack and same_pack(new, DGCNNBf16Weights.from_modules(net.convs, net.bns))
    with torch.no_grad():
        net.train()(x)  # a train-mode forward moves the running statistics
    net.eval()
    assert net.bf16_weights() is not new


def test_pack_follows_load_state_dict():
    src, dst = dgcnn(3), dgcnn(4)
    pack = dst.bf16_weights()
    dst.load_state_dict(src.state_dict())
    new = dst.bf16_weights()
    assert new is not pack and same_pack(new, src.bf16_weights())
    assert not any("bf16" in key for key in dst.state_dict())
