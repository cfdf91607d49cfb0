"""What K10's and K6's wrappers prepare on the host side for the kernels'
TMA loads, on the CPU: K10's V^T in the int8 P.V's key order
(``int8_pv_values``, ``key_order``) and the 16-byte alignment TMA needs
(``_aligned``)."""

import numpy as np
import pytest
import torch

from learning3d_tpu_torch.kernels import attention as tattn


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("mp", [32, 64, 1024])
def test_key_order_permutes_within_each_chunk(mp):
    order = tattn.key_order(mp)
    assert order.shape == (mp,)
    for c in range(0, mp, tattn.PV_KEYS):
        assert sorted(order[c:c + tattn.PV_KEYS].tolist()) == list(range(c, c + tattn.PV_KEYS))


def test_key_order_is_the_accumulators_handover():
    """The kernel packs a thread's accumulators for keys 2t, 2t+1 of the
    8-key groups 4c, 4c+1 into the four consecutive k 4t .. 4t+3 of a 32-key
    chunk's A fragment, and those of groups 4c+2, 4c+3 into 16+4t .. 16+4t+3
    (csrc/attention_int8.cu, `pa`); position p of V^T must hold the key the
    fragment puts at k = p."""
    order = tattn.key_order(128).tolist()
    for c in range(4):
        for t in range(4):
            for half in range(2):  # a0/a1 and a2/a3
                keys = [32 * c + 16 * half + 8 * j + 2 * t + e for j in range(2) for e in range(2)]
                assert order[32 * c + 16 * half + 4 * t: 32 * c + 16 * half + 4 * t + 4] == keys


@pytest.mark.parametrize("m", [1, 31, 32, 200, 1000])
def test_int8_pv_values_invert_to_v(m):
    rng = np.random.default_rng(m)
    v = torch.from_numpy(rng.integers(-127, 128, (3, m, 128)).astype(np.int8))
    vt = tattn.int8_pv_values(v)
    mp = -(-m // tattn.PV_KEYS) * tattn.PV_KEYS
    assert vt.shape == (3, 128, mp) and vt.dtype == torch.int8 and vt.is_contiguous()
    back = torch.empty_like(vt)
    back[..., tattn.key_order(mp)] = vt  # position p holds key order[p]
    assert torch.equal(back[..., :m], v.transpose(1, 2))
    assert not back[..., m:].any()  # the padding keys are zero


@pytest.mark.parametrize("m", [200, 1024])
def test_product_in_accumulator_order_is_exact(m):
    """P in the order the accumulators hand it over in, times the permuted
    V^T, is P V exactly in int32 (int64 here): the order of an integer sum
    changes nothing."""
    rng = np.random.default_rng(m + 1)
    v = torch.from_numpy(rng.integers(-127, 128, (2, m, 128)).astype(np.int8))
    p = torch.from_numpy(rng.integers(0, 128, (2, 37, m)).astype(np.int64))
    vt = tattn.int8_pv_values(v).to(torch.int64)
    mp = vt.shape[-1]
    p_pad = torch.nn.functional.pad(p, (0, mp - m))
    got = torch.matmul(p_pad[..., tattn.key_order(mp)], vt.transpose(1, 2))
    want = torch.matmul(p, v.to(torch.int64))
    assert torch.equal(got, want)
    assert got.abs().max() < 2**31  # int32 on the card


def test_aligned_keeps_aligned_and_copies_the_rest():
    base = torch.arange(40, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    assert tattn._aligned(base) is base
    view = base[1:]  # 2 bytes off
    assert view.data_ptr() % 16 != 0
    fixed = tattn._aligned(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)
