"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA card (sm_90a) and nvcc; without one they skip. The
JAX package is not needed: run them on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def folded(rng, emb, device):
    dims = [3, 64, 64, 64, 128, emb]
    ws = [torch.from_numpy(rng.normal(0, i**-0.5, (i, o)).astype(np.float32)).to(device)
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.from_numpy(rng.normal(0, 0.1, o).astype(np.float32)).to(device) for o in dims[1:]]
    return ws, bs


# emb 1024: two full channel groups; 640: a full and a partial group;
# 64: one warp n-tile. N: full tiles, a ragged tail, fewer points than a tile.
@pytest.mark.parametrize("batch,n_pts,emb", [(4, 1024, 1024), (3, 1000, 640), (2, 37, 64)])
def test_k1_matches_plain(cuda, batch, n_pts, emb):
    from learning3d_tpu_torch.kernels import LAUNCHES
    from learning3d_tpu_torch.kernels.pointnet_fused import oracle_chain, pointnet_pooled_kernel

    rng = np.random.default_rng(emb)
    ws, bs = folded(rng, emb, cuda)
    x = torch.from_numpy(rng.normal(size=(batch, n_pts, 3)).astype(np.float32)).to(cuda)
    before = LAUNCHES["pointnet_pooled_kernel"]
    got = pointnet_pooled_kernel(x, ws, bs).float()
    want = oracle_chain(x, ws, bs).float()
    torch.cuda.synchronize()
    assert LAUNCHES["pointnet_pooled_kernel"] == before + 1
    # same bf16 operands on both sides; only the f32 summation order differs
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


def test_k1_refuses_bad_arguments(cuda):
    from learning3d_tpu_torch.kernels.pointnet_fused import pointnet_pooled_kernel

    ws, bs = folded(np.random.default_rng(0), 128, cuda)
    with pytest.raises(ValueError):
        pointnet_pooled_kernel(torch.zeros(2, 8, 3, device=cuda), ws, bs, dot_dtype=torch.float32)
    with pytest.raises(ValueError):
        pointnet_pooled_kernel(torch.zeros(2, 8, 3, device=cuda, dtype=torch.float16), ws, bs)
