"""Fused eval-mode DGCNN encoder: exact kNN, the edge gather, all five
BN-folded conv stages and the per-stage max over neighbors in one CUDA
kernel (``csrc/dgcnn_fused.cu``), counterpart of
``learning3d_tpu/kernels/dgcnn_fused.py::dgcnn_encode_fused``.

The unfused path materializes every (B, N, k, C) edge tensor in device
memory; the kernel keeps them on the SM and writes only the (B, N, emb)
result. Two tricks carry over from the TPU kernel:

* stage 1 is split as z1 = nbr @ Wn1 + (center @ Wc1 + b1): the per-point
  product ``xw1 = x @ Wn1`` is taken once, outside the kernel, and the
  kernel gathers its rows by neighbor index;
* eval-mode BatchNorm is folded into every conv outside the kernel
  (``fold_bn``), so the chain inside is matmul, bias and ReLU.

Rounding, shared by the kernel and its plain version: kNN over exact f32
squared differences ``(d0*d0 + d1*d1) + d2*d2`` (no FMA), nearest first,
ties to the smaller index; bf16 operands with f32 sums; f32 bias; every
stage output rounded to bf16; conv5 on the bf16 concatenation of the
four k-maxes.
"""

from __future__ import annotations

import torch

from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import _build

DIMS = ((6, 64), (64, 64), (64, 128), (128, 256))  # stages 1-4; conv5 is (512, emb)
MAX_K = 32
MAX_N = 4096  # the kernel keeps the cloud and one distance row per warp on the SM


def fold_bn(conv, bn):
    """Fold eval-mode BatchNorm into a bias-free conv: (W', b') f32, W' in
    (in, out) layout, with relu(x @ W' + b') == relu(bn(conv(x))) under
    running statistics."""
    w = conv.weight.float().t()
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    b = bn.bias.float() - bn.running_mean.float() * s
    return (w * s[None, :]).contiguous(), b


def _xw1(x, wn1, dot_dtype):
    """Per-point stage-1 neighbor product, rounded to ``dot_dtype``."""
    f32 = torch.float32
    return torch.matmul(x.to(dot_dtype).to(f32), wn1.to(dot_dtype).to(f32)).to(dot_dtype)


def exact_knn(x, k):
    """(B, N, k) neighbor indices over exact f32 squared differences,
    nearest first, ties to the smaller index (the point itself included)."""
    x = x.float()
    d0 = x[:, :, None, 0] - x[:, None, :, 0]
    d1 = x[:, :, None, 1] - x[:, None, :, 1]
    d2 = x[:, :, None, 2] - x[:, None, :, 2]
    d = (d0 * d0 + d1 * d1) + d2 * d2
    return torch.sort(d, dim=-1, stable=True)[1][..., :k]


def dgcnn_encode_reference(x, ws, bs, k, dot_dtype=torch.bfloat16):
    """The kernel's plain version. x (B, N, 3); folded weights (in, out) and
    biases f32 -> (B, N, emb) in ``dot_dtype`` (x's dtype for f32)."""
    f32 = torch.float32

    def dot(h, w):  # rounded operands, f32 sums
        return torch.matmul(h.to(f32), w.to(dot_dtype).to(f32))

    x = x.float()
    B, N, _ = x.shape
    idx = exact_knn(x, k)
    xw1 = _xw1(x, ws[0][:3], dot_dtype)  # (B, N, 64)
    c1 = dot(x.to(dot_dtype), ws[0][3:]) + bs[0]  # (B, N, 64) f32, the center half
    nbr = torch.gather(xw1, 1, idx.reshape(B, -1, 1).expand(-1, -1, xw1.shape[-1]))
    e = torch.relu(nbr.reshape(B, N, k, -1).to(f32) + c1[:, :, None]).to(dot_dtype)
    pooled = [torch.amax(e, dim=2)]
    for w, b in zip(ws[1:4], bs[1:4]):
        e = torch.relu(dot(e, w) + b).to(dot_dtype)
        pooled.append(torch.amax(e, dim=2))
    cat = torch.cat(pooled, dim=-1)  # (B, N, 512)
    out_dtype = dot_dtype if dot_dtype != f32 else x.dtype
    return torch.relu(dot(cat, ws[4]) + bs[4]).to(out_dtype)


def _check_kernel_args(x, ws, bs, k, dot_dtype):
    if dot_dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel computes in bf16, not {dot_dtype}")
    if x.dtype != torch.float32 or x.ndim != 3 or x.shape[-1] != 3:
        raise ValueError(f"x must be (B, N, 3) float32, got {tuple(x.shape)} {x.dtype}")
    if not 1 <= k <= MAX_K or not k <= x.shape[1] <= MAX_N:
        raise ValueError(f"need 1 <= k <= {MAX_K} and k <= N <= {MAX_N}, got k={k}, N={x.shape[1]}")
    emb = ws[-1].shape[1]
    want = [*DIMS, (512, emb)]
    widths = [tuple(w.shape) for w in ws]
    if widths != want or emb % 64:
        raise ValueError(f"weights must be {want} with emb % 64 == 0, got {widths}")
    for w, b in zip(ws, bs):
        if w.device != x.device or b.device != x.device or b.dtype != torch.float32:
            raise ValueError("weights and biases must be float32 on x's device")
        if b.shape != (w.shape[1],):
            raise ValueError(f"bias {tuple(b.shape)} does not match weight {tuple(w.shape)}")


def dgcnn_encode_kernel(x, ws, bs, k, *, dot_dtype=torch.bfloat16):
    """x (B, N, 3), folded weights (in, out) and biases f32 -> (B, N, emb).
    A CUDA tensor runs the CUDA kernel (bf16 only); a CPU tensor runs the
    plain version ``dgcnn_encode_reference``."""
    if x.device.type == "cpu":
        return dgcnn_encode_reference(x, ws, bs, k, dot_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    x = x.contiguous()
    _check_kernel_args(x, ws, bs, k, dot_dtype)
    B, N, _ = x.shape
    emb = ws[-1].shape[1]
    bf16 = torch.bfloat16
    xw1 = _xw1(x, ws[0][:3], bf16).contiguous()
    wc1 = ws[0][3:].contiguous()
    # stages 2-5 as bf16 (out, in): the rows the kernel copies to shared memory
    wts = [w.t().to(bf16).contiguous() for w in ws[1:]]
    biases = [b.contiguous() for b in bs]
    out = torch.empty((B, N, emb), device=x.device, dtype=bf16)
    ptrs = [x, xw1, wc1, biases[0]] + [t for pair in zip(wts, biases[1:]) for t in pair]
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dgcnn_encode_bf16(*(t.data_ptr() for t in ptrs), out.data_ptr(), B, N, k, emb, stream)
    _build.check(err, "dgcnn_encode_bf16")
    LAUNCHES["dgcnn_encode_fused"] += 1
    return out


def dgcnn_encode_fused(x, convs, bns, k, *, dot_dtype=torch.bfloat16):
    """Eval-mode DGCNN encoder forward: x (B, N, 3) -> (B, N, emb).
    ``convs``/``bns`` are the module's bias-free Linear and BatchNorm
    stacks, BN under running statistics."""
    folded = [fold_bn(c, bn) for c, bn in zip(convs, bns)]
    return dgcnn_encode_kernel(x.float(), [w for w, _ in folded], [b for _, b in folded], k,
                               dot_dtype=dot_dtype)


def dgcnn_fused_ok(x, convs, bns, k):
    """Dispatch guard: eval-mode BN, bf16 convs, 3-channel clouds with at
    least k points, the DGCNN widths."""
    return (
        x.ndim == 3
        and x.shape[-1] == 3
        and x.shape[1] >= k
        and len(convs) == 5
        and convs[0].in_features == 6
        and all(bn is not None and not bn.training for bn in bns)
        and convs[0].dtype == torch.bfloat16
    )
