#!/usr/bin/env python3
"""How the times of the port's K5 and K6 CUDA kernels scale, on one card.

    python3 tools/sweep_torch_kernels.py

K5 (dgcnn_encode_kernel) at B=32, emb=512 over (N, k): selection costs
about k * N per query (k * N^2 a cloud), the neighbor chain k * N and conv5
N, so the sweep separates them. The wrapper's torch preparation (the
per-point stage-1 product and the bf16 weight copies) is timed alone.
K6 (attention_pallas) at B=32, N=M=1024: the pointer's H=4, D=128 over
Dv (Dv=8 leaves the two Q K^T passes and the exponentials, Dv=128 adds the
P V product), DCP(DGCNN(emb 1024))'s H=4, D=Dv=256 (two 128-wide slabs)
and the head's H=1, D=512, Dv=3. K11 (the fused int8 pointer layers) at
the DCP shape, B=32, N=1024, d=512, 4 heads, ff 1024: each launch of a
layer alone (LayerNorm + quant, the four GEMMs, the attention in both P.V
modes, the decoder's cross-attention and its GEMMs), and the whole encoder
and decoder layers in both modes, on random int8 weights. Prints one JSON
line of times per call (ms, chip_smoke.cuda_ms).
Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def k11_stages(rng, chip_smoke, batch=32, n=1024, d=512, heads=4, d_ff=1024) -> dict:
    """Each of K11's launches alone on random int8 operands."""
    from learning3d_tpu_torch.kernels import transformer_int8 as k11

    def mat(i, o):
        return torch.from_numpy(rng.integers(-127, 128, (i, o)).astype(np.int8)).cuda()

    def vec(c, lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, c).astype(np.float32)).cuda()

    w = {}
    for p in ("", "x"):
        for m in ("q", "k", "v", "o"):
            w[f"{p}w{m}"], w[f"{p}sw{m}"], w[f"{p}b{m}"] = mat(d, d), vec(d, 1e-4, 1e-3), vec(d, -0.1, 0.1)
    w["w1"], w["sw1"], w["b1"] = mat(d, d_ff), vec(d_ff, 1e-4, 1e-3), vec(d_ff, -0.1, 0.1)
    w["w2"], w["sw2"], w["b2"] = mat(d_ff, d), vec(d, 1e-4, 1e-3), vec(d, -0.1, 0.1)
    for i in (1, 2, 3):
        w[f"ln{i}a"], w[f"ln{i}b"] = vec(d, 0.9, 1.1), vec(d, -0.1, 0.1)
    sc = k11.LayerScales(*(0.02,) * 7)
    pack = k11.FusedLayerWeights(w, sc, heads, decoder=True)
    x = torch.from_numpy(rng.normal(size=(batch, n, d)).astype(np.float32)).cuda().to(torch.bfloat16)
    y = torch.from_numpy(rng.integers(-127, 128, (batch, n, d)).astype(np.int8)).cuda()
    qkv = torch.from_numpy(rng.integers(-20, 21, (batch, n, 3 * d)).astype(np.int8)).cuda()
    h = torch.from_numpy(rng.integers(0, 128, (batch, n, d_ff)).astype(np.int8)).cuda()
    x2 = x.float()
    f32 = torch.float32
    q2, kv2 = qkv[..., :d].contiguous(), qkv[..., d:].contiguous()
    stages = {
        "ln_quant": lambda: k11._ln_quant(x, pack.ln1a, pack.ln1b, sc.s_y),
        "quant_memory": lambda: k11._ln_quant(x, None, None, sc.s_mem, do_ln=False),
        "gemm_qkv": lambda: k11._gemm(y, pack, "qkv", k11._REQUANT),
        "gemm_xq": lambda: k11._gemm(y, pack, "xq", k11._REQUANT),
        "gemm_xkv": lambda: k11._gemm(y, pack, "xkv", k11._REQUANT),
        "attention_int8_pv": lambda: k11._attention(qkv, qkv, d, d, 2 * d, heads, pack.att, True),
        "attention_hybrid": lambda: k11._attention(qkv, qkv, d, d, 2 * d, heads, pack.att, False),
        "attention_cross_int8_pv": lambda: k11._attention(q2, kv2, d, 0, d, heads, pack.xatt, True),
        "attention_cross_hybrid": lambda: k11._attention(q2, kv2, d, 0, d, heads, pack.xatt, False),
        "gemm_o_residual": lambda: k11._gemm(y, pack, "o", k11._RESIDUAL, res=x, out_dtype=f32),
        "gemm_ff1": lambda: k11._gemm(y, pack, "ff1", k11._RELU_REQUANT),
        "gemm_ff2_residual": lambda: k11._gemm(h, pack, "ff2", k11._RESIDUAL, res=x2, out_dtype=torch.bfloat16),
    }
    times = {name: chip_smoke.cuda_ms(fn) for name, fn in stages.items()}
    # the whole layers on the same operands, both P.V modes (bf16 x; the
    # encoder's output as the decoder's memory)
    enc = k11.FusedLayerWeights(w, sc, heads, decoder=False)
    for int8_pv in (True, False):
        mode = "int8_pv" if int8_pv else "hybrid"
        times[f"layer_encoder_{mode}"] = chip_smoke.cuda_ms(lambda: k11.encoder_layer_int8(x, enc, int8_pv=int8_pv))
        times[f"layer_decoder_{mode}"] = chip_smoke.cuda_ms(
            lambda: k11.decoder_layer_int8(x, x, pack, int8_pv=int8_pv))
    return times


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_torch_kernels: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from learning3d_tpu_torch.kernels.attention import attention_pallas
    from learning3d_tpu_torch.kernels.dgcnn_fused import _xw1, dgcnn_encode_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(chip_smoke.SEED)
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, 512)]
    ws = [torch.from_numpy(rng.normal(0, i**-0.5, (i, o)).astype(np.float32)).cuda() for i, o in dims]
    bs = [torch.from_numpy(rng.normal(0, 0.1, o).astype(np.float32)).cuda() for _, o in dims]
    k5 = {}
    with torch.inference_mode():
        for n_pts, k in ((1024, 20), (1024, 10), (1024, 1), (512, 20), (2048, 20)):
            x = torch.from_numpy(rng.normal(size=(32, n_pts, 3)).astype(np.float32)).cuda()
            k5[f"N={n_pts},k={k}"] = chip_smoke.cuda_ms(lambda: dgcnn_encode_kernel(x, ws, bs, k))
        x = torch.from_numpy(rng.normal(size=(32, 1024, 3)).astype(np.float32)).cuda()
        k5["prep_only,N=1024"] = chip_smoke.cuda_ms(
            lambda: (_xw1(x, ws[0][:3], torch.bfloat16), [w.t().to(torch.bfloat16).contiguous() for w in ws[1:]]))
        k6 = {}
        for h, d, dv in ((4, 128, 8), (4, 128, 128), (4, 256, 256), (1, 512, 3)):
            q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda().to(torch.bfloat16)
                       for s in ((32, h, 1024, d), (32, h, 1024, d), (32, h, 1024, dv)))
            k6[f"H={h},D={d},Dv={dv}"] = chip_smoke.cuda_ms(lambda: attention_pallas(q, k, v))
        k11 = k11_stages(rng, chip_smoke)
    smi = chip_smoke.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                    capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": smi, "k5_ms_B32_emb512": k5, "k6_ms_B32_N1024": k6,
                      "k11_stage_ms_B32_N1024_d512": k11}), flush=True)


if __name__ == "__main__":
    main()
