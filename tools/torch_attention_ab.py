#!/usr/bin/env python3
"""Times of the port's attention kernels, K6 (attention_pallas) and K10
(attention_int8_kernel), and of the fused int8 pointer layers K11a/K11b, at
the shapes of their main paths, from one tree.

    python3 tools/torch_attention_ab.py [--root TREE] [--label NAME] [--parts k6,k10,k11,serve]

``--root`` names the checkout whose ``learning3d_tpu_torch`` and
``chip_smoke.py`` are imported (default: this one), so that two versions
of the kernels are timed in one call on one card by running the script once
from each tree, in turns (a, b, b, a): the Python entries are the same in
both.

Shapes: K6 at the DCP pointer (B=32, H=4, N=M=1024, D=Dv=128) in bf16 and
f32, the SVD head (H=1, D=512, Dv=3), DCP(DGCNN(emb 1024))'s pointer
(D=Dv=256) and PRNet's f32 pointer (B=16, 768 queries against 1024 keys,
and back); K10 at the int8 pointer in both P.V modes; each at a tiny shape
(one block: B=H=1, N=M=128), which the host's work a call sets; and the
wrappers' preparation alone (K6's casts of f32 operands to bf16, K10's copy
of V). ``k11``: each of K11's launches alone and the whole encoder and
decoder layers in both P.V modes at the DCP shape (B=32, N=1024, d=512, 4
heads, ff 1024; ``sweep_torch_kernels.k11_stages``). ``serve``: ``model_ms``
of DCP quantized with fused_layers=True, int8 and hybrid P.V, on a device
batch (``profile_torch_serve.build``). Inputs are numpy-seeded. Prints one
JSON line of ms a call (chip_smoke.cuda_ms) with the card's name and power
limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    parser.add_argument("--label", default="")
    parser.add_argument("--parts", default="k6,k10,k11,serve")
    args = parser.parse_args()
    parts = set(args.parts.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("torch_attention_ab: needs a CUDA card")
    sys.path.insert(0, str(args.root.resolve()))
    sys.path.insert(1, str(Path(__file__).resolve().parent))  # this tree's tools, run on the root's package
    import chip_smoke
    from learning3d_tpu_torch.kernels import _build
    from learning3d_tpu_torch.kernels.attention import attention_int8_kernel, attention_pallas

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(chip_smoke.SEED)

    def normal(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(dtype)

    f32 = torch.float32
    k6_shapes = {
        "pointer": ((32, 4, 1024, 128), (32, 4, 1024, 128), (32, 4, 1024, 128), torch.bfloat16),
        "pointer_f32": ((32, 4, 1024, 128), (32, 4, 1024, 128), (32, 4, 1024, 128), f32),
        "head": ((32, 1, 1024, 512), (32, 1, 1024, 512), (32, 1, 1024, 3), torch.bfloat16),
        "dv256": ((32, 4, 1024, 256), (32, 4, 1024, 256), (32, 4, 1024, 256), torch.bfloat16),
        "prnet_f32": ((16, 4, 768, 128), (16, 4, 1024, 128), (16, 4, 1024, 128), f32),
        "prnet_back_f32": ((16, 4, 1024, 128), (16, 4, 768, 128), (16, 4, 768, 128), f32),
        "tiny": ((1, 1, 128, 128), (1, 1, 128, 128), (1, 1, 128, 128), torch.bfloat16),
    }
    times = {}
    with torch.inference_mode():
        for name, (sq, sk, sv, dtype) in k6_shapes.items() if "k6" in parts else ():
            q, k, v = normal(*sq, dtype=dtype), normal(*sk, dtype=dtype), normal(*sv, dtype=dtype)
            times[f"k6/{name}"] = chip_smoke.cuda_ms(lambda: attention_pallas(q, k, v))
            if name == "pointer_f32":  # the wrapper's casts to bf16 alone
                times["k6/prep_f32"] = chip_smoke.cuda_ms(lambda: [t.to(torch.bfloat16) for t in (q, k, v)])
        for shape in ((32, 4, 1024, 128), (1, 1, 128, 128)) if "k10" in parts else ():
            q, k, v = (torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).cuda() for _ in range(3))
            for int8_pv in (True, False):
                name = f"k10/{'int8_pv' if int8_pv else 'hybrid'}" + ("" if shape[0] > 1 else "/tiny")
                times[name] = chip_smoke.cuda_ms(lambda: attention_int8_kernel(q, k, v, 0.004, 0.005, 0.03, int8_pv))
        # the wrappers' copies of V alone, at the pointer's shape: torch's
        # transpose and widening, and the port's attention_int8_values
        v3 = torch.from_numpy(rng.integers(-127, 128, (128, 1024, 128)).astype(np.int8)).cuda()
        if "k10" in parts:
            times["k10/prep_transpose"] = chip_smoke.cuda_ms(lambda: v3.transpose(1, 2).contiguous())
            times["k10/prep_hybrid"] = chip_smoke.cuda_ms(lambda: v3.to(torch.bfloat16))
        lib = _build.library()
        if "k10" in parts and hasattr(lib, "attention_int8_values"):
            stream = torch.cuda.current_stream().cuda_stream
            for int8_pv, dtype in ((1, torch.int8), (0, torch.bfloat16)):
                out = torch.empty(128 * 1024 * 128, device=v3.device, dtype=dtype)
                times[f"k10/values_{'int8_pv' if int8_pv else 'hybrid'}"] = chip_smoke.cuda_ms(
                    lambda: lib.attention_int8_values(v3.data_ptr(), out.data_ptr(), 128, 1024, 1024, 128, int8_pv,
                                                      stream))
        if "k11" in parts:
            from sweep_torch_kernels import k11_stages

            times.update({f"k11/{k}": v for k, v in k11_stages(np.random.default_rng(chip_smoke.SEED), chip_smoke)
                          .items()})
    if "serve" in parts:
        from profile_torch_serve import build

        for name in ("dcp-int8-fused", "dcp-int8-hybrid-fused"):
            model, _, inputs = build(name, np.random.default_rng(chip_smoke.SEED))
            dev = [torch.from_numpy(a).cuda() for a in inputs]
            with torch.inference_mode():
                times[f"serve/{name}/model_ms"] = chip_smoke.cuda_ms(lambda: model(*dev), reps=10)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "root": str(args.root), "device": smi,
                      "ms": times}), flush=True)


if __name__ == "__main__":
    main()
