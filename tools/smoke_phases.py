#!/usr/bin/env python3
"""Run chosen phases of chip_smoke.py on one card, after its device and
build phases: the quick way to try a phase, or to time one again, without
the whole script.

    python3 tools/smoke_phases.py kernel_cls serve_pointconv train_curvenet

Phases: kernel_k13, kernel_cls, serve_pointconv, train_pointconv,
serve_curvenet, train_curvenet, serve_dgcnn_cls, train_dgcnn_cls,
serve_deepgmr, train_deepgmr, serve_masknet2, train_masknet2. They run in
chip_smoke.py's order whatever the order given, on a generator seeded as
chip_smoke.py seeds theirs; a phase left out draws nothing, so the weights
of the later ones can differ from chip_smoke.py's. Each prints its JSON
line as chip_smoke.py does; a phase whose check fails prints the failure
and the next phase runs; the exit code is 1 if any failed.
"""

from __future__ import annotations

import functools
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
ORDER = ("kernel_k13", "kernel_cls", "serve_pointconv", "train_pointconv", "serve_curvenet", "train_curvenet",
         "serve_dgcnn_cls", "train_dgcnn_cls", "serve_deepgmr", "train_deepgmr", "serve_masknet2", "train_masknet2")


def main(argv) -> None:
    unknown = [a for a in argv if a not in ORDER]
    if not argv or unknown:
        raise SystemExit(f"usage: smoke_phases.py PHASE ...; phases {', '.join(ORDER)}; unknown {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("smoke_phases: torch.cuda.is_available() is False; this needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_device()
    cs.phase_build()
    rng = np.random.default_rng(cs.SEED + 17)
    make_bf16 = functools.partial(cs.make_dgcnn_cls, dtype=torch.bfloat16)
    dgcnn_cls = cs.from_state(make_bf16, cs.seeded_state(make_bf16, rng)).eval()
    gmr_rng, m2_rng = np.random.default_rng(cs.SEED + 18), np.random.default_rng(cs.SEED + 19)
    run = {
        "kernel_k13": lambda: cs.phase_kernel_k13(np.random.default_rng(cs.SEED)),
        "kernel_cls": cs.phase_kernel_cls,
        "serve_pointconv": lambda: cs.phase_serve_pointconv(rng),
        "train_pointconv": lambda: cs.phase_train_pointconv(rng),
        "serve_curvenet": lambda: cs.phase_serve_curvenet(rng),
        "train_curvenet": lambda: cs.phase_train_curvenet(rng),
        "serve_dgcnn_cls": lambda: cs.phase_serve_dgcnn_cls(dgcnn_cls),
        "train_dgcnn_cls": lambda: cs.phase_train_dgcnn_cls(rng),
        "serve_deepgmr": lambda: cs.phase_serve_deepgmr(gmr_rng),
        "train_deepgmr": lambda: cs.phase_train_deepgmr(gmr_rng),
        "serve_masknet2": lambda: cs.phase_serve_masknet2(m2_rng),
        "train_masknet2": lambda: cs.phase_train_masknet2(m2_rng),
    }
    failed = []
    for name in ORDER:
        if name in argv:
            try:
                run[name]()
            except Exception as exc:  # report and go on: one call measures every phase asked for
                traceback.print_exc()
                print(f"{name} failed: {type(exc).__name__}: {exc}", flush=True)
                failed.append(name)
    if failed:
        raise SystemExit(f"failed: {failed}")


if __name__ == "__main__":
    main(sys.argv[1:])
