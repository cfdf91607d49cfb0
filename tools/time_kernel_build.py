#!/usr/bin/env python3
"""How long a cold build of the port's CUDA kernels takes, two ways.

    python3 tools/time_kernel_build.py

"parallel" is ``kernels._build.build``: one nvcc process a source, all
started together, then one link. "one_call" compiles and links the same
sources with the same flags in a single nvcc call. Each builds into a fresh
directory under ``kernels/.build/timing/`` (gitignored, removed after), in
the order parallel, one_call, one_call, parallel, so that a drift of the
machine shows as a difference between the two runs of one way. Prints one
JSON line of wall times (s) and the host's CPU count. Needs nvcc.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    sys.path.insert(0, str(ROOT))
    from learning3d_tpu_torch.kernels import _build

    nvcc = _build.find_nvcc()
    root = _build.BUILD_ROOT / "timing"
    shutil.rmtree(root, ignore_errors=True)

    def parallel(out: Path) -> None:
        _build.build(out)

    def one_call(out: Path) -> None:
        out.mkdir(parents=True)
        flags = [f for f in _build.COMPILE_FLAGS if f != "-c"]
        cmd = [nvcc, *flags, "-shared", "-o", str(out / "lib.so"), *map(str, _build.sources())]
        subprocess.run(cmd, check=True, capture_output=True)

    times: dict[str, list[float]] = {"parallel": [], "one_call": []}
    for i, name in enumerate(("parallel", "one_call", "one_call", "parallel")):
        out = root / f"{i}_{name}"
        t0 = time.perf_counter()
        (parallel if name == "parallel" else one_call)(out)
        times[name].append(time.perf_counter() - t0)
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"phase": "kernel_build", "sources": [p.name for p in _build.sources()],
                      "cpus": os.cpu_count(), "seconds": times}))


if __name__ == "__main__":
    main()
