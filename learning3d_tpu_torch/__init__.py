"""learning3d_tpu_torch: the PyTorch/CUDA port of ``learning3d_tpu`` for an
NVIDIA H100 (Hopper, sm_90a).

Each module sits where its JAX counterpart sits. Features are channel-last
(B, N, C) at every public function. Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU; where the
JAX package runs a Pallas kernel, the port runs a CUDA kernel written by
hand (``kernels/csrc``), and on a CPU tensor that kernel's plain PyTorch
version.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """The device an entry point runs on. Asking for CUDA where there is no
    card raises: nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device
