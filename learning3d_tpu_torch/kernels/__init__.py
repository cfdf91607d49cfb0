"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel wrapper launches its kernel for a CUDA tensor and takes its
plain version for a CPU tensor. ``LAUNCHES`` counts, per kernel, the
launches of the CUDA kernel (never the plain version), so that a run can
show that its main path went through the kernels.
"""

LAUNCHES: dict[str, int] = {"pointnet_pooled_kernel": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
