"""Global pooling over points (reference models/pooling.py:6-15)."""

from learning3d_tpu_torch.utils.layers import Pooling  # noqa: F401
