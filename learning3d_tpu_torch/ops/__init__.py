"""Numerical primitives of the port, counterparts of ``learning3d_tpu/ops``.
Ported so far: what DGCNN, DCP and iPCRNet need (``geometry``, ``se3``,
``transforms``, part of ``quaternion``), and the int8 arithmetic of the
quantized paths (``int8``)."""
