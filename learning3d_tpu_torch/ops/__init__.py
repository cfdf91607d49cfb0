"""Numerical primitives of the port, counterparts of ``learning3d_tpu/ops``.
Ported so far: what DGCNN and DCP need (``geometry``, ``se3``,
``transforms``), and the int8 arithmetic of the quantized paths
(``int8``)."""
