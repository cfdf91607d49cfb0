"""Numerical primitives of the port, counterparts of ``learning3d_tpu/ops``.
Ported so far: the Lie-group layer (``sinc``, ``quaternion``, ``so3``,
``se3``, ``invmat``, ``mean_shift``), most of ``geometry`` and part of
``grouping``, ``transforms.transform_point_cloud`` (the key-driven
samplers are not ported yet), and the int8 arithmetic of the quantized
paths (``int8``)."""
