"""Numerical primitives of the port, counterparts of ``learning3d_tpu/ops``.
Ported so far: the Lie-group layer (``sinc``, ``quaternion``, ``so3``,
``se3``, ``invmat``, ``mean_shift``), most of ``geometry`` and part of
``grouping``, ``transforms.transform_point_cloud`` (the key-driven
samplers are not ported yet), and the int8 arithmetic of the quantized
paths (``int8``)."""

from learning3d_tpu_torch.ops import (  # noqa: F401
    geometry,
    grouping,
    int8,
    invmat,
    mean_shift,
    quaternion,
    se3,
    sinc,
    so3,
    transforms,
)
from learning3d_tpu_torch.ops.geometry import (  # noqa: F401
    farthest_point_sample,
    get_graph_feature,
    get_rri,
    index_points,
    knn,
    knn_point,
    query_ball_point,
    square_distance,
    three_interpolate,
    three_nn,
)
from learning3d_tpu_torch.ops.grouping import (  # noqa: F401
    compute_density,
    sample_and_group,
    sample_and_group_all,
    sample_and_group_knn,
    sample_and_group_multi,
)
from learning3d_tpu_torch.ops.sinc import sinc1, sinc2, sinc3, sinc4  # noqa: F401
