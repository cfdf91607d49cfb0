"""Model building blocks of the port, counterparts of
``learning3d_tpu.utils``: shared-MLP stacks, pooling, the DCP/PRNet
co-attention Transformer, the SVD Procrustes head, the slack Sinkhorn and
the (weighted) Kabsch solvers, CurveNet's blocks, and the import of JAX
package states (``jax_import``). The pointnet2 modules and the reference
checkpoint import are not ported yet."""

from learning3d_tpu_torch.utils.layers import MLP1d, MLP2d, Pooling  # noqa: F401
from learning3d_tpu_torch.utils.rigid import kabsch, sinkhorn_log, weighted_kabsch  # noqa: F401
from learning3d_tpu_torch.utils.svd import SVDHead  # noqa: F401
from learning3d_tpu_torch.utils.transformer import Identity, Transformer  # noqa: F401
