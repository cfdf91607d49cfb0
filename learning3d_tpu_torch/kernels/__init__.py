"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel wrapper launches its kernel for a CUDA tensor and takes its
plain version for a CPU tensor. ``LAUNCHES`` counts, per kernel, the
launches of the CUDA kernel (never the plain version), so that a run can
show that its main path went through the kernels.
"""

LAUNCHES: dict[str, int] = {
    "pointnet_pooled_kernel": 0,
    "dgcnn_encode_fused": 0,
    "attention_pallas": 0,
    "pointnet_pooled_int8": 0,
    "dgcnn_encode_fused_int8": 0,
    "attention_int8": 0,
    "encoder_layer_int8": 0,
    "decoder_layer_int8": 0,
    "pool_stats_pallas": 0,
    "pool_bwd_pallas": 0,
    "knn_neighbors_pallas": 0,
    "_nn_oneway_pallas": 0,
    "_emd_fwd_pallas": 0,
    "knn_pallas": 0,
    "fps_pallas": 0,
    "ball_query_pallas": 0,
    "ball_group_pallas": 0,
    "sinkhorn_log_pallas": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


from learning3d_tpu_torch.kernels.chamfer import chamfer_distance, nn_distance  # noqa: E402,F401
from learning3d_tpu_torch.kernels.emd import approx_match, emd_loss  # noqa: E402,F401
