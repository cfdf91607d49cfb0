"""Data pipeline of the port: the HDF5 ModelNet40 and its synthetic
stand-in, the classification wrapper, the registration pairs, the scene-flow pairs and
the part-segmentation sets (host numpy, as the JAX package's), host
batching, prefetch to the card and on-device augmentation."""

from learning3d_tpu_torch.data.dataloaders import (  # noqa: F401
    ClassificationData,
    FlowData,
    ModelNet40Data,
    RegistrationData,
    SceneflowDataset,
    SegmentationData,
    SyntheticModelNet40,
    SyntheticPartSegmentation,
    SyntheticSceneflow,
    create_random_transform,
    deg_to_rad,
    download_modelnet40,
)
from learning3d_tpu_torch.data.device_pipeline import (  # noqa: F401
    augment_classification_batch,
    batch_iterator,
    prefetch_to_device,
    to_device,
)
