"""PyTorch models: modality encoders, tracking GNNs, shared layers."""

from batch3dmot_tpu_torch.models.encoders import (  # noqa: F401
    PointNetClassifier,
    RadarNetClassifier,
    ResNetAE,
)
from batch3dmot_tpu_torch.models.gnn import MultimodalGNN, PoseGNN  # noqa: F401
from batch3dmot_tpu_torch.models.layers import init_params_  # noqa: F401
from batch3dmot_tpu_torch.models.registry import (  # noqa: F401
    MODEL_REGISTRY,
    make_model,
)
