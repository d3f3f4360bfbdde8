"""Configuration the port reads: tracking classes, per-class thresholds,
graph construction, predict, GNN-training and encoder-training settings.

A copy of the matching parts of ``batch3dmot_tpu/config.py`` (the port
imports nothing of the JAX package), cut to the fields the port reads; the
other fields come with the slices that read them. The dataclasses are built
in code, so this module never imports ``yaml``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

# The seven nuScenes tracking classes, 1-indexed; one-hot uses (idx - 1).
TRACKING_CLASSES: Dict[str, int] = {
    "car": 1,
    "truck": 2,
    "bus": 3,
    "trailer": 4,
    "pedestrian": 5,
    "motorcycle": 6,
    "bicycle": 7,
}

NUM_CLASSES = len(TRACKING_CLASSES)

# nuScenes category -> tracking class (the encoder datasets' labels)
CATEGORY_TO_TRACKING_NAME: Dict[str, str] = {
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}

TRACKING_CLASS_NAMES: Dict[int, str] = {v: k for k, v in TRACKING_CLASSES.items()}

# Per-class edge-score thresholds at inference, also the cluster-join
# thresholds.
DEFAULT_EDGE_SCORE_THRESHOLDS: Dict[str, float] = {
    "bicycle": 0.1,
    "bus": 0.005,
    "car": 0.02,
    "motorcycle": 0.03,
    "pedestrian": 0.025,
    "trailer": 0.04,
    "truck": 0.005,
}

# Per-class relative train-split edge frequencies for the class-balanced
# edge weights (graphs/weights.py).
REL_FREQ_TRAIN: Dict[str, float] = {
    "bicycle": 0.07455396870915335,
    "bus": 0.013947840246335299,
    "car": 0.44736907722651076,
    "motorcycle": 0.055813302136334404,
    "pedestrian": 0.1980141158741746,
    "trailer": 0.06407160593555014,
    "truck": 0.14623008987194142,
}


@dataclass
class GraphConstructionConfig:
    """Window-graph construction (the field ``graphs/build.py`` reads)."""

    top_knn_nodes: int = 40  # candidate predecessors per node


@dataclass
class PredictConfig:
    """Inference settings (the fields ``infer/predict.py`` and
    ``infer/device_pipeline.py`` read; ``batch3dmot_tpu/config.py:245-292``)."""

    # frames per sliding window at inference
    batch_size_graph: int = 2
    # windows scored per device batch
    windows_per_batch: int = 8
    # scenes per grouped dispatch of infer/device_pipeline.py::
    # predict_scenes_device; a group whose per-scene work fills the card is
    # scored scene by scene (device_pipeline._GROUP_WORK_CEILING)
    scenes_per_batch: int = 4
    edge_score_thresholds: Dict[str, float] = field(
        default_factory=lambda: dict(DEFAULT_EDGE_SCORE_THRESHOLDS)
    )
    # upload dtype of lidar and radar points in predict_scenes_device:
    # "float16" halves their bytes, the encoders compute in float32
    # (models/encoders.py::points_input_f32)
    point_dtype: str = "float16"
    # default transport dtype of precomputed encodings
    # (infer/predict.py::SceneEncodedScorer), upcast to float32 on the device
    embedding_dtype: str = "float16"

    def __post_init__(self) -> None:
        if self.point_dtype not in ("float16", "float32"):
            raise ValueError(
                f"Unknown predict.point_dtype '{self.point_dtype}' "
                "(use 'float16' or 'float32')"
            )


@dataclass
class GNNConfig:
    """GNN training settings (the fields ``train/trainer.py`` reads; the
    defaults are the reference's, ``batch3dmot_tpu/config.py:223-244``)."""

    batch_size: int = 2  # windows per training batch
    lr: float = 1e-4
    weight_decay: float = 1e-4
    beta_lo: float = 0.9
    beta_hi: float = 0.999
    num_epochs: int = 100
    loss: str = "cb"  # 'cb' (class-balanced BCE) or 'bce'
    # the frame-wise kNN GATConv: 'noop' skips it, as the trained reference
    # checkpoints do (the reference discards its result); 'active' applies it
    knn_conv_mode: str = "noop"
    knn_conv_k: int = 20
    manual_seed: int = 5621

    def __post_init__(self) -> None:
        if self.knn_conv_mode not in ("noop", "active"):
            raise ValueError(f"Unknown knn_conv_mode '{self.knn_conv_mode}'")


@dataclass
class EncoderTrainConfig:
    """Shared hyperparameter shape for the three encoder trainers
    (``batch3dmot_tpu/config.py:139-152``)."""

    batch_size: int = 32
    lr: float = 1e-3
    weight_decay: float = 0.0
    beta_lo: float = 0.9
    beta_hi: float = 0.999
    scheduler_step_size: int = 20
    scheduler_gamma: float = 0.5
    num_epochs: int = 10
    checkpoint: str = ""
    manual_seed: int = 5621


@dataclass
class ResNetConfig(EncoderTrainConfig):
    batch_size: int = 32
    lr: float = 0.002
    res_size: int = 32  # crop resolution (32x32)
    ego_rad_min: float = 1.0
    ego_rad_max: float = 50.0
    latent_dim: int = 96


@dataclass
class PointNetConfig(EncoderTrainConfig):
    batch_size: int = 64
    lr: float = 0.001
    num_points: int = 128
    min_lidar_pts: int = 6
    ego_rad_min: float = 1.0
    ego_rad_max: float = 50.0
    feature_transform: bool = False


@dataclass
class RadarNetConfig(EncoderTrainConfig):
    batch_size: int = 256
    lr: float = 0.0002
    num_points: int = 64
    min_radar_pts: int = 2
    ego_rad_min: float = 1.0
    ego_rad_max: float = 50.0
    feature_transform: bool = False


@dataclass
class Config:
    """The parts of the JAX package's ``Config`` the port reads, so that
    entry points such as ``predict_scene_device(model, scene, cfg)`` keep
    their signature."""

    graph_construction: GraphConstructionConfig = field(
        default_factory=GraphConstructionConfig
    )
    predict: PredictConfig = field(default_factory=PredictConfig)
