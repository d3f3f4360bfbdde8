"""Typed configuration (counterpart of ``batch3dmot_tpu/config.py``).

The reference's YAML sections (main / paths / resnet / pointnet / radarnet
/ preprocessing / graph_construction / detections / gnn / predict / classes
/ eval) as dataclasses, so the profiles under ``configs/`` load to the same
values as in the JAX package: class maps are 1-indexed, the graph-artifact
directory is one parameter (``paths.graphs_dir``, derived from
``paths.tmp`` unless set), and command-line overrides
(``apply_overrides``) name one field each.

A copy (the port imports nothing of the JAX package). ``yaml`` is imported
inside :meth:`Config.from_yaml` only: a machine without PyYAML builds its
configs in code or from ``--set`` overrides.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List

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
class MainConfig:
    project: str = "batch3dmot_tpu"
    dataset: str = "nuscenes"
    version: str = "v1.0-mini"
    class_dict: str = "nuscenes_tracking_eval"
    sensors_used: Dict[str, bool] = field(
        default_factory=lambda: {"lidar": True, "img": True, "radar": True}
    )
    detections: str = "megvii"  # 'megvii' or 'centerpoint'
    seed: int = 5621


@dataclass
class PathsConfig:
    data: str = "/data/nuscenes/"
    tmp: str = "/tmp/batch3dmot/"
    # the graph-artifact directory (.b3d stores and their sidecars)
    graphs_dir: str = ""
    models: str = ""
    eval: str = ""
    detections_dir: str = ""
    # L2 preprocessing artifacts: processed_{img,lidar,radar}_anns.json and
    # the lidar/ and radar/ per-annotation .npy directories
    preprocessed: str = ""
    # optional {split: [scene names]} JSON of split membership
    splits_json: str = ""

    def finalize(self, dataset: str) -> None:
        """Derive every empty directory from ``tmp``/``dataset``."""
        root = os.path.join(self.tmp, dataset)
        if not self.graphs_dir:
            self.graphs_dir = os.path.join(root, "graphs")
        if not self.models:
            self.models = os.path.join(root, "models")
        if not self.eval:
            self.eval = os.path.join(root, "eval")
        if not self.detections_dir:
            self.detections_dir = os.path.join(root, "detections")
        if not self.preprocessed:
            self.preprocessed = os.path.join(root, "preprocessed")


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
class PreprocessingConfig:
    res_size: int = 32
    nsweeps_lidar: int = 10
    nsweeps_radar: int = 6


@dataclass
class GraphConstructionConfig:
    """Window-graph construction (``graphs/build.py``) and the synthetic
    scenes of ``build-graphs --synthetic``."""

    batch_size_graph: int = 5  # frames per sliding window
    top_knn_nodes: int = 40  # candidate predecessors per node
    feat_3d_pose_dim: int = 19
    feat_2d_app_dim: int = 32
    feat_3d_app_dim: int = 128
    feat_3d_radar_dim: int = 64
    # hard caps of the padded window graphs
    max_nodes: int = 512
    max_edges: int = 4096
    # detection <-> GT matching: 'center_dist' (2 m gate) or 'iou'
    match_method: str = "center_dist"
    match_dist_thresh: float = 2.0
    match_iou_thresh: float = 0.0
    # the split whose detection JSON graphs are built from
    split: str = "train"
    # --synthetic scene shape; seed_base offsets the generator so that two
    # builds can produce disjoint scene sets
    synthetic_frames: int = 14
    synthetic_tracks: int = 10
    synthetic_seed_base: int = 0


@dataclass
class GNNConfig:
    """GNN settings: the model's shape (``checkpoint``, ``gnn_depth``,
    ``attention``, ``knn_conv_*``) and training (``train/trainer.py``); the
    defaults are the reference's, ``batch3dmot_tpu/config.py:223-244``."""

    checkpoint: str = ""
    batch_size_graph: int = 5
    batch_size: int = 2  # windows per training batch
    lr: float = 1e-4
    weight_decay: float = 1e-4
    beta_lo: float = 0.9
    beta_hi: float = 0.999
    num_epochs: int = 100
    gnn_depth: int = 6
    edge_dim: int = 64
    node_dim: int = 19
    loss: str = "cb"  # 'cb' (class-balanced BCE) or 'bce'
    attention: bool = True
    # the frame-wise kNN GATConv: 'noop' skips it, as the trained reference
    # checkpoints do (the reference discards its result); 'active' applies it
    knn_conv_mode: str = "noop"
    knn_conv_k: int = 20
    manual_seed: int = 5621

    def __post_init__(self) -> None:
        if self.knn_conv_mode not in ("noop", "active"):
            raise ValueError(f"Unknown knn_conv_mode '{self.knn_conv_mode}'")


@dataclass
class PredictConfig:
    """Inference settings (``infer/predict.py``, ``infer/device_pipeline.py``
    and the CLI's ``predict``; ``batch3dmot_tpu/config.py:247-292``)."""

    checkpoint: str = ""
    # frames per sliding window at inference
    batch_size_graph: int = 2
    # windows scored per device batch
    windows_per_batch: int = 8
    # scenes per grouped dispatch (``predict --pipeline encoded|device``,
    # infer/device_pipeline.py::predict_scenes_device); a group whose
    # per-scene work fills the card is scored scene by scene
    # (device_pipeline._GROUP_WORK_CEILING)
    scenes_per_batch: int = 4
    edge_score_thresholds: Dict[str, float] = field(
        default_factory=lambda: dict(DEFAULT_EDGE_SCORE_THRESHOLDS)
    )
    join_score_thresholds: Dict[str, float] = field(
        default_factory=lambda: dict(DEFAULT_EDGE_SCORE_THRESHOLDS)
    )
    interpolate_trailer_tracks: bool = True
    # upload dtype of lidar and radar points: "float16" halves their bytes,
    # the encoders compute in float32 (models/encoders.py::points_input_f32)
    point_dtype: str = "float16"
    # ``predict --pipeline encoded``'s use of the per-scene encoding caches
    # (<store>.b3d.enc.npz, keyed by the frozen encoders' digest): "auto"
    # uses them when every store has a valid one, "write" computes and
    # writes the missing ones, "off" always encodes the raw modalities
    embedding_cache: str = "auto"
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
class EvalConfig:
    verbose: int = 1
    eval_config: str = "tracking_nips_2019"
    eval_set: str = "val"
    render_curves: int = 0


@dataclass
class Config:
    main: MainConfig = field(default_factory=MainConfig)
    paths: PathsConfig = field(default_factory=PathsConfig)
    resnet: ResNetConfig = field(default_factory=ResNetConfig)
    pointnet: PointNetConfig = field(default_factory=PointNetConfig)
    radarnet: RadarNetConfig = field(default_factory=RadarNetConfig)
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)
    graph_construction: GraphConstructionConfig = field(
        default_factory=GraphConstructionConfig
    )
    gnn: GNNConfig = field(default_factory=GNNConfig)
    predict: PredictConfig = field(default_factory=PredictConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    # detection-JSON paths per detector and split
    detections: Dict[str, Dict[str, str]] = field(default_factory=dict)
    classes: Dict[str, int] = field(default_factory=lambda: dict(TRACKING_CLASSES))

    def __post_init__(self) -> None:
        self.paths.finalize(self.main.dataset)
        self.validate()

    def validate(self) -> None:
        if set(self.classes.values()) != set(range(1, len(self.classes) + 1)):
            raise ValueError(
                "Class map must be 1-indexed and contiguous (got "
                f"{self.classes}); the one-hot encoding uses class_id - 1."
            )
        if self.main.detections not in ("megvii", "centerpoint"):
            raise ValueError(f"Unknown detector '{self.main.detections}'")
        if self.gnn.knn_conv_mode not in ("noop", "active"):
            raise ValueError(f"Unknown knn_conv_mode '{self.gnn.knn_conv_mode}'")
        gc = self.graph_construction
        if gc.match_method not in ("center_dist", "iou"):
            raise ValueError(f"Unknown match_method '{gc.match_method}'")
        if self.predict.point_dtype not in ("float16", "float32"):
            raise ValueError(
                f"Unknown predict.point_dtype '{self.predict.point_dtype}' "
                "(use 'float16' or 'float32')"
            )

    # ---- loading ---------------------------------------------------------

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        """A config from a YAML profile (``configs/*.yaml`` or the
        reference's). PyYAML is imported here only."""
        import yaml

        with open(path, "r") as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        cfg = cls.__new__(cls)
        for f_ in dataclasses.fields(cls):
            section = raw.get(f_.name)
            default = (
                f_.default_factory()  # type: ignore[misc]
                if f_.default_factory is not dataclasses.MISSING
                else f_.default
            )
            if section is None:
                setattr(cfg, f_.name, default)
            elif dataclasses.is_dataclass(default):
                setattr(cfg, f_.name, _merge_dataclass(default, section))
            elif f_.name == "classes":
                # the reference's nested form {class_dict_name: {...}}
                if section and isinstance(next(iter(section.values())), dict):
                    name = raw.get("main", {}).get(
                        "class_dict", "nuscenes_tracking_eval"
                    )
                    section = section.get(name, next(iter(section.values())))
                setattr(cfg, f_.name, dict(section))
            else:
                setattr(cfg, f_.name, section)
        cfg.__post_init__()
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def apply_overrides(self, overrides: List[str]) -> None:
        """Apply ``section.key=value`` overrides (e.g. ``gnn.lr=3e-4``);
        ``paths.tmp`` or ``main.dataset`` re-derives the directories that
        are not overridden themselves."""
        explicit = {o.split("=", 1)[0] for o in overrides if "=" in o}
        if "paths.tmp" in explicit or "main.dataset" in explicit:
            for leaf in (
                "graphs_dir", "models", "eval", "detections_dir", "preprocessed"
            ):
                if f"paths.{leaf}" not in explicit:
                    setattr(self.paths, leaf, "")
        for item in overrides:
            if "=" not in item:
                raise ValueError(f"Override '{item}' is not of form key=value")
            dotted, value = item.split("=", 1)
            parts = dotted.split(".")
            obj: Any = self
            for p in parts[:-1]:
                # dict sections (detections.megvii.val=...) traverse by key,
                # creating intermediate maps as YAML would
                if isinstance(obj, dict):
                    obj = obj.setdefault(p, {})
                else:
                    obj = getattr(obj, p)
            leaf = parts[-1]
            if dataclasses.is_dataclass(obj):
                current = getattr(obj, leaf)
                setattr(obj, leaf, _coerce(value, current))
            elif isinstance(obj, dict):
                obj[leaf] = _coerce(value, obj.get(leaf))
            else:
                raise ValueError(f"Cannot override '{dotted}'")
        self.paths.finalize(self.main.dataset)
        self.validate()


def _merge_dataclass(instance: Any, updates: Dict[str, Any]) -> Any:
    """``instance`` with the known keys of ``updates`` replaced; unknown
    keys (the reference's extra fields such as 'workers' or 'device') are
    ignored."""
    known = {f_.name for f_ in dataclasses.fields(instance)}
    kwargs = {f_.name: getattr(instance, f_.name) for f_ in dataclasses.fields(instance)}
    for k, v in updates.items():
        if k in known:
            kwargs[k] = v
    return type(instance)(**kwargs)


def _coerce(value: str, current: Any) -> Any:
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(value)
    if isinstance(current, float):
        return float(value)
    return value


def class_one_hot_index(class_id: int) -> int:
    """1-indexed class id -> one-hot slot."""
    return class_id - 1
