"""The benchmark's side of the program's interface: the port's scene
container of a generated scene and the port's model of a configuration.
The port is imported inside each function: the reference and the work
counts never load it."""

from __future__ import annotations


def port_scene(scene: dict, token: str):
    """The port's scene container of a generated scene."""
    from batch3dmot_tpu_torch.data.types import SceneDetections

    m = len(scene["frame_idx"])
    keys = ("frame_idx", "center_g", "yaw_g", "vel_g", "center_e", "yaw_e", "vel_e", "wlh",
            "class_id", "score", "token_id", "img", "lidar", "radar")
    return SceneDetections(scene_token=token, num_frames=scene["num_frames"],
                           metadata=[{}] * m, **{k: scene[k] for k in keys})


def port_model(cfg: dict):
    from batch3dmot_tpu_torch.models import MultimodalGNN, PoseGNN

    if cfg["model"] == "PoseGNN":
        return PoseGNN(depth=cfg["gnn_depth"], node_dim=cfg["node_dim"], edge_dim=cfg["edge_dim"],
                       knn_conv_mode=cfg["knn_conv_mode"])
    return MultimodalGNN(depth=cfg["gnn_depth"], node_dim=cfg["node_dim"],
                         edge_dim=cfg["edge_dim"], img_dim=cfg["img_dim"],
                         lidar_dim=cfg["lidar_dim"], radar_dim=cfg["radar_dim"],
                         use_attention=cfg["use_attention"], knn_conv_mode=cfg["knn_conv_mode"],
                         num_classes=cfg["num_classes"], modalities=cfg["modalities"])
