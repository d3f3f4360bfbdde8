"""Synthetic nuScenes-like scenes with ground-truth tracks.

The reference has no tests and requires the full nuScenes download for any
run. CI here instead uses fixed-seed synthetic scenes: constant-velocity
tracks with detection noise, missed detections, and false positives —
enough structure for the whole pipeline (graph construction, GNN training,
window-score averaging, greedy rounding, clustering, submission JSON) to run
end-to-end and be asserted on.

A copy of ``batch3dmot_tpu/data/synthetic.py`` (numpy only): the port imports nothing
of the JAX package.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from batch3dmot_tpu_torch import geometry as geo
from batch3dmot_tpu_torch.config import TRACKING_CLASSES
from batch3dmot_tpu_torch.data.types import SceneDetections
from batch3dmot_tpu_torch.graph import IMG_SHAPE, LIDAR_SHAPE, RADAR_SHAPE

_CLASS_NAMES = list(TRACKING_CLASSES.keys())
# plausible (w, l, h) per class
_CLASS_SIZES = {
    "car": (1.9, 4.6, 1.7),
    "truck": (2.5, 7.0, 2.8),
    "bus": (2.9, 11.0, 3.4),
    "trailer": (2.9, 12.0, 3.8),
    "pedestrian": (0.6, 0.7, 1.7),
    "motorcycle": (0.8, 2.1, 1.4),
    "bicycle": (0.6, 1.7, 1.3),
}


def make_synthetic_scene(
    seed: int = 0,
    num_frames: int = 12,
    num_tracks: int = 10,
    fp_per_frame: float = 1.0,
    miss_rate: float = 0.05,
    with_modalities: bool = False,
    modality_dropout: float = 0.2,
    scene_token: Optional[str] = None,
    classes: Optional[List[str]] = None,
) -> SceneDetections:
    rng = np.random.default_rng(seed)
    classes = classes or _CLASS_NAMES
    scene_token = scene_token or f"synth_{seed}"

    # moving ego: straight line with slight turn
    ego_t = np.stack(
        [np.linspace(0, 5.0 * num_frames, num_frames),
         np.linspace(0, 0.5 * num_frames, num_frames),
         np.zeros(num_frames)],
        axis=1,
    )
    ego_yaw = np.linspace(0, 0.2, num_frames)
    ego_q = geo.yaw_to_quat(ego_yaw)

    rows = []  # (frame, center_g(3), yaw_g, vel_g(3), wlh(3), cls_id, score, tok)
    for tid in range(num_tracks):
        cname = classes[rng.integers(len(classes))]
        cid = TRACKING_CLASSES[cname]
        wlh = np.array(_CLASS_SIZES[cname])
        pos0 = rng.uniform(-30, 30, size=3)
        pos0[2] = rng.uniform(0.3, 1.0)
        speed = rng.uniform(0.5, 8.0)
        heading = rng.uniform(-np.pi, np.pi)
        vel = np.array([speed * np.cos(heading), speed * np.sin(heading), 0.0])
        start = int(rng.integers(0, max(1, num_frames // 3)))
        end = int(rng.integers(num_frames - num_frames // 3, num_frames + 1))
        for f in range(start, end):
            if rng.random() < miss_rate:
                continue
            center = pos0 + vel * (f - start) + ego_t[start]
            center = center + rng.normal(0, 0.15, 3)
            yaw = heading + rng.normal(0, 0.05)
            v_noisy = vel + rng.normal(0, 0.2, 3)
            v_noisy[2] = 0.0
            score = rng.uniform(0.4, 1.0)
            rows.append((f, center, yaw, v_noisy, wlh, cid, score, tid))

    # false positives
    n_fp = rng.poisson(fp_per_frame, size=num_frames)
    for f in range(num_frames):
        for _ in range(n_fp[f]):
            cname = classes[rng.integers(len(classes))]
            center = ego_t[f] + rng.uniform(-40, 40, 3)
            center[2] = rng.uniform(0.3, 1.5)
            rows.append(
                (
                    f,
                    center,
                    rng.uniform(-np.pi, np.pi),
                    rng.normal(0, 2.0, 3) * np.array([1, 1, 0]),
                    np.array(_CLASS_SIZES[cname]),
                    TRACKING_CLASSES[cname],
                    rng.uniform(0.05, 0.6),
                    -1,
                )
            )

    rows.sort(key=lambda r: r[0])
    m = len(rows)
    frame_idx = np.array([r[0] for r in rows], np.int32)
    center_g = np.array([r[1] for r in rows])
    yaw_g = np.array([r[2] for r in rows])
    vel_g = np.array([r[3] for r in rows])
    wlh = np.array([r[4] for r in rows])
    class_id = np.array([r[5] for r in rows], np.int32)
    score = np.array([r[6] for r in rows])
    token_id = np.array([r[7] for r in rows], np.int32)

    # ego-frame quantities per detection
    center_e = np.empty_like(center_g)
    yaw_e = np.empty_like(yaw_g)
    vel_e = np.empty_like(vel_g)
    for f in range(num_frames):
        sel = frame_idx == f
        if not sel.any():
            continue
        q = geo.yaw_to_quat(yaw_g[sel])
        c, qq, v = geo.boxes_global_to_ego(
            center_g[sel], q, vel_g[sel], ego_t[f], ego_q[f]
        )
        center_e[sel] = c
        yaw_e[sel] = geo.quaternion_yaw(qq)
        vel_e[sel] = v

    id2name = {v: k for k, v in TRACKING_CLASSES.items()}
    metadata = []
    for i in range(m):
        q = geo.yaw_to_quat(yaw_g[i])
        metadata.append(
            {
                "sample_token": f"{scene_token}_f{frame_idx[i]}",
                "translation": center_g[i].tolist(),
                "size": wlh[i].tolist(),
                "rotation": q.tolist(),
                "velocity": vel_g[i, :2].tolist(),
                "category_name": id2name[int(class_id[i])],
                "score": float(score[i]),
                "token": None if token_id[i] < 0 else f"tok_{token_id[i]}",
                "time": int(frame_idx[i]),
                "num_lidar_pts": 0,
                "num_radar_pts": 0,
                "ego": {
                    "center": center_e[i].tolist(),
                    "yaw": float(yaw_e[i]),
                    "vel": vel_e[i].tolist(),
                },
            }
        )

    img = lidar = radar = None
    if with_modalities:
        # uint8 crops, like the real extraction path (crop_and_resize):
        # 4x smaller uploads; encoders /255 on device
        img = (rng.random((m, *IMG_SHAPE), dtype=np.float32) * 255).astype(
            np.uint8
        )
        lidar = rng.standard_normal((m, *LIDAR_SHAPE), dtype=np.float32)
        radar = rng.standard_normal((m, *RADAR_SHAPE), dtype=np.float32)
        # intermittent modalities: zero out a random subset (presence is
        # detected by zero-sum in the GNN, reference clr_att_gnn.py:107-121)
        lidar[rng.random(m) < modality_dropout] = 0.0
        radar[rng.random(m) < 2 * modality_dropout] = 0.0

    return SceneDetections(
        scene_token=scene_token,
        num_frames=num_frames,
        frame_idx=frame_idx,
        center_g=center_g,
        yaw_g=yaw_g,
        vel_g=vel_g,
        center_e=center_e,
        yaw_e=yaw_e,
        vel_e=vel_e,
        wlh=wlh,
        class_id=class_id,
        score=score,
        token_id=token_id,
        metadata=metadata,
        frame_tokens=[f"{scene_token}_f{f}" for f in range(num_frames)],
        img=img,
        lidar=lidar,
        radar=radar,
    )
