"""Synthetic nuScenes-like scenes: the benchmark's traffic generator.

Constant-velocity tracks with detection noise, missed detections and false
positives, in the shape of ``batch3dmot_tpu_torch/data/synthetic.py`` (its
density, noise and class mix), written out vectorised so that a run builds
its scenes in bulk. A scene is split into a *layout* and its *content*:

* the layout (each track's class, first and last frame and missed frames;
  each frame's false positives and their classes) comes from the mix's
  ``layout_seed``. It fixes the detections per frame and class, so every
  window's node and candidate-edge counts, and with them every batch's
  shape and work, are the same for every run seed;
* the content (positions, headings, speeds, noise, scores, the camera
  crops, lidar and radar points and which detections lack lidar or radar)
  comes from the run's seed.

Scenes are plain dicts of numpy arrays, frame-major. Lidar and radar points
are float16, the precision the configuration's `point_dtype` states, so the
program and the reference read the same values.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

CLASS_IDS: Dict[str, int] = {
    "car": 1, "truck": 2, "bus": 3, "trailer": 4,
    "pedestrian": 5, "motorcycle": 6, "bicycle": 7,
}
CLASS_SIZES: Dict[str, tuple] = {
    "car": (1.9, 4.6, 1.7),
    "truck": (2.5, 7.0, 2.8),
    "bus": (2.9, 11.0, 3.4),
    "trailer": (2.9, 12.0, 3.8),
    "pedestrian": (0.6, 0.7, 1.7),
    "motorcycle": (0.8, 2.1, 1.4),
    "bicycle": (0.6, 1.7, 1.3),
}
IMG_SHAPE = (32, 32, 3)


def scene_layout(seed: int, mix: dict) -> dict:
    """The detections' structure of one scene: per track its class, its
    frames present; per frame its false positives' classes."""
    rng = np.random.default_rng(seed)
    frames, tracks = mix["frames"], mix["tracks"]
    names = mix["class_mix"]
    track_cls = [names[i] for i in rng.integers(len(names), size=tracks)]
    start = rng.integers(0, max(1, frames // 3), size=tracks)
    end = rng.integers(frames - frames // 3, frames + 1, size=tracks)
    f = np.arange(frames)[None, :]
    present = (f >= start[:, None]) & (f < end[:, None])
    present &= rng.random((tracks, frames)) >= mix["miss_rate"]
    n_fp = rng.poisson(mix["fp_per_frame"], size=frames)
    fp_cls = [names[i] for i in rng.integers(len(names), size=int(n_fp.sum()))]
    return dict(frames=frames, track_cls=track_cls, start=start, present=present,
                n_fp=n_fp, fp_cls=fp_cls)


def _ego_pose(frames: int):
    ego_t = np.stack([np.linspace(0, 5.0 * frames, frames),
                      np.linspace(0, 0.5 * frames, frames), np.zeros(frames)], axis=1)
    return ego_t, np.linspace(0, 0.2, frames)


def _wrap(a: np.ndarray) -> np.ndarray:
    return np.arctan2(np.sin(a), np.cos(a))


def scene_content(layout: dict, seed: int, mix: dict, points) -> dict:
    """One scene of ``layout`` with the continuous values drawn from
    ``seed``; ``points`` (lidar, radar points a detection) or None for a
    scene without modalities."""
    rng = np.random.default_rng(seed)
    frames = layout["frames"]
    tracks = len(layout["track_cls"])
    ego_t, ego_yaw = _ego_pose(frames)

    pos0 = rng.uniform(-30, 30, size=(tracks, 3))
    pos0[:, 2] = rng.uniform(0.3, 1.0, size=tracks)
    speed = rng.uniform(0.5, 8.0, size=tracks)
    heading = rng.uniform(-np.pi, np.pi, size=tracks)
    vel = np.stack([speed * np.cos(heading), speed * np.sin(heading), np.zeros(tracks)], 1)

    tid, frm = np.nonzero(layout["present"])  # track-major, as the loop emits them
    n_t = len(tid)
    center_t = (pos0[tid] + vel[tid] * (frm - layout["start"][tid])[:, None]
                + ego_t[layout["start"][tid]] + rng.normal(0, 0.15, (n_t, 3)))
    yaw_t = heading[tid] + rng.normal(0, 0.05, n_t)
    vel_t = vel[tid] + rng.normal(0, 0.2, (n_t, 3))
    vel_t[:, 2] = 0.0
    score_t = rng.uniform(0.4, 1.0, n_t)
    cls_t = [layout["track_cls"][i] for i in tid]

    fp_frame = np.repeat(np.arange(frames), layout["n_fp"])
    n_f = len(fp_frame)
    center_f = ego_t[fp_frame] + rng.uniform(-40, 40, (n_f, 3))
    center_f[:, 2] = rng.uniform(0.3, 1.5, n_f)
    yaw_f = rng.uniform(-np.pi, np.pi, n_f)
    vel_f = rng.normal(0, 2.0, (n_f, 3)) * np.array([1.0, 1.0, 0.0])
    score_f = rng.uniform(0.05, 0.6, n_f)

    frame_idx = np.concatenate([frm, fp_frame])
    order = np.argsort(frame_idx, kind="stable")  # frame-major, tracks before FPs
    names = [*cls_t, *layout["fp_cls"]]
    cls = np.array([CLASS_IDS[n] for n in names], np.int32)[order]
    wlh = np.array([CLASS_SIZES[n] for n in names], np.float64).reshape(-1, 3)[order]
    center_g = np.concatenate([center_t, center_f])[order]
    yaw_g = np.concatenate([yaw_t, yaw_f])[order]
    vel_g = np.concatenate([vel_t, vel_f])[order]
    frame_idx = frame_idx[order].astype(np.int32)
    m = len(frame_idx)

    # ego frame: a yaw-only ego rotation about z
    c, s = np.cos(ego_yaw[frame_idx]), np.sin(ego_yaw[frame_idx])
    d = center_g - ego_t[frame_idx]
    center_e = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1], d[:, 2]], 1)
    vel_e = np.stack([c * vel_g[:, 0] + s * vel_g[:, 1], -s * vel_g[:, 0] + c * vel_g[:, 1],
                      vel_g[:, 2]], 1)
    scene = dict(
        num_frames=frames, frame_idx=frame_idx, center_g=center_g, yaw_g=yaw_g,
        vel_g=vel_g, center_e=center_e, yaw_e=_wrap(yaw_g - ego_yaw[frame_idx]), vel_e=vel_e,
        wlh=wlh, class_id=cls,
        score=np.concatenate([score_t, score_f])[order],
        token_id=np.concatenate([tid, np.full(n_f, -1)])[order].astype(np.int32),
        img=None, lidar=None, radar=None,
    )
    if points is not None:
        scene["img"] = rng.integers(0, 256, size=(m, *IMG_SHAPE), dtype=np.uint8)
        lidar = rng.standard_normal((m, points[0], 3), dtype=np.float32)
        radar = rng.standard_normal((m, points[1], 4), dtype=np.float32)
        lidar[rng.random(m) < mix["modality_dropout"]] = 0.0
        radar[rng.random(m) < 2 * mix["modality_dropout"]] = 0.0
        scene["lidar"] = lidar.astype(np.float16)
        scene["radar"] = radar.astype(np.float16)
    return scene


def make_scenes(mix: dict, layout_ids: Sequence[int], seed: int, points=None) -> List[dict]:
    """The scenes of the given layout numbers (drawn from the mix's
    ``layout_seed``), their content from the run ``seed``."""
    content = np.random.SeedSequence([seed, mix["layout_seed"]])
    seeds = content.spawn(len(layout_ids))
    return [scene_content(scene_layout(mix["layout_seed"] * 100_003 + i, mix),
                          int(ss.generate_state(1)[0]), mix, points)
            for i, ss in zip(layout_ids, seeds)]
