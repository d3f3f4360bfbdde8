"""Struct-of-array containers for per-scene detection data.

The reference passes detections around as lists of nuScenes ``Box`` objects
plus per-node Python dicts (``construct...parallel.py:141-522``). Here a whole
scene is a columnar :class:`SceneDetections` — every builder step then
vectorizes over all detections of a window at once.

A copy of ``batch3dmot_tpu/data/types.py`` (numpy only): the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class SceneDetections:
    """All (class-filtered, radius-gated) detections of one scene.

    Global-frame quantities drive kNN candidate search and edge features
    (the reference computes them on boxes transformed to the global frame,
    ``construct...parallel.py:397-398``); ego-frame quantities feed the 19-d
    node pose feature (``:400-436``).
    """

    scene_token: str
    num_frames: int
    # per-detection arrays, all length M:
    frame_idx: np.ndarray  # [M] i32 — absolute frame index within scene
    center_g: np.ndarray  # [M, 3] global-frame center
    yaw_g: np.ndarray  # [M] global-frame yaw
    vel_g: np.ndarray  # [M, 3] global-frame velocity
    center_e: np.ndarray  # [M, 3] ego-frame center
    yaw_e: np.ndarray  # [M] ego-frame yaw
    vel_e: np.ndarray  # [M, 3] ego-frame velocity
    wlh: np.ndarray  # [M, 3] box size (frame-invariant)
    class_id: np.ndarray  # [M] i32, 1-indexed tracking class
    score: np.ndarray  # [M] detection score
    token_id: np.ndarray  # [M] i32 — matched GT instance id, -1 if unmatched
    # per-detection metadata dicts for track assembly / submission JSON
    # (sample_token, translation, size, rotation, velocity, category_name,
    # score, token) — host-side only, never shipped to device.
    metadata: List[Dict[str, Any]]
    # optional raw modality features (None when the sensor is disabled):
    img: Optional[np.ndarray] = None  # [M, 32, 32, 3]
    lidar: Optional[np.ndarray] = None  # [M, 128, 3]
    radar: Optional[np.ndarray] = None  # [M, 64, 4]
    # per-FRAME sample tokens, length num_frames. Load-bearing for the
    # submission: a frame whose detections were all filtered out (class
    # filter / ego-radius gate / empty detector output) has no metadata
    # row to recover its token from, yet the reference still emits an
    # empty result list under the frame's REAL sample token
    # (``predict.py:472-495,574``). None only for legacy stores written
    # before the frames sidecar existed (synthetic-pattern fallback).
    frame_tokens: Optional[List[str]] = None

    def __post_init__(self) -> None:
        m = len(self.frame_idx)
        for name in ("center_g", "vel_g", "center_e", "vel_e", "wlh"):
            arr = getattr(self, name)
            assert arr.shape == (m, 3), f"{name}: {arr.shape}"
        for name in ("yaw_g", "yaw_e", "class_id", "score", "token_id"):
            assert getattr(self, name).shape == (m,), name
        assert len(self.metadata) == m
        if self.frame_tokens is not None:
            assert len(self.frame_tokens) == self.num_frames, (
                f"frame_tokens: {len(self.frame_tokens)} != "
                f"{self.num_frames} frames"
            )

    @property
    def num_detections(self) -> int:
        return len(self.frame_idx)

    def window_indices(self, start: int, length: int) -> np.ndarray:
        """Detection indices of frames [start, start+length), frame-major and
        stable within frame — the reference's node_id order."""
        sel = (self.frame_idx >= start) & (self.frame_idx < start + length)
        idx = np.nonzero(sel)[0]
        order = np.argsort(self.frame_idx[idx], kind="stable")
        return idx[order]


@dataclasses.dataclass
class WindowGraphArrays:
    """Raw (unpadded) numpy arrays for one window graph, plus the mapping
    back to scene detection indices (for cross-window score averaging)."""

    scene_token: str
    window_start: int
    window_len: int
    det_index: np.ndarray  # [N] i32 — scene detection index per node
    pose: np.ndarray  # [N, 19]
    node_time: np.ndarray  # [N] relative frame (0..L-1)
    node_class: np.ndarray  # [N] 1-indexed
    edge_src: np.ndarray  # [E] past node (window-local index)
    edge_dst: np.ndarray  # [E] current node
    edge_attr: np.ndarray  # [E, 4]
    edge_label: np.ndarray  # [E] float 0/1
    edge_weight: np.ndarray  # [E] class-balanced weights
    img: Optional[np.ndarray] = None
    lidar: Optional[np.ndarray] = None
    radar: Optional[np.ndarray] = None

    @property
    def num_nodes(self) -> int:
        return len(self.det_index)

    @property
    def num_edges(self) -> int:
        return len(self.edge_src)
