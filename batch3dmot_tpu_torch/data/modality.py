"""Point-cloud normalisation and fixed-size collate for the encoder
datasets (numpy; a copy of ``batch3dmot_tpu/data/modality.py:126-164``).
The rest of that module (the camera, LiDAR and radar extraction from a
nuScenes tree) is not ported yet."""

from __future__ import annotations

from typing import Optional

import numpy as np


def reference_normalize(points: np.ndarray) -> np.ndarray:
    """The upstream normalisation, as it is: subtract the per-*point* mean
    over the channels, then divide by the max over the channels of the L2
    norm across the points. (Not a centroid normalisation.)"""
    x = points - np.mean(points, axis=0, keepdims=True)
    dist = np.max(np.sqrt(np.sum(x**2, axis=1)))
    return x / dist if dist > 0 else x


def encoder_dataset_normalize(points: np.ndarray) -> np.ndarray:
    """The radar encoder-dataset variant: only the first 3 channels are
    centred and scaled (float64 out)."""
    x = points.astype(np.float64).copy()
    x[0:3] = x[0:3] - np.mean(x[0:3], axis=0, keepdims=True)
    dist = np.max(np.sqrt(np.sum(x[0:3] ** 2, axis=1)))
    if dist > 0:
        x[0:3] = x[0:3] / dist
    return x


def collate_fixed_size(
    points: np.ndarray,
    pc_length: int,
    num_channels: int,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """[C, K] -> [num_channels, pc_length] float32: zero-pad short clouds,
    subsample long ones at random without replacement."""
    k = points.shape[1]
    if k < pc_length:
        out = np.zeros((num_channels, pc_length), np.float32)
        out[:, :k] = points[:num_channels]
        return out
    if k == pc_length:
        return points[:num_channels].astype(np.float32)
    rng = rng or np.random.default_rng()
    idx = rng.choice(k, size=pc_length, replace=False)
    return points[:num_channels][:, idx].astype(np.float32)
