"""Batched box and quaternion geometry used by the synthetic scenes, the
graph builder and track interpolation (numpy).

A copy of the functions of ``batch3dmot_tpu/geometry.py`` that this slice
calls. Conventions (nuScenes): quaternions are (w, x, y, z); box size is
(w, l, h).
"""

from __future__ import annotations

import numpy as np


def quat_normalize(q: np.ndarray) -> np.ndarray:
    """Normalize quaternions, shape (..., 4)."""
    q = np.asarray(q, dtype=np.float64)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quat_rotation_matrix(q: np.ndarray) -> np.ndarray:
    """Quaternion(s) (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), dtype=np.float64)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - z * w)
    R[..., 0, 2] = 2 * (x * z + y * w)
    R[..., 1, 0] = 2 * (x * y + z * w)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - x * w)
    R[..., 2, 0] = 2 * (x * z - y * w)
    R[..., 2, 1] = 2 * (y * z + x * w)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def quat_multiply(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product of quaternions (..., 4) wxyz."""
    q1 = np.asarray(q1, dtype=np.float64)
    q2 = np.asarray(q2, dtype=np.float64)
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_inverse(q: np.ndarray) -> np.ndarray:
    """Inverse of unit quaternion(s): the conjugate."""
    q = quat_normalize(q)
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def quaternion_yaw(q: np.ndarray) -> np.ndarray:
    """Yaw of box orientation quaternion(s) (..., 4) -> (...,)."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.arctan2(2 * (x * y + z * w), 1 - 2 * (y * y + z * z))


def yaw_to_quat(yaw: np.ndarray) -> np.ndarray:
    """Yaw angle(s) -> quaternion(s) rotating about +z."""
    yaw = np.asarray(yaw, dtype=np.float64)
    half = yaw / 2.0
    zeros = np.zeros_like(half)
    return np.stack([np.cos(half), zeros, zeros, np.sin(half)], axis=-1)


def angle_diff(x: np.ndarray, y: np.ndarray, period: float = 2 * np.pi) -> np.ndarray:
    """Signed smallest angle difference x - y in (-pi, pi]."""
    diff = (np.asarray(x) - np.asarray(y) + period / 2) % period - period / 2
    return np.where(diff > np.pi, diff - 2 * np.pi, diff)


def center_distance_xy(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """L2 distance between box centers using xy only."""
    d = np.asarray(c1)[..., :2] - np.asarray(c2)[..., :2]
    return np.linalg.norm(d, axis=-1)


def velocity_l2(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """L2 distance between velocity vectors."""
    return np.linalg.norm(np.asarray(v1) - np.asarray(v2), axis=-1)


def box_volume(wlh: np.ndarray) -> np.ndarray:
    """Volume of boxes from (w, l, h) sizes."""
    return np.prod(np.asarray(wlh, dtype=np.float64), axis=-1)


def boxes_global_to_ego(
    centers: np.ndarray,
    quats: np.ndarray,
    velocities: np.ndarray,
    ego_translation: np.ndarray,
    ego_rotation: np.ndarray,
):
    """Transform boxes from the global to the ego-vehicle frame:
    center' = R^-1 (c - t); orientation' = q_ego^-1 * q; velocity' = R^-1 v."""
    q_inv = quat_inverse(ego_rotation)
    R_inv = quat_rotation_matrix(q_inv)
    centers = (np.asarray(centers) - np.asarray(ego_translation)) @ R_inv.T
    quats = quat_multiply(q_inv, quats)
    velocities = np.asarray(velocities) @ R_inv.T
    return centers, quats, velocities
