"""Vectorized sliding-window tracking-graph construction.

Replaces the reference's per-detection Python loops
(``preprocessing/construct_detection_graph_disjoint_parallel.py:97-652`` and
``..._only_poses.py``) with columnar numpy over all detections of a window at
once. Semantics reproduced exactly:

  * candidate edges: for each node of frame f, its same-class nodes from all
    strictly earlier frames of the window are ranked by the weighted motion
    distance  1/2 * d_xy/max + 1/4 * |dyaw|/max + 1/4 * |dvel|/max  (each
    normalized by its per-node candidate max, ``utils/graph_utils.py:67-78``)
    and the top-k (k = min(40, #candidates)) smallest are connected
    (``construct...parallel.py:525-548``);
  * GT labels: an edge (ex -> cur) is positive iff both carry the same GT
    instance token and its time delta is minimal among cur's same-token
    selected candidates — the "rank 0" rule of
    ``construct...parallel.py:550-588`` (dt == 1 is always minimal);
  * edge features: [d_xy, |dyaw|, log(vol_ex / vol_cur), dt]
    (``graph_utils.py:7-30`` + dt append at ``construct...parallel.py:597-599``);
  * node pose features: [ego center(3), wlh(3), ego yaw(1), ego velocity(3),
    one-hot class(7), score(1), relative time(1)]
    (``construct...parallel.py:400-436``); kNN/edge features use the
    *global*-frame boxes (``:397-398``).

Deliberate deviation (documented): when a per-node candidate max distance is
0 the reference divides 0/0 producing NaNs with undefined topk order; we
treat that distance component as uniformly 0 instead (the analytic limit).

A copy of ``batch3dmot_tpu/graphs/build.py`` (numpy only): the port imports nothing
of the JAX package.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from batch3dmot_tpu_torch import geometry as geo
from batch3dmot_tpu_torch.config import NUM_CLASSES, GraphConstructionConfig
from batch3dmot_tpu_torch.data.types import SceneDetections, WindowGraphArrays
from batch3dmot_tpu_torch.graphs.weights import cb_edge_weight

_BIG = np.float64(1e30)


def pose_features(
    scene: SceneDetections, idx: np.ndarray, window_start: int
) -> np.ndarray:
    """The 19-d node feature block for the given detection indices."""
    n = len(idx)
    onehot = np.zeros((n, NUM_CLASSES), dtype=np.float32)
    onehot[np.arange(n), scene.class_id[idx] - 1] = 1.0
    rel_time = (scene.frame_idx[idx] - window_start).astype(np.float32)
    return np.concatenate(
        [
            scene.center_e[idx].astype(np.float32),
            scene.wlh[idx].astype(np.float32),
            scene.yaw_e[idx, None].astype(np.float32),
            scene.vel_e[idx].astype(np.float32),
            onehot,
            scene.score[idx, None].astype(np.float32),
            rel_time[:, None],
        ],
        axis=1,
    )


def _normalized(d: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """Per-row normalization by the max over that row's candidates.

    d, cand: [N, N]. Rows without candidates or with all-zero distances give 0.
    """
    masked = np.where(cand, d, 0.0)
    row_max = masked.max(axis=1, keepdims=True)
    return np.where(row_max > 0, d / np.where(row_max > 0, row_max, 1.0), 0.0)


def build_window_graph(
    scene: SceneDetections,
    window_start: int,
    window_len: int,
    cfg: Optional[GraphConstructionConfig] = None,
) -> WindowGraphArrays:
    """Build one window graph [window_start, window_start + window_len)."""
    cfg = cfg or GraphConstructionConfig()
    idx = scene.window_indices(window_start, window_len)
    n = len(idx)

    time = (scene.frame_idx[idx] - window_start).astype(np.int64)
    cls = scene.class_id[idx].astype(np.int64)
    tok = scene.token_id[idx].astype(np.int64)
    centers = scene.center_g[idx]
    yaws = scene.yaw_g[idx]
    vels = scene.vel_g[idx]
    wlh = scene.wlh[idx]

    if n == 0:
        return WindowGraphArrays(
            scene_token=scene.scene_token,
            window_start=window_start,
            window_len=window_len,
            det_index=idx.astype(np.int32),
            pose=np.zeros((0, 19), np.float32),
            node_time=np.zeros((0,), np.int32),
            node_class=np.zeros((0,), np.int32),
            edge_src=np.zeros((0,), np.int32),
            edge_dst=np.zeros((0,), np.int32),
            edge_attr=np.zeros((0, 4), np.float32),
            edge_label=np.zeros((0,), np.float32),
            edge_weight=np.zeros((0,), np.float32),
        )

    # --- candidate mask: strictly-past frames, same class -----------------
    cand = (time[None, :] < time[:, None]) & (cls[None, :] == cls[:, None])

    # --- weighted motion distance (rows = cur node i, cols = past node j) -
    d_xy = geo.center_distance_xy(centers[:, None, :], centers[None, :, :])
    d_yaw = np.abs(geo.angle_diff(yaws[:, None], yaws[None, :]))
    d_vel = np.abs(geo.velocity_l2(vels[:, None, :], vels[None, :, :]))
    combined = (
        0.5 * _normalized(d_xy, cand)
        + 0.25 * _normalized(d_yaw, cand)
        + 0.25 * _normalized(d_vel, cand)
    )
    combined = np.where(cand, combined, _BIG)

    # --- per-node top-k selection ----------------------------------------
    k_full = min(cfg.top_knn_nodes, n)
    order = np.argsort(combined, axis=1, kind="stable")[:, :k_full]  # [N, k]
    n_cand = cand.sum(axis=1)
    k_per_node = np.minimum(n_cand, cfg.top_knn_nodes)  # [N]
    rank = np.arange(k_full)[None, :]
    sel = rank < k_per_node[:, None]  # [N, k] valid selection mask

    e_dst = np.repeat(np.arange(n), k_full)[sel.ravel()].astype(np.int64)
    e_src = order.ravel()[sel.ravel()].astype(np.int64)

    # --- GT labels: minimal-dt rule among selected same-token candidates --
    dt = time[e_dst] - time[e_src]
    tok_match = (tok[e_src] == tok[e_dst]) & (tok[e_dst] >= 0)
    min_dt = np.full(n, np.iinfo(np.int64).max)
    np.minimum.at(min_dt, e_dst[tok_match], dt[tok_match])
    labels = (tok_match & (dt == min_dt[e_dst])).astype(np.float32)

    # --- edge features ----------------------------------------------------
    feat_d = geo.center_distance_xy(centers[e_src], centers[e_dst])
    feat_y = np.abs(geo.angle_diff(yaws[e_src], yaws[e_dst]))
    vol = geo.box_volume(wlh)
    feat_v = np.log(vol[e_src] / vol[e_dst])
    edge_attr = np.stack(
        [feat_d, feat_y, feat_v, dt.astype(np.float64)], axis=1
    ).astype(np.float32)

    weights = cb_edge_weight(cls[e_src]).astype(np.float32)

    return WindowGraphArrays(
        scene_token=scene.scene_token,
        window_start=window_start,
        window_len=window_len,
        det_index=idx.astype(np.int32),
        pose=pose_features(scene, idx, window_start),
        node_time=time.astype(np.int32),
        node_class=cls.astype(np.int32),
        edge_src=e_src.astype(np.int32),
        edge_dst=e_dst.astype(np.int32),
        edge_attr=edge_attr,
        edge_label=labels,
        edge_weight=weights,
        img=None if scene.img is None else scene.img[idx],
        lidar=None if scene.lidar is None else scene.lidar[idx],
        radar=None if scene.radar is None else scene.radar[idx],
    )


def build_scene_graphs(
    scene: SceneDetections,
    window_len: int,
    cfg: Optional[GraphConstructionConfig] = None,
) -> Iterator[WindowGraphArrays]:
    """All sliding windows of a scene (reference: nbr_samples - L + 1 windows,
    ``construct...parallel.py:110``)."""
    for start in range(scene.num_frames - window_len + 1):
        yield build_window_graph(scene, start, window_len, cfg)
