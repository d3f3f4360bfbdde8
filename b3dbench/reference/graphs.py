"""Plain sliding-window graph construction, the reference's own (a frozen
copy of the port's numpy builder, ``graphs/build.py``, and of its
class-balanced weights, ``graphs/weights.py``, written against the
benchmark's scene dicts).

A node of frame f is joined to its same-class nodes of the window's
earlier frames, the k nearest by 1/2 d_xy/max + 1/4 |dyaw|/max + 1/4
|dvel|/max (each normalised by the node's own candidate maximum, a
stable sort); an edge is positive when both ends carry one ground-truth
track and its frame gap is the node's smallest among such edges. Node
features: ego centre, size, ego yaw, ego velocity, one-hot class, score,
frame in the window (19); edge features: d_xy, |dyaw|, log volume ratio,
frame gap (4). Reference: ``preprocessing/construct_detection_graph_
disjoint_parallel.py`` of the Batch3DMOT repository.
"""

from __future__ import annotations

import numpy as np

NUM_CLASSES = 7
_BIG = np.float64(1e30)
# per-class relative train-split edge frequencies (graph_data.py:61-68 of
# the reference repository), ordered by class id 1..7
_REL_FREQ = {1: 0.44736907722651076, 2: 0.14623008987194142, 3: 0.013947840246335299,
             4: 0.06407160593555014, 5: 0.1980141158741746, 6: 0.055813302136334404,
             7: 0.07455396870915335}
_N_EDGES, _BETA = 5.0, 4.0 / 5.0
CB_TABLE = np.zeros(NUM_CLASSES + 1, np.float32)
for _cid, _f in _REL_FREQ.items():
    CB_TABLE[_cid] = (1.0 - _BETA) / (1.0 - _BETA ** (_N_EDGES * _f))


def _angle_diff(x, y, period=2 * np.pi):
    diff = (np.asarray(x) - np.asarray(y) + period / 2) % period - period / 2
    return np.where(diff > np.pi, diff - 2 * np.pi, diff)


def _dist_xy(a, b):
    return np.linalg.norm(np.asarray(a)[..., :2] - np.asarray(b)[..., :2], axis=-1)


def _normalized(d, cand):
    masked = np.where(cand, d, 0.0)
    row_max = masked.max(axis=1, keepdims=True)
    return np.where(row_max > 0, d / np.where(row_max > 0, row_max, 1.0), 0.0)


def window_indices(scene: dict, start: int, length: int) -> np.ndarray:
    f = scene["frame_idx"]
    idx = np.nonzero((f >= start) & (f < start + length))[0]
    return idx[np.argsort(f[idx], kind="stable")]


def build_window(scene: dict, start: int, length: int, k: int) -> dict:
    """One window's graph: det_index [n], pose [n, 19], src/dst [e] (past
    node, current node), edge_attr [e, 4], label [e], weight [e]."""
    idx = window_indices(scene, start, length)
    n = len(idx)
    time = (scene["frame_idx"][idx] - start).astype(np.int64)
    cls = scene["class_id"][idx].astype(np.int64)
    tok = scene["token_id"][idx].astype(np.int64)
    centers, yaws, vels = scene["center_g"][idx], scene["yaw_g"][idx], scene["vel_g"][idx]
    wlh = scene["wlh"][idx]

    cand = (time[None, :] < time[:, None]) & (cls[None, :] == cls[:, None])
    combined = (0.5 * _normalized(_dist_xy(centers[:, None, :], centers[None, :, :]), cand)
                + 0.25 * _normalized(np.abs(_angle_diff(yaws[:, None], yaws[None, :])), cand)
                + 0.25 * _normalized(np.linalg.norm(vels[:, None, :] - vels[None, :, :],
                                                    axis=-1), cand))
    combined = np.where(cand, combined, _BIG)
    k_full = min(k, n)
    order = np.argsort(combined, axis=1, kind="stable")[:, :k_full]
    sel = np.arange(k_full)[None, :] < np.minimum(cand.sum(axis=1), k)[:, None]
    dst = np.repeat(np.arange(n), k_full)[sel.ravel()]
    src = order.ravel()[sel.ravel()]

    dt = time[dst] - time[src]
    match = (tok[src] == tok[dst]) & (tok[dst] >= 0)
    min_dt = np.full(n, np.iinfo(np.int64).max)
    np.minimum.at(min_dt, dst[match], dt[match])
    label = (match & (dt == min_dt[dst])).astype(np.float32)

    vol = np.prod(wlh.astype(np.float64), axis=-1)
    edge_attr = np.stack([_dist_xy(centers[src], centers[dst]),
                          np.abs(_angle_diff(yaws[src], yaws[dst])),
                          np.log(vol[src] / vol[dst]), dt.astype(np.float64)], 1)
    onehot = np.zeros((n, NUM_CLASSES))
    onehot[np.arange(n), cls - 1] = 1.0
    pose = np.concatenate([scene["center_e"][idx], wlh, scene["yaw_e"][idx, None],
                           scene["vel_e"][idx], onehot, scene["score"][idx, None],
                           time[:, None].astype(np.float64)], 1)
    return dict(det_index=idx, pose=pose.astype(np.float32), src=src, dst=dst,
                edge_attr=edge_attr.astype(np.float32), label=label,
                weight=CB_TABLE[cls[src]], node_class=cls)


def scene_windows(scene: dict, length: int, k: int) -> list:
    """(start, window) of every window of the scene that has an edge."""
    out = []
    for start in range(scene["num_frames"] - length + 1):
        w = build_window(scene, start, length, k)
        if len(w["src"]):
            out.append((start, w))
    return out
