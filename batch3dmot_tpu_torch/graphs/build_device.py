"""Window-graph construction on the device (counterpart of
``batch3dmot_tpu/graphs/build_device.py``).

:func:`build_windows_device` builds every sliding window of a scene at once
as batched tensor ops over a ``[W, N]`` grid: each window's kNN candidate
edges, GT labels, edge features and pose features, with no Python loop
over windows. Detections are stored frame-major, so window w's members are
the contiguous slice of the scene arrays that starts at
``searchsorted(frame, start_w)``, and node i of window w is detection
``lo_w + i``.

The semantics are those of the host builder (:mod:`graphs.build`); the only
difference of layout is that every window's edge list is the dense
``[N, k]`` top-k grid with a mask, in the same (dst-major, ascending
distance) order. Ties at the k-th candidate go to the lower index, as
``jax.lax.top_k`` breaks them: a stable ascending sort of the distances
keeps the first k (``torch.topk`` promises no order among equal values).
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional

import numpy as np
import torch

from batch3dmot_tpu_torch import resolve_device
from batch3dmot_tpu_torch.config import NUM_CLASSES, GraphConstructionConfig
from batch3dmot_tpu_torch.data.types import SceneDetections, WindowGraphArrays
from batch3dmot_tpu_torch.graphs.weights import cb_weight_table

_BIG = 1e30
_FAR = 2 ** 30  # frame of a padded detection, and the "no match" time delta


def _angle_diff(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x - y wrapped into [-pi, pi]: a floor-mod, as ``jnp.remainder``
    (``torch.fmod`` truncates toward zero and differs for negative values)."""
    period = 2 * math.pi
    diff = torch.remainder(x - y + period / 2, period) - period / 2
    return torch.where(diff > math.pi, diff - 2 * math.pi, diff)


def _norm(d: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis."""
    return torch.sqrt((d * d).sum(-1))


@functools.cache
def _cb_table(device: torch.device) -> torch.Tensor:
    """The class-balanced weight table on ``device``, uploaded once (a
    pageable upload waits for the card; scene programs must not)."""
    return torch.from_numpy(cb_weight_table()).to(device)


def _gather_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a [W, N, ...] at idx [W, N, k] -> [W, N, k, ...]."""
    w, n, k = idx.shape
    flat = idx.reshape(w, n * k)
    if a.dim() == 2:
        return torch.gather(a, 1, flat).view(w, n, k)
    tail = a.shape[2:]
    out = torch.gather(a, 1, flat.view(w, n * k, *([1] * len(tail))).expand(w, n * k, *tail))
    return out.view(w, n, k, *tail)


def build_windows_device(
    frame_idx: torch.Tensor,  # [M] int (frame-major sorted)
    center_g: torch.Tensor,  # [M, 3]
    yaw_g: torch.Tensor,  # [M]
    vel_g: torch.Tensor,  # [M, 3]
    center_e: torch.Tensor,  # [M, 3]
    yaw_e: torch.Tensor,  # [M]
    vel_e: torch.Tensor,  # [M, 3]
    wlh: torch.Tensor,  # [M, 3]
    class_id: torch.Tensor,  # [M] int (1-indexed)
    score: torch.Tensor,  # [M]
    token_id: torch.Tensor,  # [M] int (-1 unmatched)
    det_mask: torch.Tensor,  # [M] bool
    window_starts: torch.Tensor,  # [W] int
    *,
    window_len: int,
    k: int,
    max_nodes: int,
):
    """Build all W windows of a scene on the scene arrays' device.

    Returns a dict of [W, ...] tensors: det_index, pose, node_time,
    node_class and node_mask [W, N, ...]; the dense edge arrays edge_src,
    edge_dst, edge_attr, edge_mask, edge_label and edge_weight [W, N*k, ...];
    num_nodes [W]. Indices are int32, as in the JAX package. Nothing waits
    for the device."""
    m = frame_idx.shape[0]
    n = max_nodes
    w_count = window_starts.shape[0]
    dev = frame_idx.device
    f32 = torch.float32
    frame_idx = frame_idx.to(torch.int32)
    starts = window_starts.to(torch.int32)

    # detections are frame-major: windows are contiguous slices
    big_frame = torch.where(det_mask, frame_idx, _FAR).contiguous()
    lo = torch.searchsorted(big_frame, starts)
    hi = torch.searchsorted(big_frame, starts + window_len)
    count = torch.clamp(hi - lo, max=n)
    ar = torch.arange(n, device=dev)
    idx = torch.clamp(lo[:, None] + ar[None, :], 0, m - 1)  # [W, N] int64
    valid = ar[None, :] < count[:, None]

    time = torch.where(valid, frame_idx[idx] - starts[:, None], -1)
    cls = torch.where(valid, class_id[idx].to(torch.int32), 0)
    tok = torch.where(valid, token_id[idx].to(torch.int32), -2)
    cg = center_g[idx].to(f32)
    yg = yaw_g[idx].to(f32)
    vg = vel_g[idx].to(f32)
    sz = wlh[idx].to(f32)

    # pose features [W, N, 19]; a padded node's class 0 has no one-hot bit
    onehot = (cls[..., None] - 1 == torch.arange(NUM_CLASSES, device=dev)).to(f32)
    pose = torch.cat(
        [
            center_e[idx].to(f32),
            sz,
            yaw_e[idx][..., None].to(f32),
            vel_e[idx].to(f32),
            onehot,
            score[idx][..., None].to(f32),
            time[..., None].to(f32),
        ],
        dim=-1,
    )
    pose = torch.where(valid[..., None], pose, 0.0)

    # candidates: strictly-past frames, same class, both valid [W, N, N]
    cand = (
        (time[:, None, :] < time[:, :, None])
        & (cls[:, None, :] == cls[:, :, None])
        & valid[:, :, None]
        & valid[:, None, :]
    )
    d_xy = _norm(cg[:, :, None, :2] - cg[:, None, :, :2])
    d_yaw = torch.abs(_angle_diff(yg[:, :, None], yg[:, None, :]))
    d_vel = _norm(vg[:, :, None, :] - vg[:, None, :, :])

    def norm_rows(d):
        row_max = torch.where(cand, d, 0.0).amax(dim=-1, keepdim=True)
        return torch.where(row_max > 0, d / torch.where(row_max > 0, row_max, 1.0), 0.0)

    combined = 0.5 * norm_rows(d_xy) + 0.25 * norm_rows(d_yaw) + 0.25 * norm_rows(d_vel)
    combined = torch.where(cand, combined, _BIG)

    dist, order = torch.sort(combined, dim=-1, stable=True)  # ascending distance
    edge_ok = dist[..., :k] < _BIG  # [W, N, k]
    e_src = order[..., :k]  # int64
    e_dst = ar[None, :, None].expand(w_count, n, k)

    t_src = _gather_rows(time, e_src)
    dt = time[:, :, None] - t_src
    tok_match = edge_ok & (_gather_rows(tok, e_src) == tok[:, :, None]) & (tok[:, :, None] >= 0)
    min_dt = torch.where(tok_match, dt, _FAR).amin(dim=-1, keepdim=True)
    labels = (tok_match & (dt == min_dt)).to(f32)

    cg_src = _gather_rows(cg, e_src)
    feat_d = _norm(cg_src[..., :2] - cg[:, :, None, :2])
    feat_y = torch.abs(_angle_diff(_gather_rows(yg, e_src), yg[:, :, None]))
    vol = sz.prod(dim=-1)
    feat_v = torch.log(torch.where(edge_ok, _gather_rows(vol, e_src) / vol[:, :, None], 1.0))
    edge_attr = torch.stack([feat_d, feat_y, feat_v, dt.to(f32)], dim=-1)
    edge_attr = torch.where(edge_ok[..., None], edge_attr, 0.0)

    weights = torch.where(edge_ok, _cb_table(dev)[_gather_rows(cls, e_src).long()], 0.0)

    flat = lambda a: a.reshape(w_count, n * k, *a.shape[3:])  # noqa: E731
    emask = flat(edge_ok)
    i32 = torch.int32
    return {
        "det_index": torch.where(valid, idx, 0).to(i32),
        "pose": pose,
        "node_time": time.to(i32),
        "node_class": cls,
        "node_mask": valid,
        "edge_src": torch.where(emask, flat(e_src), 0).to(i32),
        "edge_dst": torch.where(emask, flat(e_dst), 0).to(i32),
        "edge_attr": flat(edge_attr),
        "edge_mask": emask,
        "edge_label": flat(labels),
        "edge_weight": flat(weights),
        "num_nodes": count.to(i32),
    }


def build_scene_graphs_device(
    scene: SceneDetections,
    window_len: int,
    cfg: Optional[GraphConstructionConfig] = None,
    max_nodes: Optional[int] = None,
    device=None,
) -> List[WindowGraphArrays]:
    """Drop-in for :func:`graphs.build.build_scene_graphs` that builds the
    whole scene's windows as one batch of device ops on ``device`` (None:
    the GPU) and unpacks them into host ``WindowGraphArrays``."""
    cfg = cfg or GraphConstructionConfig()
    m = scene.num_detections
    num_windows = scene.num_frames - window_len + 1
    if m == 0 or num_windows <= 0:
        from batch3dmot_tpu_torch.graphs.build import build_scene_graphs

        return list(build_scene_graphs(scene, window_len, cfg))

    # frame-major order is a precondition
    assert np.all(np.diff(scene.frame_idx) >= 0), "detections must be frame-major"
    device = resolve_device(device)

    if max_nodes is None:
        counts = np.bincount(scene.frame_idx, minlength=scene.num_frames)
        window_sizes = [int(counts[s: s + window_len].sum()) for s in range(num_windows)]
        max_nodes = max(1, -(-max(window_sizes) // 32) * 32)

    m_pad = -(-m // 64) * 64
    pad1 = lambda a, v=0: np.pad(a, (0, m_pad - m), constant_values=v)  # noqa: E731
    pad2 = lambda a: np.pad(a, ((0, m_pad - m), (0, 0)))  # noqa: E731
    args = [
        pad1(scene.frame_idx.astype(np.int32)),
        pad2(scene.center_g.astype(np.float32)),
        pad1(scene.yaw_g.astype(np.float32)),
        pad2(scene.vel_g.astype(np.float32)),
        pad2(scene.center_e.astype(np.float32)),
        pad1(scene.yaw_e.astype(np.float32)),
        pad2(scene.vel_e.astype(np.float32)),
        pad2(scene.wlh.astype(np.float32)),
        pad1(scene.class_id.astype(np.int32)),
        pad1(scene.score.astype(np.float32)),
        pad1(scene.token_id.astype(np.int32), -1),
        pad1(np.ones(m, bool), False),
        np.arange(num_windows, dtype=np.int32),
    ]
    with torch.inference_mode():
        out = build_windows_device(
            *(torch.from_numpy(a).to(device) for a in args),
            window_len=window_len,
            k=min(cfg.top_knn_nodes, max_nodes),
            max_nodes=max_nodes,
        )
    out = {key: v.cpu().numpy() for key, v in out.items()}

    windows: List[WindowGraphArrays] = []
    for w in range(num_windows):
        n_w = int(out["num_nodes"][w])
        e_idx = np.nonzero(out["edge_mask"][w])[0]
        det = out["det_index"][w][:n_w]
        windows.append(
            WindowGraphArrays(
                scene_token=scene.scene_token,
                window_start=w,
                window_len=window_len,
                det_index=det,
                pose=out["pose"][w][:n_w],
                node_time=out["node_time"][w][:n_w],
                node_class=out["node_class"][w][:n_w],
                edge_src=out["edge_src"][w][e_idx],
                edge_dst=out["edge_dst"][w][e_idx],
                edge_attr=out["edge_attr"][w][e_idx],
                edge_label=out["edge_label"][w][e_idx],
                edge_weight=out["edge_weight"][w][e_idx],
                img=None if scene.img is None else scene.img[det],
                lidar=None if scene.lidar is None else scene.lidar[det],
                radar=None if scene.radar is None else scene.radar[det],
            )
        )
    return windows
