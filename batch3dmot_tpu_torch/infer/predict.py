"""Batched window scoring and cross-window edge-score aggregation
(counterpart of ``batch3dmot_tpu/infer/predict.py``).

  * :class:`SceneEncodedScorer` encodes every detection of a scene group
    once, then scores the windows in batches per shape bucket: each window
    gathers its nodes' embeddings by detection index, the model runs the
    pre-message-passing stage, and the fused message-passing kernel the
    loop and the edge classifier (its plain version on the CPU). A model
    in ``knn_conv_mode='active'`` runs its module loop instead (the kNN
    GATConv and the message passing, whose segment sums go through the
    segment-sum kernel), as the JAX package does. Given precomputed
    encodings (``encodings=`` / ``encodings_list=``), it uploads the
    608-d embeddings in ``embedding_dtype`` in place of the raw crops and
    points and skips the encoders.
  * Scores of an edge seen by several overlapping windows are averaged,
    thresholded per class and greedily rounded to at most one best
    incoming and one best outgoing edge per node.

PyTorch runs eagerly, so the JAX package's program-shape pinning
(``group_pad``, ``num_batches``, fill windows) has no counterpart: a batch
holds only real windows.

With ``mesh=`` (``parallel.make_mesh``; every rank makes the same calls)
each window batch is split over the ranks (padded with copies of its last
window so that the mesh divides it) and the scores are all-gathered; the
encode-once scorer also splits the detection rows it encodes when the mesh
divides them and all-gathers the encodings. Every rank returns the full
result, as the JAX package's calls return global arrays.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from batch3dmot_tpu_torch import prepare_model, upload
from batch3dmot_tpu_torch.config import (
    DEFAULT_EDGE_SCORE_THRESHOLDS,
    TRACKING_CLASSES,
    PredictConfig,
)
from batch3dmot_tpu_torch.data.types import SceneDetections, WindowGraphArrays
from batch3dmot_tpu_torch.graph import (
    DEFAULT_BUCKETS,
    IMG_SHAPE,
    LIDAR_SHAPE,
    RADAR_SHAPE,
    batch_graphs,
    pad_graph,
    pick_bucket,
)
from batch3dmot_tpu_torch.models.gnn import PoseGNN
from batch3dmot_tpu_torch.ops.fused_mp import (
    fused_logits_pose,
    fused_scores_from_encodings,
    fused_scores_full,
)
from batch3dmot_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_gather_tuple,
    pad_rows,
    replicate,
    shard_batch_fn,
    tree_map,
)
from batch3dmot_tpu_torch.train.data import to_padded
from batch3dmot_tpu_torch.train.encoded import ENC_DIMS


def _pad_detection_count(m: int) -> int:
    """Padded per-scene detection count for the encode-once batch:
    multiples of 64 up to 512, of 256 above."""
    if m <= 512:
        return max(64, -(-m // 64) * 64)
    return -(-m // 256) * 256


def _prepare(model: torch.nn.Module, device, mesh=None) -> Tuple[torch.nn.Module, torch.device]:
    """The model in eval mode on its device (a mesh's device, rank 0's
    weights, when ``mesh`` is given)."""
    if mesh is not None and device is None:
        device = mesh.device
    model, device = prepare_model(model, device)
    if mesh is not None:
        replicate(model, mesh)
    return model.eval(), device


def make_scorer(model, device=None, mesh=None) -> Callable:
    """A batched window scorer: PaddedGraph[B, ...] (with modalities) ->
    scores [B, E] on the device. The frozen encoders run per window node,
    then the fused kernel, or the module loop in ``'active'`` mode; PoseGNN
    logits go through a sigmoid. With ``mesh`` each rank scores its share
    of the windows and every rank returns all the scores."""
    model, device = _prepare(model, device, mesh)
    pose = isinstance(model, PoseGNN)
    active = model.knn_conv_mode == "active"

    def score(batch):
        if active:
            scores = model(batch)[0]
            return torch.sigmoid(scores) if pose else scores
        if pose:
            return torch.sigmoid(fused_logits_pose(model, batch))
        return fused_scores_full(model, batch)

    def run(batch):
        with torch.inference_mode():
            batch = batch.to(device)
            if mesh is None:
                return score(batch)
            n = batch.pose.shape[0]
            local = shard_batch_fn(mesh)(tree_map(lambda a: pad_rows(a, mesh.size), batch))
            return all_gather_rows(score(local), mesh)[:n]

    return run


class SceneEncodedScorer:
    """Encode-once inference for the multimodal GNN. ``embedding_dtype`` is
    the transport dtype of precomputed encodings (``PredictConfig``'s,
    float16, by default; None: float32), upcast to float32 on the device.
    With ``mesh``, ``windows_per_batch`` is rounded up to a multiple of its
    size, each rank scores its share of every window batch and encodes its
    share of the detection rows (all of them when the mesh does not divide
    the rows), and every rank returns every score."""

    def __init__(self, model, device=None, embedding_dtype=PredictConfig.embedding_dtype,
                 mesh=None):
        self.model, self.device = _prepare(model, device, mesh)
        self.mesh = mesh
        self.embedding_dtype = np.dtype(embedding_dtype or np.float32)

    def _encode(self, img, lidar, radar):
        mesh = self.mesh
        if mesh is not None and img.shape[0] % mesh.size:
            mesh = None  # the mesh does not divide the rows: every rank encodes all
        if mesh is not None:
            mine = mesh.rows(img.shape[0])
            img, lidar, radar = img[mine], lidar[mine], radar[mine]
        lp = lidar.sum(dim=(1, 2)) != 0
        rp = radar.sum(dim=(1, 2)) != 0
        x_img, pn, rn = self.model.encode_frozen(img, lidar, radar)
        enc = (x_img, pn, rn, lp, rp)
        return enc if mesh is None else all_gather_tuple(enc, mesh)

    def _enc_from_tables(self, encs, m_pad: int):
        """The device encodings of PRECOMPUTED per-scene encoding dicts
        (``train.encoded.ENC_KEYS``), scene g's rows at ``g * m_pad``: the
        row layout of the raw encode, so the window forwards are unchanged.
        Embeddings travel in ``embedding_dtype`` and are upcast on the
        device; rows past a scene's detections are the absent encoding."""
        parts = []
        for key in ("x_img", "pn", "rn"):
            buf = np.zeros((len(encs) * m_pad, ENC_DIMS[key]), self.embedding_dtype)
            for g, e in enumerate(encs):
                rows = np.asarray(e[key])
                if len(rows) > m_pad:
                    raise ValueError(f"{key}: {len(rows)} rows > m_pad {m_pad}")
                buf[g * m_pad: g * m_pad + len(rows)] = rows
            parts.append(upload(buf, self.device).float())
        for key in ("lidar_present", "radar_present"):
            buf = np.zeros((len(encs) * m_pad,), bool)
            for g, e in enumerate(encs):
                rows = np.asarray(e[key])
                buf[g * m_pad: g * m_pad + len(rows)] = rows
            parts.append(upload(buf, self.device))
        return tuple(parts)

    def _forward(self, batch, det_index, enc):
        x_img, pn, rn, lp, rp = (t[det_index] for t in enc)
        if self.model.knn_conv_mode == "active":
            return self.model.forward_from_encodings(batch, x_img, pn, rn, lp, rp)[0]
        return fused_scores_from_encodings(self.model, batch, x_img, pn, rn, lp, rp)

    def dispatch_scenes(
        self,
        scenes: Sequence[SceneDetections],
        windows_list: Sequence[Sequence[WindowGraphArrays]],
        windows_per_batch: int = 8,
        buckets=DEFAULT_BUCKETS,
        m_pad: Optional[int] = None,
        encodings_list: Optional[Sequence[Dict[str, np.ndarray]]] = None,
    ):
        """Upload and enqueue the work of a scene group without waiting for
        it: one encode of every detection (scene g's rows at ``g * m_pad``),
        or the group's precomputed ``encodings_list`` (one dict per scene),
        then one forward per window batch, pooling the scenes' windows per
        bucket. Returns a pending object for :meth:`finalize_scenes`."""
        if encodings_list is not None and (
                len(encodings_list) != len(scenes)
                or any(e is None for e in encodings_list)):
            raise ValueError("encodings_list must cover every scene in the group")
        if m_pad is None:
            m_pad = max(_pad_detection_count(s.num_detections) for s in scenes)
        for s in scenes:
            if m_pad < s.num_detections:
                raise ValueError(f"m_pad {m_pad} < {s.num_detections} detections")
        mesh = self.mesh
        if mesh is not None:
            windows_per_batch = -(-windows_per_batch // mesh.size) * mesh.size
        g_count = len(scenes)

        def padg(get, shape_tail):
            dts = {get(s).dtype for s in scenes if get(s) is not None} or {
                np.dtype(np.float32)
            }
            if len(dts) != 1:
                raise TypeError(f"mixed modality dtypes in group: {dts}")
            out = np.zeros((g_count * m_pad, *shape_tail), dts.pop())
            for g, s in enumerate(scenes):
                a = get(s)
                if a is not None and s.num_detections:
                    out[g * m_pad: g * m_pad + s.num_detections] = a
            return torch.from_numpy(out).to(self.device)

        results: List[List[Optional[np.ndarray]]] = [
            [None] * len(ws) for ws in windows_list
        ]
        by_bucket: Dict[Tuple[int, int], List[Tuple[int, int]]] = defaultdict(list)
        for g, ws in enumerate(windows_list):
            for i, w in enumerate(ws):
                if w.num_nodes == 0 or w.num_edges == 0:
                    results[g][i] = np.zeros((0,), np.float32)
                    continue
                by_bucket[pick_bucket(w.num_nodes, w.num_edges, buckets)].append((g, i))

        fetches = []
        with torch.inference_mode():
            if encodings_list is not None:
                enc = self._enc_from_tables(list(encodings_list), m_pad)
            else:
                enc = self._encode(
                    padg(lambda s: s.img, IMG_SHAPE),
                    padg(lambda s: s.lidar, LIDAR_SHAPE),
                    padg(lambda s: s.radar, RADAR_SHAPE),
                )
            for (mn, me), idxs in by_bucket.items():
                for lo in range(0, len(idxs), windows_per_batch):
                    chunk = idxs[lo: lo + windows_per_batch]
                    mine = chunk
                    if mesh is not None:
                        # padded with copies of the last window; this rank's share
                        mine = chunk + chunk[-1:] * ((-len(chunk)) % mesh.size)
                        mine = mine[mesh.rows(len(mine))]
                    graphs, dets = [], []
                    for g, i in mine:
                        w = windows_list[g][i]
                        # modality arrays left out: embeddings come from the
                        # scene-level encode
                        graphs.append(pad_graph(
                            pose=w.pose, edge_src=w.edge_src, edge_dst=w.edge_dst,
                            edge_attr=w.edge_attr, node_time=w.node_time,
                            node_class=w.node_class, max_nodes=mn, max_edges=me,
                            edge_label=w.edge_label, edge_weight=w.edge_weight,
                            include_modalities=False,
                        ))
                        di = np.zeros(mn, np.int64)
                        di[: w.num_nodes] = w.det_index + g * m_pad
                        dets.append(di)
                    batch = batch_graphs(graphs).to(self.device)
                    det_index = torch.from_numpy(np.stack(dets)).to(self.device)
                    scores = self._forward(batch, det_index, enc)
                    if mesh is not None:
                        scores = all_gather_rows(scores, mesh)[: len(chunk)]
                    fetches.append((chunk, scores))
        return results, fetches, windows_list

    def finalize_scenes(self, pending) -> List[List[np.ndarray]]:
        """Fetch and slice a :meth:`dispatch_scenes` result: per-scene lists
        of per-window score arrays [num_edges]."""
        results, fetches, windows_list = pending
        for chunk, dev in fetches:
            scores = dev.cpu().numpy()
            for slot, (g, i) in enumerate(chunk):
                results[g][i] = scores[slot, : windows_list[g][i].num_edges]
        return results  # type: ignore[return-value]

    def score_scenes(
        self,
        scenes: Sequence[SceneDetections],
        windows_list: Sequence[Sequence[WindowGraphArrays]],
        windows_per_batch: int = 8,
        buckets=DEFAULT_BUCKETS,
        m_pad: Optional[int] = None,
        encodings_list: Optional[Sequence[Dict[str, np.ndarray]]] = None,
    ) -> List[List[np.ndarray]]:
        """:meth:`dispatch_scenes` + :meth:`finalize_scenes` in one call."""
        return self.finalize_scenes(self.dispatch_scenes(
            scenes, windows_list, windows_per_batch, buckets, m_pad, encodings_list))

    def score_scene(
        self,
        scene: SceneDetections,
        windows: Sequence[WindowGraphArrays],
        windows_per_batch: int = 8,
        buckets=DEFAULT_BUCKETS,
        m_pad: Optional[int] = None,
        encodings: Optional[Dict[str, np.ndarray]] = None,
    ) -> List[np.ndarray]:
        """Per-window scores of one scene; ``encodings`` (the scene's
        ``train.encoded.ENC_KEYS`` dict) replaces the raw-modality encode."""
        return self.score_scenes([scene], [windows], windows_per_batch, buckets, m_pad,
                                 None if encodings is None else [encodings])[0]


def score_windows(
    scorer: Callable,
    windows: Sequence[WindowGraphArrays],
    windows_per_batch: int = 8,
    buckets=DEFAULT_BUCKETS,
) -> List[np.ndarray]:
    """Score all windows with a :func:`make_scorer` scorer; returns
    per-window [num_edges] arrays. Windows are grouped by bucket and
    stacked ``windows_per_batch`` at a time; empty windows get empty
    arrays."""
    results: List[Optional[np.ndarray]] = [None] * len(windows)
    by_bucket: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for i, w in enumerate(windows):
        if w.num_nodes == 0 or w.num_edges == 0:
            results[i] = np.zeros((0,), np.float32)
            continue
        by_bucket[pick_bucket(w.num_nodes, w.num_edges, buckets)].append(i)

    for (mn, me), idxs in by_bucket.items():
        for lo in range(0, len(idxs), windows_per_batch):
            chunk = idxs[lo: lo + windows_per_batch]
            graphs = [to_padded(windows[i], mn, me) for i in chunk]
            scores = scorer(batch_graphs(graphs)).cpu().numpy()
            for slot, i in enumerate(chunk):
                results[i] = scores[slot, : windows[i].num_edges]
    return results  # type: ignore[return-value]


def average_edge_scores_raw(
    src: np.ndarray, dst: np.ndarray, scores: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unique (src, dst) pairs and the mean score of each."""
    if len(scores) == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float64)
    key = src.astype(np.int64) << 32 | dst.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.bincount(inv, weights=scores.astype(np.float64))
    counts = np.bincount(inv)
    means = sums / counts
    return (uniq >> 32), (uniq & 0xFFFFFFFF), means


def average_edge_scores_arrays(
    src: np.ndarray, dst: np.ndarray, scores: np.ndarray
) -> Dict[Tuple[int, int], float]:
    """Dict view of :func:`average_edge_scores_raw`: (src, dst) -> mean."""
    ua, ub, means = average_edge_scores_raw(src, dst, scores)
    return {
        (int(a), int(b)): float(v)
        for a, b, v in zip(ua.tolist(), ub.tolist(), means.tolist())
    }


def _window_edges(windows, scores):
    """Scene-level (src, dst, score) of every scored window edge, or None."""
    srcs, dsts, vals = [], [], []
    for w, s in zip(windows, scores):
        if len(s) == 0:
            continue
        srcs.append(w.det_index[w.edge_src])
        dsts.append(w.det_index[w.edge_dst])
        vals.append(np.asarray(s))
    if not srcs:
        return None
    return np.concatenate(srcs), np.concatenate(dsts), np.concatenate(vals)


def average_scene_edges(
    windows: Sequence[WindowGraphArrays],
    window_scores: Sequence[np.ndarray],
) -> Dict[Tuple[int, int], float]:
    """Mean per-edge score across overlapping windows, keyed by scene-level
    (src_det_index, dst_det_index)."""
    edges = _window_edges(windows, window_scores)
    return {} if edges is None else average_edge_scores_arrays(*edges)


def threshold_mask(
    src: np.ndarray,
    means: np.ndarray,
    class_id: np.ndarray,
    thresholds: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """Keep-mask over unique edges: the mean score clears the threshold of
    the source node's class."""
    thresholds = thresholds or DEFAULT_EDGE_SCORE_THRESHOLDS
    thr_by_id = np.zeros(max(TRACKING_CLASSES.values()) + 1)
    for name, cid in TRACKING_CLASSES.items():
        thr_by_id[cid] = thresholds[name]
    return means > thr_by_id[class_id[src]]


def greedy_round_arrays(
    src: np.ndarray, dst: np.ndarray, scores: np.ndarray
) -> np.ndarray:
    """Mask keeping, per node, its best-scoring outgoing and incoming edge;
    ties go to the first edge in input order. Two nodes may keep edges into
    the same successor: the clustering stage resolves such conflicts by
    score order."""
    k = len(scores)
    keep = np.zeros(k, bool)
    if k == 0:
        return keep
    order = np.argsort(-scores, kind="stable")
    for nodes in (src, dst):
        n_sorted = nodes[order]
        _, first = np.unique(n_sorted, return_index=True)
        keep[order[first]] = True
    return keep


def _dict_arrays(edges: Dict[Tuple[int, int], float]):
    """(src, dst, value) arrays of an edge dict, in its order, and its
    keys."""
    keys = list(edges)
    return (np.array([a for a, _ in keys], np.int64), np.array([b for _, b in keys], np.int64),
            np.array([edges[e] for e in keys], np.float64), keys)


def threshold_edges(
    avg_scores: Dict[Tuple[int, int], float],
    scene: SceneDetections,
    thresholds: Optional[Dict[str, float]] = None,
) -> Dict[Tuple[int, int], float]:
    """Dict view of :func:`threshold_mask`: the edges whose mean score
    clears the threshold of the source node's class."""
    src, _, vals, keys = _dict_arrays(avg_scores)
    keep = threshold_mask(src, vals, scene.class_id, thresholds)
    return {e: avg_scores[e] for e, ok in zip(keys, keep.tolist()) if ok}


def greedy_round(
    edges: Dict[Tuple[int, int], float],
) -> List[Tuple[Tuple[int, int], float]]:
    """Dict view of :func:`greedy_round_arrays`: the kept edges in the
    dict's order (the first edge seen wins a tie)."""
    src, dst, vals, keys = _dict_arrays(edges)
    return [(keys[i], edges[keys[i]]) for i in np.flatnonzero(greedy_round_arrays(src, dst, vals))]


def round_scene_edges(
    usrc: np.ndarray,
    udst: np.ndarray,
    means: np.ndarray,
    class_id: np.ndarray,
    thresholds: Optional[Dict[str, float]] = None,
):
    """Per-class thresholds and greedy rounding of a scene's unique edges
    and their means, given in (src, dst) order. Returns (pred_edges,
    avg_scores): pred_edges is [((det_j, det_i), score), ...] in scene
    detection indices, avg_scores maps every pair to its mean."""
    keep = threshold_mask(usrc, means, class_id, thresholds)
    ks, kd, kv = usrc[keep], udst[keep], means[keep]
    sel = greedy_round_arrays(ks, kd, kv)
    pred_edges = [
        ((int(a), int(b)), float(v))
        for a, b, v in zip(ks[sel].tolist(), kd[sel].tolist(), kv[sel].tolist())
    ]
    avg = {
        (int(a), int(b)): float(v)
        for a, b, v in zip(usrc.tolist(), udst.tolist(), means.tolist())
    }
    return pred_edges, avg


def aggregate_scene_edges(
    scene: SceneDetections,
    windows: Sequence[WindowGraphArrays],
    scores: Sequence[np.ndarray],
    thresholds: Optional[Dict[str, float]] = None,
):
    """Cross-window averaging -> :func:`round_scene_edges` for one scene's
    window scores. Returns (pred_edges, avg_scores)."""
    edges = _window_edges(windows, scores)
    if edges is None:
        return [], {}
    return round_scene_edges(*average_edge_scores_raw(*edges), scene.class_id, thresholds)


def predict_scene(
    scorer,
    scene: SceneDetections,
    windows: Sequence[WindowGraphArrays],
    cfg: Optional[PredictConfig] = None,
    buckets=DEFAULT_BUCKETS,
    m_pad: Optional[int] = None,
    encodings: Optional[Dict[str, np.ndarray]] = None,
):
    """Per-scene edge pipeline: batched scoring (a SceneEncodedScorer, from
    the raw modalities or the scene's precomputed ``encodings``, or a
    :func:`make_scorer` scorer) -> averaging -> thresholds -> greedy
    rounding. Returns (pred_edges, avg_scores)."""
    cfg = cfg or PredictConfig()
    if isinstance(scorer, SceneEncodedScorer):
        scores = scorer.score_scene(scene, windows, cfg.windows_per_batch, buckets, m_pad,
                                    encodings)
    else:
        if encodings is not None:
            raise ValueError("encodings need a SceneEncodedScorer")
        scores = score_windows(scorer, windows, cfg.windows_per_batch, buckets)
    return aggregate_scene_edges(scene, windows, scores, cfg.edge_score_thresholds)


def dispatch_predict_scenes(
    scorer: SceneEncodedScorer,
    items: Sequence[Tuple[SceneDetections, Sequence[WindowGraphArrays]]],
    cfg: Optional[PredictConfig] = None,
    buckets=DEFAULT_BUCKETS,
    m_pad: Optional[int] = None,
    encodings_list: Optional[Sequence[Dict[str, np.ndarray]]] = None,
):
    """The upload-and-enqueue half of :func:`predict_scenes`
    (``SceneEncodedScorer.dispatch_scenes``): a caller can dispatch the
    next group while this one's fetch and aggregation run."""
    cfg = cfg or PredictConfig()
    pending = scorer.dispatch_scenes(
        [s for s, _ in items], [ws for _, ws in items],
        cfg.windows_per_batch, buckets, m_pad, encodings_list,
    )
    return items, cfg.edge_score_thresholds, pending


def finalize_predict_scenes(scorer: SceneEncodedScorer, staged) -> List[Tuple[list, dict]]:
    """Fetch and aggregate a :func:`dispatch_predict_scenes` result."""
    items, thresholds, pending = staged
    return [
        aggregate_scene_edges(scene, windows, scores, thresholds)
        for (scene, windows), scores in zip(items, scorer.finalize_scenes(pending))
    ]


def predict_scenes(
    scorer: SceneEncodedScorer,
    items: Sequence[Tuple[SceneDetections, Sequence[WindowGraphArrays]]],
    cfg: Optional[PredictConfig] = None,
    buckets=DEFAULT_BUCKETS,
    m_pad: Optional[int] = None,
    encodings_list: Optional[Sequence[Dict[str, np.ndarray]]] = None,
) -> List[Tuple[list, dict]]:
    """Grouped :func:`predict_scene` over a scene batch: one encode of the
    group (or its precomputed ``encodings_list``), pooled window batches,
    then per-scene aggregation. Returns ``[(pred_edges, avg_scores), ...]``
    in input order."""
    return finalize_predict_scenes(scorer, dispatch_predict_scenes(
        scorer, items, cfg, buckets, m_pad, encodings_list))
