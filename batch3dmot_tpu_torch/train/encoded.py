"""Precomputed-encoding training for the multimodal GNN (counterpart of
part of ``batch3dmot_tpu/train/encoded.py``).

The frozen ResNet/PointNet/RadarNet outputs are constants of the data, so
they are computed once per scene (:func:`precompute_scene_encodings`) and
the GNN trains on gathered embeddings (:class:`EncodedGraphBatcher`): the
same numbers as running the encoders in every step, without their cost.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from batch3dmot_tpu_torch import prepare_model
from batch3dmot_tpu_torch.data.types import SceneDetections, WindowGraphArrays
from batch3dmot_tpu_torch.graph import (
    DEFAULT_BUCKETS,
    IMG_SHAPE,
    LIDAR_SHAPE,
    RADAR_SHAPE,
    PaddedGraph,
    batch_graphs,
    empty_graph,
    pad_graph,
    pick_bucket,
)
from batch3dmot_tpu_torch.train.data import uniform_bucket

ENC_DIMS = {"x_img": 96, "pn": 256, "rn": 256}


def precompute_scene_encodings(
    model, scene: SceneDetections, chunk: int = 512, device=None
) -> Dict[str, np.ndarray]:
    """Frozen-encoder outputs and presence masks for every detection of a
    scene, the encoders run on ``device`` (None: the GPU) ``chunk``
    detections at a time. Returns numpy arrays: x_img [M, 96], pn [M, 256],
    rn [M, 256], lidar_present [M], radar_present [M]."""
    model, device = prepare_model(model, device)
    m = scene.num_detections

    def part(arr, tail, lo, hi):
        if arr is None:
            return torch.zeros((hi - lo, *tail), device=device)
        return torch.from_numpy(np.ascontiguousarray(arr[lo:hi])).to(device)

    xs, ps, rs = [], [], []
    with torch.inference_mode():
        for lo in range(0, m, chunk):
            hi = min(lo + chunk, m)
            xi, pn, rn = model.encode_frozen(
                part(scene.img, IMG_SHAPE, lo, hi),
                part(scene.lidar, LIDAR_SHAPE, lo, hi),
                part(scene.radar, RADAR_SHAPE, lo, hi),
            )
            xs.append(xi.cpu().numpy())
            ps.append(pn.cpu().numpy())
            rs.append(rn.cpu().numpy())

    def cat(parts, d):
        return np.concatenate(parts) if m else np.zeros((0, d), np.float32)

    lidar = scene.lidar if scene.lidar is not None else np.zeros((m, 1, 1))
    radar = scene.radar if scene.radar is not None else np.zeros((m, 1, 1))
    return {
        "x_img": cat(xs, 96),
        "pn": cat(ps, 256),
        "rn": cat(rs, 256),
        "lidar_present": lidar.reshape(m, -1).sum(1) != 0,
        "radar_present": radar.reshape(m, -1).sum(1) != 0,
    }


def _assemble_encoded_batch(windows, encs, batch_size, mn, me):
    """Fixed-shape (PaddedGraph, encodings) batch from window/encoding-table
    pairs: the graphs carry no modality arrays, and each window's nodes
    gather their embeddings by detection index into [B, N, .] buffers
    (CPU tensors). Missing windows are all padding."""
    graphs = []
    xi = np.zeros((batch_size, mn, ENC_DIMS["x_img"]), np.float32)
    pn = np.zeros((batch_size, mn, ENC_DIMS["pn"]), np.float32)
    rn = np.zeros((batch_size, mn, ENC_DIMS["rn"]), np.float32)
    lp = np.zeros((batch_size, mn), bool)
    rp = np.zeros((batch_size, mn), bool)
    for slot, (w, enc) in enumerate(zip(windows, encs)):
        graphs.append(pad_graph(
            pose=w.pose, edge_src=w.edge_src, edge_dst=w.edge_dst,
            edge_attr=w.edge_attr, node_time=w.node_time,
            node_class=w.node_class, max_nodes=mn, max_edges=me,
            edge_label=w.edge_label, edge_weight=w.edge_weight,
            include_modalities=False,
        ))
        n = w.num_nodes
        di = w.det_index
        xi[slot, :n] = enc["x_img"][di]
        pn[slot, :n] = enc["pn"][di]
        rn[slot, :n] = enc["rn"][di]
        lp[slot, :n] = enc["lidar_present"][di]
        rp[slot, :n] = enc["radar_present"][di]
    while len(graphs) < batch_size:
        graphs.append(empty_graph(mn, me, include_modalities=False))
    return batch_graphs(graphs), tuple(torch.from_numpy(a) for a in (xi, pn, rn, lp, rp))


class EncodedGraphBatcher:
    """Yields (PaddedGraph without modalities, encodings) batches: each item
    pairs a window with its scene's encoding table, and the node embeddings
    are gathered on the host into fixed [B, N, .] buffers."""

    def __init__(
        self,
        windows_with_encodings: Sequence[Tuple[WindowGraphArrays, Dict[str, np.ndarray]]],
        batch_size: int,
        buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
        seed: int = 0,
        uniform: bool = False,
    ):
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)
        self.by_bucket: Dict[Tuple[int, int], List[int]] = {}
        self.items = [
            (w, enc) for (w, enc) in windows_with_encodings
            if w.num_nodes > 0 and w.num_edges > 0
        ]
        if uniform:
            buckets = uniform_bucket(
                [(w.num_nodes, w.num_edges) for w, _ in self.items], buckets
            )
        self.buckets = tuple(buckets)
        for i, (w, _) in enumerate(self.items):
            b = pick_bucket(w.num_nodes, w.num_edges, self.buckets)
            self.by_bucket.setdefault(b, []).append(i)

    def __len__(self) -> int:
        return sum(
            (len(v) + self.batch_size - 1) // self.batch_size
            for v in self.by_bucket.values()
        )

    def epoch(self, shuffle: bool = True) -> Iterator[Tuple[PaddedGraph, Tuple]]:
        batches = []
        for b, idxs in self.by_bucket.items():
            order = np.array(idxs)
            if shuffle:
                self._rng.shuffle(order)
            for lo in range(0, len(order), self.batch_size):
                batches.append((b, order[lo: lo + self.batch_size]))
        if shuffle:
            self._rng.shuffle(batches)
        for (mn, me), idxs in batches:
            pairs = [self.items[i] for i in idxs]
            yield _assemble_encoded_batch(
                [w for w, _ in pairs], [e for _, e in pairs],
                self.batch_size, mn, me,
            )
