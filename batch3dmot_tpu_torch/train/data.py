"""Host-side batching of window graphs into fixed-shape window batches
(counterpart of ``batch3dmot_tpu/train/data.py``).

Windows are padded into a small set of (max_nodes, max_edges) buckets,
shuffled with a numpy ``default_rng(seed)`` in the same order as the JAX
package, and stacked ``batch_size`` at a time along a leading window
dimension; an incomplete batch is filled with all-padding windows, so a
batch always holds ``batch_size`` windows.

:func:`materialize_graph_dataset` stacks a whole window set instead, for
the device-resident epochs of ``GNNTrainer.fit_device``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from batch3dmot_tpu_torch.data.types import WindowGraphArrays
from batch3dmot_tpu_torch.graph import (
    DEFAULT_BUCKETS,
    PaddedGraph,
    batch_graphs,
    empty_graph,
    pad_graph,
    pick_bucket,
)


def to_padded(g: WindowGraphArrays, max_nodes: int, max_edges: int) -> PaddedGraph:
    return pad_graph(
        pose=g.pose,
        edge_src=g.edge_src,
        edge_dst=g.edge_dst,
        edge_attr=g.edge_attr,
        node_time=g.node_time,
        node_class=g.node_class,
        max_nodes=max_nodes,
        max_edges=max_edges,
        img=g.img,
        lidar=g.lidar,
        radar=g.radar,
        edge_label=g.edge_label,
        edge_weight=g.edge_weight,
    )


def uniform_bucket(
    sizes: Sequence[Tuple[int, int]],
    buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
    max_waste: float = 4.0,
) -> Tuple[Tuple[int, int], ...]:
    """The single bucket fitting every (num_nodes, num_edges) in ``sizes``,
    or every bucket (per-window bucketing) when that one bucket is more than
    ``max_waste`` times the area of the median window's own bucket: a few
    crowded windows must not force the whole epoch's padding."""
    if not sizes:
        return tuple(buckets)
    uni = pick_bucket(max(n for n, _ in sizes), max(e for _, e in sizes), buckets)
    per_window = sorted(
        pick_bucket(n, e, buckets)[0] * pick_bucket(n, e, buckets)[1]
        for n, e in sizes
    )
    median_area = per_window[len(per_window) // 2]
    if uni[0] * uni[1] > max_waste * median_area:
        return tuple(buckets)
    return (uni,)


class GraphBatcher:
    """Bucket + shuffle + stack window graphs into PaddedGraph batches."""

    def __init__(
        self,
        windows: Sequence[WindowGraphArrays],
        batch_size: int,
        buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
        drop_empty: bool = True,
        seed: int = 0,
        uniform: bool = False,
    ):
        self.batch_size = batch_size
        windows = [
            w for w in windows
            if not (drop_empty and (w.num_nodes == 0 or w.num_edges == 0))
        ]
        if uniform:
            buckets = uniform_bucket([(w.num_nodes, w.num_edges) for w in windows], buckets)
        self.buckets = tuple(buckets)
        self._rng = np.random.default_rng(seed)
        self.by_bucket: Dict[Tuple[int, int], List[WindowGraphArrays]] = {}
        for w in windows:
            b = pick_bucket(w.num_nodes, w.num_edges, self.buckets)
            self.by_bucket.setdefault(b, []).append(w)

    def __len__(self) -> int:
        return sum(
            (len(ws) + self.batch_size - 1) // self.batch_size
            for ws in self.by_bucket.values()
        )

    def epoch(self, shuffle: bool = True) -> Iterator[PaddedGraph]:
        """Yield stacked [B, ...] PaddedGraph batches (CPU tensors) for one
        epoch."""
        per_bucket: Dict[Tuple[int, int], List[int]] = {}
        for b, ws in self.by_bucket.items():
            idxs = np.arange(len(ws))
            if shuffle:
                self._rng.shuffle(idxs)
            per_bucket[b] = list(idxs)
        batches: List[Tuple[Tuple[int, int], List[int]]] = []
        for b, idxs in per_bucket.items():
            for i in range(0, len(idxs), self.batch_size):
                batches.append((b, idxs[i: i + self.batch_size]))
        if shuffle:
            self._rng.shuffle(batches)
        for b, idxs in batches:
            mn, me = b
            graphs = [to_padded(self.by_bucket[b][i], mn, me) for i in idxs]
            img_dtype = graphs[0].img.numpy().dtype
            while len(graphs) < self.batch_size:
                graphs.append(empty_graph(mn, me, img_dtype=img_dtype))
            yield batch_graphs(graphs)


def single_bucket_for(
    sizes, buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS
) -> Tuple[int, int]:
    """ONE bucket covering every (num_nodes, num_edges): ``uniform_bucket``'s
    choice when its outlier guard allows one, else the bucket of the
    densest window."""
    out = uniform_bucket(sizes, buckets)
    if len(out) == 1:
        return out[0]
    return pick_bucket(max(n for n, _ in sizes), max(e for _, e in sizes), buckets)


def group_sizes_by_bucket(
    sizes, buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS
):
    """Item-index groups: one group (the ``uniform_bucket`` shape) when the
    outlier guard allows it, else one group per occupied bucket. Returns
    [(bucket, [item indices])]."""
    out = uniform_bucket(sizes, buckets)
    if len(out) == 1:
        return [(out[0], list(range(len(sizes))))]
    by_bucket: Dict[Tuple[int, int], List[int]] = {}
    for i, (n, e) in enumerate(sizes):
        by_bucket.setdefault(pick_bucket(n, e, buckets), []).append(i)
    return sorted(by_bucket.items())


def non_empty(items, what: str, window=lambda item: item):
    """The items whose window has nodes and edges; raises when none has."""
    kept = [x for x in items if window(x).num_nodes > 0 and window(x).num_edges > 0]
    if not kept:
        raise ValueError(f"{what}: no non-empty windows")
    return kept


def alloc_rows(g: PaddedGraph, rows: int) -> PaddedGraph:
    """Zeroed [rows, ...] CPU tensors shaped like one [1, ...] graph ``g``."""
    return PaddedGraph(**{
        f.name: torch.zeros((rows, *getattr(g, f.name).shape[1:]),
                            dtype=getattr(g, f.name).dtype)
        for f in dataclasses.fields(g)
    })


def set_row(dst: PaddedGraph, k: int, g: PaddedGraph) -> None:
    """Row ``k`` of the stacked ``dst`` from the one-window [1, ...] ``g``."""
    for f in dataclasses.fields(dst):
        getattr(dst, f.name)[k] = getattr(g, f.name)[0]


def materialize_graph_datasets(
    windows, buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS
):
    """List of device-resident dataset groups, one per occupied bucket
    (:func:`group_sizes_by_bucket`); ``GNNTrainer.fit_device`` runs each
    group's steps in turn every epoch."""
    items = non_empty(windows, "materialize_graph_datasets")
    groups = group_sizes_by_bucket([(w.num_nodes, w.num_edges) for w in items], buckets)
    return [materialize_graph_dataset([items[i] for i in idxs], bucket=b)
            for b, idxs in groups]


def materialize_graph_dataset(
    windows, buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
    bucket: Optional[Tuple[int, int]] = None,
):
    """The whole (modality-free) window set as one stacked PaddedGraph of
    CPU tensors for ``GNNTrainer.fit_device`` (the pose-model counterpart
    of ``train.encoded.materialize_encoded_dataset``): every window padded
    to one bucket and stacked on a leading [W+1] axis, with an empty window
    at index W for padding the last batch. Preallocated [W+1, ...] buffers
    are filled row by row (stacking copies would double the host memory for
    a moment). Returns (graphs, None, bucket)."""
    items = non_empty(windows, "materialize_graph_dataset")
    mn, me = bucket or single_bucket_for(
        [(w.num_nodes, w.num_edges) for w in items], buckets
    )

    def one(w):
        return batch_graphs([pad_graph(
            pose=w.pose, edge_src=w.edge_src, edge_dst=w.edge_dst,
            edge_attr=w.edge_attr, node_time=w.node_time,
            node_class=w.node_class, max_nodes=mn, max_edges=me,
            edge_label=w.edge_label, edge_weight=w.edge_weight,
            include_modalities=False,
        )])

    g0 = one(items[0])
    graphs = alloc_rows(g0, len(items) + 1)
    set_row(graphs, 0, g0)
    for k, w in enumerate(items[1:], start=1):
        set_row(graphs, k, one(w))
    set_row(graphs, len(items), batch_graphs([empty_graph(mn, me, include_modalities=False)]))
    return graphs, None, (mn, me)
