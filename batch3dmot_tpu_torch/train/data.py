"""Window graph -> padded graph (counterpart of ``batch3dmot_tpu/train/data.py``;
only :func:`to_padded`, which inference uses)."""

from __future__ import annotations

from batch3dmot_tpu_torch.data.types import WindowGraphArrays
from batch3dmot_tpu_torch.graph import PaddedGraph, pad_graph


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
