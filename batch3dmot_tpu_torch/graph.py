"""Fixed-shape padded tracking-graph containers (PyTorch).

Counterpart of ``batch3dmot_tpu/graph.py``. A window graph is padded to a
``(max_nodes, max_edges)`` bucket and windows are stacked along a leading
window dimension. Padding is staged in numpy; :func:`pad_graph` wraps the
padded arrays as CPU tensors without a copy, and :meth:`PaddedGraph.to`
moves a whole batch to the device.

Padding conventions (the same as the JAX package):
  * padded node slots have ``node_mask == False`` and all-zero features;
  * padded edge slots have ``edge_mask == False`` and ``src == dst == 0``;
    every reduction skips them, so they contribute exactly zero;
  * ``node_time`` of padded slots is -1, ``node_class`` is 0 (classes are
    1-indexed).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

POSE_DIM = 19  # center(3) + wlh(3) + yaw(1) + velocity(3) + onehot(7) + score(1) + rel_time(1)
EDGE_DIM = 4  # [l2 xy dist, |yaw diff|, log volume ratio, |dt|]
IMG_SHAPE = (32, 32, 3)  # NHWC crop
LIDAR_SHAPE = (128, 3)  # points x channels
RADAR_SHAPE = (64, 4)  # points x channels


@dataclasses.dataclass(frozen=True)
class PaddedGraph:
    """One padded window graph, or a batch of them with a leading ``[B]``
    dimension on every field (see :func:`batch_graphs`)."""

    pose: torch.Tensor  # [N, 19] f32
    img: torch.Tensor  # [N, 32, 32, 3] uint8 (0..255) or f32 ([0,1])
    lidar: torch.Tensor  # [N, 128, 3] f32
    radar: torch.Tensor  # [N, 64, 4] f32
    node_time: torch.Tensor  # [N] i32 (-1 for padding)
    node_class: torch.Tensor  # [N] i32, 1-indexed (0 for padding)
    node_mask: torch.Tensor  # [N] bool
    edge_src: torch.Tensor  # [E] i32, past node j
    edge_dst: torch.Tensor  # [E] i32, current node i
    edge_attr: torch.Tensor  # [E, 4] f32
    edge_mask: torch.Tensor  # [E] bool
    edge_label: torch.Tensor  # [E] f32
    edge_weight: torch.Tensor  # [E] f32

    @property
    def max_nodes(self) -> int:
        return self.pose.shape[-2]

    @property
    def max_edges(self) -> int:
        return self.edge_src.shape[-1]

    def to(self, device, non_blocking: bool = False) -> "PaddedGraph":
        return PaddedGraph(**{
            f.name: getattr(self, f.name).to(device, non_blocking=non_blocking)
            for f in dataclasses.fields(self)
        })


def _pad_to(arr: np.ndarray, size: int, value=0) -> np.ndarray:
    pad = size - arr.shape[0]
    if pad < 0:
        raise ValueError(
            f"Array of size {arr.shape[0]} exceeds padding budget {size}"
        )
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths, mode="constant", constant_values=value)


def pad_graph(
    pose: np.ndarray,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_attr: np.ndarray,
    node_time: np.ndarray,
    node_class: np.ndarray,
    max_nodes: int,
    max_edges: int,
    img: Optional[np.ndarray] = None,
    lidar: Optional[np.ndarray] = None,
    radar: Optional[np.ndarray] = None,
    edge_label: Optional[np.ndarray] = None,
    edge_weight: Optional[np.ndarray] = None,
    dtype=np.float32,
    include_modalities: bool = True,
    img_dtype=np.float32,
) -> PaddedGraph:
    """Pad raw per-window numpy arrays into a :class:`PaddedGraph` of CPU
    tensors.

    ``include_modalities=False`` stores zero-size [N, 0, 0, 0] modality
    placeholders, for the encode-once path that never reads them. A uint8
    ``img`` keeps its dtype (the encoder divides by 255 on the device);
    ``img_dtype`` sets the placeholder dtype when ``img`` is absent.
    """
    n = pose.shape[0]
    e = edge_src.shape[0]
    if not include_modalities:
        img = lidar = radar = np.zeros((n, 0, 0, 0), dtype)
    if img is None:
        img = np.zeros((n, *IMG_SHAPE), img_dtype)
    if lidar is None:
        lidar = np.zeros((n, *LIDAR_SHAPE), dtype)
    if radar is None:
        radar = np.zeros((n, *RADAR_SHAPE), dtype)
    if edge_label is None:
        edge_label = np.zeros((e,), dtype)
    if edge_weight is None:
        edge_weight = np.ones((e,), dtype)

    node_mask = np.zeros((max_nodes,), bool)
    node_mask[:n] = True
    edge_mask = np.zeros((max_edges,), bool)
    edge_mask[:e] = True

    arrays = dict(
        pose=_pad_to(pose.astype(dtype), max_nodes),
        img=_pad_to(img if img.dtype == np.uint8 else img.astype(dtype), max_nodes),
        lidar=_pad_to(lidar.astype(dtype), max_nodes),
        radar=_pad_to(radar.astype(dtype), max_nodes),
        node_time=_pad_to(node_time.astype(np.int32), max_nodes, value=-1),
        node_class=_pad_to(node_class.astype(np.int32), max_nodes),
        node_mask=node_mask,
        edge_src=_pad_to(edge_src.astype(np.int32), max_edges),
        edge_dst=_pad_to(edge_dst.astype(np.int32), max_edges),
        edge_attr=_pad_to(edge_attr.astype(dtype), max_edges),
        edge_mask=edge_mask,
        edge_label=_pad_to(edge_label.astype(dtype), max_edges),
        edge_weight=_pad_to(edge_weight.astype(dtype), max_edges),
    )
    return PaddedGraph(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def batch_graphs(graphs: Sequence[PaddedGraph]) -> PaddedGraph:
    """Stack same-bucket graphs along a new leading window dimension."""
    out = {}
    for f in dataclasses.fields(PaddedGraph):
        xs = [getattr(g, f.name) for g in graphs]
        if len({x.dtype for x in xs}) > 1:
            # a uint8 image stacked with an f32 fill graph would promote to
            # f32 carrying 0..255, which the uint8-gated /255 would then skip
            raise TypeError(
                f"refusing to stack mixed dtypes {[x.dtype for x in xs]}"
            )
        out[f.name] = torch.stack(xs, dim=0)
    return PaddedGraph(**out)


def empty_graph(
    max_nodes: int,
    max_edges: int,
    dtype=np.float32,
    include_modalities: bool = True,
    img_dtype=np.float32,
) -> PaddedGraph:
    """An all-padding graph (fills incomplete window batches)."""
    return pad_graph(
        include_modalities=include_modalities,
        img_dtype=img_dtype,
        pose=np.zeros((0, POSE_DIM), dtype),
        edge_src=np.zeros((0,), np.int32),
        edge_dst=np.zeros((0,), np.int32),
        edge_attr=np.zeros((0, EDGE_DIM), dtype),
        node_time=np.zeros((0,), np.int32),
        node_class=np.zeros((0,), np.int32),
        max_nodes=max_nodes,
        max_edges=max_edges,
    )


# Default (max_nodes, max_edges) buckets; a window goes to the smallest that
# fits. The fused message-passing kernel covers all of them.
DEFAULT_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (64, 256),
    (64, 512),
    (128, 1024),
    (128, 4096),
    (256, 2048),
    (256, 4096),
    (256, 8192),
    (512, 4096),
    (512, 8192),
    (512, 16384),
    (1024, 8192),
    (1024, 32768),
)


def pick_bucket(
    num_nodes: int,
    num_edges: int,
    buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
) -> Tuple[int, int]:
    for n, e in buckets:
        if num_nodes <= n and num_edges <= e:
            return (n, e)
    raise ValueError(
        f"Window with {num_nodes} nodes / {num_edges} edges exceeds the "
        f"largest bucket {buckets[-1]}"
    )
