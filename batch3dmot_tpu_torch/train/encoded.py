"""Precomputed-encoding training for the multimodal GNN (counterpart of
part of ``batch3dmot_tpu/train/encoded.py``).

The frozen ResNet/PointNet/RadarNet outputs are constants of the data, so
they are computed once per scene (:func:`precompute_scene_encodings`) and
the GNN trains on gathered embeddings (:class:`EncodedGraphBatcher`): the
same numbers as running the encoders in every step, without their cost.

For the device-resident epochs of ``GNNTrainer.fit_device`` the whole set
is stacked once: per window in the dense form
(:func:`materialize_encoded_dataset`), or as one table of every distinct
detection plus per-window rows into it in the deduplicated form
(:func:`materialize_encoded_dataset_dedup`).

Training from ``.b3d`` stores keeps each scene's table next to its store as
``<store>.enc.npz`` (:func:`scene_encodings_cached`), keyed by a digest of
the frozen encoders' weights, and :class:`StreamingEncodedBatcher` walks the
stores scene by scene with one scene resident.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

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
from batch3dmot_tpu_torch.io.store import GraphStoreReader
from batch3dmot_tpu_torch.train.data import (
    alloc_rows,
    group_sizes_by_bucket,
    materialize_graph_dataset,
    non_empty,
    set_row,
    single_bucket_for,
    uniform_bucket,
)

ENC_DIMS = {"x_img": 96, "pn": 256, "rn": 256}
ENC_KEYS = ("x_img", "pn", "rn", "lidar_present", "radar_present")
FROZEN_ENCODERS = ("resnet", "pointnet", "radarnet")


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


def _encoder_digest(model) -> str:
    """Digest of the frozen encoders' weights: sha1 over the name, shape,
    dtype and bytes of every entry of the ``resnet``, ``pointnet`` and
    ``radarnet`` state dicts (buffers included), cut to 16 hex digits. It
    keys the on-disk encoding caches, so that grafted encoder weights
    invalidate them. The bytes come off the device in one copy."""
    entries = [(f"{name}.{key}", t.detach()) for name in FROZEN_ENCODERS
               if hasattr(model, name)
               for key, t in getattr(model, name).state_dict().items()]
    h = hashlib.sha1()
    if entries:
        flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for _, t in entries])
        blob = flat.cpu().numpy().tobytes()
        off = 0
        for key, t in entries:
            nbytes = t.numel() * t.element_size()
            h.update(key.encode())
            h.update(str(tuple(t.shape)).encode())
            h.update(str(t.dtype).encode())
            h.update(blob[off: off + nbytes])
            off += nbytes
    return h.hexdigest()[:16]


def store_detection_count(store_path: str) -> Optional[int]:
    """Detection-row count from the store's metadata sidecar
    (``<scene>_metadata.json``, one entry per detection, written by
    ``save_scene_graphs``); None when the store has no readable sidecar."""
    meta_path = store_path.replace(".b3d", "_metadata.json")
    try:
        with open(meta_path) as f:
            return len(json.load(f))
    except Exception:
        return None


def probe_scene_encoding_cache(
    store_path: str, digest: str, expected_rows: Optional[int] = None,
) -> Optional[Dict[str, np.ndarray]]:
    """Validity probe for ``<store>.enc.npz``: the cache must exist, be
    readable, carry this encoder ``digest`` and, when the store's row count
    is known, agree with it (the digest keys the encoders only, so a store
    rebuilt in place at another density would otherwise misalign every
    row). Returns the encoding dict; None when absent or invalid. A stale
    or unreadable cache is reported."""
    cache_path = f"{store_path}.enc.npz"
    if not os.path.exists(cache_path):
        return None
    try:
        with np.load(cache_path, allow_pickle=False) as z:
            if str(z["digest"]) != digest:
                return None
            if expected_rows is not None and len(z["x_img"]) != expected_rows:
                print(
                    f"encodings: ignoring stale embedding cache {cache_path} "
                    f"({len(z['x_img'])} rows vs {expected_rows} store "
                    "detections — the store was rebuilt in place)"
                )
                return None
            return {k: z[k] for k in ENC_KEYS}
    except Exception as e:
        # writes are atomic (os.replace), but the disk is not trusted
        print(f"encodings: ignoring unreadable embedding cache {cache_path} ({e})")
        return None


def scene_encodings_cached(
    model, store_path: str, scene_loader, cache: bool = True,
    digest: Optional[str] = None, expected_rows: Optional[int] = None, device=None,
) -> Dict[str, np.ndarray]:
    """A scene's encoding table, persisted next to its ``.b3d`` store as
    ``<store>.enc.npz`` keyed by :func:`_encoder_digest`. On a miss the
    scene (``scene_loader(store_path)``) is encoded on ``device`` (None:
    the GPU) in inference mode and the table written atomically (a
    temporary name, then ``os.replace``). ``digest``: pass the encoder
    digest when calling per scene. ``expected_rows`` defaults to the
    metadata sidecar's row count, so that a digest-matching cache of a
    store rebuilt in place is recomputed, not trusted."""
    if digest is None:
        digest = _encoder_digest(model)
    if expected_rows is None:
        expected_rows = store_detection_count(store_path)
    if cache:
        hit = probe_scene_encoding_cache(store_path, digest, expected_rows)
        if hit is not None:
            return hit
    cache_path = f"{store_path}.enc.npz"
    enc = precompute_scene_encodings(model, scene_loader(store_path), device=device)
    if cache:
        # np.savez appends '.npz' unless the name ends in it
        tmp = f"{cache_path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, digest=digest, **enc)
        os.replace(tmp, cache_path)
    return enc


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


class StreamingEncodedBatcher:
    """Scene-streaming variant of :class:`EncodedGraphBatcher`, with one
    scene resident: window sizes are indexed from the store headers alone
    (``GraphStoreReader.window_sizes``), each epoch walks the scenes in
    shuffled order, and a scene's windows and encoding table are loaded
    (:func:`scene_encodings_cached`, the digest computed once here) only
    while its batches are emitted. Windows shuffle within a scene and scenes
    across the epoch; a batch never mixes scenes.

    The batcher holds ``model``, whose frozen encoders a trainer never
    updates. A scene is encoded inside :meth:`epoch`'s generator, so a
    consumer that captures CUDA graphs must pull each batch before it
    captures (``GNNTrainer.train_epoch`` does)."""

    def __init__(
        self,
        store_paths: Sequence[str],
        model,
        scene_loader,
        batch_size: int,
        buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
        seed: int = 0,
        uniform: bool = False,
        cache: bool = True,
        device=None,
    ):
        self.batch_size = batch_size
        self.model = model
        self.scene_loader = scene_loader
        self.cache = cache
        self.device = device
        self._digest = _encoder_digest(model)
        self._rng = np.random.default_rng(seed)
        self.store_paths = list(store_paths)
        # header-only size index (no array data loaded)
        self._sizes = [GraphStoreReader(p).window_sizes() for p in self.store_paths]
        if uniform:
            buckets = uniform_bucket(
                [(n, e) for nodes, edges in self._sizes
                 for n, e in zip(nodes, edges) if n > 0 and e > 0],
                buckets,
            )
        self.buckets = tuple(buckets)

    def _live_by_bucket(self, si: int) -> Dict[Tuple[int, int], List[int]]:
        nodes, edges = self._sizes[si]
        by_bucket: Dict[Tuple[int, int], List[int]] = {}
        for i, (n, e) in enumerate(zip(nodes, edges)):
            if n > 0 and e > 0:
                by_bucket.setdefault(pick_bucket(n, e, self.buckets), []).append(i)
        return by_bucket

    def __len__(self) -> int:
        return sum(
            (len(idxs) + self.batch_size - 1) // self.batch_size
            for si in range(len(self.store_paths))
            for idxs in self._live_by_bucket(si).values()
        )

    def epoch(self, shuffle: bool = True) -> Iterator[Tuple[PaddedGraph, Tuple]]:
        scene_order = np.arange(len(self.store_paths))
        if shuffle:
            self._rng.shuffle(scene_order)
        for si in scene_order:
            by_bucket = self._live_by_bucket(si)
            if not by_bucket:
                continue
            path = self.store_paths[si]
            enc = scene_encodings_cached(self.model, path, self.scene_loader, self.cache,
                                         digest=self._digest, device=self.device)
            reader = GraphStoreReader(path)
            scene_batches = []
            for b, idxs in by_bucket.items():
                order = np.array(idxs)
                if shuffle:
                    self._rng.shuffle(order)
                for lo in range(0, len(order), self.batch_size):
                    scene_batches.append((b, order[lo: lo + self.batch_size]))
            if shuffle:
                self._rng.shuffle(scene_batches)
            for (mn, me), idxs in scene_batches:
                windows = [reader.window(int(i)) for i in idxs]
                yield _assemble_encoded_batch(windows, [enc] * len(windows),
                                              self.batch_size, mn, me)
            del reader, enc  # the scene's residency ends here


def _items(windows_with_encodings, what):
    return non_empty(windows_with_encodings, what, window=lambda item: item[0])


def materialize_encoded_datasets(windows_with_encodings, buckets=DEFAULT_BUCKETS):
    """List of device-resident dataset groups, one per occupied bucket
    (``train.data.group_sizes_by_bucket``); ``GNNTrainer.fit_device`` runs
    each group's steps in turn every epoch."""
    items = _items(windows_with_encodings, "materialize_encoded_datasets")
    groups = group_sizes_by_bucket([(w.num_nodes, w.num_edges) for w, _ in items], buckets)
    return [materialize_encoded_dataset([items[i] for i in idxs], bucket=b)
            for b, idxs in groups]


class DedupEncodings(NamedTuple):
    """Device-resident encodings in deduplicated form: one table of every
    distinct detection's embeddings, gathered by row inside each step,
    instead of per-window buffers [W+1, mn, 608] that copy a detection's
    embedding once per window it appears in (about L times at window
    length L, plus the node padding)."""

    # [W+1, mn] int32 rows into ``table``; padded node slots and the empty
    # window point at the all-zero row D
    det_index: Any
    # (x_img [D+1, 96], pn [D+1, 256], rn [D+1, 256],
    #  lidar_present [D+1] bool, radar_present [D+1] bool)
    table: Tuple[Any, Any, Any, Any, Any]


def build_encoding_table(encs: Sequence[Dict[str, np.ndarray]]):
    """Concatenate the distinct per-scene encoding tables (distinct by
    object identity: the windows of one scene share their scene's dict)
    into one table of CPU tensors with an all-zero row appended at index D.
    Returns ``(table, {id(enc): row offset}, D)``."""
    offsets: Dict[int, int] = {}
    uniq: List[Dict[str, np.ndarray]] = []
    total = 0
    for enc in encs:
        if id(enc) in offsets:
            continue
        offsets[id(enc)] = total
        uniq.append(enc)
        total += len(enc["x_img"])
    tails = {**{k: (d,) for k, d in ENC_DIMS.items()}, "lidar_present": (), "radar_present": ()}
    table = tuple(
        torch.from_numpy(np.concatenate(
            [np.asarray(e[k]) for e in uniq]
            + [np.zeros((1, *tails[k]), bool if k.endswith("present") else np.float32)]))
        for k in ENC_KEYS
    )
    return table, offsets, total


def materialize_encoded_dataset_dedup(
    windows_with_encodings: Sequence[Tuple[WindowGraphArrays, Dict[str, np.ndarray]]],
    buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
    bucket: Optional[Tuple[int, int]] = None,
    _shared: Optional[Tuple] = None,
) -> Tuple[PaddedGraph, DedupEncodings, Tuple[int, int]]:
    """:func:`materialize_encoded_dataset` with the encodings in
    :class:`DedupEncodings` form (the same training numbers: the gather on
    the device returns the rows the dense form gathers on the host).
    ``_shared`` passes a prebuilt ``(table, offsets, D)`` from the plural
    form, so that every group holds the same table object (which the
    trainer uploads once)."""
    items = _items(windows_with_encodings, "materialize_encoded_dataset_dedup")
    mn, me = bucket or single_bucket_for(
        [(w.num_nodes, w.num_edges) for w, _ in items], buckets
    )
    table, offsets, total = _shared or build_encoding_table([e for _, e in items])
    graphs, _, _ = materialize_graph_dataset([w for w, _ in items], bucket=(mn, me))
    det_index = np.full((len(items) + 1, mn), total, np.int32)
    for k, (w, e) in enumerate(items):
        det_index[k, : w.num_nodes] = offsets[id(e)] + w.det_index
    return graphs, DedupEncodings(torch.from_numpy(det_index), table), (mn, me)


def materialize_encoded_datasets_dedup(windows_with_encodings, buckets=DEFAULT_BUCKETS):
    """Per-bucket groups (:func:`materialize_encoded_datasets`) in dedup
    form; every group holds the same encoding table object."""
    items = _items(windows_with_encodings, "materialize_encoded_datasets_dedup")
    shared = build_encoding_table([e for _, e in items])
    groups = group_sizes_by_bucket([(w.num_nodes, w.num_edges) for w, _ in items], buckets)
    return [
        materialize_encoded_dataset_dedup([items[i] for i in idxs], bucket=b, _shared=shared)
        for b, idxs in groups
    ]


def materialize_encoded_dataset(
    windows_with_encodings: Sequence[Tuple[WindowGraphArrays, Dict[str, np.ndarray]]],
    buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
    bucket: Optional[Tuple[int, int]] = None,
) -> Tuple[PaddedGraph, Tuple, Tuple[int, int]]:
    """The whole encoded dataset stacked once for ``GNNTrainer.fit_device``
    (which uploads it once): every window padded to one bucket and stacked
    on a leading [W+1] axis of CPU tensors, with an empty window at index W
    for padding the last batch (its edges are all masked, so it adds
    nothing to the loss, as the host batcher's padding windows). The
    preallocated buffers are filled row by row. Returns (graphs [W+1, ...],
    encodings tuple [W+1, ...], bucket)."""
    items = _items(windows_with_encodings, "materialize_encoded_dataset")
    mn, me = bucket or single_bucket_for(
        [(w.num_nodes, w.num_edges) for w, _ in items], buckets
    )
    rows = len(items) + 1
    g0, e0 = _assemble_encoded_batch([items[0][0]], [items[0][1]], 1, mn, me)
    graphs = alloc_rows(g0, rows)
    encs = tuple(torch.zeros((rows, *a.shape[1:]), dtype=a.dtype) for a in e0)

    def fill(k, g1, e1):
        set_row(graphs, k, g1)
        for dst, src in zip(encs, e1):
            dst[k] = src[0]

    fill(0, g0, e0)
    for k, (w, e) in enumerate(items[1:], start=1):
        fill(k, *_assemble_encoded_batch([w], [e], 1, mn, me))
    fill(rows - 1, *_assemble_encoded_batch([], [], 1, mn, me))  # the empty window
    return graphs, encs, (mn, me)
