"""Store-backed training batcher (counterpart of
``batch3dmot_tpu/train/store_data.py``).

:class:`StoreGraphBatcher` streams padded batches straight from ``.b3d``
scene stores: window sizes are indexed once from the headers, windows are
bucketed and shuffled as the in-memory
:class:`~batch3dmot_tpu_torch.train.data.GraphBatcher` does, and each batch
is assembled by the native loader's multithreaded
``b3d_fill_padded_batch`` (mmap reads and copies into fixed-shape
buffers). :func:`make_batcher` falls back to the numpy reader plus
``GraphBatcher`` when the native library cannot be built, and says so.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from batch3dmot_tpu_torch.graph import DEFAULT_BUCKETS, PaddedGraph, pick_bucket
from batch3dmot_tpu_torch.io.native import (
    NativeGraphStore,
    batch_to_padded_graph,
    library_path,
    native_available,
    native_error,
)
from batch3dmot_tpu_torch.io.store import GraphStoreReader
from batch3dmot_tpu_torch.train.data import GraphBatcher, uniform_bucket


class StoreGraphBatcher:
    """Batches windows from many scene stores via the native loader; the
    same seed gives the JAX package's batches in its order."""

    def __init__(
        self,
        store_paths: Sequence[str],
        batch_size: int,
        buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
        seed: int = 0,
        uniform: bool = False,
    ):
        if not native_available():
            raise RuntimeError(
                "native graphstore unavailable; use GraphBatcher with "
                f"io.store.load_scene_graphs instead ({native_error()})"
            )
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)
        self._stores = [NativeGraphStore(p) for p in store_paths]
        sizes = [store.window_sizes() for store in self._stores]
        if uniform:
            buckets = uniform_bucket(
                [(int(n), int(e)) for nodes, edges in sizes
                 for n, e in zip(nodes, edges) if n > 0 and e > 0],
                buckets,
            )
        self.buckets = tuple(buckets)
        # global index: (store_idx, window_idx) grouped by bucket
        self.by_bucket: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        for si, (nodes, edges) in enumerate(sizes):
            for wi in range(len(nodes)):
                if nodes[wi] == 0 or edges[wi] == 0:
                    continue
                b = pick_bucket(int(nodes[wi]), int(edges[wi]), self.buckets)
                self.by_bucket.setdefault(b, []).append((si, wi))

    def __len__(self) -> int:
        return sum(
            (len(ws) + self.batch_size - 1) // self.batch_size
            for ws in self.by_bucket.values()
        )

    def epoch(self, shuffle: bool = True) -> Iterator[PaddedGraph]:
        """Yield stacked [B, ...] PaddedGraph batches (CPU tensors)."""
        batches: List[Tuple[Tuple[int, int], List[Tuple[int, int]]]] = []
        for b, entries in self.by_bucket.items():
            order = np.arange(len(entries))
            if shuffle:
                self._rng.shuffle(order)
            for lo in range(0, len(order), self.batch_size):
                batches.append((b, [entries[i] for i in order[lo: lo + self.batch_size]]))
        if shuffle:
            self._rng.shuffle(batches)
        for (mn, me), items in batches:
            yield batch_to_padded_graph(self._fill(items, mn, me))

    def _fill(self, items, mn: int, me: int) -> dict:
        """One native fill per store the batch draws from (its other slots
        empty), then each slot taken from its own store's fill."""
        slots = list(items) + [(-1, -1)] * (self.batch_size - len(items))
        parts = {
            si: self._stores[si].fill_padded_batch(
                [wi if s == si else -1 for s, wi in slots], mn, me)
            for si in sorted({s for s, _ in items})
        }
        merged = parts[items[0][0]]
        for slot, (si, _) in enumerate(slots):
            if si >= 0 and parts[si] is not merged:
                for k in merged:
                    merged[k][slot] = parts[si][k][slot]
        return merged

    def close(self) -> None:
        for s in self._stores:
            s.close()


def make_batcher(
    store_paths: Sequence[str],
    batch_size: int,
    buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
    seed: int = 0,
    uniform: bool = False,
):
    """A StoreGraphBatcher when the native loader is available, else an
    in-memory GraphBatcher over the numpy reader; prints which and why."""
    if native_available():
        print(f"make_batcher: native .b3d loader ({library_path().name}) over "
              f"{len(store_paths)} stores")
        return StoreGraphBatcher(store_paths, batch_size, buckets, seed, uniform=uniform)
    reason = (native_error() or "unavailable").strip().splitlines()
    print(f"make_batcher: numpy reader + in-memory GraphBatcher over {len(store_paths)} "
          f"stores (native loader unavailable: {reason[-1] if reason else ''})")
    windows = []
    for p in store_paths:
        windows.extend(GraphStoreReader(p).windows())
    return GraphBatcher(windows, batch_size, buckets, seed=seed, uniform=uniform)
