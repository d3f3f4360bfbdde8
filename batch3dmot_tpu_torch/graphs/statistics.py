"""Dataset statistics over built graph stores (a copy of
``batch3dmot_tpu/graphs/statistics.py`` over the port's store reader).

Equivalent of the reference's ``DatasetStatistics`` dataset
(``utils/graph_data.py:259-323``) plus the (referenced but missing)
``scripts/statistics.py`` that produced the hard-coded relative class
frequencies used by the class-balanced loss (``graph_data.py:60``): counts
edges per tracking class across .b3d stores and derives the relative
frequencies / effective-number weights.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from batch3dmot_tpu_torch.config import TRACKING_CLASSES
from batch3dmot_tpu_torch.io.store import GraphStoreReader


def edge_class_histogram(store_paths: Sequence[str]) -> Dict[str, int]:
    """Edge counts per class across all windows of the given stores."""
    id2name = {v: k for k, v in TRACKING_CLASSES.items()}
    counts = np.zeros(len(TRACKING_CLASSES) + 1, np.int64)
    for path in store_paths:
        reader = GraphStoreReader(path)
        for i in range(reader.num_windows):
            cls = reader.array(i, "node_class")
            src = reader.array(i, "edge_src")
            if len(src) == 0:
                continue
            counts += np.bincount(cls[src], minlength=len(counts))
    return {id2name[c]: int(counts[c]) for c in id2name}


def relative_frequencies(hist: Dict[str, int]) -> Dict[str, float]:
    total = max(sum(hist.values()), 1)
    return {k: v / total for k, v in hist.items()}


def positive_rate(store_paths: Sequence[str]) -> float:
    """Fraction of GT-positive edges (class balance of the BCE target)."""
    pos = tot = 0
    for path in store_paths:
        reader = GraphStoreReader(path)
        for i in range(reader.num_windows):
            y = reader.array(i, "edge_label")
            pos += float(y.sum())
            tot += len(y)
    return pos / max(tot, 1)
