"""Class-balanced edge loss weights.

Effective-number weighting (Cui et al., CVPR'19) as the reference applies it
(``utils/graph_data.py:126-138``): with a virtual edge count ``n = 5`` and
``beta = (n-1)/n``, each same-class edge gets weight

    w(c) = (1 - beta) / (1 - beta ** (n * rel_freq_train[c]))

using the hard-coded train-split relative class frequencies
(``graph_data.py:61-68``). Graphs are category-disjoint so the cross-class
branch of the reference (which referenced an undefined attribute,
``graph_data.py:223-226``) never fires and is not reproduced.

A copy of ``batch3dmot_tpu/graphs/weights.py`` (numpy only): the port imports nothing
of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from batch3dmot_tpu_torch.config import (
    REL_FREQ_TRAIN,
    TRACKING_CLASS_NAMES,
    TRACKING_CLASSES,
)

_NUM_EDGES = 5.0
_BETA = (_NUM_EDGES - 1.0) / _NUM_EDGES


def cb_scaling_factor(class_name: str, rel_freq: Optional[Dict[str, float]] = None) -> float:
    freq = (rel_freq or REL_FREQ_TRAIN)[class_name]
    return float((1.0 - _BETA) / (1.0 - _BETA ** (_NUM_EDGES * freq)))


# Precomputed per-class-id weight table (index 0 unused; classes 1-indexed).



def cb_weight_table(rel_freq: Optional[Dict[str, float]] = None) -> np.ndarray:
    table = np.zeros(len(TRACKING_CLASSES) + 1, dtype=np.float32)
    for cid, name in TRACKING_CLASS_NAMES.items():
        table[cid] = cb_scaling_factor(name, rel_freq)
    return table


_TABLE = cb_weight_table()


def cb_edge_weight(edge_class_ids: np.ndarray) -> np.ndarray:
    """Per-edge class-balanced weights from 1-indexed edge class ids."""
    return _TABLE[np.asarray(edge_class_ids, dtype=np.int64)]
