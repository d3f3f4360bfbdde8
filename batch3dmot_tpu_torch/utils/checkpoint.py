"""Checkpoint save and load (counterpart of
``batch3dmot_tpu/utils/checkpoint.py``).

A checkpoint is one ``torch.save`` file (state dicts and plain values)
written atomically, with an optional ``.meta.json`` sidecar; per-epoch
files carry the train and validation AP in their name, as the reference's
do. The JAX package writes flax msgpack; these files are the port's own
(``.pt``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch


def save_checkpoint(path: str, obj: Any, metadata: Optional[Dict] = None) -> str:
    """``torch.save`` of ``obj`` to ``path`` through a temporary file and a
    rename, so a kill mid-save never leaves a truncated file at the path a
    later resume trusts; ``metadata`` goes to ``path + '.meta.json'``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    if metadata is not None:
        meta_tmp = f"{path}.meta.json.tmp.{os.getpid()}"
        with open(meta_tmp, "w") as f:
            json.dump(metadata, f)
        os.replace(meta_tmp, path + ".meta.json")
    return path


def load_checkpoint(path: str, map_location=None) -> Any:
    """The object saved at ``path`` (tensors on ``map_location``)."""
    return torch.load(path, map_location=map_location, weights_only=True)


def epoch_checkpoint_name(
    log_dir: str, prefix: str, epoch: int, version: str, train_ap: float, val_ap: float
) -> str:
    """Metric-stamped per-epoch checkpoint path: the JAX package's name with
    the port's extension."""
    return os.path.join(
        log_dir,
        f"{prefix}_epoch{epoch}_{version}_TrainAP{train_ap:.6f}_ValAP{val_ap:.6f}.pt",
    )
