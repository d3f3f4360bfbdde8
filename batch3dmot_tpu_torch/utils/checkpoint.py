"""Checkpoint save and load (counterpart of
``batch3dmot_tpu/utils/checkpoint.py``).

A checkpoint is one ``torch.save`` file (state dicts and plain values)
written atomically, with an optional ``.meta.json`` sidecar; per-epoch
files carry the train and validation AP in their name, as the reference's
do. These files are the port's own (``.pt``).

The JAX package writes flax msgpack. :func:`load_flax_checkpoint` loads a
GNN from its epoch checkpoints and trainer states,
:func:`load_flax_encoder_checkpoint` a standalone encoder from the JAX
encoder trainer's epoch checkpoints, and :func:`merge_encoder_params`
grafts standalone encoder checkpoints (the JAX trainer's, or the port's
own ``.pt`` from ``train/encoders.py``) into a GNN's encoders (the
counterpart of its ``merge_encoder_params`` and of ``train-gnn``'s encoder
grafting); the msgpack files are read with the port's own decoder
(:mod:`batch3dmot_tpu_torch.utils.msgpack`).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from batch3dmot_tpu_torch.utils import msgpack
from batch3dmot_tpu_torch.utils.weights import (
    encoder_variables,
    flax_to_state_dict,
    load_encoder_variables,
    load_flax_variables,
    state_dict_to_encoder_variables,
)

# a standalone encoder checkpoint: a flax variable tree, or the path of its
# msgpack file (the JAX encoder trainer's) or of a port ``.pt`` file
Encoder = Union[str, os.PathLike, Dict[str, Any]]


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


def load_flax_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load ``model`` (a port ``MultimodalGNN`` or ``PoseGNN``) from a flax
    msgpack file of the JAX package: an epoch checkpoint (``{"params",
    "batch_stats"}``) or a trainer state (``{"variables", "opt_state",
    "step"}``, of which only the weights are read; the optimizer's moments
    are not carried over). Strict: every parameter and statistic of the
    model must be covered and nothing left over."""
    tree = msgpack.read(path)
    variables = tree.get("variables", tree)
    if "params" not in variables:
        raise ValueError(f"{path}: neither an epoch checkpoint nor a trainer state "
                         f"(top-level keys {sorted(tree)})")
    return load_flax_variables(model, variables)


def load_flax_encoder_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a standalone port encoder (``ResNetAE``, ``PointNetClassifier``
    or ``RadarNetClassifier``) from an epoch checkpoint of the JAX encoder
    trainer (``{prefix}_epoch{e}_loss{loss}.msgpack``: ``{"params",
    "batch_stats"}``, the decoder or ``fc3`` included), strictly."""
    return load_encoder_variables(model, msgpack.read(path))


def _read_encoder_checkpoint(path: Union[str, os.PathLike], kind: str) -> Dict[str, Any]:
    """The JAX-layout tree of a standalone encoder checkpoint: a port
    ``.pt`` (the state dict :class:`~batch3dmot_tpu_torch.train.encoders.
    EncoderTrainer` writes) of the encoder ``kind`` ('resnet', 'pointnet'
    or 'radarnet'), or a JAX msgpack file."""
    path = os.fspath(path)
    if path.endswith(".pt"):
        return state_dict_to_encoder_variables(load_checkpoint(path, map_location="cpu"), kind)
    return msgpack.read(path)


def _take_matching(dst, src, where: str):
    """The leaves of ``src`` at the places ``dst`` has them (extra leaves of
    ``src`` are dropped), each of ``dst``'s shape."""
    if isinstance(dst, dict):
        out = {}
        for k, v in dst.items():
            if not isinstance(src, dict) or k not in src:
                raise ValueError(f"encoder checkpoint missing '{where}/{k}' — wrong "
                                 f"architecture for this submodule?")
            out[k] = _take_matching(v, src[k], f"{where}/{k}")
        return out
    if tuple(dst.shape) != tuple(np.shape(src)):
        raise ValueError(f"encoder checkpoint shape mismatch at '{where}': "
                         f"{tuple(np.shape(src))} vs expected {tuple(dst.shape)}")
    return src


def merge_encoder_params(model: torch.nn.Module, resnet: Optional[Encoder] = None,
                         pointnet: Optional[Encoder] = None,
                         radarnet: Optional[Encoder] = None) -> torch.nn.Module:
    """Graft separately trained encoders into ``model``'s encoder
    submodules of the same names. Each is a flax variable tree
    (``{"params", "batch_stats"}``, numpy leaves), the path of a msgpack
    file holding one, as the JAX package's encoder trainers write them
    (with their classification heads and the ResNet's decoder), or the path
    of a ``.pt`` epoch checkpoint of the port's encoder trainer. Only the
    leaves the GNN's tree has are taken; a missing leaf or a shape mismatch
    raises ``ValueError`` naming its path. Returns ``model``."""
    taken = {}
    for name, enc in (("resnet", resnet), ("pointnet", pointnet), ("radarnet", radarnet)):
        if enc is None:
            continue
        if not hasattr(model, name):
            raise ValueError(f"the model has no {name} encoder")
        if isinstance(enc, (str, os.PathLike)):
            enc = _read_encoder_checkpoint(enc, name)
        want = encoder_variables(model, name)
        taken[name] = {coll: {name: _take_matching(want[coll], enc.get(coll, {}),
                                                   f"{name}/{coll}")}
                       for coll in ("params", "batch_stats")}
    # every encoder checked before any is loaded
    for name, tree in taken.items():
        sub = getattr(model, name)
        prefix = f"{name}."
        sd = {k[len(prefix):]: torch.tensor(v) for k, v in flax_to_state_dict(tree).items()}
        for key, buf in sub.state_dict().items():
            if key.endswith("num_batches_tracked"):
                sd[key] = buf
        sub.load_state_dict(sd, strict=True)
    return model
