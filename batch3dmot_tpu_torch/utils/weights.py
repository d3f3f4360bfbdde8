"""Carry the JAX package's weights into the port's modules.

:func:`load_flax_variables` takes flax ``variables`` as nested numpy dicts
(``params`` and, for the multimodal models, ``batch_stats``) and loads them
into a port ``MultimodalGNN`` (any modality subset, with or without the
attention blocks) or ``PoseGNN``. It is the inverse of
``batch3dmot_tpu/utils/torch_import.py``: the port's parameters carry the
upstream PyTorch names, so ``import_mm_gnn(port state dict)`` gives back
the tree loaded here.

Layouts: a flax Dense kernel [in, out] is an ``nn.Linear`` weight [out, in];
a point conv's Dense kernel becomes the upstream ``Conv1d`` weight
[out, in, 1]; a Conv kernel HWIO becomes OIHW; BatchNorm scale/bias and
mean/var become weight/bias and running_mean/running_var. The single-token
attention keeps ``in_proj_weight`` whole [3D, D]: the value slice is
filled, the query and key slices (which have no effect) are zero. The kNN
GATConv of ``knn_conv_mode='active'`` models takes PyG's names: ``lin``
kernel -> ``lin.weight``, ``att_src``/``att_dst`` [F, 1] -> [1, 1, F].

:func:`encoder_variables` goes the other way for an encoder: the flax tree
of a GNN's frozen submodule (``resnet``, ``pointnet`` or ``radarnet``), the
leaves the GNN's tree holds, or of a standalone encoder with its decoder or
classification head (a copy of the encoder half of
``batch3dmot_tpu/utils/torch_import.py``); :func:`load_encoder_variables`
loads such a standalone tree into a port encoder. A ResNet decoder's
transposed conv is the flax decoder's input-dilated conv kernel flipped
spatially, with in and out channels swapped.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from batch3dmot_tpu_torch.models.encoders import (
    PointNetClassifier,
    RadarNetClassifier,
    ResNetAE,
)


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(out: dict, key: str, p: dict) -> None:
    out[f"{key}.weight"] = _f32(p["kernel"]).T
    if "bias" in p:
        out[f"{key}.bias"] = _f32(p["bias"])


def _point_conv(out: dict, key: str, p: dict) -> None:
    out[f"{key}.weight"] = _f32(p["kernel"]).T[:, :, None]
    out[f"{key}.bias"] = _f32(p["bias"])


def _conv2d(out: dict, key: str, p: dict) -> None:
    out[f"{key}.weight"] = _f32(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        out[f"{key}.bias"] = _f32(p["bias"])


def _bn(out: dict, key: str, p: dict, s: dict) -> None:
    out[f"{key}.weight"] = _f32(p["scale"])
    out[f"{key}.bias"] = _f32(p["bias"])
    out[f"{key}.running_mean"] = _f32(s["mean"])
    out[f"{key}.running_var"] = _f32(s["var"])


def _mlp(out: dict, key: str, p: dict) -> None:
    i = 0
    while f"dense_{i}" in p:
        _linear(out, f"{key}.{2 * i}", p[f"dense_{i}"])
        i += 1


def _attention(out: dict, key: str, p: dict) -> None:
    v_w = _f32(p["v_proj"]["kernel"]).T
    d = v_w.shape[0]
    out[f"{key}.in_proj_weight"] = np.concatenate([np.zeros((2 * d, d), np.float32), v_w])
    out[f"{key}.in_proj_bias"] = np.concatenate(
        [np.zeros(2 * d, np.float32), _f32(p["v_proj"]["bias"])]
    )
    _linear(out, f"{key}.out_proj", p["out_proj"])


def _gat(out: dict, key: str, p: dict) -> None:
    """flax GATConv (lin kernel [F, F], att_src / att_dst [F, 1]) onto
    PyG's names and shapes (lin.weight [F, F], att_* [1, 1, F])."""
    _linear(out, f"{key}.lin", p["lin"])
    for name in ("att_src", "att_dst"):
        out[f"{key}.{name}"] = _f32(p[name]).reshape(1, 1, -1)
    out[f"{key}.bias"] = _f32(p["bias"])


def _conv_transpose2d(out: dict, key: str, p: dict) -> None:
    """An input-dilated flax Conv (the decoder's) onto the
    ``ConvTranspose2d`` weight [I, O, H, W]: kernel HWIO flipped back."""
    out[f"{key}.weight"] = np.ascontiguousarray(
        _f32(p["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1))
    out[f"{key}.bias"] = _f32(p["bias"])


def _resnet(out: dict, p: dict, s: dict, pre: str = "resnet.", standalone: bool = False) -> None:
    """``standalone``: the autoencoder's decoder too (a GNN's tree converts
    without it, whatever the tree holds)."""
    _conv2d(out, f"{pre}conv", p["stem"])
    for i in (1, 2, 3):
        bp, bs, blk = p[f"block{i}"], s[f"block{i}"], f"{pre}res_block{i}"
        _conv2d(out, f"{blk}.conv1", bp["conv1"])
        _bn(out, f"{blk}.bn1", bp["bn1"], bs["bn1"])
        _conv2d(out, f"{blk}.conv2", bp["conv2"])
        _bn(out, f"{blk}.bn2", bp["bn2"], bs["bn2"])
        _conv2d(out, f"{blk}.downsample.0", bp["down_conv"])
        _bn(out, f"{blk}.downsample.1", bp["down_bn"], bs["down_bn"])
    for j in range(5 if standalone else 0):
        _conv_transpose2d(out, f"{pre}conv_decoder.{2 * j}", p[f"dec_{j}"])


def _point_feat(out: dict, key: str, p: dict, s: dict) -> None:
    for i in range(3):
        _point_conv(out, f"{key}.conv{i + 1}", p[f"mlp_{i}"])
        _bn(out, f"{key}.bn{i + 1}", p[f"bn_{i}"], s[f"bn_{i}"])


def _tnet(out: dict, key: str, p: dict, s: dict) -> None:
    _point_feat(out, key, p, s)
    for i in range(2):
        _linear(out, f"{key}.fc{i + 1}", p[f"fc_{i}"])
        _bn(out, f"{key}.bn{i + 4}", p[f"fc_bn_{i}"], s[f"fc_bn_{i}"])
    _linear(out, f"{key}.fc3", p["fc_out"])


def _feat_head(out: dict, pre: str, p: dict, s: dict, standalone: bool) -> None:
    _linear(out, f"{pre}fc1", p["fc1"])
    _bn(out, f"{pre}bn1", p["bn1"], s["bn1"])
    _linear(out, f"{pre}fc2", p["fc2"])
    _bn(out, f"{pre}bn2", p["bn2"], s["bn2"])
    if standalone:
        _linear(out, f"{pre}fc3", p["fc3"])


def _pointnet(out: dict, p: dict, s: dict, pre: str = "pointnet.",
              standalone: bool = False) -> None:
    """``standalone``: ``fc3`` and (feature_transform=True) ``fstn`` too."""
    _tnet(out, f"{pre}feat.stn", p["feat"]["stn"], s["feat"]["stn"])
    if standalone and "fstn" in p["feat"]:
        _tnet(out, f"{pre}feat.fstn", p["feat"]["fstn"], s["feat"]["fstn"])
    _point_feat(out, f"{pre}feat", p["feat"], s["feat"])
    _feat_head(out, pre, p, s, standalone)


def _radarnet(out: dict, p: dict, s: dict, pre: str = "radarnet.",
              standalone: bool = False) -> None:
    """``standalone``: ``fc3`` too."""
    _point_feat(out, f"{pre}feat", p["feat"], s["feat"])
    _feat_head(out, pre, p, s, standalone)


_MP_NAMES = {
    "edge_update": "edge_update",
    "past_msgs": "create_past_msgs",
    "future_msgs": "create_future_msgs",
    "combine": "combine_future_past",
}


def flax_to_state_dict(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Upstream-named state dict (numpy) of a flax MultimodalGNN or PoseGNN
    variable tree; only the subtrees present are converted."""
    p = variables["params"]
    s = variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}
    if "resnet" in p:
        _resnet(out, p["resnet"], s["resnet"])
    if "pointnet" in p:
        _pointnet(out, p["pointnet"], s["pointnet"])
    if "radarnet" in p:
        _radarnet(out, p["radarnet"], s["radarnet"])
    for name in ("edge_encoder", "node_encoder", "edge_classifier",
                 "fc_lidar_encoder", "fc_radar_encoder", "att_edge_encoder"):
        if name in p:
            _mlp(out, name, p[name])
    for name in ("c2c_att", "l2l_att", "r2r_att"):
        if name in p:
            _attention(out, name, p[name])
    if "message_passing" in p:  # absent from an encoder-only tree
        for flax_name, torch_name in _MP_NAMES.items():
            _mlp(out, f"message_passing.{torch_name}", p["message_passing"][flax_name])
    if "knn_conv" in p:  # only models in knn_conv_mode='active' have it
        _gat(out, "knn_conv", p["knn_conv"])
    return out


def flax_grads_to_state_dict(grads: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A flax gradient tree (the ``params`` collection's structure) mapped
    onto the port's parameter names through the same transposes as
    :func:`flax_to_state_dict`, so that one leaf compares with another.
    The frozen encoders' subtrees are left out: the port gives them no
    gradient at all."""
    trainable = {k: v for k, v in grads.items()
                 if k not in ("resnet", "pointnet", "radarnet")}
    return flax_to_state_dict({"params": trainable})


def load_flax_variables(model: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    """Load flax variables into a port model (strict: every parameter and
    statistic of the model must be covered, nothing may be left over)."""
    sd = {k: torch.tensor(v) for k, v in flax_to_state_dict(variables).items()}
    for key, buf in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros_like(buf)
    model.load_state_dict(sd, strict=True)
    return model


# ---- port state dict -> flax tree, the frozen encoders ---------------------


def _to_linear(sd, key):
    out = {"kernel": sd[f"{key}.weight"].T}
    if f"{key}.bias" in sd:
        out["bias"] = sd[f"{key}.bias"]
    return out


def _to_point_conv(sd, key):
    return {"kernel": sd[f"{key}.weight"][:, :, 0].T, "bias": sd[f"{key}.bias"]}


def _to_conv2d(sd, key):
    out = {"kernel": sd[f"{key}.weight"].transpose(2, 3, 1, 0)}
    if f"{key}.bias" in sd:
        out["bias"] = sd[f"{key}.bias"]
    return out


def _to_bn(sd, key):
    return ({"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]},
            {"mean": sd[f"{key}.running_mean"], "var": sd[f"{key}.running_var"]})


def _to_conv_transpose2d(sd, key):
    w = sd[f"{key}.weight"]  # [I, O, H, W]
    return {"kernel": np.ascontiguousarray(w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)),
            "bias": sd[f"{key}.bias"]}


def _to_point_feat(sd, key, p, s):
    for i in range(3):
        p[f"mlp_{i}"] = _to_point_conv(sd, f"{key}.conv{i + 1}")
        p[f"bn_{i}"], s[f"bn_{i}"] = _to_bn(sd, f"{key}.bn{i + 1}")


def _to_tnet(sd, key):
    p, s = {}, {}
    _to_point_feat(sd, key, p, s)
    for i in range(2):
        p[f"fc_{i}"] = _to_linear(sd, f"{key}.fc{i + 1}")
        p[f"fc_bn_{i}"], s[f"fc_bn_{i}"] = _to_bn(sd, f"{key}.bn{i + 4}")
    p["fc_out"] = _to_linear(sd, f"{key}.fc3")
    return p, s


def _to_feat_head(sd, p, s):
    p["fc1"] = _to_linear(sd, "fc1")
    p["bn1"], s["bn1"] = _to_bn(sd, "bn1")
    p["fc2"] = _to_linear(sd, "fc2")
    p["bn2"], s["bn2"] = _to_bn(sd, "bn2")
    if "fc3.weight" in sd:
        p["fc3"] = _to_linear(sd, "fc3")


def _to_resnet(sd, p, s):
    p["stem"] = _to_conv2d(sd, "conv")
    for i in (1, 2, 3):
        key, bp, bs = f"res_block{i}", {}, {}
        bp["conv1"] = _to_conv2d(sd, f"{key}.conv1")
        bp["bn1"], bs["bn1"] = _to_bn(sd, f"{key}.bn1")
        bp["conv2"] = _to_conv2d(sd, f"{key}.conv2")
        bp["bn2"], bs["bn2"] = _to_bn(sd, f"{key}.bn2")
        bp["down_conv"] = _to_conv2d(sd, f"{key}.downsample.0")
        bp["down_bn"], bs["down_bn"] = _to_bn(sd, f"{key}.downsample.1")
        p[f"block{i}"], s[f"block{i}"] = bp, bs
    for j in range(5):
        if f"conv_decoder.{2 * j}.weight" in sd:
            p[f"dec_{j}"] = _to_conv_transpose2d(sd, f"conv_decoder.{2 * j}")


def _to_pointnet(sd, p, s):
    stn_p, stn_s = _to_tnet(sd, "feat.stn")
    p["feat"], s["feat"] = {"stn": stn_p}, {"stn": stn_s}
    if "feat.fstn.fc3.weight" in sd:
        p["feat"]["fstn"], s["feat"]["fstn"] = _to_tnet(sd, "feat.fstn")
    _to_point_feat(sd, "feat", p["feat"], s["feat"])
    _to_feat_head(sd, p, s)


def _to_radarnet(sd, p, s):
    p["feat"], s["feat"] = {}, {}
    _to_point_feat(sd, "feat", p["feat"], s["feat"])
    _to_feat_head(sd, p, s)


_TO_FLAX = {"resnet": _to_resnet, "pointnet": _to_pointnet, "radarnet": _to_radarnet}
_FROM_FLAX = {"resnet": _resnet, "pointnet": _pointnet, "radarnet": _radarnet}
_KINDS = ((ResNetAE, "resnet"), (PointNetClassifier, "pointnet"),
          (RadarNetClassifier, "radarnet"))


def encoder_kind(model: nn.Module) -> str:
    """'resnet', 'pointnet' or 'radarnet' for a standalone port encoder."""
    for cls, kind in _KINDS:
        if isinstance(model, cls):
            return kind
    raise ValueError(f"not an encoder model: {type(model).__name__}")


def state_dict_to_encoder_variables(sd: Dict[str, Any], kind: str) -> Dict[str, Any]:
    """``{"params", "batch_stats"}`` in the JAX package's layout of an
    encoder's state dict (the port's names without a prefix, numpy or
    torch values): the GNN's leaves, plus the decoder (``dec_0``..
    ``dec_4``), ``fc3`` and ``fstn`` where the state dict has them."""
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
          for k, v in sd.items()}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    _TO_FLAX[kind](sd, params, stats)
    return {"params": params, "batch_stats": stats}


def encoder_variables(model: nn.Module, name: Optional[str] = None) -> Dict[str, Any]:
    """``{"params": ..., "batch_stats": ...}`` in the JAX package's layout,
    as numpy arrays: of the encoder ``name`` of a port ``MultimodalGNN``
    (the leaves the GNN's flax tree holds under ``name``: the ResNet without
    its decoder, PointNet and RadarNet without ``fc3``), or, with ``name``
    None, of a standalone port encoder (the whole tree the JAX encoder
    trainer holds)."""
    if name is None:
        return state_dict_to_encoder_variables(model.state_dict(), encoder_kind(model))
    return state_dict_to_encoder_variables(getattr(model, name).state_dict(), name)


def load_encoder_variables(model: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    """Load a JAX encoder tree (``{"params", "batch_stats"}``, as the JAX
    encoder trainer holds it) into a standalone port encoder, strictly."""
    out: Dict[str, np.ndarray] = {}
    _FROM_FLAX[encoder_kind(model)](out, variables["params"], variables.get("batch_stats", {}),
                                    "", standalone=True)
    sd = {k: torch.tensor(v) for k, v in out.items()}
    for key, buf in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros_like(buf)
    model.load_state_dict(sd, strict=True)
    return model
