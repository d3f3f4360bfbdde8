"""Named model family registry (counterpart of
``batch3dmot_tpu/models/registry.py``): the upstream model-module names
mapped onto the two architectures' knobs."""

from __future__ import annotations

from typing import Callable, Dict

from batch3dmot_tpu_torch.models.gnn import MultimodalGNN, PoseGNN


def _mm(modalities, use_attention=True):
    def make(depth: int = 6, knn_conv_mode: str = "noop", knn_conv_k: int = 20, **kw):
        return MultimodalGNN(
            depth=depth,
            use_attention=use_attention,
            knn_conv_mode=knn_conv_mode,
            knn_conv_k=knn_conv_k,
            modalities=modalities,
            **kw,
        )

    return make


def _pose():
    def make(depth: int = 6, knn_conv_mode: str = "noop", knn_conv_k: int = 20, **kw):
        return PoseGNN(depth=depth, knn_conv_mode=knn_conv_mode, knn_conv_k=knn_conv_k, **kw)

    return make


MODEL_REGISTRY: Dict[str, Callable] = {
    "clr_att_gnn": _mm(("img", "lidar", "radar")),
    "cl_att_gnn": _mm(("img", "lidar")),
    "cl_gnn_trad": _mm(("img", "lidar"), use_attention=False),
    "gnn_transfer_cl": _mm(("img", "lidar")),
    "gnn_transfer_cl_med": _mm(("img", "lidar")),
    "gnn_baseline": _pose(),
    "pose_gnn": _pose(),
    "mm": _mm(("img", "lidar", "radar")),
    "pose": _pose(),
}


def make_model(name: str, depth: int = 6, knn_conv_mode: str = "noop",
               knn_conv_k: int = 20, **kw):
    """Instantiate a registered model family by upstream or short name;
    ``knn_conv_mode`` ('noop' or 'active') and ``knn_conv_k`` set the
    frame-wise kNN GATConv."""
    try:
        ctor = MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown model '{name}'; choose from {sorted(MODEL_REGISTRY)}"
        ) from None
    return ctor(depth=depth, knn_conv_mode=knn_conv_mode, knn_conv_k=knn_conv_k, **kw)
