"""Tracking-graph construction: window graphs, labels, weights."""

from batch3dmot_tpu_torch.graphs.build import build_scene_graphs, build_window_graph  # noqa: F401
from batch3dmot_tpu_torch.graphs.weights import cb_edge_weight  # noqa: F401
