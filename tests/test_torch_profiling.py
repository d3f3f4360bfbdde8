"""The training loop's tracing (``batch3dmot_tpu_torch/utils/profiling.py``):
off unless a profiler records, then five spans in the trace and counters
of the training calls, checked by hand against the dataset's edge masks;
on a CUDA card, the device intervals. Imports no JAX, so the card's case
also runs with ``python -m pytest --noconftest -m cuda
tests/test_torch_profiling.py``.
"""

import glob
import json

import numpy as np
import pytest
import torch

from batch3dmot_tpu_torch.config import GNNConfig, GraphConstructionConfig
from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
from batch3dmot_tpu_torch.graphs import build_scene_graphs
from batch3dmot_tpu_torch.models import make_model
from batch3dmot_tpu_torch.train.data import materialize_graph_dataset, materialize_graph_datasets
from batch3dmot_tpu_torch.train.trainer import GNNTrainer
from batch3dmot_tpu_torch.utils import profiling

SPANS = {"train.sources", "train.rows", "train.steps", "train.fetch", "train.metrics"}
BUCKETS = ((32, 128), (64, 512))
B = 2


def _windows():
    """Small windows and crowded ones: one group of each of BUCKETS."""
    out = []
    for seed, frames, tracks, knn, fp in ((0, 8, 4, 4, 0.0), (1, 5, 12, 6, 2.0)):
        scene = make_synthetic_scene(seed=seed, num_frames=frames, num_tracks=tracks,
                                     fp_per_frame=fp)
        cfg = GraphConstructionConfig(top_knn_nodes=knn)
        out += [w for w in build_scene_graphs(scene, 3, cfg) if w.num_edges > 0]
    return out


def _trainer(device="cpu"):
    return GNNTrainer(make_model("pose", depth=2), GNNConfig(lr=1e-4, batch_size=B),
                      device=device, seed=0)


def _hand_count(groups, epochs):
    """(steps, valid edges, edge slots) of ``epochs`` epochs: every window
    once an epoch, each group's last batch padded with its empty window."""
    steps = edges = slots = 0
    for graphs, _, _ in groups:
        n_items = graphs.pose.shape[0] - 1
        n_steps = -(-n_items // B)
        steps += n_steps
        edges += int(graphs.edge_mask[:n_items].sum())
        slots += n_steps * B * graphs.edge_mask.shape[1]
    return epochs * steps, epochs * edges, epochs * slots


def test_tracing_off_records_nothing(monkeypatch):
    """No profiler: no span, no event, no counter; annotate gives the one
    shared null context."""
    def refused(*a, **k):
        raise AssertionError("traced with no profiler recording")

    profiling.reset_loop()
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.cuda, "Event", refused)
    assert not profiling.tracing()
    assert profiling.annotate("a") is profiling.annotate("b")
    _trainer().fit_device(materialize_graph_dataset(_windows(), buckets=BUCKETS), epochs=2,
                          verbose=False, seed=3)
    assert profiling.loop_stats() == {}


@pytest.mark.parametrize("plural", [False, True])
def test_spans_and_counters_under_a_trace(tmp_path, plural):
    """Under ``profile_trace`` the Chrome trace holds the five spans, and
    the loop's file and ``loop_stats`` count the training calls, steps,
    valid edges and edge slots as the dataset's masks give them by hand
    (no device events on the CPU)."""
    windows = _windows()
    if plural:
        ds = materialize_graph_datasets(windows, buckets=BUCKETS)
        assert len(ds) == 2
    else:
        ds = materialize_graph_dataset(windows, buckets=BUCKETS)
    groups = ds if plural else [ds]
    trainer = _trainer()
    trainer.fit_device(ds, epochs=1, verbose=False)  # outside the trace
    with profiling.profile_trace(str(tmp_path)):
        trainer.fit_device(ds, epochs=2, verbose=False, seed=5)
    (trace,) = glob.glob(str(tmp_path / "trace_*.json"))
    names = {e.get("name") for e in json.load(open(trace))["traceEvents"]}
    assert SPANS <= names
    (loop,) = glob.glob(str(tmp_path / "loop_*.json"))
    stats = json.load(open(loop))
    assert stats == profiling.loop_stats()
    steps, edges, slots = _hand_count(groups, 2)
    assert stats == {"calls": 2 * len(groups), "steps": steps, "edges_valid": edges,
                     "edge_slots": slots}
    assert 0 < edges < slots
    profiling.reset_loop()
    assert profiling.loop_stats() == {}


@pytest.mark.cuda
def test_device_intervals_on_the_card():
    """On the card, under a profiler: two epochs of replays give a positive
    step time and a wait that is not negative, and the counters match the
    hand count; with no profiler nothing is recorded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    ds = materialize_graph_dataset(_windows(), buckets=BUCKETS)
    trainer = _trainer("cuda")
    profiling.reset_loop()
    trainer.fit_device(ds, epochs=1, verbose=False)  # captures, untraced
    assert profiling.loop_stats() == {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        trainer.fit_device(ds, epochs=2, verbose=False, seed=5)
    stats = profiling.loop_stats()
    steps, edges, slots = _hand_count([ds], 2)
    assert (stats["calls"], stats["steps"], stats["edges_valid"], stats["edge_slots"]) == (
        2, steps, edges, slots)
    assert stats["step_device_s"] > 0 and stats["wait_device_s"] >= 0
    assert np.isfinite([stats["step_device_s"], stats["wait_device_s"]]).all()
    profiling.reset_loop()
