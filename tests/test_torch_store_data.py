"""Training from .b3d stores in the PyTorch port against the JAX package on
the CPU: ``StoreGraphBatcher`` (the native loader) yields the JAX
batcher's batches in its order, ``make_batcher``'s fallback to the numpy
reader equals the JAX package's fallback, and a ``PoseGNN`` epoch from
store batches gives the JAX trainer's losses from the same weights."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from batch3dmot_tpu.config import GNNConfig as JaxGNNConfig
from batch3dmot_tpu.models import make_model as jax_make_model
from batch3dmot_tpu.train import store_data as jax_store_data
from batch3dmot_tpu.train.data import GraphBatcher as JaxGraphBatcher
from batch3dmot_tpu.train.data import to_padded as jax_to_padded
from batch3dmot_tpu.train.store_data import StoreGraphBatcher as JaxStoreBatcher
from batch3dmot_tpu.train.trainer import GNNTrainer as JaxTrainer
from batch3dmot_tpu_torch.config import GNNConfig, GraphConstructionConfig
from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
from batch3dmot_tpu_torch.graph import PaddedGraph
from batch3dmot_tpu_torch.graphs import build_scene_graphs
from batch3dmot_tpu_torch.io import save_scene_graphs
from batch3dmot_tpu_torch.models import make_model
from batch3dmot_tpu_torch.train import store_data
from batch3dmot_tpu_torch.train.data import GraphBatcher
from batch3dmot_tpu_torch.train.store_data import StoreGraphBatcher, make_batcher
from batch3dmot_tpu_torch.train.trainer import GNNTrainer
from batch3dmot_tpu_torch.utils.weights import load_flax_variables

torch.set_num_threads(1)

# two buckets: the smaller windows and the crowded ones part
BUCKETS = ((32, 128), (64, 256))
FIELDS = [f.name for f in dataclasses.fields(PaddedGraph)]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Three scene stores (with metadata sidecars) and their windows."""
    out = tmp_path_factory.mktemp("stores")
    paths, windows = [], []
    for seed in range(3):
        scene = make_synthetic_scene(seed=seed, num_frames=6 + seed % 2, num_tracks=5,
                                     with_modalities=True, modality_dropout=0.3)
        ws = list(build_scene_graphs(scene, 3, GraphConstructionConfig(top_knn_nodes=4)))
        paths.append(save_scene_graphs(ws, str(out), metadata=scene.metadata))
        windows.extend(ws)
    return paths, windows


def _assert_same_batches(port_batches, jax_batches):
    n = 0
    for t, j in zip(port_batches, jax_batches, strict=True):
        for f in FIELDS:
            a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
            assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f)
        n += 1
    assert n > 1


@pytest.mark.parametrize("uniform", [False, True])
def test_store_batcher_matches_jax(stores, uniform):
    """The same seed gives the same batches (every field, exactly) in the
    same order over two shuffled epochs and an unshuffled one."""
    paths, _ = stores
    tb = StoreGraphBatcher(paths, 3, BUCKETS, seed=4, uniform=uniform)
    jb = JaxStoreBatcher(paths, 3, BUCKETS, seed=4, uniform=uniform)
    assert tb.buckets == jb.buckets and len(tb) == len(jb)
    assert len(tb.buckets) == (1 if uniform else 2)
    assert tb.by_bucket == jb.by_bucket
    for shuffle in (True, True, False):
        _assert_same_batches(tb.epoch(shuffle), jb.epoch(shuffle))
    tb.close()
    jb.close()


def test_make_batcher_native_and_fallback_match_jax(stores, monkeypatch, capsys):
    """With the native loader make_batcher returns a StoreGraphBatcher and
    says so; with it made unavailable both packages fall back to the numpy
    reader and an in-memory GraphBatcher, whose batches agree, and the port
    says why."""
    paths, _ = stores
    b = make_batcher(paths, 2, BUCKETS, seed=1, uniform=True)
    assert isinstance(b, StoreGraphBatcher)
    assert "native .b3d loader" in capsys.readouterr().out
    monkeypatch.setattr(store_data, "native_available", lambda: False)
    monkeypatch.setattr(store_data, "native_error", lambda: "g++ failed (1):\nno compiler")
    monkeypatch.setattr(jax_store_data, "native_available", lambda: False)
    tb = make_batcher(paths, 2, BUCKETS, seed=1, uniform=True)
    out = capsys.readouterr().out
    assert "numpy reader" in out and "no compiler" in out
    jb = jax_store_data.make_batcher(paths, 2, BUCKETS, seed=1, uniform=True)
    assert isinstance(tb, GraphBatcher) and isinstance(jb, JaxGraphBatcher)
    assert tb.buckets == jb.buckets and len(tb) == len(jb)
    for _ in range(2):
        _assert_same_batches(tb.epoch(), jb.epoch())


def test_pose_epoch_from_store_matches_jax(stores):
    """One epoch of a depth-2 PoseGNN, step by step from each package's
    StoreGraphBatcher (same seed, same weights): the losses agree at
    rtol=1e-4, as the port's trainer tests hold the host path."""
    paths, windows = stores
    cfg_kw = dict(batch_size=2, lr=1e-3, weight_decay=1e-4, loss="cb")
    example = jax_to_padded(windows[0], *BUCKETS[0])
    jt = JaxTrainer(jax_make_model("pose", depth=2), example, JaxGNNConfig(**cfg_kw),
                    fused=False, seed=1)
    port = load_flax_variables(make_model("pose", depth=2),
                               jax.tree.map(np.asarray, jt.variables))
    tt = GNNTrainer(port, GNNConfig(**cfg_kw), device="cpu", init_state_dict=port.state_dict())
    jb = JaxStoreBatcher(paths, 2, BUCKETS, seed=2)
    tb = StoreGraphBatcher(paths, 2, BUCKETS, seed=2)
    jl, tl = [], []
    for j, t in zip(jb.epoch(), tb.epoch(), strict=True):
        jt.state, loss, _ = jt._train_step(jt.state, j)
        jl.append(float(loss))
        tl.append(float(tt.train_step(t)[0]))
    assert len(tl) == len(tb) and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


@pytest.mark.parametrize("uniform", [False, True])
def test_store_batcher_equals_in_memory_batcher(stores, uniform):
    """Over the stores of the same windows, the port's StoreGraphBatcher and
    its in-memory GraphBatcher draw the same batches from the same seed
    (padding windows included), field for field."""
    paths, windows = stores
    sb = StoreGraphBatcher(paths, 3, BUCKETS, seed=6, uniform=uniform)
    mb = GraphBatcher(windows, 3, BUCKETS, seed=6, uniform=uniform)
    assert sb.buckets == mb.buckets and len(sb) == len(mb)
    for _ in range(2):
        for s, m in zip(sb.epoch(), mb.epoch(), strict=True):
            for f in FIELDS:
                a, b = getattr(s, f), getattr(m, f)
                assert a.dtype == b.dtype and torch.equal(a, b), f
