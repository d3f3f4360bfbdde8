"""Per-scene encoding caches and the scene-streaming batcher of the PyTorch
port, on the CPU: the port's forms of the JAX package's streaming tests
(``tests/test_train.py``: the streaming batcher against the in-RAM one,
every window once, ``__len__``, a second epoch from the cache, an encoder
change, a stale row count), a corrupt cache, a cache written by the JAX
package (another digest: rejected and rewritten, and the reverse), and the
streaming batches against the JAX package's under the same weights."""

import os

import jax
import numpy as np
import pytest
import torch

from batch3dmot_tpu.models import make_model as jax_make_model
from batch3dmot_tpu.train.data import to_padded as jax_to_padded
from batch3dmot_tpu.train.encoded import StreamingEncodedBatcher as JaxStreaming
from batch3dmot_tpu.train.encoded import scene_encodings_cached as jax_cached
from batch3dmot_tpu_torch.config import GraphConstructionConfig
from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
from batch3dmot_tpu_torch.graphs import build_scene_graphs
from batch3dmot_tpu_torch.io import load_scene_graphs, save_scene_graphs
from batch3dmot_tpu_torch.models import init_params_, make_model
from batch3dmot_tpu_torch.train import encoded as enc_mod
from batch3dmot_tpu_torch.train.encoded import (
    ENC_KEYS,
    EncodedGraphBatcher,
    StreamingEncodedBatcher,
    _encoder_digest,
    precompute_scene_encodings,
    scene_encodings_cached,
)
from batch3dmot_tpu_torch.utils.weights import load_flax_variables

torch.set_num_threads(1)

# the tolerance tests/test_torch_models.py holds the encoders to
RTOL, ATOL = 2e-4, 2e-5
BUCKETS = ((32, 128), (64, 256))
GRAPH_FIELDS = ("pose", "node_time", "node_class", "node_mask", "edge_src", "edge_dst",
                "edge_attr", "edge_mask", "edge_label", "edge_weight")


def _stores(out_dir, n_scenes):
    """Scene stores on disk and a loader from store path to its scene."""
    gc = GraphConstructionConfig(top_knn_nodes=4)
    by_path = {}
    for seed in range(n_scenes):
        scene = make_synthetic_scene(seed=seed, num_frames=6, num_tracks=5,
                                     with_modalities=True, modality_dropout=0.3)
        windows = list(build_scene_graphs(scene, 3, gc))
        by_path[save_scene_graphs(windows, str(out_dir), metadata=scene.metadata)] = scene
    return list(by_path), by_path.__getitem__


def _model(seed=0):
    return init_params_(make_model("mm", depth=2), torch.Generator().manual_seed(seed))


def _poisoned(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("cache miss: re-encoded a cached scene")

    monkeypatch.setattr(enc_mod, "precompute_scene_encodings", boom)


def test_streaming_matches_in_ram_and_serves_from_cache(tmp_path, monkeypatch):
    """One scene, unshuffled: the streaming batches equal the in-RAM
    EncodedGraphBatcher's (graphs exactly, encodings at RTOL/ATOL), the
    cache file appears, and a second epoch runs with the encoder poisoned."""
    paths, loader = _stores(tmp_path, 1)
    model = _model()
    windows = [w for w in load_scene_graphs(paths[0]) if w.num_edges > 0]
    enc = precompute_scene_encodings(model, loader(paths[0]), chunk=64, device="cpu")
    ram = EncodedGraphBatcher([(w, enc) for w in windows], 2, BUCKETS, seed=0)
    stream = StreamingEncodedBatcher(paths, model, loader, 2, BUCKETS, seed=0, device="cpu")
    assert len(stream) == len(ram)
    for (g_r, e_r), (g_s, e_s) in zip(ram.epoch(shuffle=False), stream.epoch(shuffle=False),
                                      strict=True):
        for f in GRAPH_FIELDS:
            assert torch.equal(getattr(g_r, f), getattr(g_s, f)), f
        for a, b in zip(e_r, e_s, strict=True):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL, atol=ATOL)
    assert os.path.exists(paths[0] + ".enc.npz")
    _poisoned(monkeypatch)
    assert sum(1 for _ in stream.epoch()) == len(stream)


def test_streaming_covers_every_window_once(tmp_path):
    """Every live window of every scene appears once per shuffled epoch,
    and __len__ is the number of batches emitted."""
    paths, loader = _stores(tmp_path, 3)
    stream = StreamingEncodedBatcher(paths, _model(), loader, 2, BUCKETS, seed=1,
                                     uniform=True, device="cpu")
    want = sorted((p, w.window_start) for p in paths for w in load_scene_graphs(p)
                  if w.num_nodes > 0 and w.num_edges > 0)
    starts = {(p, w.window_start): w.pose for p in paths for w in load_scene_graphs(p)}
    got, batches = [], 0
    for g, _ in stream.epoch():
        batches += 1
        for slot in range(g.pose.shape[0]):
            n = int(g.node_mask[slot].sum())
            if n:
                (key,) = [k for k, pose in starts.items()
                          if pose.shape[0] == n and np.array_equal(pose, g.pose[slot, :n].numpy())]
                got.append(key)
    assert sorted(got) == want
    assert batches == len(stream)


def test_cache_invalidates_on_encoder_change(tmp_path):
    """Other encoder weights give another digest: the cache is recomputed."""
    paths, loader = _stores(tmp_path, 1)
    m1, m2 = _model(0), _model(7)
    assert _encoder_digest(m1) != _encoder_digest(m2)
    assert _encoder_digest(m1) == _encoder_digest(_model(0)) and len(_encoder_digest(m1)) == 16
    e1 = scene_encodings_cached(m1, paths[0], loader, device="cpu")
    e1_again = scene_encodings_cached(m1, paths[0], loader, device="cpu")
    np.testing.assert_array_equal(e1["x_img"], e1_again["x_img"])
    e2 = scene_encodings_cached(m2, paths[0], loader, device="cpu")
    assert not np.allclose(e1["x_img"], e2["x_img"])
    with np.load(paths[0] + ".enc.npz") as z:
        assert str(z["digest"]) == _encoder_digest(m2)


def test_stale_row_count_and_corrupt_cache_are_reported_and_recomputed(tmp_path, capsys):
    """A digest-matching cache whose row count disagrees with the store's
    metadata sidecar, and a truncated cache file, each print the JAX
    package's message and are recomputed into a valid cache."""
    paths, loader = _stores(tmp_path, 1)
    model = _model()
    cache_path = paths[0] + ".enc.npz"
    e1 = scene_encodings_cached(model, paths[0], loader, device="cpu")
    rows = len(e1["x_img"])
    assert rows > 1
    with np.load(cache_path) as z:
        full = {k: z[k] for k in z.files}
    np.savez(cache_path, **{k: (v[:-1] if k in ENC_KEYS else v) for k, v in full.items()})
    capsys.readouterr()
    again = scene_encodings_cached(model, paths[0], loader, device="cpu")
    assert "ignoring stale embedding cache" in capsys.readouterr().out
    np.testing.assert_array_equal(again["x_img"], e1["x_img"])
    blob = open(cache_path, "rb").read()
    with open(cache_path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    again = scene_encodings_cached(model, paths[0], loader, device="cpu")
    assert "ignoring unreadable embedding cache" in capsys.readouterr().out
    np.testing.assert_array_equal(again["x_img"], e1["x_img"])
    with np.load(cache_path) as z:
        assert len(z["x_img"]) == rows and str(z["digest"]) == _encoder_digest(model)


@pytest.fixture(scope="module")
def jax_mm():
    """A depth-2 flax MultimodalGNN and its variables (numpy leaves)."""
    jm = jax_make_model("mm", depth=2)
    scene = make_synthetic_scene(seed=0, num_frames=6, num_tracks=5, with_modalities=True)
    first = list(build_scene_graphs(scene, 3, GraphConstructionConfig(top_knn_nodes=4)))[0]
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.key(0), jax_to_padded(first, *BUCKETS[0])))
    return jm, variables


def test_jax_written_cache_is_rejected_and_rewritten(tmp_path, jax_mm):
    """A cache the JAX package wrote carries its digest: the port re-encodes
    and rewrites it with its own (the same encoder outputs, at RTOL/ATOL),
    and the JAX package then rejects the port's cache in turn."""
    paths, loader = _stores(tmp_path, 1)
    cache_path = paths[0] + ".enc.npz"
    jm, variables = jax_mm
    port = load_flax_variables(make_model("mm", depth=2), variables)
    jax_enc = jax_cached(jm, variables, paths[0], loader)
    with np.load(cache_path) as z:
        jax_digest = str(z["digest"])
    assert jax_digest != _encoder_digest(port)
    got = scene_encodings_cached(port, paths[0], loader, device="cpu")
    with np.load(cache_path) as z:
        assert str(z["digest"]) == _encoder_digest(port)
    for k in ENC_KEYS:
        np.testing.assert_allclose(got[k], jax_enc[k], rtol=RTOL, atol=ATOL, err_msg=k)
    jax_cached(jm, variables, paths[0], loader)
    with np.load(cache_path) as z:
        assert str(z["digest"]) == jax_digest


def test_streaming_batches_match_jax(tmp_path, jax_mm):
    """Under the same weights (load_flax_variables) and seed, two shuffled
    uniform epochs over three stores: the graphs equal the JAX streaming
    batcher's exactly, the encodings at RTOL/ATOL."""
    paths, loader = _stores(tmp_path, 3)
    jm, variables = jax_mm
    port = load_flax_variables(make_model("mm", depth=2), variables)
    jb = JaxStreaming(paths, jm, variables, loader, 2, BUCKETS, seed=3, uniform=True,
                      cache=False)
    tb = StreamingEncodedBatcher(paths, port, loader, 2, BUCKETS, seed=3, uniform=True,
                                 cache=False, device="cpu")
    assert len(tb) == len(jb) and tb.buckets == jb.buckets
    for _ in range(2):
        n = 0
        for (jg, je), (tg, te) in zip(jb.epoch(), tb.epoch(), strict=True):
            for f in GRAPH_FIELDS:
                np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                              err_msg=f)
            for a, b in zip(je, te, strict=True):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)
            n += 1
        assert n == len(tb)


@pytest.mark.parametrize("uniform", [False, True])
def test_streaming_len_matches_jax(tmp_path, jax_mm, uniform):
    """``__len__`` and the buckets agree with the JAX batcher's (header-only
    size index), per-window bucketing and uniform."""
    paths, loader = _stores(tmp_path, 3)
    jm, variables = jax_mm
    jb = JaxStreaming(paths, jm, variables, loader, 3, BUCKETS, uniform=uniform, cache=False)
    tb = StreamingEncodedBatcher(paths, _model(), loader, 3, BUCKETS, uniform=uniform,
                                 cache=False, device="cpu")
    assert len(tb) == len(jb) and tb.buckets == jb.buckets
