"""The .b3d graph store of the PyTorch port against the JAX package's, on
the CPU: the writer byte for byte (store and sidecars), each package
reading the other's stores, uint8 crops, the atomic commit, and the native
loader (built by the port into its own build directory) against the JAX
package's loader and the port's ``to_padded``. Arrays are compared exactly
(tolerance 0): the store moves bytes."""

import builtins
import dataclasses

import numpy as np
import pytest
import torch

from batch3dmot_tpu.config import GraphConstructionConfig as JaxGCConfig
from batch3dmot_tpu.data.synthetic import make_synthetic_scene as jax_scene
from batch3dmot_tpu.graphs import build_scene_graphs as jax_build
from batch3dmot_tpu.io import GraphStoreReader as JaxReader
from batch3dmot_tpu.io import save_scene_graphs as jax_save
from batch3dmot_tpu.io import native as jax_native
from batch3dmot_tpu_torch.config import GraphConstructionConfig
from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
from batch3dmot_tpu_torch.graph import PaddedGraph
from batch3dmot_tpu_torch.graphs import build_scene_graphs
from batch3dmot_tpu_torch.io import GraphStoreReader, load_scene_graphs, save_scene_graphs
from batch3dmot_tpu_torch.io import native, store
from batch3dmot_tpu_torch.io.native import (
    NativeGraphStore,
    batch_to_padded_graph,
    native_available,
    native_error,
)
from batch3dmot_tpu_torch.ops.cuda_build import BUILD_DIR
from batch3dmot_tpu_torch.train.data import to_padded

torch.set_num_threads(1)

SCENE = dict(seed=0, num_frames=7, num_tracks=5, with_modalities=True, modality_dropout=0.3)
ARRAYS = ("det_index", "pose", "node_time", "node_class", "edge_src", "edge_dst",
          "edge_attr", "edge_label", "edge_weight", "img", "lidar", "radar")


@pytest.fixture(scope="module")
def scenes():
    """The same synthetic scene and windows from each package."""
    port = make_synthetic_scene(**SCENE)
    jax = jax_scene(**SCENE)
    return ((port, list(build_scene_graphs(port, 3, GraphConstructionConfig(top_knn_nodes=4)))),
            (jax, list(jax_build(jax, 3, JaxGCConfig(top_knn_nodes=4)))))


def _write(save, scene, windows, out_dir):
    return save(windows, str(out_dir), metadata=scene.metadata,
                frame_tokens=[f"{scene.scene_token}_f{i}" for i in range(scene.num_frames)])


def test_store_bytes_match_jax(tmp_path, scenes):
    """For the same windows the port writes the JAX package's file byte for
    byte, and the same metadata and frame sidecars."""
    (scene, windows), (jscene, jwindows) = scenes
    path = _write(save_scene_graphs, scene, windows, tmp_path / "port")
    jpath = _write(jax_save, jscene, jwindows, tmp_path / "jax")
    for suffix in (".b3d", "_metadata.json", "_frames.json"):
        got = open(path.replace(".b3d", suffix), "rb").read()
        want = open(jpath.replace(".b3d", suffix), "rb").read()
        assert got == want, suffix
    assert len(want) > 0


def _same_windows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.scene_token, g.window_start, g.window_len) == (
            w.scene_token, w.window_start, w.window_len)
        for name in ARRAYS:
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_store(tmp_path, scenes, writer):
    """A store written by one package reads, window by window and array by
    array, the same in the other; the header-only sizes agree."""
    (scene, windows), (jscene, jwindows) = scenes
    if writer == "jax":
        path = _write(jax_save, jscene, jwindows, tmp_path)
    else:
        path = _write(save_scene_graphs, scene, windows, tmp_path)
    port_reader, jax_reader = GraphStoreReader(path), JaxReader(path)
    _same_windows(port_reader.windows(), jax_reader.windows())
    _same_windows(load_scene_graphs(path), jax_reader.windows())
    assert port_reader.window_sizes() == jax_reader.window_sizes()
    assert port_reader.window_starts == [w.window_start for w in windows]
    np.testing.assert_array_equal(port_reader.array(1, "edge_attr"), windows[1].edge_attr)


def test_store_preserves_uint8_crops(tmp_path, scenes):
    """uint8 crops stay uint8 on disk, in the numpy reader and in the
    native loader's batch buffer."""
    (_, windows), _ = scenes
    assert windows[0].img.dtype == np.uint8
    path = save_scene_graphs(windows, str(tmp_path))
    loaded = load_scene_graphs(path)
    assert loaded[0].img.dtype == np.uint8
    np.testing.assert_array_equal(loaded[0].img, windows[0].img)
    batch = NativeGraphStore(path).fill_padded_batch([0, 1], 64, 256)
    assert batch["img"].dtype == np.uint8
    np.testing.assert_array_equal(batch["img"][0, : windows[0].num_nodes], windows[0].img)


def test_save_scene_graphs_atomic_on_crash(tmp_path, scenes, monkeypatch):
    """A kill inside the blob writes leaves no .b3d at the final path and no
    temporary file, while the sidecars (written first) are complete; the
    retry succeeds."""
    real_open = builtins.open

    class Boom(RuntimeError):
        pass

    class ExplodingFile:
        def __init__(self, f):
            self._f = f
            self._writes = 0

        def write(self, data):
            self._writes += 1
            if self._writes >= 4:  # inside the blob loop
                raise Boom("simulated kill mid-write")
            return self._f.write(data)

        def __getattr__(self, name):
            return getattr(self._f, name)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return self._f.__exit__(*a)

    def exploding_open(path, mode="r", *a, **k):
        f = real_open(path, mode, *a, **k)
        if "b" in mode and "w" in mode and ".b3d.tmp." in str(path):
            return ExplodingFile(f)
        return f

    (scene, windows), _ = scenes
    monkeypatch.setattr(store, "open", exploding_open, raising=False)
    with pytest.raises(Boom):
        save_scene_graphs(windows, str(tmp_path), metadata=scene.metadata)
    monkeypatch.undo()
    final = tmp_path / f"{scene.scene_token}_len3.b3d"
    assert not final.exists(), "truncated store committed to the final path"
    assert not list(tmp_path.glob("*.tmp*")), "temporary files left behind"
    assert (tmp_path / f"{scene.scene_token}_len3_metadata.json").exists()
    path = save_scene_graphs(windows, str(tmp_path), metadata=scene.metadata)
    assert len(load_scene_graphs(path)) == len(windows)


def _graph_equal(got: PaddedGraph, want: PaddedGraph, what):
    for f in dataclasses.fields(PaddedGraph):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype, (what, f.name, a.dtype, b.dtype)
        assert torch.equal(a, b), (what, f.name)


def test_native_fill_matches_jax_loader_and_to_padded(tmp_path, scenes):
    """The port's library is built from native/graphstore.cc into the
    port's build directory; its fill equals the JAX package's native fill
    field by field, and each slot equals ``to_padded`` of the window (an
    empty slot equals an all-padding window)."""
    (scene, windows), _ = scenes
    assert native_available(), native_error()
    assert native_error() is None
    assert native.library_path().parent == BUILD_DIR and native.library_path().exists()
    path = save_scene_graphs(windows, str(tmp_path))
    st = NativeGraphStore(path)
    n, e = st.window_sizes()
    assert n.tolist() == [w.num_nodes for w in windows]
    assert e.tolist() == [w.num_edges for w in windows]
    idx = list(range(len(windows))) + [-1]
    out = st.fill_padded_batch(idx, 64, 256)
    assert jax_native.native_available(), (
        "the JAX package's native loader (make -C native) did not build; "
        "it is this test's oracle")
    ref = jax_native.NativeGraphStore(path).fill_padded_batch(idx, 64, 256)
    assert out.keys() == ref.keys()
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    g = batch_to_padded_graph(out)
    for slot, w in enumerate(windows):
        want = to_padded(w, 64, 256)
        _graph_equal(PaddedGraph(**{f.name: getattr(g, f.name)[slot]
                                    for f in dataclasses.fields(g)}), want, slot)
    empty = PaddedGraph(**{f.name: getattr(g, f.name)[-1] for f in dataclasses.fields(g)})
    assert not empty.node_mask.any() and not empty.edge_mask.any()
    assert (empty.node_time == -1).all() and not empty.pose.any()
    st.close()


def test_native_over_budget_fill_and_bad_input_raise(tmp_path, scenes):
    """A window over the padding budget, a window index outside the store
    and a file that is not a store raise instead of reading out of bounds."""
    (_, windows), _ = scenes
    st = NativeGraphStore(save_scene_graphs(windows, str(tmp_path)))
    with pytest.raises(ValueError, match="padding budget"):
        st.fill_padded_batch([0], 2, 2)
    for bad in ([len(windows)], [0, -2]):
        with pytest.raises(IndexError):
            st.fill_padded_batch(bad, 64, 256)
    st.close()
    other = tmp_path / "other.b3d"
    other.write_bytes(b"NOPE" + bytes(60))
    with pytest.raises(ValueError, match="not a .b3d file"):
        GraphStoreReader(str(other))
    with pytest.raises(IOError):
        NativeGraphStore(str(other))


def test_native_build_failure_is_reported(tmp_path, monkeypatch):
    """A source that does not compile: native_available() is False and
    native_error() holds the compiler's message."""
    bad = tmp_path / "graphstore.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert not native.native_available()
    assert "g++ failed" in native.native_error() and "error" in native.native_error()
    with pytest.raises(RuntimeError, match="unavailable"):
        NativeGraphStore(str(tmp_path / "x.b3d"))
