"""The port's host side against the JAX package: synthetic scenes, window
graph construction and the padding contract."""

import dataclasses

import numpy as np
import pytest
import torch

from batch3dmot_tpu.config import GraphConstructionConfig as JaxGCConfig
from batch3dmot_tpu.data.synthetic import make_synthetic_scene as jax_scene
from batch3dmot_tpu.graphs import build_scene_graphs as jax_build
from batch3dmot_tpu_torch.config import GraphConstructionConfig
from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
from batch3dmot_tpu_torch.graph import (
    DEFAULT_BUCKETS,
    batch_graphs,
    empty_graph,
    pad_graph,
    pick_bucket,
)
from batch3dmot_tpu_torch.graphs import build_scene_graphs

torch.set_num_threads(1)


def _assert_same(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
            assert x.dtype == y.dtype, f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scene_and_windows_equal_jax(seed):
    kw = dict(seed=seed, num_frames=8, num_tracks=9, with_modalities=True,
              classes=["car", "car", "pedestrian", "truck"])
    scene, ref = make_synthetic_scene(**kw), jax_scene(**kw)
    _assert_same(scene, ref)
    windows = list(build_scene_graphs(scene, 4, GraphConstructionConfig(top_knn_nodes=6)))
    ref_windows = list(jax_build(ref, 4, JaxGCConfig(top_knn_nodes=6)))
    assert len(windows) == len(ref_windows) == 5
    assert sum(w.num_edges for w in windows) > 0
    for w, r in zip(windows, ref_windows):
        _assert_same(w, r)


def test_pad_graph_contract():
    scene = make_synthetic_scene(seed=4, num_frames=5, num_tracks=5, with_modalities=True)
    w = next(iter(build_scene_graphs(scene, 3, GraphConstructionConfig(top_knn_nodes=4))))
    mn, me = pick_bucket(w.num_nodes, w.num_edges)
    g = pad_graph(
        pose=w.pose, edge_src=w.edge_src, edge_dst=w.edge_dst, edge_attr=w.edge_attr,
        node_time=w.node_time, node_class=w.node_class, max_nodes=mn, max_edges=me,
        img=scene.img[w.det_index], lidar=scene.lidar[w.det_index],
        radar=scene.radar[w.det_index],
    )
    n, e = w.num_nodes, w.num_edges
    assert g.max_nodes == mn and g.max_edges == me
    assert g.img.dtype == torch.uint8  # crops keep their byte dtype
    assert g.node_mask[:n].all() and not g.node_mask[n:].any()
    assert g.edge_mask[:e].all() and not g.edge_mask[e:].any()
    assert (g.edge_src[e:] == 0).all() and (g.edge_dst[e:] == 0).all()
    assert (g.node_time[n:] == -1).all() and (g.node_class[n:] == 0).all()
    assert (g.pose[n:] == 0).all() and (g.edge_attr[e:] == 0).all()
    np.testing.assert_array_equal(g.edge_src[:e].numpy(), w.edge_src)

    fill = empty_graph(mn, me, img_dtype=np.uint8)
    assert not fill.node_mask.any() and not fill.edge_mask.any()
    assert (fill.node_time == -1).all()
    batch = batch_graphs([g, fill])
    assert batch.pose.shape == (2, mn, 19) and batch.edge_src.shape == (2, me)
    with pytest.raises(TypeError):
        batch_graphs([g, empty_graph(mn, me)])  # uint8 img with an f32 fill
    with pytest.raises(ValueError):
        pad_graph(pose=np.zeros((3, 19)), edge_src=np.zeros(0), edge_dst=np.zeros(0),
                  edge_attr=np.zeros((0, 4)), node_time=np.zeros(3),
                  node_class=np.zeros(3), max_nodes=2, max_edges=4)


def test_pick_bucket():
    assert pick_bucket(10, 100) == (64, 256)
    assert pick_bucket(200, 3000) == (256, 4096)
    assert pick_bucket(1024, 32768) == DEFAULT_BUCKETS[-1]
    with pytest.raises(ValueError):
        pick_bucket(1025, 10)
