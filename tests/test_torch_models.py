"""The port's models against the flax models with the same weights (carried
across by ``batch3dmot_tpu_torch.utils.weights``): frozen encoders,
pre-message-passing, the module forward, and the state-dict bridge."""

import jax
import numpy as np
import pytest
import torch

from batch3dmot_tpu.config import GraphConstructionConfig as JaxGCConfig
from batch3dmot_tpu.data.synthetic import make_synthetic_scene
from batch3dmot_tpu.graph import batch_graphs as jax_batch
from batch3dmot_tpu.graph import pad_graph as jax_pad
from batch3dmot_tpu.graphs import build_scene_graphs
from batch3dmot_tpu.models import make_model as jax_make_model
from batch3dmot_tpu.utils.torch_import import import_mm_gnn, import_pose_gnn
from batch3dmot_tpu_torch.graph import batch_graphs, pad_graph
from batch3dmot_tpu_torch.models import MODEL_REGISTRY, make_model
from batch3dmot_tpu_torch.utils.weights import load_flax_variables

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def windows():
    scene = make_synthetic_scene(
        seed=3, num_frames=6, num_tracks=6, with_modalities=True, modality_dropout=0.3
    )
    ws = [w for w in build_scene_graphs(scene, 3, JaxGCConfig(top_knn_nodes=5))
          if w.num_edges > 0][:3]
    kws = [
        dict(pose=w.pose, edge_src=w.edge_src, edge_dst=w.edge_dst,
             edge_attr=w.edge_attr, node_time=w.node_time, node_class=w.node_class,
             max_nodes=32, max_edges=128, img=scene.img[w.det_index],
             lidar=scene.lidar[w.det_index], radar=scene.radar[w.det_index])
        for w in ws
    ]
    jb = jax_batch([jax_pad(**k) for k in kws])
    tb = batch_graphs([pad_graph(**k) for k in kws])
    return ws, jb, tb


_VARIABLES = {}


def _variables(name, depth, example, seed=0):
    """flax init, with batch-norm statistics randomised so they matter. The
    weights are shared over depth, so one init per family serves every
    depth."""
    model = jax_make_model(name, depth=depth)
    if name not in _VARIABLES:
        variables = jax.tree.map(
            np.asarray, jax.jit(model.init)(jax.random.key(seed), example)
        )
        rng = np.random.default_rng(seed)

        def perturb(path, x):
            key = path[-1].key
            if key == "mean":
                return rng.normal(0, 0.5, x.shape).astype(np.float32)
            if key == "var":
                return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
            return x

        if "batch_stats" in variables:
            variables = dict(variables)
            variables["batch_stats"] = jax.tree_util.tree_map_with_path(
                perturb, variables["batch_stats"]
            )
        _VARIABLES[name] = variables
    return model, _VARIABLES[name]


def _port(name, depth, variables):
    return load_flax_variables(make_model(name, depth=depth), variables).eval()


def test_encode_frozen_uint8_crops_f16_points(windows):
    _, jb, _ = windows
    jm, variables = _variables("mm", 1, jax.tree.map(lambda x: x[0], jb))
    tm = _port("mm", 1, variables)
    rng = np.random.default_rng(11)
    img = (rng.random((6, 32, 32, 3)) * 255).astype(np.uint8)
    lidar = rng.standard_normal((6, 128, 3)).astype(np.float16)
    radar = rng.standard_normal((6, 64, 4)).astype(np.float16)
    ref = jm.apply(variables, img, lidar, radar, method=jm.encode_frozen)
    with torch.no_grad():
        got = tm.encode_frozen(*(torch.from_numpy(a) for a in (img, lidar, radar)))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["mm", "cl_gnn_trad", "pose"])
def test_forward_matches_flax(windows, name):
    """Depth 2, full widths: pre-message-passing outputs and the scores of
    the module forward (logits for pose) on valid edges."""
    ws, jb, tb = windows
    jm, variables = _variables(name, 2, jax.tree.map(lambda x: x[0], jb))
    tm = _port(name, 2, variables)
    with torch.no_grad():
        got, _ = tm(tb)
    ref, _ = jax.vmap(lambda g: jm.apply(variables, g))(jb)
    if name == "pose":
        jpre = jax.vmap(lambda g: jm.apply(variables, g, method=jm.pre_message_passing))(jb)
        with torch.no_grad():
            tpre = tm.pre_message_passing(tb)
    else:
        def enc(g):
            xi, pn, rn = jm.apply(variables, g.img, g.lidar, g.radar, method=jm.encode_frozen)
            return (xi, pn, rn, g.lidar.sum(axis=(1, 2)) != 0, g.radar.sum(axis=(1, 2)) != 0)

        encs = jax.vmap(enc)(jb)
        jpre = jax.vmap(
            lambda g, *e: jm.apply(variables, g, *e, method=jm.pre_message_passing)
        )(jb, *encs)
        with torch.no_grad():
            tpre = tm.pre_message_passing(tb, *(torch.tensor(np.asarray(e)) for e in encs))
    for k, w in enumerate(ws):
        n, e = w.num_nodes, w.num_edges
        np.testing.assert_allclose(got[k, :e].numpy(), np.asarray(ref)[k, :e],
                                   rtol=RTOL, atol=ATOL)
        for r, g in zip(jpre, tpre):
            rows = n if g.shape[1] == 32 else e
            np.testing.assert_allclose(g[k, :rows].numpy(), np.asarray(r)[k, :rows],
                                       rtol=RTOL, atol=ATOL)


def _strip(tree):
    """Nested dict of numpy leaves."""
    return jax.tree.map(np.asarray, tree)


def test_state_dict_round_trip_mm(windows):
    _, jb, _ = windows
    _, variables = _variables("mm", 6, jax.tree.map(lambda x: x[0], jb))
    tm = _port("mm", 6, variables)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    # the upstream bridge reads the classifier heads fc3 and then drops them
    for head in ("pointnet", "radarnet"):
        sd[f"{head}.fc3.weight"] = np.zeros((7, 256), np.float32)
        sd[f"{head}.fc3.bias"] = np.zeros(7, np.float32)
    back = import_mm_gnn(sd)
    assert jax.tree.structure(back) == jax.tree.structure(_strip(variables))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_strip(variables))):
        np.testing.assert_array_equal(a, b)
    assert tm.c2c_att.in_proj_weight.shape == (3 * 96, 96)


def test_state_dict_round_trip_pose(windows):
    _, jb, _ = windows
    _, variables = _variables("pose", 6, jax.tree.map(lambda x: x[0], jb))
    tm = _port("pose", 6, variables)
    back = import_pose_gnn({k: v.numpy() for k, v in tm.state_dict().items()})
    assert jax.tree.structure(back) == jax.tree.structure(_strip(variables))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_strip(variables))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_registry_matches_flax_parameters(windows, name):
    """Every registered family has the flax model's parameters one for one:
    the strict load of a zero tree of the flax shapes fails on any missing,
    extra or misshapen tensor."""
    _, jb, _ = windows
    model = jax_make_model(name, depth=1)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jax.tree.map(lambda x: x[0], jb))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tm = _port(name, 1, zeros)
    n_flax = sum(x.size for x in jax.tree.leaves(zeros["params"]))
    n_attn_qk = sum(2 * m.dim * (m.dim + 1) for n, m in tm.named_modules()
                    if n.endswith("_att"))
    assert sum(p.numel() for p in tm.parameters()) == n_flax + n_attn_qk


def test_knn_conv_modes():
    """'active' models carry the kNN GATConv under PyG's names, 'noop'
    models have none (the flax tree has it only in active mode), and an
    unknown mode is refused by the models and by GNNConfig."""
    from batch3dmot_tpu_torch.config import GNNConfig

    for name in ("mm", "pose"):
        active = make_model(name, knn_conv_mode="active", knn_conv_k=7)
        nd = active.node_dim
        assert active.knn_conv_k == 7
        shapes = {k: tuple(v.shape) for k, v in active.state_dict().items()
                  if k.startswith("knn_conv.")}
        assert shapes == {"knn_conv.lin.weight": (nd, nd), "knn_conv.att_src": (1, 1, nd),
                          "knn_conv.att_dst": (1, 1, nd), "knn_conv.bias": (nd,)}
        assert not any(k.startswith("knn_conv") for k in make_model(name).state_dict())
        with pytest.raises(ValueError, match="knn_conv_mode"):
            make_model(name, knn_conv_mode="discard")
    assert GNNConfig(knn_conv_mode="active").knn_conv_k == 20
    with pytest.raises(ValueError, match="knn_conv_mode"):
        GNNConfig(knn_conv_mode="discard")


_ACTIVE = dict(knn_conv_mode="active", knn_conv_k=4)


@pytest.mark.parametrize("name, depth", [("mm", 3), ("pose", 3)])
def test_active_forward_matches_flax(windows, name, depth):
    """knn_conv_mode='active' at full widths, depth 3 (kNN GATConv before
    layers 0 and 2) and k = 4 of at most 5 same-time candidates per node:
    the module forward (logits for pose) against flax with the weights
    carried by utils/weights.py, knn_conv included. The windows have no
    kNN near-tie, so both sides pick the same neighbours."""
    ws, jb, tb = windows
    jm = jax_make_model(name, depth=depth, **_ACTIVE)
    example = jax.tree.map(lambda x: x[0], jb)
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(5), example))
    assert "knn_conv" in variables["params"]
    tm = load_flax_variables(make_model(name, depth=depth, **_ACTIVE), variables).eval()
    with torch.no_grad():
        got, _ = tm(tb)
    ref, _ = jax.vmap(lambda g: jm.apply(variables, g))(jb)
    for k, w in enumerate(ws):
        np.testing.assert_allclose(got[k, :w.num_edges].numpy(),
                                   np.asarray(ref)[k, :w.num_edges], rtol=RTOL, atol=ATOL)


def test_segment_sum_masked_edges_add_zero():
    from batch3dmot_tpu.ops import segment_sum as jax_segment_sum
    from batch3dmot_tpu_torch.ops.segment import segment_sum

    rng = np.random.default_rng(2)
    data = rng.standard_normal((3, 40, 5)).astype(np.float32)
    ids = rng.integers(0, 7, (3, 40)).astype(np.int32)
    mask = rng.random((3, 40)) < 0.6
    data[~mask] = 1e30  # a masked edge must not reach any sum
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 7,
                      torch.from_numpy(mask)).numpy()
    ref = np.stack([np.asarray(jax_segment_sum(np.where(m[:, None], d, 0), i, 7, m))
                    for d, i, m in zip(data, ids, mask)])
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert np.abs(got).max() < 1e3
