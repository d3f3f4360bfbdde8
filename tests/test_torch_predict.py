"""The inference slice end to end, port against JAX package, both on the CPU
with the same weights: encode-once scoring of two synthetic scenes,
cross-window averaging, thresholds, greedy rounding, track clustering, the
submission and AMOTA."""

import jax
import numpy as np
import pytest
import torch

from batch3dmot_tpu.config import GraphConstructionConfig as JaxGCConfig
from batch3dmot_tpu.data.synthetic import make_synthetic_scene as jax_scene
from batch3dmot_tpu.eval.tracking_metrics import evaluate_tracking as jax_evaluate
from batch3dmot_tpu.eval.tracking_metrics import gt_boxes_from_scene as jax_gt
from batch3dmot_tpu.graph import pad_graph as jax_pad
from batch3dmot_tpu.graphs import build_scene_graphs as jax_build
from batch3dmot_tpu.infer import tracks as jax_tracks
from batch3dmot_tpu.infer.predict import SceneEncodedScorer as JaxScorer
from batch3dmot_tpu.infer.predict import make_scorer as jax_make_scorer
from batch3dmot_tpu.infer.predict import predict_scenes as jax_predict_scenes
from batch3dmot_tpu.infer.predict import score_windows as jax_score_windows
from batch3dmot_tpu.models import MultimodalGNN as JaxMM
from batch3dmot_tpu.models import make_model as jax_make_model
from batch3dmot_tpu.train.data import to_padded as jax_to_padded
from batch3dmot_tpu_torch.config import (
    DEFAULT_EDGE_SCORE_THRESHOLDS,
    TRACKING_CLASS_NAMES,
    GraphConstructionConfig,
)
from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
from batch3dmot_tpu_torch.eval.tracking_metrics import evaluate_tracking, gt_boxes_from_scene
from batch3dmot_tpu_torch.graphs import build_scene_graphs
from batch3dmot_tpu_torch.infer import tracks
from batch3dmot_tpu_torch.infer.predict import (
    SceneEncodedScorer,
    make_scorer,
    predict_scenes,
    score_windows,
)
from batch3dmot_tpu_torch.models import make_model
from batch3dmot_tpu_torch.utils.weights import load_flax_variables

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
SCENE = dict(num_frames=6, num_tracks=7, with_modalities=True,
             classes=["car", "car", "pedestrian", "truck"])
WEIGHT_SEED = 2


def _submission(mod, items, preds):
    """hierarchical_clusters -> scene_results -> assemble_submission, track
    ids offset per scene (the predict CLI's assembly)."""
    results, tokens, offset = [], [], 0
    for (scene, _), (pred_edges, _) in zip(items, preds):
        cats = {i: m["category_name"] for i, m in enumerate(scene.metadata)}
        trk = mod.hierarchical_clusters(pred_edges, cats)
        results.append(mod.scene_results(trk, scene, track_id_offset=offset))
        offset += len(trk)
        tokens += mod.all_scene_sample_tokens(scene)
    return mod.assemble_submission(results, tokens)


def _example(jax_items):
    scene, windows = jax_items[0]
    w = windows[0]
    return jax_pad(
        pose=w.pose, edge_src=w.edge_src, edge_dst=w.edge_dst, edge_attr=w.edge_attr,
        node_time=w.node_time, node_class=w.node_class, max_nodes=64, max_edges=256,
        img=scene.img[w.det_index], lidar=scene.lidar[w.det_index],
        radar=scene.radar[w.det_index],
    )


@pytest.fixture(scope="module")
def predictions():
    items = [
        (s, list(build_scene_graphs(s, 3, GraphConstructionConfig(top_knn_nodes=5))))
        for s in (make_synthetic_scene(seed=k, **SCENE) for k in (10, 11))
    ]
    jax_items = [
        (s, list(jax_build(s, 3, JaxGCConfig(top_knn_nodes=5))))
        for s in (jax_scene(seed=k, **SCENE) for k in (10, 11))
    ]
    example = _example(jax_items)
    jm = JaxMM()
    variables = jax.tree.map(
        np.asarray, jax.jit(jm.init)(jax.random.key(WEIGHT_SEED), example)
    )
    ref = jax_predict_scenes(JaxScorer(jm, variables, fused=False), jax_items)

    port = load_flax_variables(make_model("mm"), variables)
    got = predict_scenes(SceneEncodedScorer(port, device="cpu"), items)
    return items, jax_items, ref, got


def _check_scores_and_pred_edges(items, ref, got):
    n_edges = 0
    for (scene, _), (r_edges, r_avg), (g_edges, g_avg) in zip(items, ref, got):
        assert r_avg.keys() == g_avg.keys()
        keys = sorted(r_avg)
        r = np.array([r_avg[k] for k in keys])
        g = np.array([g_avg[k] for k in keys])
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)
        # the seed is chosen so that no averaged score sits within the
        # tolerance of its class threshold: both sides keep the same edges
        thr = np.array([DEFAULT_EDGE_SCORE_THRESHOLDS[
            TRACKING_CLASS_NAMES[int(scene.class_id[a])]] for a, _ in keys])
        assert (np.abs(r - thr) > ATOL + RTOL * thr).all()
        assert [e for e, _ in g_edges] == [e for e, _ in r_edges]
        np.testing.assert_allclose([s for _, s in g_edges], [s for _, s in r_edges],
                                   rtol=RTOL, atol=ATOL)
        n_edges += len(g_edges)
    assert n_edges > 10


def test_scores_and_pred_edges_match(predictions):
    items, _, ref, got = predictions
    _check_scores_and_pred_edges(items, ref, got)


# the frame-wise kNN GATConv: k = 4 of at most 6 same-time candidates, so
# the k-th neighbour is a real choice; these scenes and weights have no kNN
# near-tie, so both sides pick the same neighbours
ACTIVE = dict(knn_conv_mode="active", knn_conv_k=4)


def test_active_scores_and_pred_edges_match(predictions):
    """knn_conv_mode='active': the port's SceneEncodedScorer (the module
    loop) against the JAX SceneEncodedScorer(fused=False), full width,
    depth 6: averaged scores and predicted edges."""
    items, jax_items, _, _ = predictions
    jm = JaxMM(**ACTIVE)
    variables = jax.tree.map(
        np.asarray, jax.jit(jm.init)(jax.random.key(WEIGHT_SEED), _example(jax_items)))
    ref = jax_predict_scenes(JaxScorer(jm, variables, fused=False), jax_items)
    port = load_flax_variables(make_model("mm", **ACTIVE), variables)
    got = predict_scenes(SceneEncodedScorer(port, device="cpu"), items)
    _check_scores_and_pred_edges(items, ref, got)


def test_submission_and_amota_match(predictions):
    items, jax_items, ref, got = predictions
    sub = _submission(tracks, items, got)
    ref_sub = _submission(jax_tracks, jax_items, ref)
    assert sub == ref_sub
    boxes = [b for v in sub["results"].values() for b in v]
    assert boxes
    frames = list(sub["results"].keys())
    res = evaluate_tracking([b for s, _ in items for b in gt_boxes_from_scene(s)],
                            boxes, frames)
    ref_res = jax_evaluate([b for s, _ in jax_items for b in jax_gt(s)], boxes, frames)
    assert np.isfinite(res.amota)
    assert res.amota == ref_res.amota and res.per_class == ref_res.per_class


def _windows_scorer_check(predictions, name, **model_kw):
    items, jax_items, _, _ = predictions
    windows, jax_windows = items[0][1], jax_items[0][1]
    jm = jax_make_model(name, **model_kw)
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.key(WEIGHT_SEED), jax_to_padded(jax_windows[0], 64, 256)))
    ref = jax_score_windows(jax_make_scorer(jm, variables, fused=False), jax_windows)
    port = load_flax_variables(make_model(name, **model_kw), variables)
    got = score_windows(make_scorer(port, device="cpu"), windows)
    assert sum(len(s) for s in got) > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["mm", "pose"])
def test_windows_scorer_matches_jax(predictions, name):
    """The per-window path (``make_scorer``: encoders per window node for
    mm, logits through a sigmoid for pose) against the JAX package's
    ``make_scorer`` on the first scene's windows."""
    _windows_scorer_check(predictions, name)


def test_active_pose_windows_scorer_matches_jax(predictions):
    """``make_scorer`` of an active PoseGNN (the module loop, sigmoid of
    its logits) against the JAX package's on the first scene's windows."""
    _windows_scorer_check(predictions, "pose", **ACTIVE)
