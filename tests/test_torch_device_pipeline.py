"""The device inference pipeline and scoring from precomputed encodings in
the PyTorch port, against the JAX package on the CPU with the same weights:
the window builder (``graphs/build_device.py``), the cross-window averaging
(``device_average_scores``), ``DeviceScenePipeline`` per scene and grouped
in both kNN-conv modes, ``predict_scene(s)_device`` and the dict-form
rounding, and
``SceneEncodedScorer``'s ``encodings``/``encodings_list`` path; on a CUDA
card, the pipeline through the fused kernel against its plain version and
the host path.

The JAX side is imported inside the tests, so the CUDA case also runs on a
machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_device_pipeline.py``.
"""

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from batch3dmot_tpu_torch.config import Config, GraphConstructionConfig, PredictConfig
from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
from batch3dmot_tpu_torch.graphs import build_scene_graphs
from batch3dmot_tpu_torch.graphs.build_device import (
    build_scene_graphs_device,
    build_windows_device,
)
from batch3dmot_tpu_torch.infer import device_pipeline
from batch3dmot_tpu_torch.infer.device_pipeline import (
    DeviceScenePipeline,
    device_average_scores,
    predict_scene_device,
)
from batch3dmot_tpu_torch.infer.predict import (
    SceneEncodedScorer,
    average_scene_edges,
    greedy_round,
    predict_scenes,
    threshold_edges,
)
from batch3dmot_tpu_torch.models import init_params_, make_model
from batch3dmot_tpu_torch.train.encoded import precompute_scene_encodings

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
BUCKETS = ((64, 256),)
SCENE = dict(seed=7, num_frames=6, num_tracks=4, with_modalities=True, modality_dropout=0.3)
# kNN-conv k = 3 of at most 4 same-time candidates: the k-th neighbour is a
# real choice, and this scene and these weights have no near-tie there
ACTIVE = dict(knn_conv_mode="active", knn_conv_k=3)


def _scene_pair(**kw):
    """The same synthetic scene from the port's and the JAX package's
    generators."""
    from batch3dmot_tpu.data.synthetic import make_synthetic_scene as jax_scene

    return make_synthetic_scene(**kw), jax_scene(**kw)


def _windows(scene, window_len, knn=4):
    cfg = GraphConstructionConfig(top_knn_nodes=knn)
    return [w for w in build_scene_graphs(scene, window_len, cfg) if w.num_edges > 0]


def _jax_variables(windows, seed=0, **model_kw):
    """Seeded flax variables of a depth-2 MultimodalGNN and the port model
    that holds them."""
    import jax

    from batch3dmot_tpu.models import MultimodalGNN as JaxMM
    from batch3dmot_tpu.train.data import to_padded
    from batch3dmot_tpu_torch.utils.weights import load_flax_variables

    jm = JaxMM(depth=2, **model_kw)
    variables = jax.tree.map(
        np.asarray, jax.jit(jm.init)(jax.random.key(seed), to_padded(windows[0], *BUCKETS[0])))
    port = load_flax_variables(make_model("mm", depth=2, **model_kw), variables)
    return jm, variables, port.eval()


def _half_points(scene):
    """The scene with float16 lidar and radar points."""
    return dataclasses.replace(scene, lidar=scene.lidar.astype(np.float16),
                               radar=scene.radar.astype(np.float16))


def _assert_same_averages(got, want):
    """The same edge keys, each mean within 2e-4 |v| + 2e-5."""
    assert set(got) == set(want) and want
    for key, v in want.items():
        assert abs(got[key] - v) <= RTOL * abs(v) + ATOL, (key, got[key], v)


# ---------------------------------------------------------------------------
# The window builder
# ---------------------------------------------------------------------------


def _padded_args(scene, window_len, m_pad):
    m = scene.num_detections
    pad1 = lambda a, v=0: np.pad(a, (0, m_pad - m), constant_values=v)  # noqa: E731
    pad2 = lambda a: np.pad(a, ((0, m_pad - m), (0, 0)))  # noqa: E731
    return [
        pad1(scene.frame_idx.astype(np.int32)),
        pad2(scene.center_g.astype(np.float32)),
        pad1(scene.yaw_g.astype(np.float32)),
        pad2(scene.vel_g.astype(np.float32)),
        pad2(scene.center_e.astype(np.float32)),
        pad1(scene.yaw_e.astype(np.float32)),
        pad2(scene.vel_e.astype(np.float32)),
        pad2(scene.wlh.astype(np.float32)),
        pad1(scene.class_id.astype(np.int32)),
        pad1(scene.score.astype(np.float32)),
        pad1(scene.token_id.astype(np.int32), -1),
        pad1(np.ones(m, bool), False),
        # the real windows, then two parked ones past every frame
        np.array([*range(scene.num_frames - window_len + 1), 1 << 20, 1 << 20], np.int32),
    ]


@pytest.mark.parametrize("seed", [0, 3])
def test_build_windows_device_matches_jax(seed):
    """All windows of a scene in one call, port against JAX (as
    tests/test_graph_build.py:276 holds the JAX builder): indices, masks,
    times, classes and labels equal; pose, edge attributes and weights at
    1e-5. Then the unpacked windows against the port's host builder: the
    same nodes and the same labelled edge sets."""
    from batch3dmot_tpu.graphs.build_device import build_windows_device as jax_build

    scene = make_synthetic_scene(seed=seed, num_frames=8, num_tracks=8)
    args = _padded_args(scene, 3, -(-scene.num_detections // 64) * 64)
    kw = dict(window_len=3, k=5, max_nodes=32)
    want = {k: np.asarray(v) for k, v in jax_build(*args, **kw).items()}
    got = build_windows_device(*(torch.from_numpy(a) for a in args), **kw)
    assert set(got) == set(want)
    for key in ("det_index", "node_mask", "node_time", "node_class", "edge_mask",
                "edge_src", "edge_dst", "edge_label", "num_nodes"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    for key in ("pose", "edge_attr", "edge_weight"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    assert got["edge_mask"].any(dim=1)[:-2].all() and not got["edge_mask"][-2:].any()

    cfg = GraphConstructionConfig(top_knn_nodes=5)
    host = list(build_scene_graphs(scene, 3, cfg))
    dev = build_scene_graphs_device(scene, 3, cfg, device="cpu")
    assert len(host) == len(dev)
    for a, b in zip(host, dev):
        np.testing.assert_array_equal(a.det_index, b.det_index)
        np.testing.assert_allclose(a.pose, b.pose, rtol=1e-5, atol=1e-5)
        assert (sorted(zip(a.edge_src.tolist(), a.edge_dst.tolist(), a.edge_label.tolist()))
                == sorted(zip(b.edge_src.tolist(), b.edge_dst.tolist(),
                              b.edge_label.tolist())))


# ---------------------------------------------------------------------------
# Cross-window averaging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window_len", [2, 3, 4])
def test_device_average_scores_matches_jax(window_len):
    """Random window grids over a frame-major scene (some windows parked),
    sources drawn from a few detections so that rows hold duplicates: the
    JAX package's packed result and the port's (src, mean) pair give equal
    source rows. At window length 2 the scores pass through unchanged; above
    it the port's means equal the float64 run means at rtol 1e-6, and the
    JAX package's at rtol 1e-6 beside the rounding of its float32 prefix
    sums: a mean is the difference of two of them, and a float32 sum over a
    destination's R slots is off by at most (R-1)/2 eps times the sum of
    their magnitudes, so two differ by at most (R-1) eps times it."""
    from batch3dmot_tpu.infer.device_pipeline import device_average_scores as jax_avg

    rng = np.random.default_rng(window_len)
    frames, k, n = 9, 4, 24
    m_pad = 64
    frame_idx = np.sort(rng.integers(0, frames, 50)).astype(np.int32)
    frame_idx = np.pad(frame_idx, (0, m_pad - 50))
    det_mask = np.arange(m_pad) < 50
    real = frames - window_len + 1
    starts = np.full(8, 1 << 20, np.int32)
    starts[:real] = np.arange(real)
    scores = rng.random((8, n, k)).astype(np.float32)
    gsrc = rng.integers(0, 6, (8, n, k)).astype(np.int32)
    emask = rng.random((8, n, k)) < 0.8
    args = (scores, gsrc, emask, frame_idx, det_mask, starts)

    packed = np.asarray(jax_avg(*args, window_len=window_len))
    src, mean = device_average_scores(*(torch.from_numpy(a) for a in args),
                                      window_len=window_len)
    src, mean = src.numpy(), mean.numpy()
    np.testing.assert_array_equal(src, packed[0])
    assert (src >= 0).sum() > 100

    if window_len == 2:
        # one window per edge: the slots pass through, nothing is summed
        np.testing.assert_array_equal(mean, packed[1].view(np.float32))
        return
    # the float64 run means of every (dst, src) pair, from the same slots
    ref = np.zeros_like(mean, np.float64)
    row_abs = np.zeros(m_pad)  # sum of |score| over each destination's R slots
    lo = np.searchsorted(np.where(det_mask, frame_idx, 2 ** 30), starts)
    for d in np.nonzero(det_mask)[0]:
        runs = {}
        for w in range(frame_idx[d] - window_len + 1, frame_idx[d]):
            r = d - lo[w] if 0 <= w < 8 and starts[w] == w else -1
            if 0 <= r < n:
                for a, v, ok in zip(gsrc[w, r], scores[w, r], emask[w, r]):
                    if ok:
                        runs.setdefault(int(a), []).append(float(v))
        row_abs[d] = sum(abs(v) for vs in runs.values() for v in vs)
        for slot in np.nonzero(src[d] >= 0)[0]:
            ref[d, slot] = np.mean(runs.pop(int(src[d, slot])))
        assert not runs
    np.testing.assert_allclose(mean, ref, rtol=1e-6)
    jax_mean = packed[1].view(np.float32)
    prefix = ((window_len - 1) * k - 1) * np.finfo(np.float32).eps * row_abs[:, None]
    bad = np.abs(mean - jax_mean) > 1e-6 * np.abs(jax_mean) + prefix
    assert not bad.any(), (np.argwhere(bad), mean[bad], jax_mean[bad])


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def noop_setup():
    """Scene, windows, the JAX model and variables, the port model."""
    scene, _ = _scene_pair(**SCENE)
    windows = _windows(scene, 3)
    jm, variables, port = _jax_variables(windows)
    return scene, windows, jm, variables, port


@pytest.mark.parametrize("mode", ["noop", "active"])
def test_pipeline_matches_jax_and_host_path(noop_setup, mode):
    """DeviceScenePipeline.score_scene, port against the JAX pipeline on the
    same scene and weights (tests/test_infer.py:306; the JAX side runs its
    unfused loop on the CPU, the port its kernel's plain version in
    'noop' mode and its module loop in 'active' mode), and against the
    port's host path (SceneEncodedScorer + average_scene_edges)."""
    from batch3dmot_tpu.infer.device_pipeline import DeviceScenePipeline as JaxPipeline

    scene, windows, jm, variables, port = noop_setup
    jax_scene = _scene_pair(**SCENE)[1]
    if mode == "active":
        jm, variables, port = _jax_variables(windows, **ACTIVE)
    want = JaxPipeline(jm, variables, window_len=3, k=4).score_scene(jax_scene)
    pipe = DeviceScenePipeline(port, 3, 4, device="cpu")
    assert pipe.fused == (mode == "noop")
    got = pipe.score_scene(scene)
    _assert_same_averages(got, want)
    host = average_scene_edges(
        windows, SceneEncodedScorer(port, device="cpu").score_scene(scene, windows, 4, BUCKETS))
    _assert_same_averages(got, host)


def test_pipeline_merges_edges_seen_in_three_windows():
    """Window length 4 (up to 3 observations of an edge, the sorted
    run-mean path): port against the JAX pipeline and against the host
    average (tests/test_infer.py:379)."""
    from batch3dmot_tpu.infer.device_pipeline import DeviceScenePipeline as JaxPipeline

    kw = dict(seed=11, num_frames=9, num_tracks=5, with_modalities=True, modality_dropout=0.2)
    scene, jax_scene = _scene_pair(**kw)
    windows = _windows(scene, 4)
    obs = Counter((int(a), int(b)) for w in windows
                  for a, b in zip(w.det_index[w.edge_src], w.det_index[w.edge_dst]))
    assert max(obs.values()) >= 3
    jm, variables, port = _jax_variables(windows)
    got = DeviceScenePipeline(port, 4, 4, device="cpu").score_scene(scene)
    _assert_same_averages(got, JaxPipeline(jm, variables, window_len=4, k=4).score_scene(
        jax_scene))
    host = average_scene_edges(
        windows, SceneEncodedScorer(port, device="cpu").score_scene(scene, windows, 4, BUCKETS))
    _assert_same_averages(got, host)


def test_pipeline_fused_matches_module_loop(noop_setup):
    """fused=False (the model's module loop) against the kernel's plain
    version (tests/test_pallas_mp.py:130)."""
    scene, _, _, _, port = noop_setup
    a = DeviceScenePipeline(port, 3, 4, fused=False, device="cpu").score_scene(scene)
    b = DeviceScenePipeline(port, 3, 4, device="cpu").score_scene(scene)
    _assert_same_averages(a, b)


def test_pipeline_f16_points_close_to_f32(noop_setup):
    """Half-precision lidar and radar upload as they are and are upcast on
    the device: the same edges, scores within 5e-3 of the float32 run
    (tests/test_infer.py:340). point_dtype="float16" casts float32 points
    for the upload and gives the same scores as half-precision points."""
    scene, _, _, _, port = noop_setup
    pipe = DeviceScenePipeline(port, 3, 4, device="cpu")
    full = pipe.score_scene(scene)
    half = pipe.score_scene(_half_points(scene))
    assert set(full) == set(half) and full
    assert max(abs(full[k] - half[k]) for k in full) < 5e-3
    assert DeviceScenePipeline(port, 3, 4, device="cpu", point_dtype="float16").score_scene(
        scene) == half


def test_pipeline_grouped_matches_singles(monkeypatch):
    """score_scenes over a group of scenes of other sizes and a windowless
    one equals per-scene score_scene within 1e-5 (tests/test_infer.py:560
    without the mesh half), grouped and with the density routing sending
    the group scene by scene."""
    scenes = [make_synthetic_scene(seed=s, num_frames=f, num_tracks=t, with_modalities=True,
                                   modality_dropout=0.3)
              for s, f, t in ((1, 6, 4), (2, 8, 3), (3, 5, 5))]
    scenes.append(make_synthetic_scene(seed=4, num_frames=2, num_tracks=2,
                                       with_modalities=True))
    model = init_params_(make_model("mm", depth=2), torch.Generator().manual_seed(0))
    pipe = DeviceScenePipeline(model, 3, 4, device="cpu")
    singles = [pipe.score_scene(s) for s in scenes]
    assert singles[-1] == {} and all(singles[:-1])
    pending = pipe.dispatch_scenes(scenes)
    assert pending[0] == "group" and pending[2] == [0, 1, 2]
    monkeypatch.setattr(device_pipeline, "_GROUP_WORK_CEILING", 0)
    routed = pipe.dispatch_scenes(scenes)
    assert routed[0] == "singles"
    for grouped in (pipe.finalize_scenes(pending), pipe.finalize_scenes(routed)):
        assert len(grouped) == len(scenes)
        for single, grp in zip(singles, grouped):
            assert set(single) == set(grp)
            for key in single:
                assert abs(single[key] - grp[key]) < 1e-5, key


def test_predict_scene_device_matches_predict_scenes(noop_setup):
    """predict_scenes_device (Config-driven: window 3, kNN 4, groups of
    two scenes, float16 point uploads) and the host path's predict_scenes
    on the same float16 points give the same predicted edges and averages;
    a windowless scene gives none; predict_scene_device is the one-scene
    form."""
    scene, _, _, _, port = noop_setup
    other = make_synthetic_scene(seed=8, num_frames=5, num_tracks=3, with_modalities=True)
    empty = make_synthetic_scene(seed=4, num_frames=2, num_tracks=2, with_modalities=True)
    scenes = [scene, empty, other]
    cfg = Config(graph_construction=GraphConstructionConfig(top_knn_nodes=4),
                 predict=PredictConfig(batch_size_graph=3, scenes_per_batch=2))
    got = device_pipeline.predict_scenes_device(port, scenes, cfg, device="cpu")
    assert got[1] == ([], {})
    assert predict_scene_device(port, scene, cfg, device="cpu") == got[0]
    host = predict_scenes(
        SceneEncodedScorer(port, device="cpu"),
        [(_half_points(sc), _windows(sc, 3)) for sc in (scene, other)], cfg.predict, BUCKETS)
    for (pred, avg), (pred_host, avg_host) in zip((got[0], got[2]), host):
        _assert_same_averages(avg, avg_host)
        assert pred and {e for e, _ in pred} == {e for e, _ in pred_host}


def test_dict_rounding_matches_jax():
    """threshold_edges and greedy_round (dict views over the array forms)
    against the JAX package's dict loops, on averages with tied scores:
    the same kept edges."""
    from batch3dmot_tpu.infer.predict import greedy_round as jax_round
    from batch3dmot_tpu.infer.predict import threshold_edges as jax_threshold

    scene = make_synthetic_scene(seed=5, num_frames=6, num_tracks=6)
    rng = np.random.default_rng(0)
    m = scene.num_detections
    pairs = {(int(a), int(b)) for a, b in rng.integers(0, m, (6 * m, 2)) if a != b}
    # scores on a coarse grid, so that many of a node's edges tie
    avg = {e: float(rng.integers(0, 8)) / 8 for e in sorted(pairs, key=lambda e: rng.random())}
    kept = threshold_edges(avg, scene)
    assert kept == jax_threshold(avg, scene) and 0 < len(kept) < len(avg)
    got, want = greedy_round(kept), jax_round(kept)
    assert len(got) == len(set(got)) and set(got) == set(want)
    assert threshold_edges({}, scene) == {} and greedy_round({}) == []


# ---------------------------------------------------------------------------
# Scoring from precomputed encodings
# ---------------------------------------------------------------------------


def test_encodings_path_matches_raw_and_jax(noop_setup):
    """Scores from precomputed encodings against the raw encode
    (tests/test_infer.py:609): float32 transport within 1e-6, float16
    within 5e-3, per scene and in the grouped dispatch (two scenes at
    rows g * m_pad); the float16 path against the JAX package's on the same
    encodings; a list that misses a scene is refused."""
    from batch3dmot_tpu.infer.predict import SceneEncodedScorer as JaxScorer

    scene, windows, jm, variables, port = noop_setup
    enc = precompute_scene_encodings(port, scene, device="cpu")
    raw = SceneEncodedScorer(port, device="cpu").score_scene(scene, windows, 4, BUCKETS)
    f32 = SceneEncodedScorer(port, device="cpu", embedding_dtype="float32")
    f16 = SceneEncodedScorer(port, device="cpu")
    s32 = f32.score_scene(scene, windows, 4, BUCKETS, encodings=enc)
    s16 = f16.score_scene(scene, windows, 4, BUCKETS, encodings=enc)
    for a, b, c in zip(raw, s32, s16):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        assert c.shape == a.shape
        np.testing.assert_allclose(c, a, atol=5e-3)

    # the transport itself: float16-rounded embeddings, upcast on the device
    x_img = f16._enc_from_tables([enc], 64)[0][: scene.num_detections].numpy()
    np.testing.assert_array_equal(x_img, enc["x_img"].astype(np.float16).astype(np.float32))
    assert not np.array_equal(x_img, enc["x_img"])

    want = JaxScorer(jm, variables, fused=False).score_scene(
        _scene_pair(**SCENE)[1], windows, 4, BUCKETS, encodings=enc)
    for a, b in zip(s16, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)

    other = make_synthetic_scene(seed=8, num_frames=5, num_tracks=3, with_modalities=True)
    other_windows = _windows(other, 3)
    encs = [enc, precompute_scene_encodings(port, other, device="cpu")]
    for scorer in (f32, f16):
        grouped = scorer.score_scenes([scene, other], [windows, other_windows], 4, BUCKETS,
                                      m_pad=64, encodings_list=encs)
        for sc, ws, e, got in zip((scene, other), (windows, other_windows), encs, grouped):
            single = scorer.score_scene(sc, ws, 4, BUCKETS, m_pad=64, encodings=e)
            for a, b in zip(got, single):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="every scene"):
        f16.score_scenes([scene, other], [windows, other_windows], 4, BUCKETS,
                         encodings_list=[enc])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_pipeline_matches_plain_and_host_path():
    """On the card: the pipeline through the fused kernel (one launch per
    scene dispatch and one per group) against the same pipeline with the
    kernel's plain version, against the host path, and grouped against
    per-scene."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from batch3dmot_tpu_torch.ops import fused_mp

    scenes = [make_synthetic_scene(seed=s, num_frames=7, num_tracks=6, with_modalities=True,
                                   modality_dropout=0.3) for s in (1, 2)]
    model = init_params_(make_model("mm"), torch.Generator().manual_seed(0))
    pipe = DeviceScenePipeline(model, 3, 4)
    fused_mp.fused_mp_scores.launches = 0
    got = [pipe.score_scene(s) for s in scenes]
    assert fused_mp.fused_mp_scores.launches == 2
    grouped = pipe.score_scenes(scenes)
    assert fused_mp.fused_mp_scores.launches == 3
    kernel = fused_mp.fused_mp_scores_cuda
    fused_mp.fused_mp_scores_cuda = fused_mp.fused_mp_scores_plain
    try:
        plain = [pipe.score_scene(s) for s in scenes]
    finally:
        fused_mp.fused_mp_scores_cuda = kernel
    for scene, a, b, c in zip(scenes, got, plain, grouped):
        _assert_same_averages(a, b)
        assert set(a) == set(c) and all(abs(a[k] - c[k]) < 1e-5 for k in a)
        windows = _windows(scene, 3)
        host = average_scene_edges(windows, SceneEncodedScorer(model).score_scene(
            scene, windows, 4, BUCKETS))
        _assert_same_averages(a, host)
