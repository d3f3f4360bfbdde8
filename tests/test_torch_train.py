"""GNN training in the PyTorch port against the JAX package on the CPU:
losses and metrics, the window batchers, the frozen-encoder precompute, and
the trainer (loss, gradients and parameters over a few Adam steps) from
the same weights; checkpoints."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batch3dmot_tpu.config import GNNConfig as JaxGNNConfig
from batch3dmot_tpu.config import GraphConstructionConfig
from batch3dmot_tpu.data.synthetic import make_synthetic_scene
from batch3dmot_tpu.graphs import build_scene_graphs
from batch3dmot_tpu.models import make_model as jax_make_model
from batch3dmot_tpu.train import metrics as jax_metrics
from batch3dmot_tpu.train.data import GraphBatcher as JaxGraphBatcher
from batch3dmot_tpu.train.data import group_sizes_by_bucket as jax_groups
from batch3dmot_tpu.train.data import single_bucket_for as jax_single
from batch3dmot_tpu.train.data import to_padded as jax_to_padded
from batch3dmot_tpu.train.data import uniform_bucket as jax_uniform
from batch3dmot_tpu.train.encoded import EncodedGraphBatcher as JaxEncodedBatcher
from batch3dmot_tpu.train.encoded import precompute_scene_encodings as jax_precompute
from batch3dmot_tpu.train.trainer import GNNTrainer as JaxTrainer
from batch3dmot_tpu.train.trainer import average_precision_np as jax_ap_np
from batch3dmot_tpu.utils.checkpoint import epoch_checkpoint_name as jax_ckpt_name
from batch3dmot_tpu_torch.config import GNNConfig
from batch3dmot_tpu_torch.graph import PaddedGraph
from batch3dmot_tpu_torch.models import make_model
from batch3dmot_tpu_torch.train import metrics
from batch3dmot_tpu_torch.train.data import (
    GraphBatcher,
    group_sizes_by_bucket,
    single_bucket_for,
    uniform_bucket,
)
from batch3dmot_tpu_torch.train.encoded import (
    EncodedGraphBatcher,
    precompute_scene_encodings,
)
from batch3dmot_tpu_torch.train.trainer import GNNTrainer, average_precision_np
from batch3dmot_tpu_torch.utils.checkpoint import epoch_checkpoint_name
from batch3dmot_tpu_torch.utils.weights import (
    flax_grads_to_state_dict,
    flax_to_state_dict,
    load_flax_variables,
)

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-3, 2e-4  # atol relative to the leaf's max |value|
BUCKETS = ((32, 128), (64, 256))
FROZEN = ("resnet", "pointnet", "radarnet")


# ---- losses and metrics ---------------------------------------------------


@pytest.mark.parametrize("from_logits", [False, True])
def test_masked_bce_matches_jax(from_logits):
    """Both forms, with scores of exactly 0 and 1 (clipped at 1e-7 in the
    probability form), per-edge weights and a mask."""
    rng = np.random.default_rng(0)
    n = 64
    if from_logits:
        s = rng.normal(0, 4, n).astype(np.float32)
    else:
        s = rng.random(n).astype(np.float32)
        s[:4] = [0.0, 1.0, 0.0, 1.0]
    y = (rng.random(n) < 0.4).astype(np.float32)
    y[:4] = [1.0, 0.0, 0.0, 1.0]
    m = rng.random(n) < 0.8
    m[:4] = True
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    want = float(jax_metrics.masked_bce(*(jnp.asarray(a) for a in (s, y, m, w)),
                                        from_logits=from_logits))
    got = float(metrics.masked_bce(*(torch.from_numpy(a) for a in (s, y, m, w)),
                                   from_logits=from_logits))
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=1e-6)


def _tied_scores(rng, n):
    """Scores with many ties (few distinct values), labels and a mask."""
    s = rng.integers(0, 6, n).astype(np.float32) / 5.0
    y = (rng.random(n) < 0.5).astype(np.float32)
    m = rng.random(n) < 0.85
    return s, y, m


def test_average_precision_with_ties_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(5):
        s, y, m = _tied_scores(rng, 200)
        want = float(jax_metrics.average_precision(*(jnp.asarray(a) for a in (s, y, m))))
        got = float(metrics.average_precision(*(torch.from_numpy(a) for a in (s, y, m))))
        assert got == pytest.approx(want, rel=1e-6)
        assert average_precision_np(s[m], y[m]) == pytest.approx(jax_ap_np(s[m], y[m]))
    no_pos = np.zeros(10, np.float32)
    assert np.isnan(float(metrics.average_precision(
        torch.from_numpy(no_pos), torch.from_numpy(no_pos))))


def test_average_precision_multi_and_accuracy_match_jax():
    rng = np.random.default_rng(2)
    s, y, _ = _tied_scores(rng, 300)
    sels = rng.random((5, 300)) < 0.5
    sels[3] = False  # a row that selects nothing: NaN
    want = np.asarray(jax_metrics.average_precision_multi(
        jnp.asarray(s), jnp.asarray(y), jnp.asarray(sels)))
    got = metrics.average_precision_multi(
        torch.from_numpy(s), torch.from_numpy(y), torch.from_numpy(sels)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)
    for row in range(5):
        one = float(metrics.average_precision(
            torch.from_numpy(s), torch.from_numpy(y), torch.from_numpy(sels[row])))
        np.testing.assert_allclose(one, got[row], rtol=1e-6, equal_nan=True)
    m = sels[0]
    want_acc = float(jax_metrics.masked_accuracy(
        jnp.asarray(s), jnp.asarray(y), jnp.asarray(m.astype(np.float32))))
    got_acc = float(metrics.masked_accuracy(
        torch.from_numpy(s), torch.from_numpy(y), torch.from_numpy(m)))
    assert got_acc == pytest.approx(want_acc)


# ---- batchers and the encoder precompute -----------------------------------


@pytest.fixture(scope="module")
def scene_windows():
    # Gradients are compared element by element: a ReLU whose f32
    # pre-activation lies within rounding of zero takes different branches
    # in two f32 summation orders (seed 4 has one in att_edge_encoder, where
    # the port's f32 and the JAX f32 disagree and float64 sides with JAX),
    # so the scene is one without such a tie.
    scene = make_synthetic_scene(seed=5, num_frames=8, num_tracks=6,
                                 with_modalities=True, modality_dropout=0.3)
    windows = list(build_scene_graphs(scene, 3, GraphConstructionConfig(top_knn_nodes=4)))
    return scene, windows


def test_bucket_choice_matches_jax():
    sizes = [(20, 100), (30, 120), (60, 250), (25, 90)]
    crowded = sizes + [(1000, 30000)]
    for s in (sizes, crowded, []):
        assert uniform_bucket(s) == jax_uniform(s)
    for s in (sizes, crowded):
        assert single_bucket_for(s) == jax_single(s)
        assert group_sizes_by_bucket(s) == jax_groups(s)


def _graph_arrays(g):
    return {f: np.asarray(getattr(g, f)) for f in (
        "pose", "img", "node_mask", "node_class", "edge_src", "edge_dst",
        "edge_attr", "edge_mask", "edge_label", "edge_weight")}


def test_graph_batcher_matches_jax(scene_windows):
    """The same seed gives the same batches, in the same order, over two
    shuffled epochs (incomplete batches filled with padding windows)."""
    _, windows = scene_windows
    jb = JaxGraphBatcher(windows, 3, BUCKETS, seed=7)
    tb = GraphBatcher(windows, 3, BUCKETS, seed=7)
    assert len(jb) == len(tb) and jb.buckets == tb.buckets
    for _ in range(2):
        for j, t in zip(jb.epoch(), tb.epoch(), strict=True):
            for f, a in _graph_arrays(j).items():
                np.testing.assert_array_equal(getattr(t, f).numpy(), a, err_msg=f)


# the frame-wise kNN GATConv: k = 3 of at most 5 same-time candidates (6
# tracks), so the k-th neighbour is a real choice
ACTIVE = dict(knn_conv_mode="active", knn_conv_k=3)


def _mm_variables(windows, **model_kw):
    """flax MultimodalGNN (depth 2) variables with randomised batch-norm
    statistics, so that the encoders' running statistics matter."""
    model = jax_make_model("mm", depth=2, **model_kw)
    example = jax_to_padded(windows[0], *BUCKETS[0])
    variables = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(3), example))
    rng = np.random.default_rng(3)

    def perturb(path, x):
        key = path[-1].key
        if key == "mean":
            return rng.normal(0, 0.5, x.shape).astype(np.float32)
        if key == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        return x

    variables = dict(variables)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        perturb, variables["batch_stats"])
    return model, variables


@pytest.fixture(scope="module")
def mm_variables(scene_windows):
    return _mm_variables(scene_windows[1])


@pytest.fixture(scope="module")
def mm_active_variables(scene_windows):
    return _mm_variables(scene_windows[1], **ACTIVE)


def test_precompute_and_encoded_batcher_match_jax(scene_windows, mm_variables):
    scene, windows = scene_windows
    jmodel, variables = mm_variables
    port = load_flax_variables(make_model("mm", depth=2), variables)
    want = jax_precompute(jmodel, variables, scene, chunk=32)
    got = precompute_scene_encodings(port, scene, chunk=32, device="cpu")
    assert set(got) == set(want)
    for k in want:
        if want[k].dtype == bool:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)

    pairs = [(w, want) for w in windows]
    jb = JaxEncodedBatcher(pairs, 2, BUCKETS, seed=5, uniform=True)
    tb = EncodedGraphBatcher(pairs, 2, BUCKETS, seed=5, uniform=True)
    assert jb.buckets == tb.buckets and len(jb) == len(tb)
    for (jg, je), (tg, te) in zip(jb.epoch(), tb.epoch(), strict=True):
        for f, a in _graph_arrays(jg).items():
            np.testing.assert_array_equal(getattr(tg, f).numpy(), a, err_msg=f)
        for a, b in zip(je, te, strict=True):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---- the trainer -----------------------------------------------------------


def _leaf_close(got, ref, rtol, atol_scale, what):
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-6)
        np.testing.assert_allclose(got[k], r, rtol=rtol, atol=atol_scale * scale,
                                   err_msg=f"{what}: {k}")


# GATConv's attention vectors. a_dst enters only as a_dst . (W x_i), which is
# constant within each destination's softmax segment, so the softmax removes
# it and its gradient comes only through the LeakyReLU kink: a sum of nearly
# cancelling terms (a_src's partly so). Two f32 summation orders land ~1e-3
# apart relative to each other there, and which order a CPU's kernels take
# depends on the host. These leaves are held against a float64 run instead:
# the port's f32 error (max over the leaf) at most twice the JAX package's f32
# error plus 1e-5 of the leaf's largest value.
CANCELLING = ("knn_conv.att_src", "knn_conv.att_dst")


def _as_f64(x):
    if isinstance(x, tuple):
        return tuple(_as_f64(t) for t in x)
    if isinstance(x, PaddedGraph):
        return PaddedGraph(**{f.name: _as_f64(getattr(x, f.name))
                              for f in dataclasses.fields(x)})
    return x.double() if x.dtype == torch.float32 else x


def _f64_grads(jt, tt, jbatch, tbatch):
    """First-step gradients in float64: the port's model.double() on the CPU
    (every sum in f64) and the JAX loss under x64 with its params and batch
    cast (its one-hot segment sums still accumulate in f32, through
    preferred_element_type, so it sits ~1e-5 relative from the port's)."""
    trainer = copy.copy(tt)
    trainer.model = copy.deepcopy(tt.model).double()
    loss, _ = trainer._loss(_as_f64(trainer._to_device(tbatch)))
    loss.backward()
    port = {k: p.grad.numpy() for k, p in trainer.model.named_parameters()
            if p.grad is not None}
    with jax.enable_x64(True):
        cast = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64) if a.dtype == jnp.float32 else a, t)
        extra = cast(jt.state.extra_variables)
        g = jax.grad(lambda p, b: jt._loss(p, extra, b)[0])(
            cast(jt.state.params), cast(jbatch))
        ref = flax_grads_to_state_dict(jax.tree.map(lambda a: np.asarray(a, np.float64), g))
    return port, ref


def _trainers(name, scene_windows, mm_variables, cfg_kw, **model_kw):
    """A JAX GNNTrainer(fused=False) and the port's GNNTrainer (CPU) from
    the same weights, and three host batches for each (the same windows)."""
    scene, windows = scene_windows
    jcfg, cfg = JaxGNNConfig(**cfg_kw), GNNConfig(**cfg_kw)
    if name == "pose":
        jmodel = jax_make_model("pose", depth=2, **model_kw)
        example = jax_to_padded(windows[0], *BUCKETS[0])
        jt = JaxTrainer(jmodel, example, jcfg, fused=False, seed=1)
        jbatches = list(JaxGraphBatcher(windows, 2, BUCKETS, seed=3).epoch())[:3]
        tbatches = list(GraphBatcher(windows, 2, BUCKETS, seed=3).epoch())[:3]
    else:
        jmodel, variables = mm_variables
        example = jax_to_padded(windows[0], *BUCKETS[0])
        jt = JaxTrainer(jmodel, example, jcfg, fused=False, init_variables=variables)
        enc = jax_precompute(jmodel, variables, scene, chunk=64)
        pairs = [(w, enc) for w in windows]
        jbatches = list(JaxEncodedBatcher(pairs, 2, BUCKETS, seed=3, uniform=True).epoch())[:3]
        tbatches = list(EncodedGraphBatcher(pairs, 2, BUCKETS, seed=3, uniform=True).epoch())[:3]
    assert len(jbatches) == 3
    variables = jax.tree.map(np.asarray, jt.variables)
    port = load_flax_variables(make_model(name, depth=2, **model_kw), variables)
    tt = GNNTrainer(port, cfg, device="cpu", init_state_dict=port.state_dict())
    return jt, tt, jbatches, tbatches


def _check_trainer(name, scene_windows, mm_variables, **model_kw):
    """Three Adam steps with weight decay 1e-4 from the same weights: the
    losses, the first step's gradient of every trainable leaf, and the
    parameters after the steps (within 2 * lr per step: Adam may flip the
    sign of a step where a gradient is near zero) agree with the JAX
    trainer's XLA-autodiff path; the frozen encoders do not move at all.
    Returns the port's first-step gradients."""
    lr = 1e-4
    jt, tt, jbatches, tbatches = _trainers(
        name, scene_windows, mm_variables,
        dict(batch_size=2, lr=lr, weight_decay=1e-4, loss="cb"), **model_kw)
    frozen0 = {k: v.clone() for k, v in tt.model.state_dict().items()
               if k.split(".")[0] in FROZEN}

    loss_fn = jax.jit(lambda p, b: jt._loss(p, jt.state.extra_variables, b)[0])
    g_ref = flax_grads_to_state_dict(jax.tree.map(
        np.asarray, jax.grad(loss_fn)(jt.state.params, jbatches[0])))
    cancelling = [k for k in CANCELLING if k in g_ref]
    if cancelling:
        port64, jax64 = _f64_grads(jt, tt, jbatches[0], tbatches[0])
        _leaf_close(port64, jax64, GRAD_RTOL, GRAD_ATOL, f"{name} float64 gradient")
    jl, tl = [], []
    for step, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        jt.state, loss, _ = jt._train_step(jt.state, jb)
        jl.append(float(loss))
        loss_t, _ = tt.train_step(tb)
        tl.append(float(loss_t))
        if step == 0:
            grads = {k: p.grad.numpy() for k, p in tt.model.named_parameters()
                     if p.grad is not None}
            _leaf_close({k: g for k, g in grads.items() if k not in cancelling},
                        {k: g for k, g in g_ref.items() if k not in cancelling},
                        GRAD_RTOL, GRAD_ATOL, f"{name} step-0 gradient")
            for k in cancelling:
                f64 = port64[k]
                err_port = np.abs(grads[k] - f64).max()
                err_jax = np.abs(g_ref[k] - f64).max()
                assert err_port <= 2 * err_jax + 1e-5 * np.abs(f64).max(), (
                    f"{name} step-0 gradient: {k}: |port - f64| {err_port:.3e}, "
                    f"|jax - f64| {err_jax:.3e}")
    np.testing.assert_allclose(tl, jl, rtol=1e-4)

    want = flax_to_state_dict(jax.tree.map(np.asarray, jt.variables))
    got = {k: v.numpy() for k, v in tt.model.state_dict().items() if k in want}
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=2 * lr * 3 + 1e-6, err_msg=k)
    for k, v in frozen0.items():
        assert torch.equal(tt.model.state_dict()[k], v), f"frozen {k} moved"
    assert all(not p.requires_grad for k, p in tt.model.named_parameters()
               if k.split(".")[0] in FROZEN)
    return grads


@pytest.mark.parametrize("name", ["pose", "mm"])
def test_trainer_matches_jax(name, scene_windows, mm_variables):
    """The fused training path (its plain version's autograd on the CPU)
    against the JAX trainer; see :func:`_check_trainer`."""
    _check_trainer(name, scene_windows, mm_variables)


@pytest.mark.parametrize("name", ["pose", "mm"])
def test_active_trainer_matches_jax(name, scene_windows, mm_active_variables):
    """knn_conv_mode='active': the module loop under autograd against the
    JAX trainer's, knn_conv leaves included; see :func:`_check_trainer`.
    The scene and weights have no kNN near-tie, so both sides pick the
    same neighbours in every step."""
    grads = _check_trainer(name, scene_windows, mm_active_variables, **ACTIVE)
    knn = {k: g for k, g in grads.items() if k.startswith("knn_conv.")}
    assert set(knn) == {"knn_conv.lin.weight", "knn_conv.att_src",
                        "knn_conv.att_dst", "knn_conv.bias"}
    assert all(np.abs(g).max() > 0 for g in knn.values())


def test_save_state_round_trip_and_epoch_checkpoint(tmp_path, scene_windows):
    """save_state -> load_state into a fresh trainer gives a bit-identical
    next step (Adam moments and step count included); fit writes an
    AP-stamped epoch checkpoint that loads into a fresh model."""
    _, windows = scene_windows
    cfg = GNNConfig(batch_size=2, lr=1e-3)
    batches = list(GraphBatcher(windows, 2, BUCKETS, seed=0).epoch())
    tr = GNNTrainer(make_model("pose", depth=2), cfg, device="cpu", seed=0)
    tr.train_step(batches[0])
    path = tr.save_state(str(tmp_path / "state.pt"))
    loss_a, _ = tr.train_step(batches[1])
    other = GNNTrainer(make_model("pose", depth=2), cfg, device="cpu", seed=9)
    other.load_state(path)
    assert other.step == 1
    loss_b, _ = other.train_step(batches[1])
    assert float(loss_a) == float(loss_b)
    for (k, a), b in zip(tr.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(a, b), k

    hist = tr.fit(GraphBatcher(windows, 2, BUCKETS, seed=0), val_batcher=GraphBatcher(
        windows, 2, BUCKETS), epochs=1, log_dir=str(tmp_path), verbose=False)
    assert np.isfinite(hist[0]["train/loss"]) and "val/avgprec" in hist[0]
    (ckpt,) = tmp_path.glob("gnn_epoch0_*ValAP*.pt")
    assert (tmp_path / (ckpt.name + ".meta.json")).exists()
    fresh = make_model("pose", depth=2)
    fresh.load_state_dict(torch.load(ckpt, weights_only=True))
    for (k, a), b in zip(tr.model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k


def test_epoch_checkpoint_name_matches_jax():
    args = ("/logs", "gnn", 3, "v1.0-mini", 0.8123456, float("nan"))
    want = jax_ckpt_name(*args)
    got = epoch_checkpoint_name(*args)
    assert want.endswith(".msgpack") and got.endswith(".pt")
    assert got[: -len(".pt")] == want[: -len(".msgpack")]

