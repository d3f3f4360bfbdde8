"""Device-resident training in the PyTorch port against the JAX package on
the CPU: the stacked datasets (graph, dense and deduplicated encodings),
``GNNTrainer.fit_device`` from the same weights and seed, the device
metrics, and K steps per dispatch (``fused_steps``); on a CUDA card, the
captured steps against eager ones.

The JAX side is imported inside the tests, so the CUDA cases also run on a
machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_fit_device.py``.
"""

import dataclasses
from collections import defaultdict

import numpy as np
import pytest
import torch

from batch3dmot_tpu_torch.config import TRACKING_CLASSES, GNNConfig, GraphConstructionConfig
from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
from batch3dmot_tpu_torch.graphs import build_scene_graphs
from batch3dmot_tpu_torch.models import init_params_, make_model
from batch3dmot_tpu_torch.train import encoded as port_encoded
from batch3dmot_tpu_torch.train.data import (
    GraphBatcher,
    materialize_graph_dataset,
    materialize_graph_datasets,
)
from batch3dmot_tpu_torch.train.encoded import (
    DedupEncodings,
    EncodedGraphBatcher,
    materialize_encoded_dataset,
    materialize_encoded_dataset_dedup,
    materialize_encoded_datasets_dedup,
    precompute_scene_encodings,
)
from batch3dmot_tpu_torch.train.trainer import GNNTrainer, epoch_batches

torch.set_num_threads(1)

BUCKETS = ((32, 128), (64, 256))
SPLIT = ((32, 128), (64, 512))  # the small and the crowded pose windows part
PLURAL = ((16, 32), (32, 128))  # the mm windows part at 16 nodes
LR = 1e-4
GRAPH_FIELDS = ("pose", "node_time", "node_class", "node_mask", "edge_src", "edge_dst",
                "edge_attr", "edge_mask", "edge_label", "edge_weight")


def _windows(seed, frames, tracks, knn, **scene_kw):
    scene = make_synthetic_scene(seed=seed, num_frames=frames, num_tracks=tracks, **scene_kw)
    cfg = GraphConstructionConfig(top_knn_nodes=knn)
    return scene, [w for w in build_scene_graphs(scene, 3, cfg) if w.num_edges > 0]


@pytest.fixture(scope="module")
def pose_windows():
    """Small windows and crowded ones (two buckets of SPLIT), and a
    validation set with a remainder batch at batch size 2. The AP of a
    batch is a step function of its ranking: these scenes have no pair of
    scores within the two packages' f32 rounding of each other."""
    _, small = _windows(0, 8, 4, 4)
    _, crowded = _windows(1, 5, 12, 6, fp_per_frame=2.0)
    _, val = _windows(6, 7, 4, 4)
    return small + crowded, val[: len(val) - 1 + len(val) % 2]


@pytest.fixture(scope="module")
def mm_items():
    """Two scenes with modalities, their windows paired with encodings
    from a seeded flax MultimodalGNN (depth 2), and its variables."""
    import jax

    from batch3dmot_tpu.models import make_model as jax_make_model
    from batch3dmot_tpu.train.data import to_padded
    from batch3dmot_tpu.train.encoded import precompute_scene_encodings as jax_precompute

    scenes = [_windows(s, 7, 5, 4, with_modalities=True, modality_dropout=0.3)
              for s in (3, 4)]
    model = jax_make_model("mm", depth=2)
    variables = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.key(3), to_padded(scenes[0][1][0], *BUCKETS[0])))
    items = []
    for scene, windows in scenes:
        enc = jax_precompute(model, variables, scene, chunk=64)
        items.append([(w, enc) for w in windows])
    return items, variables


def _arrays(tree):
    """Every array of a stacked dataset group (graphs, encodings), either
    package's, as numpy, keyed by name."""
    graphs, enc = tree[0], tree[1]
    out = {f: np.asarray(getattr(graphs, f)) for f in GRAPH_FIELDS}
    if isinstance(enc, tuple) and hasattr(enc, "table"):
        out["det_index"] = np.asarray(enc.det_index)
        enc = enc.table
    for i, a in enumerate(enc or ()):
        out[f"enc{i}"] = np.asarray(a)
    return out


def _assert_groups_equal(got, want):
    got, want = (g if isinstance(g, list) else [g] for g in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[2] == w[2]
        a, b = _arrays(g), _arrays(w)
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("plural", [False, True])
def test_materialize_graph_matches_jax(pose_windows, plural):
    from batch3dmot_tpu.train import data as jax_data

    windows, _ = pose_windows
    if plural:
        got = materialize_graph_datasets(windows, buckets=SPLIT)
        want = jax_data.materialize_graph_datasets(windows, buckets=SPLIT)
        assert len(got) > 1
    else:
        got = materialize_graph_dataset(windows, buckets=SPLIT)
        want = jax_data.materialize_graph_dataset(windows, buckets=SPLIT)
        assert got[1] is None and got[0].pose.shape[0] == len(windows) + 1
    _assert_groups_equal(got, want)


@pytest.mark.parametrize("form", ["dense", "dense-plural", "dedup", "dedup-plural"])
def test_materialize_encoded_matches_jax(mm_items, form):
    from batch3dmot_tpu.train import encoded as jax_encoded

    items = mm_items[0][0] + mm_items[0][1]
    buckets = PLURAL if form.endswith("plural") else BUCKETS
    name = "materialize_encoded_dataset" + ("s" if form.endswith("plural") else "")
    name += "_dedup" if form.startswith("dedup") else ""
    got = getattr(port_encoded, name)(items, buckets=buckets)
    want = getattr(jax_encoded, name)(items, buckets=buckets)
    _assert_groups_equal(got, want)
    if form.startswith("dedup"):
        groups = got if isinstance(got, list) else [got]
        assert all(isinstance(g[1], DedupEncodings) for g in groups)
        assert len({id(g[1].table) for g in groups}) == 1
        d = groups[0][1].table[0].shape[0] - 1
        assert not any(t[d].any() for t in groups[0][1].table)  # the all-zero row
    if form.endswith("plural"):
        assert len(got) > 1 and sum(g[0].pose.shape[0] - 1 for g in got) == len(items)


def _port_from(name, variables, cfg_kw):
    from batch3dmot_tpu_torch.utils.weights import load_flax_variables

    port = load_flax_variables(make_model(name, depth=2), variables)
    return GNNTrainer(port, GNNConfig(**cfg_kw), device="cpu",
                      init_state_dict=port.state_dict())


def _assert_history_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        keys = set(w) - {"epoch_time_s"}
        assert set(g) - {"epoch_time_s"} == keys
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, equal_nan=True, err_msg=k)


def _assert_params_close(tt, jt, steps):
    import jax

    from batch3dmot_tpu_torch.utils.weights import flax_to_state_dict

    want = flax_to_state_dict(jax.tree.map(np.asarray, jt.variables))
    got = tt.model.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=2 * LR * steps + 1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("case", ["pose", "mm-dense", "mm-dedup"])
def test_fit_device_matches_jax(case, pose_windows, mm_items):
    """Two epochs of fit_device against the JAX trainer's (fused=False) from
    the same weights and seed: the same batches (multi-bucket groups and a
    validation set for pose; one group with a remainder batch, or the
    dedup groups of two scenes, and a dense validation set for mm); every
    history entry but the time at rtol 1e-4, the parameters within 2 * lr
    per step."""
    import jax

    from batch3dmot_tpu.models import make_model as jax_make_model
    from batch3dmot_tpu.train import data as jax_data
    from batch3dmot_tpu.train import encoded as jax_encoded
    from batch3dmot_tpu.train.data import to_padded
    from batch3dmot_tpu.train.trainer import GNNTrainer as JaxTrainer
    from batch3dmot_tpu.config import GNNConfig as JaxGNNConfig

    cfg_kw = dict(lr=LR, weight_decay=1e-4, batch_size=2)
    if case == "pose":
        windows, val = pose_windows
        jt = JaxTrainer(jax_make_model("pose", depth=2), to_padded(windows[0], *SPLIT[0]),
                        JaxGNNConfig(**cfg_kw), fused=False, seed=1)
        tt = _port_from("pose", jax.tree.map(np.asarray, jt.variables), cfg_kw)
        jax_args = (jax_data.materialize_graph_datasets(windows, buckets=SPLIT),
                    jax_data.materialize_graph_datasets(val, buckets=SPLIT))
        port_args = (materialize_graph_datasets(windows, buckets=SPLIT),
                     materialize_graph_datasets(val, buckets=SPLIT))
    else:
        (first, second), variables = mm_items
        jt = JaxTrainer(jax_make_model("mm", depth=2), to_padded(first[0][0], *BUCKETS[0]),
                        JaxGNNConfig(**cfg_kw), fused=False, init_variables=variables)
        tt = _port_from("mm", variables, cfg_kw)
        if case == "mm-dense":
            assert len(first) % 2 == 1, "want a remainder batch"
            train, mod_name = first, "materialize_encoded_dataset"
        else:
            train, mod_name = first + second, "materialize_encoded_datasets_dedup"
        buckets = BUCKETS if case == "mm-dense" else PLURAL
        jax_args = (getattr(jax_encoded, mod_name)(train, buckets=buckets),
                    jax_encoded.materialize_encoded_dataset(second, buckets=BUCKETS))
        port_args = (
            (materialize_encoded_dataset if case == "mm-dense"
             else materialize_encoded_datasets_dedup)(train, buckets=buckets),
            materialize_encoded_dataset(second, buckets=BUCKETS))
    want = jt.fit_device(jax_args[0], epochs=2, val_dataset=jax_args[1], verbose=False, seed=11)
    got = tt.fit_device(port_args[0], epochs=2, val_dataset=port_args[1], verbose=False,
                        seed=11)
    _assert_history_close(got, want)
    assert tt.step == int(jt.state.step)
    _assert_params_close(tt, jt, tt.step)


def test_fit_device_matches_host_steps(mm_items):
    """fit_device (batches gathered by index, one fetch per group) against
    train_step on the same index rows of the same stacked arrays, the last
    batch padded with the empty window: same losses and parameters."""
    (first, _), variables = mm_items
    cfg_kw = dict(lr=LR, weight_decay=0.0, batch_size=2)
    tr_dev, tr_host = (_port_from("mm", variables, cfg_kw) for _ in range(2))
    ds = materialize_encoded_dataset(first, buckets=BUCKETS)
    (hist,) = tr_dev.fit_device(ds, epochs=1, verbose=False, seed=7)

    batches = epoch_batches(ds, 2, 7)
    n_items = ds[0].pose.shape[0] - 1
    assert len(batches) == -(-n_items // 2)
    pad = batches[-1][0].edge_mask[n_items % 2:]  # the empty window pads the last batch
    assert n_items % 2 == 1 and not pad.any()
    losses = [float(tr_host.train_step(b)[0]) for b in batches]
    assert hist["train/loss"] == pytest.approx(float(np.mean(losses)), rel=1e-5)
    assert tr_dev.step == tr_host.step == len(batches)
    for (k, a), b in zip(tr_dev.model.state_dict().items(), tr_host.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_device_batch_metrics_match_host(pose_windows):
    """The device metrics (no sigmoid, one shared sort) against the host
    metrics and the JAX package's device metrics on one batch with heavy
    score ties and a class that has masked edges but no positive (NaN)."""
    import jax.numpy as jnp

    from batch3dmot_tpu.graph import PaddedGraph as JaxGraph
    from batch3dmot_tpu.train.trainer import GNNTrainer as JaxTrainer
    from batch3dmot_tpu.config import GNNConfig as JaxGNNConfig

    windows, _ = pose_windows
    batch = next(GraphBatcher(windows, 3, SPLIT).epoch(shuffle=False))
    edge_class = np.take_along_axis(batch.node_class.numpy(), batch.edge_src.numpy(), -1)
    mask = batch.edge_mask.numpy()
    counts = {c: int((mask & (edge_class == i)).sum()) for c, i in TRACKING_CLASSES.items()}
    nan_cls = max(counts, key=counts.get)
    labels = batch.edge_label.numpy().copy()
    labels[edge_class == TRACKING_CLASSES[nan_cls]] = 0.0
    batch = dataclasses.replace(batch, edge_label=torch.from_numpy(labels))
    logits = np.round(np.random.default_rng(0).normal(size=mask.shape) * 2, 1).astype(np.float32)

    tr = GNNTrainer(make_model("pose", depth=2), GNNConfig(batch_size=3), device="cpu")
    host = defaultdict(list)
    tr._batch_metrics(host, "m", 0.0, torch.from_numpy(logits), batch)
    ap, ap_cls, present = (t.numpy() for t in tr._device_batch_metrics(
        torch.from_numpy(logits), batch))
    jt = JaxTrainer.__new__(JaxTrainer)  # the method reads no trainer state
    jbatch = JaxGraph(**{f.name: jnp.asarray(getattr(batch, f.name).numpy())
                         for f in dataclasses.fields(batch)})
    j_ap, j_cls, j_present = (np.asarray(a) for a in jt._device_batch_metrics(
        jnp.asarray(logits), jbatch))

    assert float(ap) == pytest.approx(host["m/avgprec"][0], rel=1e-4)
    assert float(ap) == pytest.approx(float(j_ap), rel=1e-6)
    np.testing.assert_array_equal(present, j_present)
    np.testing.assert_allclose(ap_cls, j_cls, rtol=1e-6, equal_nan=True)
    for i, cname in enumerate(TRACKING_CLASSES):
        key = f"m/avgprec/{cname}"
        assert bool(present[i]) == (key in host), cname
        if present[i]:
            np.testing.assert_allclose(ap_cls[i], host[key][0], rtol=1e-4, equal_nan=True)
    assert np.isnan(host[f"m/avgprec/{nan_cls}"][0])
    assert np.isnan(ap_cls[list(TRACKING_CLASSES).index(nan_cls)])
    # the accumulated history keys are the host path's
    dev = defaultdict(list)
    row = np.concatenate([[0.0, ap], ap_cls, present.astype(np.float32)])
    tr._accumulate_device_metrics(dev, "m", row[None])
    assert set(dev) == set(host)


def test_fused_steps_match_single_steps(pose_windows):
    """One group of 3 steps (stacked once, gathered by index, one fetch)
    against 3 single steps on the same batches, then a whole epoch with
    fused_steps=3 (groups of 3 and a smaller leftover) against the plain
    epoch."""
    windows, _ = pose_windows
    cfg = GNNConfig(lr=LR, weight_decay=1e-4, batch_size=2)
    trainers = [GNNTrainer(make_model("pose", depth=2), cfg, device="cpu", seed=0)
                for _ in range(4)]
    small = [w for w in windows if w.num_nodes <= SPLIT[0][0] and w.num_edges <= SPLIT[0][1]]
    batches = list(GraphBatcher(small, 2, SPLIT[:1], seed=0).epoch())[:3]
    assert len({b.edge_src.shape for b in batches}) == 1
    seq = [float(trainers[0].train_step(b)[0]) for b in batches]
    fused = defaultdict(list)
    trainers[1]._run_fused(fused, batches, 3)
    np.testing.assert_allclose(fused["train/loss"], seq, rtol=1e-6)
    assert trainers[1].step == 3

    plain = trainers[2].train_epoch(GraphBatcher(windows, 2, SPLIT, seed=4), fused_steps=1)
    grouped = trainers[3].train_epoch(GraphBatcher(windows, 2, SPLIT, seed=4), fused_steps=3)
    assert grouped["train/loss"] == pytest.approx(plain["train/loss"], rel=1e-6)
    assert trainers[2].step == trainers[3].step > 3
    for a, b in ((trainers[0], trainers[1]), (trainers[2], trainers[3])):
        for (k, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values()):
            np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=1e-5, atol=1e-7, err_msg=k)


def test_fit_device_keeps_the_sources_it_uses(pose_windows, mm_items):
    """A fit_device call keeps the uploads (and captured steps) of the
    groups it is given again and drops the others; dedup groups share one
    uploaded table; a train_epoch with fused steps drops them all."""
    windows, val = pose_windows
    tr = GNNTrainer(make_model("pose", depth=2), GNNConfig(lr=LR, batch_size=2), device="cpu",
                    seed=0)
    ds, other = (materialize_graph_dataset(w, buckets=SPLIT) for w in (windows, val))
    tr.fit_device(ds, verbose=False)
    kept = tr._sources[id(ds)]
    tr.fit_device(ds, val_dataset=other, verbose=False)
    assert tr._sources[id(ds)] is kept and set(tr._sources) == {id(ds), id(other)}
    tr.fit_device(other, verbose=False)
    assert set(tr._sources) == {id(other)}
    tr.train_epoch(GraphBatcher(windows, 2, SPLIT, seed=0), fused_steps=2)
    assert tr._sources == {}

    (first, second), variables = mm_items
    groups = materialize_encoded_datasets_dedup(first + second, buckets=PLURAL)
    mm = _port_from("mm", variables, dict(lr=LR, batch_size=2))
    resident = mm._upload_dataset_groups(groups)
    assert len(groups) > 1 and len({id(r.enc.table) for r in resident}) == 1
    again = mm._upload_dataset_groups(groups[1:])
    assert all(a is b for a, b in zip(again, resident[1:])) and len(mm._sources) == len(again)


def test_kernel_names_cover_the_sources():
    """The kernel names the traced launch counts look for: every kernel of
    the three sources, templated or not, once."""
    from batch3dmot_tpu_torch.ops.cuda_build import CSRC, kernel_names

    names = kernel_names()
    assert {"edge_kernel", "node_kernel", "edge_bwd_kernel", "wgrad_kernel",
            "segment_sum_kernel"} <= names
    assert len(names) == sum(p.read_text().count("__global__") for p in CSRC.glob("*.cu*"))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fit_device", "fused_steps", "dedup"])
def test_cuda_graphed_steps_match_eager(path):
    """On the card: the captured steps (replayed once per step) against
    eager train_steps on the same batches: the losses step by step at rtol
    1e-4, the parameters within 5e-5 (the two run the same kernels on the
    same batches; an Adam step moves a parameter by about lr = 1e-4). Then
    a run of replays alone, traced by the profiler: the wrappers launch
    nothing, and each of the port's kernels runs steps times as often as in
    one eager step, whose wrappers count one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from batch3dmot_tpu_torch.ops.cuda_build import traced_launches
    from batch3dmot_tpu_torch.ops.fused_mp_train import fused_mp_train_scores

    scene, windows = _windows(3, 7, 5, 4, with_modalities=True, modality_dropout=0.3)
    model = init_params_(make_model("mm"), torch.Generator().manual_seed(0))
    enc = precompute_scene_encodings(model, scene)
    items = [(w, enc) for w in windows]
    cfg = GNNConfig(lr=LR, weight_decay=1e-4, batch_size=2)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    graphed = GNNTrainer(make_model("mm"), cfg, init_state_dict=start)
    eager = GNNTrainer(make_model("mm"), cfg, init_state_dict=start)
    losses = []
    accumulate = graphed._accumulate_device_metrics
    graphed._accumulate_device_metrics = lambda m, prefix, rows: (
        losses.extend(float(r[0]) for r in rows), accumulate(m, prefix, rows))
    if path == "fused_steps":
        batches = list(EncodedGraphBatcher(items, 2, BUCKETS, seed=1, uniform=True).epoch())
        run = lambda: graphed._run_fused(defaultdict(list), batches, len(batches))  # noqa: E731
    else:
        ds = (materialize_encoded_dataset if path == "fit_device"
              else materialize_encoded_dataset_dedup)(items, buckets=BUCKETS)
        batches = epoch_batches(materialize_encoded_dataset(items, buckets=BUCKETS), 2, 7)
        run = lambda: graphed.fit_device(ds, epochs=1, verbose=False, seed=7)  # noqa: E731
    run()
    steps = len(batches)
    assert graphed.graph_replays == steps

    fused_mp_train_scores.fwd_launches = fused_mp_train_scores.bwd_launches = 0
    first = []
    per_step = traced_launches(lambda: first.append(float(eager.train_step(batches[0])[0])))
    assert fused_mp_train_scores.fwd_launches == fused_mp_train_scores.bwd_launches == 1
    want = first + [float(eager.train_step(b)[0]) for b in batches[1:]]
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    for (k, a), b in zip(graphed.model.state_dict().items(), eager.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-5, msg=k)

    fused_mp_train_scores.fwd_launches = fused_mp_train_scores.bwd_launches = 0
    replayed = traced_launches(run)
    assert fused_mp_train_scores.fwd_launches == fused_mp_train_scores.bwd_launches == 0
    assert graphed.graph_replays == 2 * steps
    assert per_step and replayed == {k: steps * v for k, v in per_step.items()}
