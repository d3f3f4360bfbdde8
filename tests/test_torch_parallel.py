"""Data-parallel GNN training in the PyTorch port (``parallel/mesh.py``,
``GNNTrainer(mesh=)``) on two gloo ranks on the CPU, against the JAX
trainer on ``make_mesh(2)`` and the port in one process, from the same
weights and batches: ``train_step`` twice, ``fit``, ``fit(fused_steps=2)``
and ``fit_device`` (graphs, dense and dedup encodings) for ``PoseGNN`` and
``MultimodalGNN``, with their APs and (pose) validation; and the mesh's own pieces (``make_mesh``,
``shard_batch_fn``, ``fetch_rows``, the split datasets).

The two ranks run once, in a module fixture, and write their results to a
temporary directory; the JAX package runs in this process only (its
imports stay inside the functions, so the spawned ranks import no JAX).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from batch3dmot_tpu_torch.config import GNNConfig, GraphConstructionConfig
from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
from batch3dmot_tpu_torch.graphs import build_scene_graphs
from batch3dmot_tpu_torch.models import make_model
from batch3dmot_tpu_torch.parallel import make_mesh, shard_batch_fn
from batch3dmot_tpu_torch.parallel.mesh import RowTable, fetch_rows, spawn
from batch3dmot_tpu_torch.train.data import GraphBatcher, materialize_graph_dataset
from batch3dmot_tpu_torch.train.encoded import (
    EncodedGraphBatcher,
    materialize_encoded_dataset,
    materialize_encoded_dataset_dedup,
)
from batch3dmot_tpu_torch.train.trainer import GNNTrainer
from batch3dmot_tpu_torch.utils.weights import load_flax_variables

torch.set_num_threads(1)

RANKS = 2
BUCKETS = ((64, 256),)
BATCH = 4
LR = 1e-4
LOSS_REL = 1e-4
RTOL, ATOL = 2e-4, 2e-5
CASES = [f"{m}-{k}" for m in ("pose", "mm") for k in ("steps", "fit", "fused")] + [
    "pose-fit_device", "mm-fit_device-dense", "mm-fit_device-dedup"]


def _scene_windows():
    """Pose windows (two scenes) and mm windows (a scene with modalities)."""
    gc = GraphConstructionConfig(top_knn_nodes=4)
    pose = [w for seed in range(2)
            for w in build_scene_graphs(make_synthetic_scene(seed=seed, num_frames=8,
                                                             num_tracks=5), 3, gc)
            if w.num_edges > 0]
    scene = make_synthetic_scene(seed=2, num_frames=8, num_tracks=5, with_modalities=True,
                                 modality_dropout=0.3)
    mm = [w for w in build_scene_graphs(scene, 3, gc) if w.num_edges > 0]
    return pose, scene, mm


def _inputs(name, case, pose, mm, enc):
    """The batcher (host cases) or the dataset (fit_device cases) of a
    case, for either package: ``enc`` is the mm scene's encodings."""
    pairs = [(w, enc) for w in mm]
    if case == "fit_device":
        return materialize_graph_dataset(pose, buckets=BUCKETS)
    if case == "fit_device-dense":
        return materialize_encoded_dataset(pairs, buckets=BUCKETS)
    if case == "fit_device-dedup":
        return materialize_encoded_dataset_dedup(pairs, buckets=BUCKETS)
    if name == "pose":
        return GraphBatcher(pose, BATCH, BUCKETS, seed=5)
    return EncodedGraphBatcher(pairs, BATCH, BUCKETS, seed=5, uniform=True)


def _val(name, case, pose):
    """The pose cases' validation set: batches for fit, a dataset for
    fit_device."""
    if name != "pose" or case not in ("fit", "fit_device"):
        return {}
    if case == "fit":
        return dict(val_batcher=GraphBatcher(pose[:5], BATCH, BUCKETS, seed=6))
    return dict(val_dataset=materialize_graph_dataset(pose[:5], buckets=BUCKETS))


def _history(hist):
    return [{k: v for k, v in h.items() if k != "epoch_time_s"} for h in hist]


def _run_case(trainer, name, case, inputs, pose):
    """A case's history on a port trainer (each step's loss for
    "steps"; each epoch's losses and APs otherwise)."""
    if case == "steps":
        return [{"train/loss": float(trainer.train_step(b)[0])} for b in list(inputs.epoch())[:2]]
    if case.startswith("fit_device"):
        return _history(trainer.fit_device(inputs, epochs=2, verbose=False, seed=3,
                                           **_val(name, case, pose)))
    return _history(trainer.fit(inputs, epochs=2, verbose=False, **_val(name, case, pose),
                                fused_steps=2 if case == "fused" else 1))


def _port_trainer(name, variables, mesh=None):
    model = load_flax_variables(make_model(name, depth=2), variables)
    kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    return GNNTrainer(model, GNNConfig(lr=LR, weight_decay=1e-4, batch_size=BATCH),
                      init_state_dict=model.state_dict(), **kw)


def _port_cases(variables, enc, mesh=None):
    """Every case on the port: {case: (losses, state dict as numpy, extra)}."""
    pose, _, mm = _scene_windows()
    out = {}
    for case in CASES:
        name, kind = case.split("-", 1)
        trainer = _port_trainer(name, variables[name], mesh)
        losses = _run_case(trainer, name, kind, _inputs(name, kind, pose, mm, enc), pose)
        extra = {}
        if mesh is not None and kind.startswith("fit_device"):
            res = next(iter(trainer._sources.values()))  # the training group
            extra = dict(resident=res.rows.table.shape[0], n_items=res.n_items,
                         table_rows=None if res.enc is None else res.enc.table[0].shape[0])
        out[case] = (losses, {k: v.numpy().copy() for k, v in trainer.model.state_dict().items()},
                     extra)
    return out


def _mesh_pieces(mesh):
    """What the mesh's own functions give on this rank."""
    shard = shard_batch_fn(mesh)
    got = shard({"t": torch.arange(12).reshape(6, 2), "a": np.arange(6.0), "s": 3.0})
    try:
        shard(torch.zeros(3))
        error = None
    except ValueError as err:
        error = str(err)
    # a row table of 8 rows (three dtypes), 4 on each rank; rows fetched by
    # global index, rank r receiving positions r * 2 .. r * 2 + 2
    rows = [torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3) - 7.5,
            torch.arange(8) % 3 == 0, torch.arange(8, dtype=torch.int64) * -1000]
    table = RowTable.split(rows, mesh, mesh.device)
    idx = torch.tensor([7, 0, 2, 5])
    fetched = table.fetch(idx, mesh)
    raw = fetch_rows(torch.arange(4 * 2, dtype=torch.uint8).reshape(4, 2) + 8 * mesh.rank,
                     4 * mesh.rank, torch.tensor([1, 6, 4, 3]), mesh)
    return dict(rank=mesh.rank, size=mesh.size, device=str(mesh.device), backend=mesh.backend,
                shard_t=got["t"].numpy(), shard_a=got["a"], shard_s=got["s"], error=error,
                fetched=[t.numpy() for t in fetched], raw=raw.numpy(),
                table_rows=table.table.shape[0])


def _rank(mesh, tmp):
    import sys

    data = torch.load(f"{tmp}/inputs.pt", weights_only=False)
    out = dict(pieces=_mesh_pieces(mesh), cases=_port_cases(data["variables"], data["enc"], mesh),
               modules=sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "flax", "msgpack", "batch3dmot_tpu")))
    torch.save(out, f"{tmp}/rank{mesh.rank}.pt")


def _jax_case(name, case, variables, enc, pose, mm):
    """A case on the JAX trainer on make_mesh(2) (fused=False, as on the
    CPU): its losses and parameters as a port state dict."""
    import jax

    from batch3dmot_tpu.config import GNNConfig as JaxGNNConfig
    from batch3dmot_tpu.models import make_model as jax_make_model
    from batch3dmot_tpu.parallel import make_mesh as jax_make_mesh
    from batch3dmot_tpu.train import data as jdata
    from batch3dmot_tpu.train import encoded as jenc
    from batch3dmot_tpu.train.data import to_padded
    from batch3dmot_tpu.train.trainer import GNNTrainer as JaxTrainer
    from batch3dmot_tpu_torch.utils.weights import flax_to_state_dict

    example = to_padded((pose if name == "pose" else mm)[0], *BUCKETS[0])
    jt = JaxTrainer(jax_make_model(name, depth=2), example,
                    JaxGNNConfig(lr=LR, weight_decay=1e-4, batch_size=BATCH), fused=False,
                    init_variables=jax.tree.map(jax.numpy.asarray, variables),
                    mesh=jax_make_mesh(RANKS))
    pairs = [(w, enc) for w in mm]
    if case == "fit_device":
        ds = jdata.materialize_graph_dataset(pose, buckets=BUCKETS)
    elif case.startswith("fit_device"):
        ds = (jenc.materialize_encoded_dataset if case.endswith("dense")
              else jenc.materialize_encoded_dataset_dedup)(pairs, buckets=BUCKETS)
    val = {}
    if (name, case) == ("pose", "fit"):
        val = dict(val_batcher=jdata.GraphBatcher(pose[:5], BATCH, BUCKETS, seed=6))
    elif (name, case) == ("pose", "fit_device"):
        val = dict(val_dataset=jdata.materialize_graph_dataset(pose[:5], buckets=BUCKETS))
    if case.startswith("fit_device"):
        hist = _history(jt.fit_device(ds, epochs=2, verbose=False, seed=3, **val))
    else:
        batcher = (jdata.GraphBatcher(pose, BATCH, BUCKETS, seed=5) if name == "pose"
                   else jenc.EncodedGraphBatcher(pairs, BATCH, BUCKETS, seed=5, uniform=True))
        if case == "steps":
            hist = []
            for b in list(batcher.epoch())[:2]:
                jt.state, loss, _ = jt._train_step(jt.state, jt.shard_batch(b))
                hist.append({"train/loss": float(loss)})
        else:
            hist = _history(jt.fit(batcher, epochs=2, verbose=False, **val,
                                   fused_steps=2 if case == "fused" else 1))
    return hist, flax_to_state_dict(jax.tree.map(np.asarray, jt.variables))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results, the port in one process, and the JAX
    trainer on make_mesh(2), case by case."""
    import jax

    from batch3dmot_tpu.models import make_model as jax_make_model
    from batch3dmot_tpu.train.data import to_padded
    from batch3dmot_tpu.train.encoded import precompute_scene_encodings as jax_precompute

    tmp = tmp_path_factory.mktemp("dp")
    pose, scene, mm = _scene_windows()
    variables = {}
    for name, example in (("pose", pose[0]), ("mm", mm[0])):
        model = jax_make_model(name, depth=2)
        variables[name] = jax.tree.map(np.asarray, jax.jit(model.init)(
            jax.random.key(1), to_padded(example, *BUCKETS[0])))
    enc = jax_precompute(jax_make_model("mm", depth=2), variables["mm"], scene, chunk=64)
    torch.save(dict(variables=variables, enc=enc), tmp / "inputs.pt")
    with ThreadPoolExecutor(1) as pool:  # the ranks run while this process works
        spawned = pool.submit(spawn, _rank, RANKS, str(tmp), device="cpu")
        single = _port_cases(variables, enc)
        jax_runs = {case: _jax_case(*case.split("-", 1), variables[case.split("-")[0]], enc,
                                    pose, mm) for case in CASES}
        spawned.result()
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    return ranks, single, jax_runs


def test_spawned_ranks_import_no_jax(runs):
    ranks, _, _ = runs
    assert [r["modules"] for r in ranks] == [[]] * RANKS


@pytest.mark.parametrize("rank", range(RANKS))
def test_mesh_pieces(runs, rank):
    """make_mesh's rank and device, shard_batch_fn (rows, pass-through and
    the JAX package's error) and fetch_rows (every dtype bit for bit)."""
    p = runs[0][rank]["pieces"]
    assert (p["rank"], p["size"], p["device"], p["backend"]) == (rank, RANKS, "cpu", "gloo")
    np.testing.assert_array_equal(p["shard_t"], np.arange(12).reshape(6, 2)[3 * rank: 3 * rank + 3])
    np.testing.assert_array_equal(p["shard_a"], np.arange(6.0)[3 * rank: 3 * rank + 3])
    assert p["shard_s"] == 3.0
    assert p["error"] == f"Dim 0 of size 3 not divisible by mesh size {RANKS}"
    want_idx = [7, 0, 2, 5][2 * rank: 2 * rank + 2]
    full = [np.arange(24, dtype=np.float32).reshape(8, 3) - 7.5, np.arange(8) % 3 == 0,
            np.arange(8) * -1000]
    assert p["table_rows"] == 8 // RANKS
    for got, want in zip(p["fetched"], full, strict=True):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want[want_idx])
    table = np.arange(16, dtype=np.uint8).reshape(8, 2)  # rank r's rows 4r.. hold 8r + ..
    np.testing.assert_array_equal(p["raw"], table[[1, 6, 4, 3][2 * rank: 2 * rank + 2]])


def test_make_mesh_refuses_without_a_card():
    """No fallback: without a GPU the default device raises, and NCCL is
    refused on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(1)
    with pytest.raises(ValueError, match="only gloo"):
        make_mesh(1, "nccl", device="cpu")


@pytest.mark.parametrize("case", CASES)
def test_matches_jax_mesh_and_one_process(runs, case):
    """Each rank's history (losses; for the epoch cases the APs over the
    gathered scores, and validation for pose's fit and fit_device) against
    the JAX trainer on make_mesh(2) and the port in one process (rel
    1e-4), its parameters against both at rtol 2e-4, atol 2e-5, and
    bit-identical on the two ranks."""
    ranks, single, jax_runs = runs
    hist, state, _ = ranks[0]["cases"][case]
    assert ("val/loss" in hist[0]) == (case in ("pose-fit", "pose-fit_device"))
    for ref_hist, ref_state in (jax_runs[case], single[case][:2]):
        assert len(hist) == len(ref_hist)
        for got, want in zip(hist, ref_hist):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=LOSS_REL, equal_nan=True,
                                           err_msg=k)
        assert set(ref_state) <= set(state)
        for k, want in ref_state.items():
            np.testing.assert_allclose(state[k], want, rtol=RTOL, atol=ATOL, err_msg=k)
    other = ranks[1]["cases"][case]
    np.testing.assert_array_equal([list(h.values()) for h in other[0]],
                                  [list(h.values()) for h in hist])
    for k, v in state.items():
        np.testing.assert_array_equal(other[1][k], v, err_msg=k)


@pytest.mark.parametrize("case", [c for c in CASES if "fit_device" in c])
def test_fit_device_splits_windows(runs, case):
    """Each rank holds ceil((n_items + 1) / 2) windows of a fit_device
    group (the empty window included, padded with copies of it); the dedup
    table is whole on every rank."""
    pose, scene, mm = _scene_windows()
    n_windows = len(pose if case.startswith("pose") else mm)
    for rank in runs[0]:
        extra = rank["cases"][case][2]
        assert extra["n_items"] == n_windows
        assert extra["resident"] == -(-(n_windows + 1) // RANKS)
        if case.endswith("dedup"):  # every detection's row and the zero row
            assert extra["table_rows"] == scene.num_detections + 1
