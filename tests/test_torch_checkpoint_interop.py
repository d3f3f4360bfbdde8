"""The JAX package's checkpoints in the PyTorch port, on the CPU: the
port's msgpack decoder against ``flax.serialization``, GNN epoch
checkpoints and trainer states written by the JAX trainer loaded through
``load_flax_checkpoint`` and scored against the JAX model, standalone
encoder checkpoints grafted by ``merge_encoder_params`` against the JAX
package's grafting, and ``MetricWriter`` records against the JAX writer's."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from batch3dmot_tpu.config import GNNConfig as JaxGNNConfig
from batch3dmot_tpu.config import GraphConstructionConfig as JaxGCConfig
from batch3dmot_tpu.data.synthetic import make_synthetic_scene as jax_scene
from batch3dmot_tpu.graphs import build_scene_graphs as jax_build
from batch3dmot_tpu.infer.predict import make_scorer as jax_make_scorer
from batch3dmot_tpu.infer.predict import score_windows as jax_score_windows
from batch3dmot_tpu.models import make_model as jax_make_model
from batch3dmot_tpu.models.encoders import PointNetClassifier, RadarNetClassifier, ResNetAE
from batch3dmot_tpu.train.data import GraphBatcher as JaxGraphBatcher
from batch3dmot_tpu.train.data import to_padded as jax_to_padded
from batch3dmot_tpu.train.trainer import GNNTrainer as JaxTrainer
from batch3dmot_tpu.utils.checkpoint import merge_encoder_params as jax_merge
from batch3dmot_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from batch3dmot_tpu.utils.metric_logging import MetricWriter as JaxMetricWriter
from batch3dmot_tpu_torch.config import GNNConfig, GraphConstructionConfig
from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
from batch3dmot_tpu_torch.graphs import build_scene_graphs
from batch3dmot_tpu_torch.infer.predict import make_scorer, score_windows
from batch3dmot_tpu_torch.models import init_params_, make_model
from batch3dmot_tpu_torch.train.data import GraphBatcher
from batch3dmot_tpu_torch.train.trainer import GNNTrainer
from batch3dmot_tpu_torch.utils import msgpack
from batch3dmot_tpu_torch.utils.checkpoint import load_flax_checkpoint, merge_encoder_params
from batch3dmot_tpu_torch.utils.metric_logging import MetricWriter
from batch3dmot_tpu_torch.utils.weights import (
    encoder_variables,
    flax_to_state_dict,
    load_flax_variables,
)

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
BUCKETS = ((32, 128), (64, 256))
SCENE = dict(seed=4, num_frames=6, num_tracks=5, with_modalities=True)


# ---- the msgpack decoder ---------------------------------------------------


def _assert_same_tree(got, want, path="root"):
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), path
    else:
        assert got == want, path


def test_msgpack_decoder_matches_flax():
    """``msgpack.restore`` of ``flax.serialization.to_bytes`` gives what
    ``msgpack_restore`` gives, type for type and bit for bit, over nested
    trees of f32/i32/uint8/bool/f64/int64 arrays (empty and 0-d included),
    numpy and Python scalars, strings, bytes, None, tuples, lists and empty
    dicts; an array in flax's chunked form is joined; truncated or trailing
    data raises ValueError."""
    rng = np.random.default_rng(0)
    tree = {
        "params": {
            "dense": {"kernel": rng.standard_normal((19, 48)).astype(np.float32),
                      "bias": np.zeros((48,), np.float32)},
            "ids": rng.integers(-2**31, 2**31 - 1, (7, 3)).astype(np.int32),
            "crop": rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8),
            "mask": rng.random(5) < 0.5,
            "f64": rng.standard_normal((3,)),
            "i64": np.arange(4, dtype=np.int64) - 2**40,
            "empty": np.zeros((0, 3), np.float32),
            "zero_d": np.array(2.5, np.float32),
            "jax": jnp.arange(6.0).reshape(2, 3),
        },
        "empty_dict": {},
        "scalars": {"np_f32": np.float32(1.5), "np_i64": np.int64(-7), "np_bool": np.bool_(True),
                    "py_int": 3, "neg": -33, "big": 2**40, "big_neg": -2**40, "u16": 60000,
                    "py_float": 0.1, "nan": float("nan"), "true": True, "false": False,
                    "none": None, "str": "x" * 40, "long_str": "é" * 300, "bytes": b"\x00\xff"},
        "tuple": (1, 2.0, "three"),
        "list": list(range(20)),
        "wide": {f"k{i}": i for i in range(40)},
    }
    blob = serialization.to_bytes(tree)
    _assert_same_tree(msgpack.restore(blob), serialization.msgpack_restore(blob))
    chunked = serialization.msgpack.packb(
        {"w": serialization._chunk(np.arange(10, dtype=np.float32).reshape(2, 5))},
        default=serialization._msgpack_ext_pack, strict_types=True)
    _assert_same_tree(msgpack.restore(chunked), serialization.msgpack_restore(chunked))
    for cut in (1, 7, len(blob) // 2, len(blob) - 1):
        with pytest.raises(ValueError):
            msgpack.restore(blob[:cut])
    with pytest.raises(ValueError, match="after the value"):
        msgpack.restore(blob + b"\x00")


# ---- GNN checkpoints ---------------------------------------------------------


@pytest.fixture(scope="module")
def windows():
    """The same windows from each package's builder."""
    port = list(build_scene_graphs(make_synthetic_scene(**SCENE), 3,
                                   GraphConstructionConfig(top_knn_nodes=4)))
    jax_ws = list(jax_build(jax_scene(**SCENE), 3, JaxGCConfig(top_knn_nodes=4)))
    return port, jax_ws


@pytest.fixture(scope="module")
def jax_checkpoints(windows, tmp_path_factory):
    """For mm and pose (depth 2): a JAX trainer, the epoch checkpoint its
    epoch tail wrote (pose: after one epoch of fit; mm: from the initial
    weights, which spares compiling its training step) and a save_state
    file of that trainer."""
    _, jax_ws = windows
    out = {}
    for name in ("mm", "pose"):
        log_dir = tmp_path_factory.mktemp(name)
        jm = jax_make_model(name, depth=2)
        jt = JaxTrainer(jm, jax_to_padded(jax_ws[0], *BUCKETS[0]),
                        JaxGNNConfig(batch_size=2, lr=1e-3), fused=False, seed=1)
        if name == "pose":
            jt.fit(JaxGraphBatcher(jax_ws, 2, BUCKETS, seed=0), epochs=1,
                   log_dir=str(log_dir), verbose=False)
        else:
            jt._finish_epoch(0, {"train/avgprec": 0.5}, 0.0, [], log_dir=str(log_dir),
                             verbose=False)
        (epoch_ckpt,) = log_dir.glob("gnn_epoch0_*.msgpack")
        state = jt.save_state(str(log_dir / "state.msgpack"))
        scores = jax_score_windows(jax_make_scorer(
            jm, jax.tree.map(np.asarray, jt.variables), fused=False), jax_ws)
        out[name] = (jt, str(epoch_ckpt), state, scores)
    return out


@pytest.mark.parametrize("name,form", [("mm", "epoch"), ("pose", "epoch"), ("mm", "state")])
def test_jax_checkpoint_scores_as_jax(windows, jax_checkpoints, name, form):
    """A JAX epoch checkpoint ({params, batch_stats}) or trainer state
    ({variables, opt_state, step}) loaded strictly into a port model holds
    the JAX trainer's weights exactly and scores the windows as the JAX
    model does, at rtol=2e-4, atol=2e-5."""
    port_ws, _ = windows
    jt, epoch_ckpt, state, want = jax_checkpoints[name]
    model = load_flax_checkpoint(epoch_ckpt if form == "epoch" else state,
                                 make_model(name, depth=2))
    variables = jax.tree.map(np.asarray, jt.variables)
    got_sd = model.state_dict()
    for k, v in flax_to_state_dict(variables).items():
        np.testing.assert_array_equal(got_sd[k].numpy(), v, err_msg=k)
    got = score_windows(make_scorer(model, device="cpu"), port_ws)
    assert sum(len(s) for s in got) > 0
    for g, r in zip(got, want, strict=True):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)


def test_load_flax_checkpoint_is_strict(jax_checkpoints, tmp_path):
    """A pose checkpoint does not load into an mm model, an mm checkpoint
    not into a camera+LiDAR one, and a file that is neither form raises
    ValueError."""
    pose_ckpt, mm_ckpt = jax_checkpoints["pose"][1], jax_checkpoints["mm"][1]
    with pytest.raises((KeyError, RuntimeError)):
        load_flax_checkpoint(pose_ckpt, make_model("mm", depth=2))
    with pytest.raises((KeyError, RuntimeError)):
        load_flax_checkpoint(mm_ckpt, make_model("cl_att_gnn", depth=2))
    other = tmp_path / "other.msgpack"
    other.write_bytes(serialization.to_bytes({"step": 3}))
    with pytest.raises(ValueError, match="neither"):
        load_flax_checkpoint(str(other), make_model("pose", depth=2))


# ---- encoder grafting ------------------------------------------------------


@pytest.fixture(scope="module")
def standalone_encoders():
    """Standalone flax encoders as their trainers init them: the ResNet with
    its decoder, PointNet and RadarNet with their classification heads."""
    init = lambda m, shape, k: jax.tree.map(  # noqa: E731
        np.asarray, jax.jit(m.init)(jax.random.key(k), jnp.zeros(shape)))
    return {"resnet": init(ResNetAE(), (2, 32, 32, 3), 11),
            "pointnet": init(PointNetClassifier(7), (2, 128, 3), 12),
            "radarnet": init(RadarNetClassifier(7), (2, 64, 4), 13)}


def test_merge_encoder_params_matches_jax(jax_checkpoints, standalone_encoders, tmp_path):
    """Grafting the three standalone checkpoints (two from msgpack files
    the JAX package wrote, one as a tree) into a port GNN gives the state
    dict of the JAX package's merge_encoder_params followed by
    flax_to_state_dict, exactly; the rest of the GNN is untouched, and the
    GNN's encoder trees read back in the JAX layout."""
    jt = jax_checkpoints["mm"][0]
    gnn_vars = jax.tree.map(np.asarray, jt.variables)
    paths = {}
    for name in ("resnet", "pointnet"):
        paths[name] = jax_save_checkpoint(str(tmp_path / f"{name}.msgpack"),
                                          standalone_encoders[name])
    port = load_flax_variables(make_model("mm", depth=2), gnn_vars)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    merge_encoder_params(port, resnet=paths["resnet"], pointnet=paths["pointnet"],
                         radarnet=standalone_encoders["radarnet"])
    want = flax_to_state_dict(jax_merge(gnn_vars, **standalone_encoders))
    got = port.state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    changed = {k for k, v in got.items() if not torch.equal(v, before[k])}
    assert changed and {k.split(".")[0] for k in changed} == {"resnet", "pointnet", "radarnet"}
    for name in ("resnet", "pointnet", "radarnet"):
        _assert_same_tree(
            encoder_variables(load_flax_variables(make_model("mm", depth=2), gnn_vars), name),
            {coll: gnn_vars[coll][name] for coll in ("params", "batch_stats")})


def test_merge_encoder_params_rejects_wrong_shape_and_missing_leaf(standalone_encoders):
    """A leaf of another shape and a missing leaf raise ValueError naming
    the path as the JAX package's grafting does, and leave the model as it
    was (a valid encoder passed beside a faulty one is not loaded either)."""
    model = init_params_(make_model("mm", depth=2), torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bad = jax.tree.map(lambda x: x, standalone_encoders["resnet"])
    bad["params"]["stem"]["kernel"] = np.zeros((3, 3, 3, 5), np.float32)
    with pytest.raises(ValueError, match=r"shape mismatch at 'resnet/params/stem/kernel': "
                                         r"\(3, 3, 3, 5\) vs expected"):
        merge_encoder_params(model, resnet=bad)
    missing = jax.tree.map(lambda x: x, standalone_encoders["radarnet"])
    del missing["batch_stats"]["bn1"]
    with pytest.raises(ValueError, match="encoder checkpoint missing "
                                         "'radarnet/batch_stats/bn1' — wrong architecture"):
        merge_encoder_params(model, pointnet=standalone_encoders["pointnet"], radarnet=missing)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---- the metric writer -----------------------------------------------------


def test_metric_writer_records_match_jax(tmp_path, windows):
    """The same logs give the JAX writer's records, less ``time``; fit and
    fit_device log one record per epoch."""
    records = [(0, {"train/loss": 0.5, "train/avgprec": float("nan")}),
               (1, {"train/loss": 0.25, "epoch_time_s": 1.5})]
    for cls, sub in ((MetricWriter, "port"), (JaxMetricWriter, "jax")):
        w = cls(str(tmp_path / sub), tensorboard=False)
        for step, m in records:
            w.log(step, m)
        w.close()

    def read(sub):
        lines = (tmp_path / sub / "metrics.jsonl").read_text().splitlines()
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in lines]

    assert json.dumps(read("port")) == json.dumps(read("jax"))

    port_ws, _ = windows
    tr = GNNTrainer(make_model("pose", depth=2), GNNConfig(batch_size=2), device="cpu")
    writer = MetricWriter(str(tmp_path / "fit"), tensorboard=False)
    hist = tr.fit(GraphBatcher(port_ws, 2, BUCKETS), epochs=2, verbose=False, writer=writer)
    from batch3dmot_tpu_torch.train.data import materialize_graph_dataset

    hist += tr.fit_device(materialize_graph_dataset(port_ws, BUCKETS), epochs=1,
                          verbose=False, writer=writer)
    writer.close()
    logged = [json.loads(line) for line in
              (tmp_path / "fit" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logged] == [0, 1, 0]
    for r, h in zip(logged, hist, strict=True):
        assert r["train/loss"] == h["train/loss"] and "time" in r
