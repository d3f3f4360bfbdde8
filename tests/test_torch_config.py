"""The port's ``Config`` (``batch3dmot_tpu_torch/config.py``) against the
JAX package's: every profile under ``configs/`` loads to the same
``to_dict()`` and the same active modalities, the defaults agree,
``apply_overrides`` (path re-derivation, coercion, dict sections) gives the
same configs, ``validate`` refuses the same cases with the same messages,
the reference's nested class maps load; and ``utils/profiling.py``."""

import glob
import json
import os

import pytest
import torch

from batch3dmot_tpu.cli import _active_modalities as jax_active
from batch3dmot_tpu.config import Config as JConfig
from batch3dmot_tpu_torch import cli as tcli
from batch3dmot_tpu_torch.config import Config, class_one_hot_index

torch.set_num_threads(1)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
PROFILES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(CONFIG_DIR, "*.yaml")))


def test_profiles_ship():
    assert {"pose_mini.yaml", "cam.yaml", "cam_lidar.yaml", "clr.yaml", "cl.yaml"} <= set(
        PROFILES)


@pytest.mark.parametrize("name", PROFILES)
def test_profile_loads_to_the_jax_config(name):
    path = os.path.join(CONFIG_DIR, name)
    got, want = Config.from_yaml(path), JConfig.from_yaml(path)
    assert got.to_dict() == want.to_dict()
    assert tcli._active_modalities(got) == jax_active(want)


def test_defaults_match_jax():
    assert Config().to_dict() == JConfig().to_dict()


OVERRIDES = [
    ["paths.tmp=/tmp/xyz"],
    ["paths.tmp=/tmp/xyz", "paths.models=/keep/me"],
    ["main.dataset=other", "paths.eval=/e"],
    ["gnn.lr=3e-4", "gnn.attention=false", "gnn.gnn_depth=2", "gnn.knn_conv_mode=active"],
    ["predict.point_dtype=float32", "predict.scenes_per_batch=1",
     "predict.edge_score_thresholds.car=0.5"],
    ["detections.megvii.val=megvii/val.json", "main.sensors_used.radar=0"],
    ["graph_construction.top_knn_nodes=4", "resnet.batch_size=4", "eval.eval_set=mini_val"],
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: o[0].split("=")[0])
def test_apply_overrides_matches_jax(overrides):
    got, want = Config(), JConfig()
    got.apply_overrides(overrides)
    want.apply_overrides(overrides)
    assert got.to_dict() == want.to_dict()


def test_override_rederives_paths():
    cfg = Config()
    cfg.apply_overrides(["paths.tmp=/tmp/xyz"])
    assert cfg.paths.graphs_dir.startswith("/tmp/xyz")
    assert cfg.paths.models.startswith("/tmp/xyz")
    cfg2 = Config()
    cfg2.apply_overrides(["paths.tmp=/tmp/xyz", "paths.models=/keep/me"])
    assert cfg2.paths.models == "/keep/me"


INVALID = [
    ("dict", {"classes": {"car": 0, "truck": 1}}),
    ("dict", {"main": {"detections": "nope"}}),
    ("dict", {"gnn": {"knn_conv_mode": "sometimes"}}),
    ("dict", {"graph_construction": {"match_method": "nearest"}}),
    ("dict", {"predict": {"point_dtype": "bfloat16"}}),
    ("override", ["gnn.lr"]),
    ("override", ["gnn.knn_conv_mode=sometimes"]),
    ("override", ["predict.point_dtype=int8"]),
    ("override", ["main.detections=nope"]),
]


@pytest.mark.parametrize("kind,bad", INVALID, ids=lambda x: str(x)[:30])
def test_validate_refuses_what_jax_refuses(kind, bad):
    def attempt(cls):
        with pytest.raises(ValueError) as e:
            if kind == "dict":
                cls.from_dict(bad)
            else:
                cls().apply_overrides(bad)
        return str(e.value)

    assert attempt(Config) == attempt(JConfig)


def test_reference_nested_class_map_and_unknown_keys():
    raw = {"main": {"class_dict": "mine", "workers": 8},
           "classes": {"mine": {"car": 1, "pedestrian": 2}, "other": {"x": 1}},
           "gnn": {"device": "cuda:0", "lr": 0.5}}
    got, want = Config.from_dict(raw), JConfig.from_dict(raw)
    assert got.to_dict() == want.to_dict()
    assert got.classes == {"car": 1, "pedestrian": 2} and got.gnn.lr == 0.5
    assert class_one_hot_index(1) == 0


def test_profiling_trace_and_timer(tmp_path):
    from batch3dmot_tpu_torch.utils.profiling import annotate, profile_trace

    with profile_trace(str(tmp_path)):
        with annotate("matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    (trace,) = glob.glob(str(tmp_path / "trace_*.json"))
    names = {e.get("name") for e in json.load(open(trace))["traceEvents"]}
    assert "matmul" in names
