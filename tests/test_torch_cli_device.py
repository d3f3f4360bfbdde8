"""The port's CLI against the JAX CLI on the same argv (``--device cpu``)
for the multimodal model's ``windows`` and ``device`` predict pipelines,
from one JAX msgpack (the model's initial variables): per-scene edge
scores, submission and AMOTA; on the port alone, the device pipeline
grouped against scene by scene, and its density-aware routing of groups to
singles (the scenes of ``test_cli_pipelines.py:263,301``)."""

import json
import os

import pytest
import torch

from batch3dmot_tpu.cli import main as jax_main
from batch3dmot_tpu_torch import cli as tcli
from test_torch_cli import (
    amota_line,
    assert_scores_close,
    assert_submissions_equal,
    common,
    edge_scores,
    jax_init_checkpoint,
    port_main,
    write_gt,
)
from test_torch_cli_predict import _predict, grouped_runs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def init_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli_device")
    jroot, proot = tmp / "jax", tmp / "port"
    jax_main(["build-graphs", "--synthetic", "2", *common(jroot)])
    port_main(["build-graphs", "--synthetic", "2", *common(proot)])
    return dict(tmp=tmp, jroot=jroot, proot=proot,
                ck=jax_init_checkpoint(tmp / "init.msgpack"))


PIPELINES = {
    "windows": ["--pipeline", "windows"],
    "device": ["--pipeline", "device", "--synthetic", "2",
               "--set", "predict.batch_size_graph=3"],
}


@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_predict_mm_matches_jax(init_run, pipeline, capsys):
    """The re-encoding windows path and the device pipeline from the JAX
    msgpack: per-scene edge scores at rtol 2e-4 / atol 2e-5, the same
    submission and the same eval AMOTA."""
    extra = PIPELINES[pipeline]
    jdir = _predict(jax_main, init_run["jroot"], init_run["ck"], pipeline, *extra)
    capsys.readouterr()
    pdir = _predict(port_main, init_run["proot"], init_run["ck"], pipeline, *extra)
    assert f"predict[{pipeline}]: 2 scenes" in capsys.readouterr().out
    assert_scores_close(edge_scores(pdir), edge_scores(jdir))
    subs = [os.path.join(d, "submission.json") for d in (jdir, pdir)]
    assert_submissions_equal(json.load(open(subs[1])), json.load(open(subs[0])))
    gt = write_gt(init_run["tmp"] / "gt.json", 2)
    amotas = []
    for run, sub in ((jax_main, subs[0]), (tcli.main, subs[1])):
        run(["eval", "--submission", sub, "--gt", gt])
        amotas.append(amota_line(capsys.readouterr().out))
    assert amotas[0] == amotas[1]


def test_grouped_device_pipeline_matches_ungrouped(init_run):
    """predict --pipeline device with scenes_per_batch 2 over 3 scenes (a
    group of 2 and a group of 1) gives the scores and submission of one
    scene at a time."""
    (s1, sub1), (s2, sub2) = grouped_runs(port_main, init_run["proot"], init_run["ck"],
                                          "device", (1, 2))
    assert len(s1) == 3
    assert_scores_close(s2, s1, rtol=1e-5, atol=1e-6)
    assert_submissions_equal(sub2, sub1)


def _routing(monkeypatch, pipe):
    """Record singles dispatches; a grouped dispatch raises a sentinel."""
    called = []

    class Grouped(Exception):
        pass

    monkeypatch.setattr(type(pipe), "dispatch_scene",
                        lambda self, s: called.append(s.scene_token))

    def grouped(self, *a, **k):
        raise Grouped()

    monkeypatch.setattr(type(pipe), "_dispatch", grouped)
    return called, Grouped


def test_device_pipeline_group_routes_biggest_bucket_to_singles(monkeypatch):
    """Scenes whose windows reach the 512-node quantum are scored one by
    one even in a group."""
    from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
    from batch3dmot_tpu_torch.infer.device_pipeline import DeviceScenePipeline
    from batch3dmot_tpu_torch.models import MultimodalGNN

    scenes = [
        make_synthetic_scene(seed=50 + i, num_frames=12, num_tracks=90, fp_per_frame=6.0,
                             with_modalities=True, scene_token=f"dense{i}")
        for i in range(2)
    ]
    pipe = DeviceScenePipeline(MultimodalGNN(depth=1), 5, 16, device="cpu")
    assert max(pipe._quanta(s)[2] for s in scenes) == 512
    called, _ = _routing(monkeypatch, pipe)
    assert pipe.score_scenes(scenes) == [{}, {}]
    assert called == ["dense0", "dense1"]


def test_device_pipeline_group_routes_chip_filling_scenes_to_singles(monkeypatch):
    """Trainval-shaped scenes: at window 5 one scene's work reaches the
    ceiling and the scenes go one by one; at window 2 they group."""
    from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
    from batch3dmot_tpu_torch.infer.device_pipeline import DeviceScenePipeline
    from batch3dmot_tpu_torch.models import MultimodalGNN

    scenes = [
        make_synthetic_scene(seed=70 + i, num_frames=40, num_tracks=40,
                             with_modalities=True, scene_token=f"tv{i}")
        for i in range(2)
    ]
    pipe5 = DeviceScenePipeline(MultimodalGNN(depth=1), 5, 16, device="cpu")
    _, w, n = pipe5._quanta(scenes[0])
    assert (-(-w // 8) * 8) * n * n * 16 >= 32_000_000
    called, grouped = _routing(monkeypatch, pipe5)
    assert pipe5.score_scenes(scenes) == [{}, {}]
    assert called == ["tv0", "tv1"]

    called.clear()
    pipe2 = DeviceScenePipeline(MultimodalGNN(depth=1), 2, 16, device="cpu")
    _, w, n = pipe2._quanta(scenes[0])
    assert (-(-w // 8) * 8) * n * n * 16 < 32_000_000
    with pytest.raises(grouped):
        pipe2.score_scenes(scenes)
    assert called == []
