"""The port's CLI (``batch3dmot_tpu_torch/cli.py``) against the JAX CLI on
the same argv, on the CPU (``--device cpu``): ``build-graphs --synthetic``
stores byte for byte and ``--skip-existing``; ``train-gnn --model pose``
from one JAX-written checkpoint (``--init-checkpoint``) with the same
history; ``predict`` (pose, the windows path) from the JAX msgpack with the
same per-scene edge scores, submission and ``eval`` AMOTA; ``concat-jsons``,
``import-checkpoint``, the reference model names; every subcommand's option
strings and defaults (``--device`` the one addition); and the default
device, which refuses to run without a GPU. The nuScenes data plane's
subcommands are in ``test_torch_cli_nuscenes*.py``.

The helpers here are shared by the other ``test_torch_cli_*`` files."""

import argparse
import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from batch3dmot_tpu.cli import main as jax_main
from batch3dmot_tpu_torch import cli as tcli

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 2e-5
LOSS_REL = 1e-4
SIZES = [
    "--set", "graph_construction.batch_size_graph=3",
    "--set", "graph_construction.top_knn_nodes=4",
    "--set", "gnn.gnn_depth=2",
    "--set", "gnn.batch_size=2",
]


def port_main(argv):
    return tcli.main([*argv, "--device", "cpu"])


def common(root):
    return ["--set", f"paths.tmp={root}", *SIZES]


def paths_of(root):
    return os.path.join(root, "nuscenes")


def checkpoints(models_dir, ext):
    return sorted(glob.glob(os.path.join(models_dir, "gnn", f"*.{ext}")), key=os.path.getmtime)


def edge_scores(eval_dir):
    return {
        os.path.basename(p): json.load(open(p))
        for p in glob.glob(os.path.join(eval_dir, "predict", "*_edge_scores.json"))
    }


def assert_scores_close(got, want, rtol=RTOL, atol=ATOL):
    assert got.keys() == want.keys() and want
    for name in want:
        assert got[name].keys() == want[name].keys(), name
        a = np.array([got[name][k] for k in want[name]])
        b = np.array([want[name][k] for k in want[name]])
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


def assert_submissions_equal(got, want):
    """The same boxes per sample token: tracking ids and names equal,
    translations equal up to float32 rounding."""
    assert got["meta"] == want["meta"]
    assert got["results"].keys() == want["results"].keys()
    for token in want["results"]:
        a = sorted(got["results"][token], key=lambda b: (int(b["tracking_id"]), b["translation"]))
        b = sorted(want["results"][token], key=lambda b: (int(b["tracking_id"]), b["translation"]))
        assert len(a) == len(b), token
        for x, y in zip(a, b):
            assert x["tracking_id"] == y["tracking_id"]
            assert x["tracking_name"] == y["tracking_name"]
            assert x["sample_token"] == y["sample_token"]
            np.testing.assert_allclose(x["translation"], y["translation"], rtol=1e-6)


def assert_histories_close(got, want, rel=LOSS_REL, keys=None):
    """Every metric of every epoch (or those in ``keys``) at ``rel``."""
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        assert set(w) - {"epoch_time_s"} == set(g) - {"epoch_time_s"}, (sorted(g), sorted(w))
        for k in keys or set(w) - {"epoch_time_s"}:
            if np.isnan(w[k]):
                assert np.isnan(g[k]), k
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=rel, atol=1e-7, err_msg=k)


def amota_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith('{"amota"')][-1])


def write_gt(path, num_scenes, extra=()):
    """GT boxes of the synthetic scenes (the JAX package's generator and
    ``gt_boxes_from_scene``) as the JSON ``eval --gt`` reads."""
    from batch3dmot_tpu.cli import _build_synthetic_scenes
    from batch3dmot_tpu.config import Config
    from batch3dmot_tpu.eval.tracking_metrics import gt_boxes_from_scene

    cfg = Config()
    cfg.apply_overrides(list(extra))
    boxes = [b for s in _build_synthetic_scenes(cfg, num_scenes, False)
             for b in gt_boxes_from_scene(s)]
    with open(path, "w") as f:
        json.dump({"boxes": boxes}, f)
    return str(path)


def jax_init_checkpoint(path, kind="mm"):
    """A JAX msgpack of the ``kind`` model's initial variables at ``SIZES``."""
    from batch3dmot_tpu.cli import _init_variables_for_scene_model, _make_cli_model
    from batch3dmot_tpu.config import Config
    from batch3dmot_tpu.utils.checkpoint import save_checkpoint

    cfg = Config()
    cfg.apply_overrides(SIZES[1::2])
    model = _make_cli_model(cfg, kind)
    return save_checkpoint(str(path), _init_variables_for_scene_model(cfg, model))


@pytest.fixture(scope="module")
def pose_run(tmp_path_factory):
    """Both CLIs on the same argv: stores built by each, one JAX epoch from
    its own initialisation (the shared start), then one epoch of each CLI
    from that checkpoint, then predict from the JAX epoch's checkpoint."""
    tmp = tmp_path_factory.mktemp("torch_cli")
    jroot, proot = tmp / "jax", tmp / "port"
    jax_main(["build-graphs", "--synthetic", "2", *common(jroot)])
    port_main(["build-graphs", "--synthetic", "2", *common(proot)])
    jax_main(["train-gnn", "--model", "pose", "--epochs", "1", *common(jroot),
              "--set", f"paths.models={tmp}/start"])
    start = checkpoints(tmp / "start", "msgpack")[-1]
    argv = ["train-gnn", "--model", "pose", "--epochs", "1", "--init-checkpoint", start,
            "--fused-steps", "2"]
    hj = jax_main([*argv, *common(jroot)])
    hp = port_main([*argv, *common(proot)])
    ck = checkpoints(paths_of(jroot) + "/models", "msgpack")[-1]
    gt = write_gt(tmp / "gt.json", 2)
    return dict(tmp=tmp, jroot=jroot, proot=proot, hj=hj, hp=hp, ck=ck, gt=gt)


def test_build_graphs_stores_byte_equal(pose_run):
    jdir = Path(paths_of(pose_run["jroot"])) / "graphs"
    pdir = Path(paths_of(pose_run["proot"])) / "graphs"
    names = sorted(p.name for p in jdir.iterdir() if not p.name.endswith(".enc.npz"))
    assert names == sorted(p.name for p in pdir.iterdir() if not p.name.endswith(".enc.npz"))
    assert any(n.endswith(".b3d") for n in names)
    for n in names:
        assert (jdir / n).read_bytes() == (pdir / n).read_bytes(), n


def test_build_graphs_skip_existing_counts(pose_run, capsys):
    argv = ["build-graphs", "--synthetic", "2", "--skip-existing"]
    capsys.readouterr()
    jax_main([*argv, *common(pose_run["jroot"])])
    j = capsys.readouterr().out
    port_main([*argv, *common(pose_run["proot"])])
    p = capsys.readouterr().out
    for out in (j, p):
        assert "(2 skipped)" in out and "0 windows" in out
    assert j.split(" -> ")[0] == p.split(" -> ")[0]


def test_train_gnn_pose_matches_jax(pose_run):
    """One epoch from the same JAX checkpoint (host batches from the
    stores, two steps per fused group): every metric at rel 1e-4, and the
    epoch checkpoint named as the JAX one with the port's extension."""
    assert_histories_close(pose_run["hp"], pose_run["hj"])
    jnames = [os.path.basename(p)[: -len(".msgpack")]
              for p in checkpoints(paths_of(pose_run["jroot"]) + "/models", "msgpack")]
    pnames = [os.path.basename(p)[: -len(".pt")]
              for p in checkpoints(paths_of(pose_run["proot"]) + "/models", "pt")]
    assert len(pnames) == 1 and pnames[0].split("_TrainAP")[0] == jnames[-1].split("_TrainAP")[0]
    metrics = Path(paths_of(pose_run["proot"])) / "models" / "gnn" / "metrics.jsonl"
    assert json.loads(metrics.read_text().splitlines()[-1])["step"] == 0


def test_predict_and_eval_pose_match_jax(pose_run, capsys):
    """predict (pose: auto -> windows) from the JAX msgpack: edge scores at
    rtol 2e-4 / atol 2e-5, the same submission, the same eval AMOTA."""
    outs = {}
    for name, run, root in (("jax", jax_main, pose_run["jroot"]),
                            ("port", port_main, pose_run["proot"])):
        run(["predict", "--model", "pose", "--checkpoint", pose_run["ck"], *common(root)])
        outs[name] = capsys.readouterr().out
    assert "predict[windows]: 2 scenes" in outs["port"]
    jeval, peval = (os.path.join(paths_of(r), "eval") for r in (pose_run["jroot"],
                                                               pose_run["proot"]))
    assert_scores_close(edge_scores(peval), edge_scores(jeval))
    jsub = json.load(open(os.path.join(jeval, "submission.json")))
    psub = json.load(open(os.path.join(peval, "submission.json")))
    assert_submissions_equal(psub, jsub)
    jax_main(["eval", "--submission", os.path.join(jeval, "submission.json"),
              "--gt", pose_run["gt"]])
    j = amota_line(capsys.readouterr().out)
    res = tcli.main(["eval", "--submission", os.path.join(peval, "submission.json"),
                     "--gt", pose_run["gt"]])
    p = amota_line(capsys.readouterr().out)
    assert p == j and res.amota == j["amota"]


def test_pose_rejects_encoded_and_device_pipelines(pose_run):
    for pipeline in ("encoded", "device"):
        with pytest.raises(SystemExit, match="applies to the multimodal models"):
            port_main(["predict", "--model", "pose", "--checkpoint", pose_run["ck"],
                       "--pipeline", pipeline, "--synthetic", "1", *common(pose_run["proot"])])
    with pytest.raises(SystemExit, match="multimodal"):
        port_main(["train-gnn", "--model", "pose", "--encoded", "--epochs", "1",
                   *common(pose_run["proot"])])


def test_train_gnn_accepts_reference_model_name(pose_run):
    history = port_main(["train-gnn", "--model", "gnn_baseline", "--epochs", "1",
                         *common(pose_run["proot"]),
                         "--set", f"paths.models={pose_run['tmp']}/baseline"])
    assert history and np.isfinite(history[0]["train/loss"])
    assert checkpoints(pose_run["tmp"] / "baseline", "pt")


def test_eval_requires_gt(tmp_path):
    sub = tmp_path / "sub.json"
    sub.write_text(json.dumps({"results": {}}))
    with pytest.raises(SystemExit, match="--gt is required"):
        tcli.main(["eval", "--submission", str(sub)])


def test_concat_jsons_matches_jax(tmp_path, capsys):
    from batch3dmot_tpu.utils.json_tools import merge_split_keyed as jmerge
    from batch3dmot_tpu_torch.utils.json_tools import merge_split_keyed, merge_split_keyed_files

    a = {"train": [{"x": 1}], "val": [{"x": 2}], "version": "mini"}
    b = {"train": [{"x": 3}], "test": [{"x": 4}]}
    (tmp_path / "a.json").write_text(json.dumps(a))
    (tmp_path / "b.json").write_text(json.dumps(b))
    outs = {}
    for name, run in (("jax", jax_main), ("port", tcli.main)):
        out = tmp_path / f"{name}.json"
        run(["concat-jsons", "--file1", str(tmp_path / "a.json"),
             "--file2", str(tmp_path / "b.json"), "--outfile", str(out)])
        outs[name] = (out.read_bytes(), capsys.readouterr().out.replace(str(out), "OUT"))
    assert outs["port"] == outs["jax"]
    lists = {k: v for k, v in a.items() if isinstance(v, list)}
    assert merge_split_keyed(lists, b) == jmerge(lists, b)
    merge_split_keyed_files(str(tmp_path / "a.json"), str(tmp_path / "b.json"),
                            str(tmp_path / "m.json"))
    assert json.loads((tmp_path / "m.json").read_text())["train"] == [{"x": 1}, {"x": 3}]


@pytest.mark.parametrize("arch", ["pose", "mm", "resnet", "pointnet", "radarnet"])
def test_import_checkpoint_matches_jax(arch, tmp_path, capsys):
    """The same reference .pth through both CLIs: the port's .pt holds the
    weights the JAX msgpack holds, exactly (the mm tracker's standalone
    encoder heads are dropped by both; of an attention's input projection
    the JAX tree keeps the value slice, the only one a single token reads)."""
    sys.path.insert(0, str(Path(__file__).parent))
    import test_torch_import as twins

    from batch3dmot_tpu_torch import models
    from batch3dmot_tpu_torch.utils.checkpoint import (
        load_flax_checkpoint,
        load_flax_encoder_checkpoint,
    )

    torch.manual_seed(0)
    twin = {"pose": lambda: twins._TorchPoseGNN(depth=2),
            "mm": lambda: twins._TorchMMGNNRef(2),
            "resnet": twins._TorchResNetAE, "pointnet": twins._TorchPointNet,
            "radarnet": twins._TorchRadarNet}[arch]().eval()
    for m in twin.modules():
        if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
            m.running_mean.normal_(0, 0.3)
            m.running_var.uniform_(0.5, 2.0)
    pth = tmp_path / "ref.pth"
    torch.save(twin.state_dict(), pth)
    jax_main(["import-checkpoint", "--torch", str(pth), "--arch", arch,
              "--out", str(tmp_path / "ref.msgpack")])
    tcli.main(["import-checkpoint", "--torch", str(pth), "--arch", arch,
               "--out", str(tmp_path / "ref.pt")])
    out = capsys.readouterr().out
    assert f"import-checkpoint[{arch}]" in out and "ref.pt" in out
    got = torch.load(tmp_path / "ref.pt", weights_only=True)
    module = {"pose": models.PoseGNN, "mm": models.MultimodalGNN, "resnet": models.ResNetAE,
              "pointnet": models.PointNetClassifier,
              "radarnet": models.RadarNetClassifier}[arch]()
    load = load_flax_checkpoint if arch in ("pose", "mm") else load_flax_encoder_checkpoint
    want = load(str(tmp_path / "ref.msgpack"), module).state_dict()
    assert set(got) == set(want)
    for k in want:
        a, b = got[k].numpy(), want[k].numpy()
        if "in_proj" in k:
            # one key-value token: the JAX tree holds only the value slice
            # (query and key cannot change the output), the port the whole
            a, b = a[2 * a.shape[0] // 3:], b[2 * b.shape[0] // 3:]
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(a, b, err_msg=k)


DEFAULT_DEVICE = [
    ["build-graphs", "--synthetic", "1"],
    ["train-gnn", "--model", "pose"],
    ["train-resnet", "--synthetic"],
    ["predict", "--model", "pose"],
    ["demo"],
]


@pytest.mark.parametrize("argv", DEFAULT_DEVICE, ids=lambda a: a[0])
def test_default_device_needs_a_gpu(argv, tmp_path):
    """Without a GPU and without --device cpu a computing subcommand exits
    with "no CUDA device" before it computes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main([*argv, "--set", f"paths.tmp={tmp_path}"])
    assert not os.path.exists(os.path.join(tmp_path, "nuscenes"))


def test_module_entry_point_exits_nonzero_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    r = subprocess.run(
        [sys.executable, "-m", "batch3dmot_tpu_torch.cli", "predict", "--model", "pose",
         "--set", f"paths.tmp={tmp_path}"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr[-2000:]


def _jax_parser():
    """The JAX CLI's parser, caught as ``main`` parses."""
    class Caught(Exception):
        pass

    def catch(self, *a, **k):
        raise Caught(self)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        jax_main(["demo"])
    except Caught as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError("the JAX CLI did not parse")


def _options(parser):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {
        name: {
            a.dest: (tuple(a.option_strings), a.default, a.choices and tuple(a.choices),
                     a.required, a.type, a.nargs)
            for a in p._actions if not isinstance(a, argparse._HelpAction)
        }
        for name, p in sub.choices.items()
    }


def test_parser_matches_jax():
    """Every JAX subcommand, with the same option strings, defaults,
    choices and types; the port adds --device on the subcommands that
    compute, and nothing else."""
    want, got = _options(_jax_parser()), _options(tcli.build_parser())
    assert set(got) == set(want)
    with_device = set()
    for name in want:
        extra = set(got[name]) - set(want[name])
        assert extra <= {"device"}, (name, extra)
        if extra:
            with_device.add(name)
            assert got[name]["device"][:3] == (("--device",), None, ("cuda", "cpu"))
        for dest in want[name]:
            assert got[name][dest] == want[name][dest], (name, dest)
    assert with_device == {"build-graphs", "train-gnn", "train-resnet", "train-pointnet",
                           "train-radarnet", "predict", "demo"}


def test_help_lists_every_subcommand(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    sub = next(a for a in _jax_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    for name in sub.choices:
        assert name in out, name


def test_config_file_and_overrides_through_the_cli(tmp_path):
    """--config loads a profile (PyYAML imported there) and --set applies
    on top of it, as in the JAX CLI."""
    from batch3dmot_tpu.cli import _load_config as jax_load

    argv = ["build-graphs", "--config", str(REPO / "configs" / "cam.yaml"),
            "--set", f"paths.tmp={tmp_path}", "--set", "gnn.lr=3e-4"]
    jargs = argparse.Namespace(config=argv[2], set=[argv[4], argv[6]])
    assert tcli._load_config(jargs).to_dict() == jax_load(jargs).to_dict()
    cfg = tcli._load_config(jargs)
    assert tcli._active_modalities(cfg) == ("img",) and cfg.gnn.lr == 3e-4


def test_aot_cache_moves_the_kernel_build_directory(pose_run, tmp_path):
    """predict --aot-cache DIR: the kernels build into (and load from) DIR,
    the port's only cold-start cost."""
    from batch3dmot_tpu_torch.ops import cuda_build

    before = cuda_build.BUILD_DIR
    try:
        port_main(["predict", "--model", "pose", "--checkpoint", pose_run["ck"],
                   "--aot-cache", str(tmp_path / "kernels"), *common(pose_run["proot"]),
                   "--set", f"paths.eval={tmp_path}/eval"])
        assert cuda_build.BUILD_DIR == tmp_path / "kernels"
    finally:
        cuda_build.BUILD_DIR = before
    assert (tmp_path / "eval" / "submission.json").exists()


def test_torchrun_environment_is_joined_not_spawned(pose_run, monkeypatch, capsys):
    """Under torchrun (WORLD_SIZE set) --devices joins the environment's
    process group in this process: one gloo rank on the CPU here, the same
    history as without a mesh."""
    argv = ["train-gnn", "--model", "pose", "--epochs", "1", "--init-checkpoint",
            pose_run["ck"], *common(pose_run["proot"])]
    h0 = port_main([*argv, "--set", f"paths.models={pose_run['tmp']}/nomesh"])
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    h1 = port_main([*argv, "--devices", "1", "--set", f"paths.models={pose_run['tmp']}/torchrun"])
    assert "epoch 0: loss=" in capsys.readouterr().out
    assert_histories_close(h1, h0, rel=1e-6)
    import torch.distributed as dist

    assert not dist.is_initialized()
