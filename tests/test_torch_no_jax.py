"""Import hygiene of the PyTorch port: it imports no JAX, no flax, no optax,
no msgpack and nothing of ``batch3dmot_tpu``, it imports, scores (the
encode-once scorer, from precomputed encodings, and the device pipeline),
takes a training step and runs device-resident and K-step epochs without
``nvcc`` or a GPU (in both kNN-conv modes), trains from .b3d stores (the
native loader built with g++, the numpy fallback, per-scene encoding caches
and the streaming batcher, a metric writer), decodes a flax msgpack file,
trains the three encoders from their loaders and stacked datasets and
grafts one into a GNN, and its default-device entry points (scorers, the
device pipeline and its window construction, the trainers, the encoding
cache, the data-parallel mesh) refuse to run on the CPU unless asked to; and
the ranks that the data-parallel dry run spawns (``parallel/dryrun.py``)
import none of those modules either; nor does the CLI (build, train,
predict, eval on the CPU), which also imports no ``yaml`` until a
``--config`` file is read, nor the ranks that ``--devices 2`` spawns; and
the nuScenes data plane's lidar and radar path (``validate-data``,
``preprocess`` of each modality, ``build-graphs`` with the image sensor
off, ``export-gt``) runs where PIL and PyYAML cannot be imported, as on
the machine with the card, while an image request there raises."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import batch3dmot_tpu_torch as port

    for mod in pkgutil.walk_packages(port.__path__, "batch3dmot_tpu_torch."):
        importlib.import_module(mod.name)

    from batch3dmot_tpu_torch.config import GraphConstructionConfig
    from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
    from batch3dmot_tpu_torch.graphs import build_scene_graphs
    from batch3dmot_tpu_torch.infer.predict import (
        SceneEncodedScorer, make_scorer, predict_scenes)
    from batch3dmot_tpu_torch.models import init_params_, make_model

    scene = make_synthetic_scene(seed=0, num_frames=4, num_tracks=3,
                                 with_modalities=True)
    windows = list(build_scene_graphs(scene, 2, GraphConstructionConfig(top_knn_nodes=3)))
    model = init_params_(make_model("mm", depth=1), torch.Generator().manual_seed(0))
    (pred_edges, avg), = predict_scenes(
        SceneEncodedScorer(model, device="cpu"), [(scene, windows)])
    assert avg and all(np.isfinite(v) for v in avg.values())

    # the device pipeline, predict_scene_device, the device builder and
    # scoring from precomputed encodings
    from batch3dmot_tpu_torch.config import Config, PredictConfig
    from batch3dmot_tpu_torch.graphs.build_device import build_scene_graphs_device
    from batch3dmot_tpu_torch.infer.device_pipeline import (
        DeviceScenePipeline, predict_scene_device, predict_scenes_device)
    from batch3dmot_tpu_torch.train.encoded import precompute_scene_encodings

    pipe = DeviceScenePipeline(model, 2, 3, device="cpu")
    assert pipe.score_scene(scene) and pipe.score_scenes([scene, scene])[1]
    cfg = Config(graph_construction=GraphConstructionConfig(top_knn_nodes=3))
    _, dev_avg = predict_scene_device(model, scene, cfg, device="cpu")
    assert dev_avg.keys() == avg.keys()
    assert predict_scenes_device(model, [scene, scene], cfg, device="cpu")[1][1] == dev_avg
    assert len(build_scene_graphs_device(scene, 2, device="cpu")) == len(windows)
    enc = precompute_scene_encodings(model, scene, device="cpu")
    (_, enc_avg), = predict_scenes(SceneEncodedScorer(model, device="cpu"), [(scene, windows)],
                                   PredictConfig(), encodings_list=[enc])
    assert enc_avg.keys() == avg.keys()

    for entry in (SceneEncodedScorer, make_scorer,
                  lambda m: DeviceScenePipeline(m, 2, 3),
                  lambda m: predict_scene_device(m, scene),
                  lambda m: predict_scenes_device(m, [scene]),
                  lambda m: build_scene_graphs_device(scene, 2)):
        try:
            entry(model)
        except RuntimeError as err:
            assert "device='cpu'" in str(err)
        else:
            raise AssertionError(f"{entry} ran without a GPU")

    from batch3dmot_tpu_torch.config import GNNConfig
    from batch3dmot_tpu_torch.train.encoded import (
        EncodedGraphBatcher, precompute_scene_encodings)
    from batch3dmot_tpu_torch.train.trainer import GNNTrainer

    enc = precompute_scene_encodings(model, scene, device="cpu")
    batch = next(EncodedGraphBatcher([(w, enc) for w in windows], 2).epoch())
    trainer = GNNTrainer(make_model("mm", depth=1), GNNConfig(), device="cpu")
    loss, _ = trainer.train_step(batch)
    assert np.isfinite(float(loss)) and trainer.step == 1

    # device-resident epochs (dense and dedup encodings, graphs) and K steps
    # per dispatch
    from batch3dmot_tpu_torch.train.data import GraphBatcher, materialize_graph_dataset
    from batch3dmot_tpu_torch.train.encoded import (
        materialize_encoded_dataset, materialize_encoded_datasets_dedup)
    pairs = [(w, enc) for w in windows]
    for ds in (materialize_encoded_dataset(pairs), materialize_encoded_datasets_dedup(pairs)):
        (hist,) = trainer.fit_device(ds, epochs=1, verbose=False)
        assert np.isfinite(hist["train/loss"])
    pose = GNNTrainer(make_model("pose", depth=1), GNNConfig(batch_size=2), device="cpu")
    (hist,) = pose.fit(GraphBatcher(windows, 2), epochs=1, verbose=False, fused_steps=2)
    (hist,) = pose.fit_device(materialize_graph_dataset(windows), epochs=1, verbose=False,
                              val_dataset=materialize_graph_dataset(windows))
    assert np.isfinite(hist["val/loss"])

    # knn_conv_mode='active': the module loop with the kNN GATConv
    active = init_params_(make_model("mm", depth=1, knn_conv_mode="active", knn_conv_k=2),
                          torch.Generator().manual_seed(1))
    (_, avg), = predict_scenes(SceneEncodedScorer(active, device="cpu"), [(scene, windows)])
    assert avg and all(np.isfinite(v) for v in avg.values())
    trainer = GNNTrainer(make_model("mm", depth=1, knn_conv_mode="active", knn_conv_k=2),
                         GNNConfig(), device="cpu")
    loss, _ = trainer.train_step(batch)
    assert np.isfinite(float(loss))
    assert trainer.model.knn_conv.lin.weight.grad.abs().sum() > 0
    try:
        GNNTrainer(make_model("pose", depth=1))
    except RuntimeError as err:
        assert "device='cpu'" in str(err)
    else:
        raise AssertionError("GNNTrainer ran without a GPU")

    # training from .b3d stores: the store, the native loader, the store
    # batcher and its fallback, encoding caches, the streaming batcher (K
    # steps per dispatch), a metric writer; a flax msgpack blob
    import contextlib, io, os, tempfile
    from batch3dmot_tpu_torch.io import GraphStoreReader, save_scene_graphs
    from batch3dmot_tpu_torch.io import native
    from batch3dmot_tpu_torch.train import store_data
    from batch3dmot_tpu_torch.train.encoded import (
        StreamingEncodedBatcher, scene_encodings_cached)
    from batch3dmot_tpu_torch.utils import msgpack
    from batch3dmot_tpu_torch.utils.metric_logging import MetricWriter

    tmp = tempfile.mkdtemp()
    path = save_scene_graphs(windows, tmp, metadata=scene.metadata)
    assert len(GraphStoreReader(path).windows()) == len(windows)
    assert native.native_available(), native.native_error()
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        sb = store_data.make_batcher([path], 2, uniform=True)
    assert isinstance(sb, store_data.StoreGraphBatcher) and "native" in said.getvalue()
    writer = MetricWriter(os.path.join(tmp, "log"), tensorboard=False)
    (hist,) = pose.fit(sb, epochs=1, verbose=False, writer=writer)
    store_data.native_available = lambda: False
    with contextlib.redirect_stdout(said):
        assert isinstance(store_data.make_batcher([path], 2), GraphBatcher)
    assert "numpy reader" in said.getvalue()
    enc = scene_encodings_cached(model, path, lambda p: scene, device="cpu")
    assert os.path.exists(path + ".enc.npz") and len(enc["x_img"]) == scene.num_detections
    stream = StreamingEncodedBatcher([path], model, lambda p: scene, 2, uniform=True,
                                     device="cpu")
    mm = GNNTrainer(make_model("mm", depth=1), GNNConfig(), device="cpu")
    (hist,) = mm.fit(stream, epochs=1, verbose=False, fused_steps=2, writer=writer)
    writer.close()
    assert len(open(os.path.join(tmp, "log", "metrics.jsonl")).readlines()) == 2
    tree = msgpack.restore(bytes.fromhex(
        "82a6706172616d7381a177c71901939103a7666c6f61743332c40c000000000000803f"
        "00000040a473746570c70e039390a5696e743332c40402000000"))
    assert tree["params"]["w"].tolist() == [0.0, 1.0, 2.0] and tree["step"] == 2
    try:
        scene_encodings_cached(model, path, lambda p: scene, cache=False)
    except RuntimeError as err:
        assert "device='cpu'" in str(err)
    else:
        raise AssertionError("scene_encodings_cached ran without a GPU")

    # encoder training: the loaders and stacked datasets over .npy files, the
    # three trainers through fit and fit_device, an epoch checkpoint grafted
    from batch3dmot_tpu_torch.config import EncoderTrainConfig
    from batch3dmot_tpu_torch.data import modality, preprocess
    from batch3dmot_tpu_torch.train import encoders as enc_train
    from batch3dmot_tpu_torch.utils.checkpoint import merge_encoder_params

    rng = np.random.default_rng(0)
    entries = []
    for i in range(8):
        np.save(os.path.join(tmp, f"a{i}.npy"), rng.normal(size=(18, 20)).astype(np.float32))
        entries.append({"sample_annotation_token": f"a{i}", "category_name": "vehicle.car",
                        "num_lidar_pts": 20, "num_radar_pts": 20, "ann_ego_radius": 9.0})
    assert modality.reference_normalize(np.ones((3, 2))).shape == (3, 2)
    ecfg = EncoderTrainConfig(batch_size=4)
    lidar = list(preprocess.lidar_batches(tmp, entries, 4, num_points=16, augment=True))
    radar = list(preprocess.radar_batches(tmp, entries, 4, num_points=16))
    pn = enc_train.make_pointnet_trainer(ecfg, device="cpu")
    rn = enc_train.make_radarnet_trainer(ecfg, device="cpu")
    (hist,) = pn.fit(lambda: iter(lidar), epochs=1, verbose=False, log_dir=tmp, prefix="pn")
    assert np.isfinite(hist["train/nll"])
    (hist,) = rn.fit_device(preprocess.materialize_radar_dataset(tmp, entries, num_points=16),
                            transform=enc_train.radar_transform(16), epochs=1, verbose=False)
    (hist,) = pn.fit_device(preprocess.materialize_lidar_dataset(tmp, entries, num_points=16),
                            transform=enc_train.lidar_transform(16), epochs=1, verbose=False)
    rs = enc_train.make_resnet_trainer(ecfg, device="cpu")
    imgs = (rng.random((8, 32, 32, 3)) * 255).astype(np.uint8)
    (hist,) = rs.fit_device((imgs, np.zeros(8, np.int32)),
                            transform=enc_train.image_transform(), epochs=1, verbose=False)
    assert np.isfinite(hist["train/mse"])
    pt = [os.path.join(tmp, f) for f in os.listdir(tmp) if f.startswith("pn_epoch0_")
          and f.endswith(".pt")]
    merge_encoder_params(make_model("mm", depth=1), pointnet=pt[0], radarnet=rn.variables)
    try:
        enc_train.make_radarnet_trainer(ecfg)
    except RuntimeError as err:
        assert "device='cpu'" in str(err)
    else:
        raise AssertionError("EncoderTrainer ran without a GPU")

    from batch3dmot_tpu_torch.parallel import make_mesh
    try:
        make_mesh(1)
    except RuntimeError as err:
        assert "device='cpu'" in str(err)
    else:
        raise AssertionError("make_mesh ran without a GPU")

    bad = sorted(m for m in sys.modules
                 if m in ("jax", "flax", "optax", "msgpack", "batch3dmot_tpu")
                 or m.startswith(("jax.", "flax.", "optax.", "msgpack.", "batch3dmot_tpu.")))
    assert not bad, bad
    print("ok", len(avg))
    """
)

FOREIGN = ("jax", "flax", "optax", "msgpack", "batch3dmot_tpu")


def test_port_imports_no_jax_and_needs_no_gpu():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""  # no GPU, whatever the machine has
    env["PATH"] = "/usr/bin:/bin"  # no nvcc on the path
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def _dryrun_rank(mesh, out_dir):
    """The dry run's rank entry, then the foreign modules this rank holds."""
    from batch3dmot_tpu_torch.parallel import dryrun

    dryrun._rank(mesh, out_dir)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
    torch.save(bad, f"{out_dir}/modules{mesh.rank}.pt")


def test_spawned_dryrun_ranks_import_no_jax(tmp_path):
    """Two gloo ranks spawned from this process (which holds JAX) run the
    data-parallel dry run's six paths and import no JAX, flax, optax,
    msgpack or batch3dmot_tpu module; the dry run's comparison holds them
    to the same paths in one process."""
    from batch3dmot_tpu_torch.parallel.dryrun import compare, run_paths
    from batch3dmot_tpu_torch.parallel.mesh import spawn

    spawn(_dryrun_rank, 2, str(tmp_path), device="cpu")
    ranks = []
    for rank in range(2):
        assert torch.load(tmp_path / f"modules{rank}.pt") == []
        ranks.append(torch.load(tmp_path / f"rank{rank}.pt", weights_only=False))
        assert len(ranks[-1]["losses"]) == 5 and ranks[-1]["pipeline"] and ranks[-1]["cached"]
    worst = compare(ranks, run_paths(None, 2, device="cpu", say=lambda line: None))
    assert worst["param"] <= 1e-5 and worst["grad"] <= 1e-6
    assert worst["pipeline"] <= 1e-6 and worst["cached"] <= 1e-6


CLI_SCRIPT = textwrap.dedent(
    """
    import sys, tempfile
    import torch
    torch.set_num_threads(1)
    from batch3dmot_tpu_torch.cli import main

    tmp = tempfile.mkdtemp()
    common = ["--set", f"paths.tmp={tmp}", "--set", "graph_construction.batch_size_graph=3",
              "--set", "graph_construction.top_knn_nodes=4", "--set", "gnn.gnn_depth=1",
              "--device", "cpu"]
    main(["build-graphs", "--synthetic", "1", *common])
    history = main(["train-gnn", "--model", "pose", "--epochs", "1", *common])
    assert history[0]["train/loss"] > 0
    main(["predict", "--model", "pose", *common])
    main(["predict", "--model", "mm", "--pipeline", "device", "--synthetic", "1", *common,
          "--set", f"paths.eval={tmp}/dev"])
    main(["train-gnn", "--model", "mm", "--encoded", "--epochs", "1", *common,
          "--set", f"paths.models={tmp}/mm"])
    bad = sorted(m for m in sys.modules if m.split(".")[0] in
                 ("jax", "flax", "optax", "msgpack", "batch3dmot_tpu", "yaml"))
    assert not bad, bad
    main(["build-graphs", "--synthetic", "1", "--config", sys.argv[1], *common])
    assert "yaml" in sys.modules
    print("ok")
    """
)


def test_cli_imports_no_jax_and_no_yaml_without_a_config():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PATH"] = "/usr/bin:/bin"
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", CLI_SCRIPT, str(REPO / "configs" / "pose_mini.yaml")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.rstrip().endswith("ok")


def _cli_rank(mesh, argv, result_path, out_dir):
    """A ``--devices`` rank of the CLI, then the foreign modules it holds."""
    from batch3dmot_tpu_torch import cli

    cli._rank_command(mesh, argv, result_path)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in (*FOREIGN, "yaml"))
    torch.save(bad, f"{out_dir}/cli_modules{mesh.rank}.pt")


def test_spawned_cli_ranks_import_no_jax(tmp_path):
    """The ranks of ``predict --devices 2`` (spawned from this process,
    which holds JAX) import no foreign module and no yaml; rank 0 writes
    the result the parent returns."""
    from batch3dmot_tpu_torch import cli
    from batch3dmot_tpu_torch.parallel.mesh import spawn

    common = ["--set", f"paths.tmp={tmp_path}", "--set", "graph_construction.batch_size_graph=3",
              "--set", "graph_construction.top_knn_nodes=4", "--set", "gnn.gnn_depth=1",
              "--device", "cpu"]
    cli.main(["build-graphs", "--synthetic", "1", *common])
    argv = ["predict", "--model", "pose", "--devices", "2", *common]
    spawn(_cli_rank, 2, argv, str(tmp_path / "result.json"), str(tmp_path), device="cpu")
    for rank in range(2):
        assert torch.load(tmp_path / f"cli_modules{rank}.pt") == []
    assert (tmp_path / "result.json").exists()
    assert (tmp_path / "nuscenes" / "eval" / "submission.json").exists()


DATA_PLANE_SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["PIL"] = None  # as absent as on the card's machine
    sys.modules["yaml"] = None
    import glob, os
    import torch
    torch.set_num_threads(1)
    from batch3dmot_tpu_torch.cli import main

    root, splits, dets, out = sys.argv[1:5]
    sets = []
    for s in (f"paths.tmp={out}", f"paths.data={root}", f"paths.splits_json={splits}",
              f"paths.detections_dir={dets}", "main.version=v1.0-trainval",
              "detections.megvii.train=train.json", "detections.megvii.val=val.json",
              "main.sensors_used.img=false", "graph_construction.batch_size_graph=3"):
        sets += ["--set", s]
    main(["validate-data", "--strict", *sets])
    for modality in ("img", "lidar", "radar"):
        assert main(["preprocess", "--modality", modality, *sets])[modality]["annotations"]
    assert len(glob.glob(f"{out}/nuscenes/preprocessed/lidar/*.npy")) > 10
    said = main(["build-graphs", "--device", "cpu", *sets])
    assert said["modalities"] > 0 and len(glob.glob(f"{out}/nuscenes/graphs/*.b3d")) == 2
    main(["export-gt", "--out", f"{out}/gt.json", *sets])
    try:
        main(["build-graphs", "--device", "cpu", *sets, "--set", "main.sensors_used.img=true",
              "--set", f"paths.graphs_dir={out}/img"])
    except ImportError as err:
        assert "PIL" in str(err)
    else:
        raise AssertionError("an image request ran without PIL")
    bad = sorted(m for m in sys.modules if sys.modules[m] is not None and m.split(".")[0] in
                 ("jax", "flax", "optax", "msgpack", "batch3dmot_tpu", "PIL", "yaml"))
    assert not bad, bad
    print("ok")
    """
)


def test_data_plane_runs_without_pil_and_yaml(tmp_path):
    """A fabricated tree written here (with PIL); the lidar and radar data
    plane run on it in a subprocess that cannot import PIL or yaml."""
    from fab_nusc import make_fab_dataset_multi, make_fab_detections

    root, splits = make_fab_dataset_multi(
        tmp_path, num_scenes=3, num_samples=4, splits={"train": [0, 1], "val": [2]},
        version="v1.0-trainval")
    dets = tmp_path / "dets"
    for split, toks in (("train", ["scene0", "scene1"]), ("val", ["scene2"])):
        make_fab_detections(root, "v1.0-trainval", str(dets / f"{split}.json"),
                            scene_tokens=toks)
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PATH"] = "/usr/bin:/bin"
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", DATA_PLANE_SCRIPT, root, splits, str(dets), str(tmp_path / "out")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.rstrip().endswith("ok")
