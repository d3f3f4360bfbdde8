"""``train-resnet``, ``train-pointnet`` and ``train-radarnet`` of the port's
CLI against the JAX CLI on the same argv (``--device cpu``): on random
batches (``--synthetic``) and from ``processed_*_anns.json`` files with
their crops and clouds (the host loaders, and ``--device-dataset``), the
per-epoch losses and metrics at rel 1e-4; and a JAX-trained encoder
grafted into ``train-gnn`` (``--resnet-checkpoint``).

Both CLIs start from the JAX trainer's initial weights (the port's
trainer constructor is patched to take them) with dropout 0: the two
packages' random streams cannot match."""

import functools
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from batch3dmot_tpu.cli import main as jax_main
from batch3dmot_tpu.models import encoders as jmodels
from batch3dmot_tpu.train import encoders as jenc
from batch3dmot_tpu_torch.models import encoders as tmodels
from batch3dmot_tpu_torch.train import encoders as tenc
from test_torch_cli import assert_histories_close, common, paths_of, port_main

torch.set_num_threads(1)

ENCODERS = ("resnet", "pointnet", "radarnet")
# Adam turns float32 noise into whole steps of about lr (a bias right
# before a batch norm has an analytically zero gradient in train mode), and
# on batches of 4 noise clouds PointNet's losses then part at ~1e-3 after 5
# to 6 steps at lr 1e-4 (the first step agrees to 6e-7); an epoch here is
# 16 steps, so PointNet trains at 1e-5, where they stay within 1e-5
SMALL = ["--set", "resnet.batch_size=4", "--set", "pointnet.batch_size=4",
         "--set", "radarnet.batch_size=8", "--set", "pointnet.lr=1e-5",
         "--set", "radarnet.lr=1e-4", "--set", "resnet.lr=1e-4"]
CATEGORIES = ("vehicle.car", "human.pedestrian.adult", "vehicle.truck",
              "vehicle.bus.rigid", "vehicle.bicycle", "human.pedestrian.child")


@pytest.fixture
def same_start(monkeypatch):
    """The port's trainers start from the JAX trainer's initial variables
    (captured as the JAX CLI builds it), both without dropout."""
    captured = {}
    monkeypatch.setattr(jenc, "PointNetClassifier",
                        functools.partial(jmodels.PointNetClassifier, dropout=0.0))
    monkeypatch.setattr(jenc, "RadarNetClassifier",
                        functools.partial(jmodels.RadarNetClassifier, dropout=0.0))
    port_models = {"resnet": tmodels.ResNetAE,
                   "pointnet": functools.partial(tmodels.PointNetClassifier, 7, dropout=0.0),
                   "radarnet": functools.partial(tmodels.RadarNetClassifier, 7, dropout=0.0)}
    for prefix in ENCODERS:
        make = getattr(jenc, f"make_{prefix}_trainer")

        def jax_make(cfg=None, _make=make, _p=prefix, **kw):
            trainer = _make(cfg, **kw)
            captured[_p] = jax.tree.map(np.asarray, trainer.variables)
            return trainer

        def port_make(cfg=None, _p=prefix, **kw):
            return tenc.EncoderTrainer(port_models[_p](), getattr(tenc, f"{_p}_loss"
                                       if _p != "resnet" else "resnet_ae_loss"),
                                       cfg, init_variables=captured[_p], **kw)

        monkeypatch.setattr(jenc, f"make_{prefix}_trainer", jax_make)
        monkeypatch.setattr(tenc, f"make_{prefix}_trainer", port_make)
    return captured


def _both(argv):
    hj = jax_main(argv)
    hp = port_main(argv)
    return hj, hp


@pytest.mark.parametrize("prefix", ENCODERS)
def test_synthetic_encoder_training_matches_jax(prefix, same_start, tmp_path):
    hj, hp = _both([f"train-{prefix}", "--epochs", "1", "--synthetic", *SMALL,
                    "--set", f"paths.tmp={tmp_path}"])
    assert_histories_close(hp, hj)
    assert len(glob.glob(f"{tmp_path}/nuscenes/models/{prefix}/*.pt")) == 1


def _write_anns(root, rng):
    """processed_{img,lidar,radar}_anns.json with train and val entries,
    PNG camera images under the data root and per-annotation clouds."""
    from PIL import Image

    pre = root / "pre"
    data = root / "data"
    for d in (pre / "lidar", pre / "radar", data):
        d.mkdir(parents=True)
    img, lidar, radar = {"train": [], "val": []}, {"train": [], "val": []}, \
        {"train": [], "val": []}
    for i in range(20):
        split = "val" if i % 5 == 4 else "train"
        cat = CATEGORIES[i % len(CATEGORIES)]
        name = f"cam{i}.png"
        Image.fromarray((rng.random((60, 90, 3)) * 255).astype(np.uint8)).save(data / name)
        x0, y0 = rng.uniform(0, 40), rng.uniform(0, 20)
        img[split].append({"filename": name, "category_name": cat,
                           "bbox_corners": [x0, y0, x0 + rng.uniform(10, 45),
                                            y0 + rng.uniform(10, 35)]})
        tok = f"ann{i:03d}"
        k = int(rng.integers(10, 200))
        np.save(pre / "lidar" / f"{tok}.npy", rng.normal(size=(4, k)).astype(np.float32))
        lidar[split].append({"sample_annotation_token": tok, "category_name": cat,
                             "num_lidar_pts": k,
                             "ann_ego_radius": float(rng.uniform(2.0, 40.0))})
        k = int(rng.integers(2, 90))
        np.save(pre / "radar" / f"{tok}.npy", rng.normal(size=(18, k)).astype(np.float32))
        radar[split].append({"sample_annotation_token": tok, "category_name": cat,
                             "num_radar_pts": k,
                             "ann_ego_radius": float(rng.uniform(2.0, 40.0))})
    for kind, anns in (("img", img), ("lidar", lidar), ("radar", radar)):
        (pre / f"processed_{kind}_anns.json").write_text(json.dumps(anns))
    return ["--set", f"paths.preprocessed={pre}", "--set", f"paths.data={data}",
            "--set", f"paths.tmp={root}"]


@pytest.fixture(scope="module")
def anns(tmp_path_factory):
    pytest.importorskip("PIL", reason="the image loaders decode with PIL")
    return _write_anns(tmp_path_factory.mktemp("anns"), np.random.default_rng(3))


@pytest.mark.parametrize("prefix", ENCODERS)
def test_encoder_training_from_annotations_matches_jax(prefix, same_start, anns, capsys):
    """The host loaders over the annotation files (shuffle, the LiDAR
    augmentation, subsampling: numpy draws from the same seed)."""
    hj, hp = _both([f"train-{prefix}", "--epochs", "1", *SMALL, *anns])
    out = capsys.readouterr().out
    assert f"train-{prefix}: " in out and " val annotations, batch " in out
    assert_histories_close(hp, hj)


def test_resnet_device_dataset_matches_jax(same_start, anns, capsys):
    """--device-dataset: every crop decoded once, the epochs on the device
    (the image transform draws nothing, so the JAX losses are reached)."""
    hj, hp = _both(["train-resnet", "--epochs", "2", "--device-dataset", *SMALL, *anns])
    assert capsys.readouterr().out.count("train-resnet: device-resident dataset (") == 2
    assert_histories_close(hp, hj)


@pytest.mark.parametrize("prefix", ["pointnet", "radarnet"])
def test_cloud_device_dataset_trains(prefix, anns, capsys):
    """The point encoders' --device-dataset (the loaders' augmentation and
    subsampling drawn on the device) trains and checkpoints."""
    h = port_main([f"train-{prefix}", "--epochs", "2", "--device-dataset", *SMALL, *anns])
    assert f"train-{prefix}: device-resident dataset (" in capsys.readouterr().out
    assert len(h) == 2 and all(np.isfinite(m["train/loss"]) for m in h)


def test_too_few_annotations_is_refused(anns):
    with pytest.raises(SystemExit, match="usable annotations"):
        port_main(["train-radarnet", "--epochs", "1", *anns, "--set", "radarnet.batch_size=64"])


def test_jax_encoder_grafts_into_train_gnn(tmp_path, capsys):
    """A JAX-trained ResNet-AE msgpack grafted by the port's train-gnn: the
    GNN's resnet weights in its epoch checkpoint are the JAX encoder's."""
    from batch3dmot_tpu_torch.utils.checkpoint import load_flax_encoder_checkpoint

    jax_main(["train-resnet", "--epochs", "1", "--synthetic", *SMALL,
              "--set", f"paths.tmp={tmp_path}/enc"])
    enc = sorted(glob.glob(f"{tmp_path}/enc/nuscenes/models/resnet/*.msgpack"))[-1]
    port_main(["build-graphs", "--synthetic", "1", *common(tmp_path)])
    port_main(["train-gnn", "--model", "mm", "--encoded", "--epochs", "1",
               "--resnet-checkpoint", enc, *common(tmp_path)])
    assert "grafted frozen resnet encoder" in capsys.readouterr().out
    ck = sorted(glob.glob(os.path.join(paths_of(tmp_path), "models", "gnn", "*.pt")))[-1]
    gnn = torch.load(ck, weights_only=True)
    want = load_flax_encoder_checkpoint(enc, tmodels.ResNetAE()).state_dict()
    shared = [k for k in want if f"resnet.{k}" in gnn]
    assert len(shared) > 20
    for k in shared:
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(gnn[f"resnet.{k}"].numpy(), want[k].numpy(),
                                          err_msg=k)
