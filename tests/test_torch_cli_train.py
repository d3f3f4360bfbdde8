"""``train-gnn`` paths of the port's CLI against the JAX CLI on the same
argv (``--device cpu``), each from one JAX checkpoint: ``--device-dataset``
for pose and ``--encoded --stream`` (the scene-streaming batcher); on the
port alone, the forced and the automatic device-resident dataset, the
budget that sends ``--encoded`` to streaming, the refusals, a port ``.pt``
encoder graft, ``--profile``, and ``_estimate_dedup_device_bytes`` against
the bytes the port materializes (both cases of
``test_device_bytes_estimate.py``)."""

import glob
import os

import numpy as np
import pytest
import torch

from batch3dmot_tpu.cli import main as jax_main
from batch3dmot_tpu_torch import cli as tcli
from test_torch_cli import (
    assert_histories_close,
    checkpoints,
    common,
    jax_init_checkpoint,
    paths_of,
    port_main,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli_train")
    jroot, proot = tmp / "jax", tmp / "port"
    jax_main(["build-graphs", "--synthetic", "2", *common(jroot)])
    port_main(["build-graphs", "--synthetic", "2", *common(proot)])
    return dict(tmp=tmp, jroot=jroot, proot=proot,
                mm=jax_init_checkpoint(tmp / "mm.msgpack", "mm"),
                pose=jax_init_checkpoint(tmp / "pose.msgpack", "pose"))


def _both(built, tag, argv):
    """(JAX history, port history) of one argv, each into its own models
    directory ``tag``."""
    out = []
    for run, root in ((jax_main, built["jroot"]), (port_main, built["proot"])):
        out.append(run([*argv, *common(root), "--set", f"paths.models={root}/{tag}"]))
    return out


def test_device_dataset_pose_matches_jax(built, capsys):
    hj, hp = _both(built, "pose_dd", ["train-gnn", "--model", "pose", "--epochs", "2",
                                      "--device-dataset", "--init-checkpoint", built["pose"]])
    assert "train-gnn: device-resident dataset (" in capsys.readouterr().out
    assert_histories_close(hp, hj)
    assert checkpoints(built["proot"] / "pose_dd", "pt")


def test_encoded_stream_matches_jax(built, capsys):
    """--encoded --stream (StreamingEncodedBatcher, fused steps): the JAX
    CLI's history at rel 1e-4."""
    hj, hp = _both(built, "stream", ["train-gnn", "--model", "mm", "--encoded", "--stream",
                                     "--epochs", "1", "--init-checkpoint", built["mm"]])
    out = capsys.readouterr().out
    assert "auto device-resident" not in out and "train batches/epoch" in out
    assert_histories_close(hp, hj)


def test_device_resident_encoded_routes(built, capsys, monkeypatch):
    """Forced and automatic device-resident datasets train the same steps;
    an impossible budget makes the estimate choose streaming, which equals
    --stream; multimodal --device-dataset needs --encoded."""
    root = built["proot"]
    base = ["train-gnn", "--model", "mm", "--encoded", "--epochs", "1",
            "--init-checkpoint", built["mm"], *common(root)]

    def run(tag, *extra):
        h = port_main([*base, *extra, "--set", f"paths.models={root}/{tag}"])
        return h, capsys.readouterr().out

    h_auto, out = run("auto")
    assert "auto device-resident dataset" in out and "device-resident dataset (" in out
    h_forced, out = run("forced", "--device-dataset")
    assert "auto device-resident" not in out and "device-resident dataset (" in out
    assert_histories_close(h_forced, h_auto, rel=1e-6)
    h_stream, _ = run("stream", "--stream")
    monkeypatch.setenv("B3D_DEVICE_DATASET_GB", "0.000001")
    h_tiny, out = run("tiny")
    assert "exceeds" in out and "train batches/epoch" in out
    assert_histories_close(h_tiny, h_stream, rel=1e-6)
    with pytest.raises(SystemExit, match="needs --encoded"):
        port_main(["train-gnn", "--model", "mm", "--device-dataset", "--epochs", "1",
                   *common(root)])


def test_port_encoder_graft_and_profile(built, capsys):
    """A port .pt from train-resnet grafts into train-gnn (which then runs
    under --profile and writes a Chrome trace)."""
    enc_root = built["tmp"] / "port_enc"
    port_main(["train-resnet", "--epochs", "1", "--synthetic", "--set", "resnet.batch_size=4",
               "--set", f"paths.tmp={enc_root}"])
    enc = sorted(glob.glob(f"{enc_root}/nuscenes/models/resnet/*.pt"))[-1]
    trace = built["tmp"] / "trace"
    h = port_main(["train-gnn", "--model", "mm", "--encoded", "--device-dataset",
                   "--epochs", "1", "--resnet-checkpoint", enc, "--profile", str(trace),
                   *common(built["proot"]), "--set", f"paths.models={built['proot']}/pgraft"])
    assert "grafted frozen resnet encoder" in capsys.readouterr().out
    assert np.isfinite(h[0]["train/loss"])
    assert glob.glob(str(trace / "trace_*.json"))
    assert checkpoints(built["proot"] / "pgraft", "pt")
    with pytest.raises(SystemExit, match="pointnet"):
        port_main(["train-gnn", "--model", "mm", "--encoded", "--epochs", "1",
                   "--pointnet-checkpoint", enc, *common(built["proot"])])


def _estimate_case(tmp_path, scenes):
    """(estimate, the bytes of what the device-resident branch
    materializes) over ``scenes`` stores."""
    from batch3dmot_tpu_torch.io import GraphStoreReader
    from batch3dmot_tpu_torch.models import MultimodalGNN
    from batch3dmot_tpu_torch.train.encoded import (
        materialize_encoded_datasets_dedup,
        precompute_scene_encodings,
    )

    port_main(["build-graphs", "--synthetic", str(scenes), "--set", f"paths.tmp={tmp_path}",
               "--set", "graph_construction.batch_size_graph=2",
               "--set", "graph_construction.synthetic_frames=8",
               "--set", "graph_construction.synthetic_tracks=6"])
    stores = sorted(glob.glob(os.path.join(paths_of(tmp_path), "graphs", "*.b3d")))
    assert len(stores) == scenes
    est = tcli._estimate_dedup_device_bytes(stores)
    model = MultimodalGNN(depth=2)
    items = []
    for p in stores:
        windows = GraphStoreReader(p).windows()
        scene = tcli._scene_from_store(p, windows, with_modalities=True)
        enc = precompute_scene_encodings(model, scene, device="cpu")
        items.extend((w, enc) for w in windows if w.num_nodes > 0 and w.num_edges > 0)
    return stores, est, tcli._dataset_nbytes(materialize_encoded_datasets_dedup(items))


def test_dedup_byte_estimate_pins_materialized_nbytes(tmp_path):
    """The estimate is within 5% of the port's materialized dedup dataset,
    counted as the CLI's budget guard counts it (a shared table once)."""
    from batch3dmot_tpu.cli import _estimate_dedup_device_bytes as jax_estimate

    stores, est, actual = _estimate_case(tmp_path, 2)
    assert abs(est - actual) <= 0.05 * actual, (est, actual)
    assert est == jax_estimate(stores)


def test_dedup_byte_estimate_fallback_without_sidecars(tmp_path):
    stores, with_sidecar, _ = _estimate_case(tmp_path, 1)
    for p in stores:
        os.remove(p.replace(".b3d", "_metadata.json"))
    without = tcli._estimate_dedup_device_bytes(stores)
    assert 0.3 * with_sidecar < without < 3 * with_sidecar
