"""``--devices 2`` of the port's CLI (two gloo ranks on the CPU, spawned
by the CLI) against the JAX CLI's ``--devices 2`` (its CPU mesh) and the
port in one process, on the same argv from one JAX checkpoint:
``train-gnn --model pose`` over host batches (two fused steps; with
``--device-dataset`` in ``test_torch_cli_parallel_dataset.py``), and the
batch rounding; the predict paths and an encoder trainer's batch rounding
are in ``test_torch_cli_parallel_predict.py``. The ranks import no
JAX (``test_torch_no_jax.py``)."""

import pytest
import torch

from batch3dmot_tpu.cli import main as jax_main
from batch3dmot_tpu_torch import cli as tcli
from test_torch_cli import (
    assert_histories_close,
    checkpoints,
    common,
    jax_init_checkpoint,
    port_main,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    return build_both(tmp_path_factory)


def build_both(tmp_path_factory):
    """Stores built by both CLIs and a JAX pose checkpoint."""
    tmp = tmp_path_factory.mktemp("torch_cli_mesh")
    jroot, proot = tmp / "jax", tmp / "port"
    jax_main(["build-graphs", "--synthetic", "2", *common(jroot)])
    port_main(["build-graphs", "--synthetic", "2", *common(proot)])
    return dict(tmp=tmp, jroot=jroot, proot=proot,
                pose=jax_init_checkpoint(tmp / "pose.msgpack", "pose"))


def devices_case(built, extra, capfd):
    """Two ranks train the steps of one process and of the JAX CLI on its
    two-device mesh, every metric at rel 1e-4; rank 0 alone prints and
    writes the checkpoints."""
    argv = ["train-gnn", "--model", "pose", "--epochs", "2", "--init-checkpoint",
            built["pose"], *extra]
    tag = extra[0].strip("-")
    hj = jax_main([*argv, "--devices", "2", *common(built["jroot"]),
                   "--set", f"paths.models={built['jroot']}/{tag}"])
    h1 = port_main([*argv, *common(built["proot"]),
                    "--set", f"paths.models={built['proot']}/{tag}1"])
    h2 = port_main([*argv, "--devices", "2", *common(built["proot"]),
                    "--set", f"paths.models={built['proot']}/{tag}2"])
    out = capfd.readouterr().out
    assert out.count("epoch 1: loss=") == 3  # JAX, one process, rank 0
    assert_histories_close(h2, h1)
    assert_histories_close(h2, hj)
    assert len(checkpoints(built["proot"] / f"{tag}2", "pt")) == 2


def test_train_gnn_devices_matches_single_and_jax(built, capfd):
    devices_case(built, ["--fused-steps", "2"], capfd)


def test_train_gnn_rounds_the_batch_to_the_mesh(built, capsys, monkeypatch):
    """On a mesh of 2 an odd gnn.batch_size is rounded up with the JAX
    CLI's message before the trainer is built (the trainer is stubbed: the
    rounding is all this checks)."""
    from batch3dmot_tpu_torch.train import trainer

    class Built(Exception):
        pass

    def stub(model, cfg, device=None, mesh=None):
        raise Built(cfg.batch_size)

    monkeypatch.setattr(trainer, "GNNTrainer", stub)
    args = tcli.build_parser().parse_args(
        ["train-gnn", "--model", "pose", *common(built["proot"]), "--set", "gnn.batch_size=3"])
    args.mesh = type("Mesh", (), {"size": 2, "rank": 0, "device": torch.device("cpu")})()
    with pytest.raises(Built) as e:
        tcli.cmd_train_gnn(args)
    assert e.value.args == (4,)
    assert ("train-gnn: rounding gnn.batch_size 3 -> 4 (divisible by 2 devices)"
            in capsys.readouterr().out)
