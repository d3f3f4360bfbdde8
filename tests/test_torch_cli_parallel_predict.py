"""``predict --devices N`` of the port's CLI (gloo ranks on the CPU,
spawned by the CLI) against the port in one process and the JAX CLI's
``--devices N`` on its CPU mesh, from one JAX checkpoint: the windows
pipeline (pose, and mm at ``--devices 3``, which rounds the window batch
up to the mesh) and the device pipeline (mm). Rank 0 alone writes the
per-scene JSONs and the submission. And an encoder trainer's batch
rounding on two ranks."""

import json
import os

import numpy as np
import pytest
import torch

from batch3dmot_tpu.cli import main as jax_main
from test_torch_cli import (
    assert_scores_close,
    assert_submissions_equal,
    common,
    edge_scores,
    jax_init_checkpoint,
    port_main,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli_mesh_predict")
    jroot, proot = tmp / "jax", tmp / "port"
    jax_main(["build-graphs", "--synthetic", "2", *common(jroot)])
    port_main(["build-graphs", "--synthetic", "2", *common(proot)])
    return dict(tmp=tmp, jroot=jroot, proot=proot,
                pose=jax_init_checkpoint(tmp / "pose.msgpack", "pose"),
                mm=jax_init_checkpoint(tmp / "mm.msgpack", "mm"))


CASES = {
    "pose-windows": (["--model", "pose"], 2),
    "mm-windows-3": (["--model", "mm", "--pipeline", "windows"], 3),
    "mm-device": (["--model", "mm", "--pipeline", "device", "--synthetic", "2",
                   "--set", "predict.batch_size_graph=3"], 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_predict_devices_matches_single_and_jax(built, case):
    extra, n = CASES[case]
    ck = built["mm" if "mm" in case else "pose"]

    def run(main, root, tag, devices):
        eval_dir = os.path.join(root, f"eval_{case}_{tag}")
        argv = ["predict", "--checkpoint", ck, *extra, *common(root),
                "--set", f"paths.eval={eval_dir}"]
        main(argv + (["--devices", str(devices)] if devices else []))
        return edge_scores(eval_dir), json.load(open(os.path.join(eval_dir, "submission.json")))

    s1, sub1 = run(port_main, built["proot"], "one", 0)
    sn, subn = run(port_main, built["proot"], "mesh", n)
    sj, subj = run(jax_main, built["jroot"], "jax", n)
    assert len(s1) == 2
    assert_scores_close(sn, s1, rtol=1e-5, atol=1e-6)
    assert_scores_close(sn, sj)
    assert_submissions_equal(subn, sub1)
    assert_submissions_equal(subn, subj)


def test_encoder_devices_rounds_the_batch(tmp_path, capfd):
    h = port_main(["train-radarnet", "--epochs", "1", "--synthetic", "--devices", "2",
                   "--set", "radarnet.batch_size=3", "--set", f"paths.tmp={tmp_path}"])
    assert "train-radarnet: rounding batch_size to 4 for 2 devices" in capfd.readouterr().out
    assert len(h) == 1 and np.isfinite(h[0]["train/loss"])
