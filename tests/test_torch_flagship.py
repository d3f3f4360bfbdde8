"""The port's flagship script (``scripts/torch_flagship_synthetic.py``)
against the JAX package's (``scripts/flagship_synthetic.py``) at a tiny
size on the CPU, and the device pipeline on windows past 1,024 nodes.

The JAX script runs in this process (its compile-cache settings left
out); the port's flagship function starts from the JAX trainer's initial
variables, taken from the very trainer the script builds
(``GNNTrainer(model, to_padded(windows[0], bucket), cfg, seed=train_seed)``).
Held: the final training AP at ``rel=1e-4``, the trained weights within
``2·lr·steps``, and AMOTA, AMOTP and the inference edge count exactly, for
a run that trains and for ``--load-checkpoint`` of the JAX msgpack, with
and without ``--device-pipeline``.
"""

import contextlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))

import torch_flagship_synthetic as port_flagship  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
TINY = ["--scenes", "3", "--val-scenes", "2", "--frames", "6", "--tracks", "6",
        "--window-len", "3", "--knn", "8", "--depth", "2", "--epochs", "2"]
LR = 1e-3  # the scripts' default
STEPS = 2 * 2  # 12 training windows at batch size 8: 2 steps an epoch, 2 epochs
EXACT = ("amota", "amotp", "inference_edges", "val_scenes")


def _run_jax(argv, record=None):
    """The JAX script's main() on ``argv``; returns its FLAGSHIP summary.
    With ``record`` (a list), the initial variables of the trainer it
    builds are appended to it."""
    import jax

    import batch3dmot_tpu.train as jax_train
    import flagship_synthetic

    mp = pytest.MonkeyPatch()
    update = jax.config.update
    mp.setattr(jax.config, "update", lambda k, v: None if "cache" in k else update(k, v))
    if record is not None:
        class Recording(jax_train.GNNTrainer):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                record.append(jax.tree.map(np.array, self.variables))

        mp.setattr(jax_train, "GNNTrainer", Recording)
    mp.setattr(sys, "argv", ["flagship_synthetic.py", *argv])
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            flagship_synthetic.main()
    finally:
        mp.undo()
    return json.loads(re.search(r"^FLAGSHIP (\{.*\})$", buf.getvalue(), re.M).group(1))


def _run_port(argv, init_state_dict=None):
    args = port_flagship.build_parser().parse_args([*argv, "--device", "cpu"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = port_flagship.run(args, init_state_dict=init_state_dict)
    printed = json.loads(re.search(r"^FLAGSHIP (\{.*\})$", buf.getvalue(), re.M).group(1))
    assert printed.keys() == summary.keys()
    return summary


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both scripts: a run that trains (saving its checkpoint) and the
    device pipeline on the JAX checkpoint; the port's trained weights and
    the JAX trainer's initial variables."""
    from batch3dmot_tpu_torch.utils.weights import flax_to_state_dict

    tmp = tmp_path_factory.mktemp("flagship")
    jax_ckpt, port_ckpt = str(tmp / "jax.msgpack"), str(tmp / "port.pt")
    init = []
    jax_trained = _run_jax([*TINY, "--save-checkpoint", jax_ckpt], init)
    jax_device = _run_jax([*TINY, "--load-checkpoint", jax_ckpt, "--device-pipeline"])
    init_sd = {k: torch.from_numpy(v) for k, v in flax_to_state_dict(init[0]).items()}
    port_trained = _run_port([*TINY, "--save-checkpoint", port_ckpt], init_sd)
    return dict(jax_trained=jax_trained, jax_device=jax_device, jax_ckpt=jax_ckpt,
                port_trained=port_trained, port_ckpt=port_ckpt, init=init_sd)


def _assert_same_tracking(got, want):
    for k in EXACT:
        assert got[k] == want[k], (k, got[k], want[k])


def test_flagship_trains_as_jax(runs):
    """A run that trains from the JAX trainer's initial weights: the final
    training AP at rel 1e-4, the trained weights within 2·lr·steps of the
    JAX checkpoint's, the same AMOTA, AMOTP and edges."""
    from batch3dmot_tpu_torch.models import MultimodalGNN
    from batch3dmot_tpu_torch.utils.checkpoint import load_checkpoint, load_flax_checkpoint

    got, want = runs["port_trained"], runs["jax_trained"]
    assert got["final_train_ap"] == pytest.approx(want["final_train_ap"], rel=1e-4)
    _assert_same_tracking(got, want)
    assert got["train_windows"] == want["train_windows"] == 12
    jax_sd = load_flax_checkpoint(runs["jax_ckpt"], MultimodalGNN(depth=2)).state_dict()
    port_sd = load_checkpoint(runs["port_ckpt"])
    assert port_sd.keys() == jax_sd.keys()
    moved = 0
    for k, w in jax_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(port_sd[k].numpy(), w.numpy(), rtol=0,
                                   atol=2 * LR * STEPS + 1e-6, err_msg=k)
        moved += not torch.equal(w, runs["init"][k])
    assert moved > 0  # training moved the weights


def test_flagship_scores_the_jax_checkpoint(runs):
    """--load-checkpoint of the JAX msgpack: the JAX run's AMOTA, AMOTP and
    edges, from the encode-once scorer and from the device pipeline."""
    host = _run_port([*TINY, "--load-checkpoint", runs["jax_ckpt"]])
    _assert_same_tracking(host, runs["jax_trained"])
    device = _run_port([*TINY, "--load-checkpoint", runs["jax_ckpt"], "--device-pipeline"])
    _assert_same_tracking(device, runs["jax_device"])
    assert np.isnan(host["final_train_ap"]) and host["steps_per_s"] == 0.0


def test_flagship_trains_and_scores_on_the_device_pipeline(runs):
    """A run that trains, then scores with the device pipeline: the JAX
    device pipeline's numbers on the JAX-trained weights."""
    got = _run_port([*TINY, "--device-pipeline"], runs["init"])
    assert got["final_train_ap"] == pytest.approx(runs["jax_trained"]["final_train_ap"],
                                                  rel=1e-4)
    _assert_same_tracking(got, runs["jax_device"])


def test_flagship_refuses_without_a_card_or_with_no_fused():
    """No GPU and no --device cpu: the script raises rather than run on the
    CPU; --no-fused has no counterpart in the port."""
    args = port_flagship.build_parser().parse_args(TINY)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_flagship.run(args)
    args = port_flagship.build_parser().parse_args([*TINY, "--no-fused", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no-fused"):
        port_flagship.run(args)


def test_device_pipeline_past_1024_nodes_matches_jax_module_loop():
    """A scene whose windows pass 1,024 nodes (the old cover) through the
    port's pipeline (the fused kernel's plain version here) against the JAX
    pipeline's module loop on the same weights, at RTOL, ATOL; past the new
    cover the fused pipeline raises with the cover in its message."""
    import jax

    from batch3dmot_tpu.data.synthetic import make_synthetic_scene as jax_scene
    from batch3dmot_tpu.infer.device_pipeline import DeviceScenePipeline as JaxPipeline
    from batch3dmot_tpu.models import MultimodalGNN as JaxMM
    from batch3dmot_tpu.train.data import to_padded
    from batch3dmot_tpu_torch.config import GraphConstructionConfig
    from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
    from batch3dmot_tpu_torch.graphs import build_scene_graphs
    from batch3dmot_tpu_torch.infer.device_pipeline import DeviceScenePipeline
    from batch3dmot_tpu_torch.models import make_model
    from batch3dmot_tpu_torch.ops.fused_mp import COVER
    from batch3dmot_tpu_torch.utils.weights import load_flax_variables

    kw = dict(seed=11, num_frames=4, num_tracks=460, with_modalities=False)
    scene = make_synthetic_scene(**kw)
    windows = [w for w in build_scene_graphs(scene, 3, GraphConstructionConfig(top_knn_nodes=8))
               if w.num_edges]
    assert min(w.num_nodes for w in windows) > 1024
    small = next(w for w in build_scene_graphs(
        make_synthetic_scene(seed=0, num_frames=3, num_tracks=3), 3,
        GraphConstructionConfig(top_knn_nodes=3)) if w.num_edges)
    jm = JaxMM(depth=2)
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.key(4), to_padded(small, 64, 256)))
    port = load_flax_variables(make_model("mm", depth=2), variables).eval()
    pipe = DeviceScenePipeline(port, 3, 8, device="cpu")
    assert pipe.fused
    got = pipe.score_scene(scene)
    want = JaxPipeline(jm, variables, window_len=3, k=8, fused=False).score_scene(jax_scene(**kw))
    assert set(got) == set(want) and len(want) > 10_000
    for key, v in want.items():
        assert abs(got[key] - v) <= RTOL * abs(v) + ATOL, (key, got[key], v)
    past = make_synthetic_scene(seed=12, num_frames=3, num_tracks=1200, with_modalities=False)
    assert pipe._quanta(past)[2] > COVER[0]
    with pytest.raises(ValueError, match=re.escape(str(COVER))):
        pipe.score_scene(past)
