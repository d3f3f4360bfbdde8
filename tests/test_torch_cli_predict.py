"""The port's CLI on the multimodal model against the JAX CLI on the same
argv (``--device cpu``): ``train-gnn --model mm --encoded`` from one JAX
checkpoint (the automatic device-resident dataset) with the same history,
then ``predict`` from the JAX epoch checkpoint through every pipeline
(``windows``, ``encoded``, ``auto``, ``device``) with the same per-scene
edge scores, submission and AMOTA; and, on the port alone, grouped against
ungrouped predict, ``--skip-existing`` and the embedding cache. The
windows and device pipelines are in ``test_torch_cli_device.py``."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from batch3dmot_tpu.cli import main as jax_main
from batch3dmot_tpu_torch import cli as tcli
from test_torch_cli import (
    amota_line,
    assert_histories_close,
    assert_scores_close,
    assert_submissions_equal,
    checkpoints,
    common,
    edge_scores,
    jax_init_checkpoint,
    paths_of,
    port_main,
    write_gt,
)

torch.set_num_threads(1)

@pytest.fixture(scope="module")
def mm_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli_mm")
    jroot, proot = tmp / "jax", tmp / "port"
    jax_main(["build-graphs", "--synthetic", "2", *common(jroot)])
    port_main(["build-graphs", "--synthetic", "2", *common(proot)])
    start = jax_init_checkpoint(tmp / "start.msgpack")
    argv = ["train-gnn", "--model", "mm", "--encoded", "--epochs", "1",
            "--init-checkpoint", start]
    hj = jax_main([*argv, *common(jroot)])
    hp = port_main([*argv, *common(proot)])
    ck = checkpoints(paths_of(jroot) + "/models", "msgpack")[-1]
    return dict(tmp=tmp, jroot=jroot, proot=proot, hj=hj, hp=hp, ck=ck)


def _predict(run, root, ck, tag, *extra):
    eval_dir = os.path.join(root, f"eval_{tag}")
    run(["predict", "--model", "mm", "--checkpoint", ck, *common(root),
         "--set", f"paths.eval={eval_dir}", *extra])
    return eval_dir


def test_train_gnn_mm_encoded_matches_jax(mm_run):
    """The automatic device-resident dataset (dedup encodings, fit_device)
    from the same JAX checkpoint: every metric at rel 1e-4."""
    assert_histories_close(mm_run["hp"], mm_run["hj"])
    assert glob.glob(os.path.join(paths_of(mm_run["proot"]), "graphs", "*.b3d.enc.npz"))


PIPELINES = {
    # raw-modality encode in both (the caches hold each package's own
    # encodings, whose float16 transport could round apart)
    "encoded": ["--pipeline", "encoded", "--set", "predict.embedding_cache=off"],
    # the caches both trainings wrote, at float32 transport
    "auto": ["--set", "predict.embedding_dtype=float32"],
}


@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_predict_mm_matches_jax(mm_run, pipeline, capsys):
    """Each pipeline from the JAX msgpack: per-scene edge scores at rtol
    2e-4 / atol 2e-5, the same submission and the same eval AMOTA."""
    extra = PIPELINES[pipeline]
    jdir = _predict(jax_main, mm_run["jroot"], mm_run["ck"], pipeline, *extra)
    capsys.readouterr()
    pdir = _predict(port_main, mm_run["proot"], mm_run["ck"], pipeline, *extra)
    out = capsys.readouterr().out
    shown = "encoded" if pipeline == "auto" else pipeline
    assert f"predict[{shown}]: 2 scenes" in out
    if pipeline == "auto":
        assert "cached-embedding path (float32 uploads, 2 scenes)" in out
    assert_scores_close(edge_scores(pdir), edge_scores(jdir))
    subs = [os.path.join(d, "submission.json") for d in (jdir, pdir)]
    assert_submissions_equal(json.load(open(subs[1])), json.load(open(subs[0])))
    gt = write_gt(mm_run["tmp"] / "gt.json", 2)
    amotas = []
    for run, sub in ((jax_main, subs[0]), (tcli.main, subs[1])):
        run(["eval", "--submission", sub, "--gt", gt])
        amotas.append(amota_line(capsys.readouterr().out))
    assert amotas[0] == amotas[1]


def test_scene_from_store_matches_jax(mm_run):
    from batch3dmot_tpu.cli import _scene_from_store as jax_scene
    from batch3dmot_tpu.io import GraphStoreReader as JReader
    from batch3dmot_tpu_torch.cli import _scene_from_store
    from batch3dmot_tpu_torch.io import GraphStoreReader

    store = sorted(glob.glob(os.path.join(paths_of(mm_run["proot"]), "graphs", "*.b3d")))[0]
    got = _scene_from_store(store, GraphStoreReader(store).windows(), with_modalities=True)
    want = jax_scene(store, JReader(store).windows(), with_modalities=True)
    for f in ("num_frames", "scene_token", "metadata", "frame_tokens"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("frame_idx", "center_g", "yaw_g", "vel_g", "center_e", "yaw_e", "vel_e",
              "wlh", "class_id", "score", "token_id", "img", "lidar", "radar"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert np.abs(got.vel_g).sum() > 0


def grouped_runs(run, root, ck, pipeline, sizes):
    """Edge scores and submission of predict at each scenes_per_batch in
    ``sizes``."""
    extra = ["--pipeline", pipeline]
    if pipeline == "device":
        extra += ["--synthetic", "3", "--set", "predict.batch_size_graph=3"]
    else:
        extra += ["--set", "predict.embedding_cache=off"]
    runs = []
    for n in sizes:
        d = _predict(run, root, ck, f"grp_{pipeline}{n}", *extra,
                     "--set", f"predict.scenes_per_batch={n}")
        runs.append((edge_scores(d), json.load(open(os.path.join(d, "submission.json")))))
    return runs


def test_grouped_predict_matches_ungrouped(mm_run):
    """predict.scenes_per_batch 3 (one encode and pooled window batches per
    group, a partial group here) gives the scores and submission of one
    scene at a time."""
    (s1, sub1), (s2, sub2) = grouped_runs(port_main, mm_run["proot"], mm_run["ck"],
                                          "encoded", (1, 3))
    assert len(s1) == 2
    assert_scores_close(s2, s1, rtol=1e-5, atol=1e-6)
    assert_submissions_equal(sub2, sub1)


def test_predict_skip_existing_resumes(mm_run):
    """A re-run with one scene's results kept and the rest deleted (an
    interrupted run) gives the same submission."""
    root, ck = mm_run["proot"], mm_run["ck"]
    d = _predict(port_main, root, ck, "resume")
    sub1 = json.load(open(os.path.join(d, "submission.json")))
    results = sorted(glob.glob(os.path.join(d, "predict", "*_results.json")))
    assert len(results) == 2
    os.remove(os.path.join(d, "submission.json"))
    os.remove(results[1])
    _predict(port_main, root, ck, "resume", "--skip-existing")
    assert_submissions_equal(json.load(open(os.path.join(d, "submission.json"))), sub1)


def test_embedding_cache_roundtrip(mm_run, capsys):
    """predict.embedding_cache: `write` scores from the per-scene caches
    (float32 transport: the raw path's scores at 1e-4); a warm `auto`
    re-run is bit-identical; a stale or unreadable cache is reported and
    `auto` falls back to the raw encode, bit-identically."""
    root, ck = mm_run["tmp"] / "cache", mm_run["ck"]
    port_main(["build-graphs", "--synthetic", "2", *common(root)])
    capsys.readouterr()

    def run(tag, *extra):
        d = _predict(port_main, root, ck, tag, "--pipeline", "encoded", *extra)
        return edge_scores(d), capsys.readouterr().out

    s_off, out = run("off", "--set", "predict.embedding_cache=off")
    assert "cached-embedding path" not in out
    f32 = ["--set", "predict.embedding_dtype=float32"]
    s_w, out = run("write", "--set", "predict.embedding_cache=write", *f32)
    assert "cached-embedding path" in out
    stores = glob.glob(os.path.join(paths_of(root), "graphs", "*.b3d"))
    assert stores and all(os.path.exists(f"{p}.enc.npz") for p in stores)
    assert_scores_close(s_w, s_off, rtol=1e-4, atol=1e-5)
    s_a, out = run("auto", *f32)
    assert "cached-embedding path" in out and s_a == s_w
    with np.load(f"{stores[0]}.enc.npz", allow_pickle=False) as z:
        full = {k: z[k] for k in z.files}
    np.savez(f"{stores[0]}.enc.npz",
             **{k: (v[:-1] if getattr(v, "ndim", 0) else v) for k, v in full.items()})
    s_s, out = run("stale", *f32)
    assert "ignoring stale embedding cache" in out and "cached-embedding path" not in out
    assert s_s == s_off
    with open(f"{stores[0]}.enc.npz", "wb") as f:
        f.write(b"not an npz")
    s_c, out = run("corrupt", *f32)
    assert "ignoring unreadable embedding cache" in out and "cached-embedding path" not in out
    assert s_c == s_off
