"""The port's CLI against the JAX CLI on stores built from a fabricated
nuScenes tree (``test_torch_cli_nuscenes.py``'s, every sensor): ``train-gnn
--model mm --encoded`` from one JAX checkpoint with the same history (rel
1e-4), then ``predict`` from the JAX epoch checkpoint through the
``encoded`` and ``windows`` pipelines over the stores and the ``device``
pipeline straight from the tree's val split: per-scene edge scores at
rtol 2e-4 / atol 2e-5, the same submission, and the same AMOTA against
``export-gt``. And ``test_nuscenes_e2e.py``'s fixed values on the port's
CLI alone."""

import json
import os

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
    edge_scores,
    jax_init_checkpoint,
    paths_of,
)
from test_torch_cli_nuscenes import data_args, fab  # noqa: F401 (the fixture)

torch.set_num_threads(1)


def _run(side, argv):
    return jax_main(argv) if side == "jax" else tcli.main([*argv, "--device", "cpu"])


@pytest.fixture(scope="module")
def trained(fab):  # noqa: F811
    tmp = fab["parent"] / "train"
    start = jax_init_checkpoint(tmp / "start.msgpack", "mm")
    roots, hist = {}, {}
    for side in ("jax", "port"):
        roots[side] = tmp / side
        _run(side, ["build-graphs", *data_args(fab, roots[side])])
        hist[side] = _run(side, ["train-gnn", "--model", "mm", "--encoded", "--epochs", "1",
                                 "--init-checkpoint", start, *data_args(fab, roots[side])])
    ck = checkpoints(paths_of(roots["jax"]) + "/models", "msgpack")[-1]
    gt = str(tmp / "gt.json")
    jax_main(["export-gt", "--out", gt, *data_args(fab, tmp, sizes=False)])
    return dict(roots=roots, hist=hist, ck=ck, gt=gt)


def test_train_gnn_mm_encoded_matches_jax(trained):
    assert_histories_close(trained["hist"]["port"], trained["hist"]["jax"])


PIPELINES = {
    "encoded": ["--pipeline", "encoded", "--set", "predict.embedding_cache=off"],
    "windows": ["--pipeline", "windows"],
    "device": ["--pipeline", "device", "--set", "predict.batch_size_graph=3"],
}


@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_predict_matches_jax(fab, trained, pipeline, capsys):  # noqa: F811
    subs, scores = {}, {}
    for side in ("jax", "port"):
        eval_dir = os.path.join(trained["roots"][side], f"eval_{pipeline}")
        capsys.readouterr()
        _run(side, ["predict", "--model", "mm", "--checkpoint", trained["ck"],
                    *PIPELINES[pipeline], *data_args(fab, trained["roots"][side]),
                    "--set", f"paths.eval={eval_dir}"])
        # the stores hold the train split; the device pipeline reads val
        n = 1 if pipeline == "device" else 2
        assert f"predict[{pipeline}]: {n} scenes" in capsys.readouterr().out
        scores[side] = edge_scores(eval_dir)
        subs[side] = os.path.join(eval_dir, "submission.json")
    assert_scores_close(scores["port"], scores["jax"])
    assert_submissions_equal(json.load(open(subs["port"])), json.load(open(subs["jax"])))
    amotas = []
    for run, sub in ((jax_main, subs["jax"]), (tcli.main, subs["port"])):
        capsys.readouterr()
        run(["eval", "--submission", sub, "--gt", trained["gt"]])
        amotas.append(amota_line(capsys.readouterr().out))
    assert amotas[0] == amotas[1]


def test_real_path_end_to_end_fixed_values(tmp_path):
    """``test_nuscenes_e2e.py``'s case on the port's CLI alone: one car over
    six frames of ``make_fab_dataset`` with a near detection and a far false
    positive per frame (mini, no splits JSON: every scene). The fixed
    values of the JAX test hold: six detections matched to ``inst_0``, six
    unmatched, at least five positive edges, six GT boxes exported, and
    the tracker's car AMOTA above 0.5 after two pose epochs."""
    import glob

    from batch3dmot_tpu_torch.eval.tracking_metrics import evaluate_tracking
    from batch3dmot_tpu_torch.io import GraphStoreReader
    from fab_nusc import make_fab_dataset

    root = make_fab_dataset(tmp_path / "fab", num_samples=6)
    results = {
        f"s{i}": [
            {"sample_token": f"s{i}", "translation": t, "size": [2, 4, 1.5],
             "rotation": [1, 0, 0, 0], "velocity": v, "detection_name": "car",
             "detection_score": score}
            for t, v, score in (([10.0 + 2.0 * i + 0.3, 0.1, 0.5], [2.0, 0.0], 0.9),
                                ([10.0 + 2.0 * i + 15.0, 10.0, 0.5], [0.0, 0.0], 0.2))
        ]
        for i in range(6)
    }
    det_dir = os.path.join(root, "detections")
    os.makedirs(det_dir)
    with open(os.path.join(det_dir, "dets_mini.json"), "w") as f:
        json.dump({"results": results}, f)
    sets = [x for s in (
        f"paths.data={root}", f"paths.tmp={tmp_path}", f"paths.detections_dir={det_dir}",
        "main.version=v1.0-mini", "detections.megvii.mini=dets_mini.json",
        "graph_construction.batch_size_graph=2", "graph_construction.top_knn_nodes=3",
        "gnn.gnn_depth=2", "gnn.batch_size=2", "gnn.lr=1e-3", "gnn.weight_decay=0.0",
    ) for x in ("--set", s)]
    tcli.main(["build-graphs", "--device", "cpu", *sets])
    stores = glob.glob(os.path.join(paths_of(tmp_path), "graphs", "*.b3d"))
    assert len(stores) == 1
    meta = json.load(open(stores[0].replace(".b3d", "_metadata.json")))
    assert sum(m["token"] == "inst_0" for m in meta) == 6
    assert sum(m["token"] is None for m in meta) == 6
    reader = GraphStoreReader(stores[0])
    assert sum(float(reader.array(i, "edge_label").sum()) for i in range(reader.num_windows)) >= 5

    tcli.main(["train-gnn", "--model", "pose", "--epochs", "2", "--device", "cpu", *sets])
    ck = checkpoints(paths_of(tmp_path) + "/models", "pt")[-1]
    submission = tcli.main(["predict", "--model", "pose", "--checkpoint", ck, "--device", "cpu",
                            *sets])
    gt_path = str(tmp_path / "gt.json")
    tcli.main(["export-gt", "--out", gt_path, *sets])
    gt = json.load(open(gt_path))
    assert len(gt["boxes"]) == 6
    pred = [b for boxes in submission["results"].values() for b in boxes]
    assert pred
    res = evaluate_tracking(gt["boxes"], pred, gt["frames"])
    assert res.per_class["car"]["amota"] > 0.5, res.summary()
