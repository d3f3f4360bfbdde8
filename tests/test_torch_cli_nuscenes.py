"""The port's CLI on a fabricated nuScenes tree against the JAX CLI on the
same argv: ``validate-data`` (the same findings and exit code, ``--strict``,
``--split``), ``preprocess`` (byte-equal artifacts, ``--skip-existing``
writes nothing, a second run writes the same bytes), ``build-graphs`` from
the tables and the detector JSON with each sensor subset the configs use
and the card's lidar+radar (byte-equal stores, ``--skip-existing``),
``export-gt`` (the same JSON), ``eval`` on it (the same AMOTA), ``eval
--devkit`` without the devkit (the JAX message), and the split selection's
refusals. The tree is ``tests/fab_nusc.py``'s v1.0-trainval layout: two
train scenes and one val scene by a splits JSON, all seven classes, a
noisy detector per split. A small tree from ``chip_smoke.py``'s
``write_nuscenes_tree`` (phase 3k's input on the card) goes through
validate-data, preprocess, build-graphs and export-gt in both CLIs too.

The helpers here are shared by ``test_torch_cli_nuscenes_train.py``."""

import json
import os
from pathlib import Path

import pytest
import torch

from batch3dmot_tpu.cli import main as jax_main
from batch3dmot_tpu_torch import cli as tcli
from test_torch_cli import SIZES, amota_line, paths_of

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fab(tmp_path_factory):
    from fab_nusc import make_fab_dataset_multi, make_fab_detections

    parent = tmp_path_factory.mktemp("nusc_cli")
    root, splits_json = make_fab_dataset_multi(
        parent, num_scenes=3, num_samples=5, splits={"train": [0, 1], "val": [2]},
        version="v1.0-trainval",
    )
    det_dir = os.path.join(root, "detections")
    for split, toks, seed in (("train", ["scene0", "scene1"], 1), ("val", ["scene2"], 2)):
        make_fab_detections(root, "v1.0-trainval",
                            os.path.join(det_dir, "megvii", f"{split}.json"),
                            scene_tokens=toks, miss_rate=0.15, fp_per_frame=1, noise=0.2,
                            seed=seed)
    return dict(root=root, splits_json=splits_json, det_dir=det_dir, parent=parent)


SENSORS = {
    "poses": (),
    "img": ("img",),
    "img-lidar": ("img", "lidar"),
    "all": ("img", "lidar", "radar"),
    "lidar-radar": ("lidar", "radar"),
}


def data_args(fab, root, sensors=("img", "lidar", "radar"), sizes=True):
    """``--set`` overrides for the fabricated tree, outputs under ``root``."""
    sets = [
        f"paths.tmp={root}", f"paths.data={fab['root']}",
        f"paths.detections_dir={fab['det_dir']}", f"paths.splits_json={fab['splits_json']}",
        "main.version=v1.0-trainval",
        "detections.megvii.train=megvii/train.json", "detections.megvii.val=megvii/val.json",
        *(f"main.sensors_used.{m}={m in sensors}" for m in ("img", "lidar", "radar")),
    ]
    return [x for s in sets for x in ("--set", s)] + (SIZES if sizes else [])


def run_both(argv_of, capsys, port_extra=()):
    """(JAX outcome, port outcome) of one command: its stdout and the exit
    code it raised (None when it returned). ``argv_of(side)`` gives the
    argv of 'jax' and 'port'."""
    out = []
    for side, run in (("jax", jax_main), ("port", tcli.main)):
        capsys.readouterr()
        code = None
        try:
            run([*argv_of(side), *(port_extra if side == "port" else ())])
        except SystemExit as e:
            code = e.code
        out.append((capsys.readouterr().out, code))
    return out


def tree_bytes(d):
    return {p.relative_to(d).as_posix(): p.read_bytes()
            for p in sorted(Path(d).rglob("*")) if p.is_file()}


def assert_trees_equal(a, b):
    ta, tb = tree_bytes(a), tree_bytes(b)
    assert ta.keys() == tb.keys() and ta
    for name in ta:
        assert ta[name] == tb[name], name


VALIDATE = {
    "clean": ["--strict"],
    "val-split": ["--split", "val", "--strict"],
    "unknown-split": ["--split", "bogus"],
    "strict-warning": ["--strict", "--set", "detections.megvii.train=missing.json"],
}


@pytest.mark.parametrize("case", sorted(VALIDATE))
def test_validate_data_matches_jax(fab, case, capsys, tmp_path):
    (jout, jcode), (pout, pcode) = run_both(
        lambda side: ["validate-data", *data_args(fab, tmp_path, sizes=False), *VALIDATE[case]],
        capsys)
    assert pout == jout and pcode == jcode
    assert (pcode is None) == (case in ("clean", "val-split")), pout


@pytest.fixture(scope="module")
def preprocessed(fab):
    roots = {side: fab["parent"] / f"pre_{side}" for side in ("jax", "port")}
    jax_main(["preprocess", "--modality", "all", *data_args(fab, roots["jax"], sizes=False)])
    said = tcli.main(["preprocess", "--modality", "all",
                      *data_args(fab, roots["port"], sizes=False)])
    return {side: os.path.join(paths_of(r), "preprocessed") for side, r in roots.items()}, said


def test_preprocess_matches_jax(preprocessed):
    """The three processed_*_anns.json and every per-annotation .npy."""
    dirs, said = preprocessed
    assert_trees_equal(dirs["port"], dirs["jax"])
    assert set(said) == {"img", "lidar", "radar"} and all(v["annotations"] for v in said.values())
    anns = json.load(open(os.path.join(dirs["port"], "processed_lidar_anns.json")))
    assert set(anns) == {"train", "val"} and all(anns.values())


def test_preprocess_rerun_and_skip_existing(fab, preprocessed, capsys):
    """--skip-existing rewrites nothing; a plain rerun writes the same bytes."""
    dirs, _ = preprocessed
    root = Path(dirs["port"]).parents[1]
    before = {p: p.stat().st_mtime_ns for p in Path(dirs["port"]).rglob("*") if p.is_file()}
    snapshot = tree_bytes(dirs["port"])
    capsys.readouterr()
    assert tcli.main(["preprocess", "--skip-existing",
                      *data_args(fab, root, sizes=False)]) == {}
    assert "annotations" not in capsys.readouterr().out
    assert before == {p: p.stat().st_mtime_ns
                      for p in Path(dirs["port"]).rglob("*") if p.is_file()}
    tcli.main(["preprocess", *data_args(fab, root, sizes=False)])
    assert tree_bytes(dirs["port"]) == snapshot


def test_preprocess_lidar_needs_img_anns(fab, capsys, tmp_path):
    (jout, jcode), (pout, pcode) = run_both(
        lambda side: ["preprocess", "--modality", "lidar",
                      *data_args(fab, tmp_path / side, sizes=False)], capsys)
    assert pcode == jcode and "run `preprocess --modality img` first" in pcode


@pytest.fixture(scope="module")
def stores(fab):
    """build-graphs by both CLIs for each sensor subset."""
    out = {}
    for name, sensors in SENSORS.items():
        roots = {side: fab["parent"] / f"build_{name}_{side}" for side in ("jax", "port")}
        jax_main(["build-graphs", *data_args(fab, roots["jax"], sensors)])
        said = tcli.main(["build-graphs", "--device", "cpu",
                          *data_args(fab, roots["port"], sensors)])
        out[name] = ({side: os.path.join(paths_of(r), "graphs") for side, r in roots.items()},
                     said, roots["port"])
    return out


@pytest.mark.parametrize("name", sorted(SENSORS))
def test_build_graphs_matches_jax(stores, name):
    """Stores, metadata and frame sidecars byte for byte, train split only."""
    dirs, said, _ = stores[name]
    assert_trees_equal(dirs["port"], dirs["jax"])
    built = sorted(p.name for p in Path(dirs["port"]).glob("*.b3d"))
    assert built == ["scene0_len3.b3d", "scene1_len3.b3d"]
    assert said["detections"] > 40
    assert set(said) >= {"tables", "modalities", "graphs", "write"}
    assert (said["modalities"] > 0) == bool(SENSORS[name])


def test_build_graphs_skip_existing(fab, stores, capsys):
    dirs, _, root = stores["lidar-radar"]
    before = tree_bytes(dirs["port"])
    capsys.readouterr()
    said = tcli.main(["build-graphs", "--device", "cpu", "--skip-existing",
                      *data_args(fab, root, SENSORS["lidar-radar"])])
    assert "0 scenes (2 skipped)" in capsys.readouterr().out
    assert said["detections"] == 0 and said["modalities"] == 0
    assert tree_bytes(dirs["port"]) == before


def test_export_gt_and_eval_match_jax(fab, capsys, tmp_path):
    """export-gt over the eval split (val): the same JSON; eval of a
    submission made from it: the same summary and AMOTA line."""
    paths = {}
    for side, run in (("jax", jax_main), ("port", tcli.main)):
        paths[side] = str(tmp_path / f"gt_{side}.json")
        run(["export-gt", "--out", paths[side], *data_args(fab, tmp_path, sizes=False)])
    gt = json.load(open(paths["port"]))
    assert gt == json.load(open(paths["jax"]))
    assert gt["frames"] and all(t.startswith("sc2_") for t in gt["frames"])
    assert len(gt["boxes"]) == 35
    ids = {inst: str(k) for k, inst in enumerate(sorted({b["instance"] for b in gt["boxes"]}))}
    results = {t: [] for t in gt["frames"]}
    for b in gt["boxes"][::2]:
        results[b["sample_token"]].append({
            "sample_token": b["sample_token"], "translation": b["translation"],
            "size": [2.0, 4.0, 1.5], "rotation": [1.0, 0, 0, 0], "velocity": [0.0, 0.0],
            "tracking_id": ids[b["instance"]], "tracking_name": b["tracking_name"],
            "tracking_score": 0.8})
    sub = tmp_path / "sub.json"
    sub.write_text(json.dumps({"meta": {}, "results": results}))
    (jout, jcode), (pout, pcode) = run_both(
        lambda side: ["eval", "--submission", str(sub), "--gt", paths[side]], capsys)
    assert pout == jout and pcode is jcode is None
    assert 0 < amota_line(pout)["amota"] < 1


def test_eval_devkit_needs_the_devkit(tmp_path, capsys):
    """Without nuscenes-devkit, eval --devkit exits with the JAX message."""
    sub = tmp_path / "sub.json"
    sub.write_text(json.dumps({"results": {}}))
    (_, jcode), (_, pcode) = run_both(
        lambda side: ["eval", "--submission", str(sub), "--devkit"], capsys)
    assert pcode == jcode and pcode.startswith("nuscenes-devkit is not installed")


SPLIT_ERRORS = {
    "unknown-split": ["--set", "graph_construction.split=bogus"],
    "no-splits-json": ["--set", "paths.splits_json="],
    "no-detections": ["--set", "main.detections=centerpoint"],
}


@pytest.mark.parametrize("case", sorted(SPLIT_ERRORS))
def test_split_selection_refusals_match_jax(fab, case, capsys, tmp_path):
    (_, jcode), (_, pcode) = run_both(
        lambda side: ["build-graphs", *data_args(fab, tmp_path / side, ()),
                      *SPLIT_ERRORS[case]], capsys, port_extra=("--device", "cpu"))
    assert isinstance(pcode, str) and pcode == jcode


def test_smoke_tree_matches_jax(capsys, tmp_path):
    """A small tree from ``chip_smoke.py``'s writer (its 3k input on the
    card): validate-data --strict clean and preprocess, build-graphs (lidar
    and radar) and export-gt byte-equal in both CLIs; LIDAR_TOP and the
    radars take full 10 and 6 sweeps."""
    import importlib.util

    import numpy as np

    from batch3dmot_tpu_torch.data.nuscenes_tables import NuScenesTables
    from batch3dmot_tpu_torch.data.preprocess import sample_lidar_ego, sample_radar_ego

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tree = smoke.write_nuscenes_tree(str(tmp_path / "nusc"), seed=1, keyframes=4, objects=20,
                                     others=3, lidar_points=2000, radar_points=30)
    sets = ["--set", f"paths.data={tree['root']}", "--set", f"paths.splits_json={tree['splits_json']}",
            "--set", f"paths.detections_dir={tree['det_dir']}", "--set", "main.version=v1.0-trainval",
            "--set", "detections.megvii.train=megvii/megvii_train.json",
            "--set", "detections.megvii.val=megvii/megvii_val.json",
            "--set", "main.sensors_used.img=false", *SIZES]
    (jout, jcode), (pout, pcode) = run_both(
        lambda side: ["validate-data", "--strict", *sets, "--set", f"paths.tmp={tmp_path}"], capsys)
    assert pout == jout and jcode is pcode is None
    assert "validate-data: 0 error(s), 0 warning(s)" in pout
    for side, run in (("jax", jax_main), ("port", tcli.main)):
        argv_tmp = ["--set", f"paths.tmp={tmp_path / side}"]
        run(["preprocess", *sets, *argv_tmp])
        run(["build-graphs", *sets, *argv_tmp, *(["--device", "cpu"] if side == "port" else [])])
        run(["export-gt", "--out", str(tmp_path / side / "gt.json"), *sets, *argv_tmp])
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    assert len(list((tmp_path / "port").rglob("*.b3d"))) == 1
    tables = NuScenesTables(tree["root"], tree["version"])
    tok = tables.scene_sample_tokens("sc0")[-1]
    assert sample_lidar_ego(tables, tok, 10).shape[1] >= 10 * (2000 - 40)
    front = sample_radar_ego(tables, tok, ["RADAR_FRONT"], 6)
    assert front.shape[0] == 18 and front.shape[1] > 3 * 30
    assert np.isfinite(front).all()
