"""The port's nuScenes data plane against the JAX package's on the same
inputs (numpy seeds and the fabricated trees of ``tests/fab_nusc.py``):
geometry, the sensor-file readers and modality features, the tables and
splits, detection loading and matching, scene assembly, the data doctor's
findings and the store statistics are exactly equal; the L2 preprocessing
artifacts (the three ``processed_*_anns.json`` and every per-annotation
``.npy``) are byte-equal; the per-detection modality extraction of the
real-data graph build is exactly equal; ``encode_dtype="bfloat16"`` keeps
both packages' scores within 0.06 of their float32 ones with equal
presence flags. The cases are those of ``tests/test_geometry.py``,
``test_modality.py``, ``test_preprocess.py``, ``test_detections.py``,
``test_statistics.py`` and ``test_validate_data.py``."""

import dataclasses
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from batch3dmot_tpu import geometry as jgeo
from batch3dmot_tpu.config import Config as JaxConfig
from batch3dmot_tpu.data import detections as jdet
from batch3dmot_tpu.data import modality as jmod
from batch3dmot_tpu.data import nuscenes_tables as jtab
from batch3dmot_tpu.data import preprocess as jpre
from batch3dmot_tpu.data import validate as jval
from batch3dmot_tpu_torch import geometry as tgeo
from batch3dmot_tpu_torch.config import Config
from batch3dmot_tpu_torch.data import detections as tdet
from batch3dmot_tpu_torch.data import modality as tmod
from batch3dmot_tpu_torch.data import nuscenes_tables as ttab
from batch3dmot_tpu_torch.data import preprocess as tpre
from batch3dmot_tpu_torch.data import validate as tval

torch.set_num_threads(1)


def assert_same(a, b, where=""):
    """Recursively equal: arrays by value, dtype and shape; dataclasses by
    field; dicts, lists and tuples by item; floats exactly (NaN == NaN)."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _boxes(rng, n):
    center = rng.uniform(-20, 20, (n, 3))
    wlh = rng.uniform(0.5, 5, (n, 3))
    quat = jgeo.yaw_to_quat(rng.uniform(-np.pi, np.pi, n))
    return center, wlh, quat


# geometry ------------------------------------------------------------------

GEOMETRY = {
    "quat_rotate": lambda g, r: g.quat_rotate(r.normal(size=(5, 4)), r.normal(size=(5, 3))),
    "scale_iou": lambda g, r: g.scale_iou(r.uniform(0.5, 4, (6, 3)), r.uniform(0.5, 4, (6, 3))),
    "box_corners": lambda g, r: g.box_corners(*_boxes(r, 4), wlh_factor=1.3),
    "bottom_corners": lambda g, r: g.bottom_corners(*_boxes(r, 4)),
    "points_in_box": lambda g, r: [
        g.points_in_box(np.array([1.0, 2, 0.5]), np.array([2.0, 4, 1.5]),
                        g.yaw_to_quat(0.7), r.uniform(-4, 5, (3, 400)), wlh_factor=f,
                        ignore_z=z)
        for f in (1.0, 1.05) for z in (False, True)],
    "view_points": lambda g, r: [
        g.view_points(r.uniform(1, 30, (3, 9)), np.array(
            [[1266.4, 0, 816.3], [0, 1266.4, 491.5], [0, 0, 1]]), normalize=n)
        for n in (True, False)],
    "count_box_corners_in_image": lambda g, r: [
        g.count_box_corners_in_image(
            g.box_corners(np.array([x, 0.0, 10.0]), np.array([2.0, 4, 1.5]),
                          g.yaw_to_quat(0.3)),
            np.array([[400.0, 0, 200], [0, 400, 150], [0, 0, 1]]), (400, 300))
        for x in (-30.0, -8.0, 0.0, 3.0, 12.0)],
    "convex_hull": lambda g, r: [g.convex_hull(r.normal(size=(k, 2))) for k in (1, 2, 3, 30)],
    "clip_polygon_to_box": lambda g, r: g.clip_polygon_to_box(
        g.convex_hull(r.uniform(-50, 450, (12, 2))), 0, 0, 400, 300),
    "convex_polygon_intersection_area": lambda g, r: [
        g.convex_polygon_intersection_area(
            g.convex_hull(r.normal(size=(8, 2))), g.convex_hull(r.normal(size=(8, 2)) + d))
        for d in (0.0, 0.5, 10.0)],
    "polygon_area": lambda g, r: g.polygon_area(g.convex_hull(r.normal(size=(10, 2)))),
    "post_process_coords": lambda g, r: [
        g.post_process_coords(r.uniform(lo, hi, (8, 2)), imsize=(400, 300))
        for lo, hi in ((10, 200), (-100, 150), (500, 900))],
    "iou2d_bev": lambda g, r: [
        g.iou2d_bev(np.array([0.0, 0, 0]), np.array([2.0, 4, 1.5]), g.yaw_to_quat(0.2),
                    np.array([dx, 0.5, 0]), np.array([2.2, 4.5, 1.5]), g.yaw_to_quat(-0.4))
        for dx in (0.0, 1.0, 3.0, 9.0)],
    "transform_matrix": lambda g, r: [
        g.transform_matrix(r.normal(size=3), g.quat_normalize(r.normal(size=4)), inverse=i)
        for i in (False, True)],
    "boxes_ego_to_global": lambda g, r: g.boxes_ego_to_global(
        r.normal(size=(5, 3)), g.quat_normalize(r.normal(size=(5, 4))),
        r.normal(size=(5, 3)), r.normal(size=3), g.quat_normalize(r.normal(size=4))),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_geometry_equal(name):
    fn = GEOMETRY[name]
    assert_same(fn(tgeo, np.random.default_rng(3)), fn(jgeo, np.random.default_rng(3)), name)


# modality ------------------------------------------------------------------

CAMERAS = [
    {"channel": "CAM_FRONT", "cs_translation": np.array([1.7, 0.0, 1.5]),
     "cs_rotation": np.array([0.5, -0.5, 0.5, -0.5]),
     "intrinsic": np.array([[1266.4, 0, 816.3], [0, 1266.4, 491.5], [0, 0, 1]]),
     "imsize": (1600, 900)},
    {"channel": "CAM_BACK", "cs_translation": np.array([-1.0, 0.0, 1.5]),
     "cs_rotation": jgeo.quat_multiply(jgeo.yaw_to_quat(np.pi), [0.5, -0.5, 0.5, -0.5]),
     "intrinsic": np.array([[809.2, 0, 829.2], [0, 809.2, 481.8], [0, 0, 1]]),
     "imsize": (1600, 900)},
]


def _radar_cloud(rng, n=60):
    pts = np.zeros((18, n), np.float32)
    pts[0:2] = rng.uniform(-6, 6, (2, n))
    pts[2] = rng.uniform(-0.5, 0.5, n)
    pts[8:10] = rng.normal(size=(2, n))
    return pts


MODALITY = {
    "box_to_camera_frame": lambda m, r: [
        m.box_to_camera_frame(c, w, q, cam["cs_translation"], cam["cs_rotation"])
        for c, w, q in zip(*_boxes(r, 3)) for cam in CAMERAS],
    "select_camera": lambda m, r: [
        m.select_camera(np.array([x, y, 0.5]), np.array([2.0, 4, 1.5]), m.geo.yaw_to_quat(0.4),
                        CAMERAS)
        for x, y in ((12, 1), (-15, 2), (3, 20), (1, 0.5))],
    "crop_coords_for_box": lambda m, r: [
        m.crop_coords_for_box(np.array([x, 0.5, 0.5]), np.array([2.0, 4, 1.5]),
                              m.geo.yaw_to_quat(0.1), CAMERAS[0])
        for x in (-10.0, 2.0, 8.0, 30.0)],
    "crop_and_resize": lambda m, r: [
        m.crop_and_resize(img, (20.3, 15.7, 180.2, 140.9), 32)
        for img in ((r.random((300, 400, 3)) * 255).astype(np.uint8), r.random((300, 400, 3)))],
    "lidar_node_feature": lambda m, r: [
        m.lidar_node_feature(
            np.vstack([r.uniform(-3, 3, (3, n)), r.random((1, n))]),
            np.zeros(3), np.array([2.0, 4, 3]), m.geo.yaw_to_quat(0.3), rng=np.random.default_rng(5))
        for n in (4, 50, 900)],
    "radar_node_feature": lambda m, r: [
        m.radar_node_feature(_radar_cloud(r, n), np.zeros(3), np.array([4.0, 6, 2]),
                             m.geo.yaw_to_quat(-0.2), rng=np.random.default_rng(6))
        for n in (1, 30, 300)],
    "augment_box": lambda m, r: m.augment_box(
        np.ones(3), np.array([2.0, 4, 1.5]), m.geo.yaw_to_quat(0.5), np.random.default_rng(7)),
    "radar_devkit_filter": lambda m, r: [
        m.radar_devkit_filter(np.vstack([
            r.normal(size=(3, 40)), r.integers(0, 8, (1, 40)), r.normal(size=(7, 40)),
            r.integers(0, 5, (1, 40)), r.normal(size=(2, 40)), r.integers(0, 3, (1, 40)),
            r.normal(size=(3, 40))]).astype(np.float32)),
        m.radar_devkit_filter(r.normal(size=(4, 10)))],
    "remove_close": lambda m, r: m.remove_close(r.uniform(-3, 3, (4, 200)), 1.0),
    "sensor_to_ego": lambda m, r: m.sensor_to_ego(
        r.normal(size=(18, 30)).astype(np.float32), r.normal(size=3),
        m.geo.quat_normalize(r.normal(size=4))),
    "reference_normalize": lambda m, r: m.reference_normalize(r.normal(size=(4, 20))),
    "collate_fixed_size": lambda m, r: [
        m.collate_fixed_size(r.normal(size=(4, k)), 16, 3, np.random.default_rng(8))
        for k in (5, 16, 40)],
    "CAM_TO_RADAR": lambda m, r: m.CAM_TO_RADAR,
}


@pytest.mark.parametrize("name", sorted(MODALITY))
def test_modality_equal(name):
    fn = MODALITY[name]
    assert_same(fn(tmod, np.random.default_rng(4)), fn(jmod, np.random.default_rng(4)), name)


def _write_pcd(path, arr, mode="binary", header_cut=None):
    n, f = arr.shape
    fields = ["x", "y", "z"] + [f"f{j}" for j in range(3, f)]
    head = (
        "# .PCD v0.7\nVERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\nSIZE {' '.join(['4'] * f)}\n"
        f"TYPE {' '.join(['F'] * f)}\nCOUNT {' '.join(['1'] * f)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA {mode}\n"
    )
    if header_cut is not None:
        head = head[:header_cut]
    with open(path, "wb") as fh:
        fh.write(head.encode())
        if header_cut is None:
            if mode == "binary":
                fh.write(arr.astype(np.float32).tobytes())
            else:
                fh.write("\n".join(" ".join(f"{v:.6f}" for v in row) for row in arr).encode())


def test_sensor_file_readers_equal(tmp_path):
    rng = np.random.default_rng(9)
    rows = rng.normal(size=(300, 5)).astype(np.float32)
    rows.tofile(tmp_path / "l.pcd.bin")
    assert_same(tmod.load_lidar_bin(str(tmp_path / "l.pcd.bin")),
                jmod.load_lidar_bin(str(tmp_path / "l.pcd.bin")))
    arr = rng.normal(size=(25, 18)).astype(np.float32)
    arr[:, 3] = rng.integers(0, 8, 25)
    arr[:, 11] = rng.integers(0, 5, 25)
    arr[:, 14] = rng.integers(0, 3, 25)
    for mode in ("binary", "ascii"):
        p = str(tmp_path / f"r_{mode}.pcd")
        _write_pcd(p, arr, mode)
        assert_same(tmod.load_radar_pcd(p), jmod.load_radar_pcd(p), mode)
        assert_same(tmod.load_radar_pcd_filtered(p), jmod.load_radar_pcd_filtered(p), mode)
    bad = str(tmp_path / "bad.pcd")
    _write_pcd(bad, arr, header_cut=60)
    for m in (tmod, jmod):
        with pytest.raises(ValueError, match="without a DATA line"):
            m.load_radar_pcd(bad)


# fabricated trees --------------------------------------------------------------


@pytest.fixture(scope="module")
def fab_multi(tmp_path_factory):
    """Two mini_train and one mini_val scene, all 7 classes, intermittent
    lidar and radar coverage, a noisy detector with false positives."""
    from fab_nusc import make_fab_dataset_multi, make_fab_detections

    root, splits_json = make_fab_dataset_multi(
        tmp_path_factory.mktemp("nusc_data"), num_scenes=3, num_samples=5,
        splits={"mini_train": [0, 1], "mini_val": [2]},
    )
    dets = make_fab_detections(
        root, "v1.0-mini", os.path.join(root, "detections", "dets.json"),
        miss_rate=0.15, fp_per_frame=2, noise=0.3, seed=3,
    )
    return root, splits_json, dets


@pytest.fixture(scope="module")
def fab_single(tmp_path_factory):
    from fab_nusc import make_fab_dataset

    return make_fab_dataset(tmp_path_factory.mktemp("nusc_single"), num_samples=3)


def _tables(root, version="v1.0-mini"):
    return ttab.NuScenesTables(root, version), jtab.NuScenesTables(root, version)


def test_tables_equal(fab_multi):
    root, splits_json, _ = fab_multi
    t, j = _tables(root)
    for scene in j.scenes:
        tok = scene["token"]
        assert_same(t.scene_sample_tokens(tok), j.scene_sample_tokens(tok))
        assert_same(t.scene_ego_poses(tok), j.scene_ego_poses(tok))
        assert_same(t.scene_gt(tok), j.scene_gt(tok))
        for s in j.scene_sample_tokens(tok):
            assert_same(t.sample_channels(s), j.sample_channels(s))
            assert_same(t.sample_lidar_sd(s), j.sample_lidar_sd(s))
    for ann in j.table("sample_annotation"):
        assert_same(t.box_velocity(ann), j.box_velocity(ann))
        assert_same(t.box_velocity(ann, max_time_diff=0.4), j.box_velocity(ann, max_time_diff=0.4))


@pytest.mark.parametrize("version", ["v1.0-mini", "v1.0-trainval"])
def test_splits_equal(fab_multi, tmp_path, version):
    root, splits_json, _ = fab_multi
    if version != "v1.0-mini":
        (Path(root) / version).mkdir(exist_ok=True)
        for f in (Path(root) / "v1.0-mini").iterdir():
            (Path(root) / version / f.name).write_bytes(f.read_bytes())
        splits_json = str(tmp_path / "tv.json")
        Path(splits_json).write_text(json.dumps(
            {"train": ["scene-0001", "scene-0002"], "val": ["scene-0003", "scene-9999"]}))
    t, j = _tables(root, version)
    assert_same(ttab._official_splits(splits_json), jtab._official_splits(splits_json))
    assert ttab._official_splits(None) is None and jtab._official_splits(None) is None
    for sj in (splits_json, None):
        assert_same(t.split_scene_lists(sj), j.split_scene_lists(sj))
        for split in ("train", "val", "mini_train", "bogus"):
            outs = []
            for tab in (t, j):
                try:
                    outs.append(tab.scene_metas_for_split(split, sj))
                except KeyError as e:
                    outs.append(("KeyError", str(e)))
            assert_same(outs[0], outs[1], f"{sj} {split}")


def _det_json(tmp_path, boxes):
    p = str(tmp_path / "d.json")
    Path(p).write_text(json.dumps({"results": {"s0": boxes, "s1": []}}))
    return p


def test_detection_loading_equal(fab_multi, tmp_path):
    _, _, dets = fab_multi
    assert_same(tdet.load_detection_results(dets), jdet.load_detection_results(dets))
    box = {"sample_token": "s0", "translation": [1.0, 2, 0], "size": [2, 4, 1.5],
           "rotation": [1, 0, 0, 0], "detection_name": "car", "detection_score": 0.5}
    variants = [dict(box, velocity=[float("nan"), 1.0]), dict(box, velocity=None),
                dict(box), dict(box, detection_name="barrier"), dict(box, velocity=[0.5, 0.2])]
    p = _det_json(tmp_path, variants)
    assert_same(tdet.load_detection_results(p), jdet.load_detection_results(p))


def _frame(mod, rng, n, classes, scores=True):
    c, w, q = _boxes(rng, n)
    return mod.FrameBoxes(
        center=c, wlh=w, quat=q, velocity=rng.normal(size=(n, 3)),
        class_id=np.asarray(classes, np.int32),
        score=rng.uniform(0, 1, n) if scores else np.ones(n),
        instance=[None] * n if scores else [f"i{k}" for k in range(n)],
    )


@pytest.mark.parametrize("method", ["center_dist", "iou"])
def test_match_frame_equal(method):
    out = []
    for mod in (tdet, jdet):
        rng = np.random.default_rng(11)
        gt = _frame(mod, rng, 12, rng.integers(1, 4, 12), scores=False)
        dets = _frame(mod, rng, 15, rng.integers(1, 4, 15))
        dets.center[:10] = gt.center[:10] + rng.normal(0, 0.8, (10, 3))
        dets.wlh[:10] = gt.wlh[:10]
        out.append([
            mod.match_frame(dets, gt, method, dist_thresh=d, iou_thresh=i)
            for d, i in ((2.0, 0.0), (0.5, 0.3))
        ] + [mod.match_frame(dets, mod.FrameBoxes.empty(), method)])
    assert_same(out[0], out[1])
    assert any(x is not None for x in out[0][0])
    with pytest.raises(ValueError, match="Unknown match method"):
        tdet.match_frame(_frame(tdet, np.random.default_rng(0), 1, [1]),
                         _frame(tdet, np.random.default_rng(0), 1, [1], scores=False), "nope")


def _scene_args(mod, tabmod, root, dets_path):
    tables = tabmod.NuScenesTables(root, "v1.0-mini")
    meta = tables.scenes[0]
    toks, ego_t, ego_q = tables.scene_ego_poses(meta["token"])
    return tables, meta["token"], toks, mod.load_detection_results(dets_path), \
        tables.scene_gt(meta["token"]), ego_t, ego_q


@pytest.mark.parametrize("modalities", [(), ("lidar", "radar"), ("img", "lidar", "radar")],
                         ids=["poses", "lidar-radar", "all"])
def test_modalities_and_scene_equal(fab_multi, modalities):
    """extract_detection_modalities, then scene_from_frames with the
    modality arrays and camera_keep, both matching methods."""
    root, _, dets_path = fab_multi
    out = []
    for mod, tabmod, pre, cfg in ((tdet, ttab, tpre, Config()), (jdet, jtab, jpre, JaxConfig())):
        tables, scene_tok, toks, dets, gt, ego_t, ego_q = _scene_args(mod, tabmod, root, dets_path)
        mods = (None,) * 4
        if modalities:
            mods = pre.extract_detection_modalities(tables, toks, dets, cfg, modalities=modalities)
        img, lidar, radar, cam_ok = mods
        scenes = [
            mod.scene_from_frames(
                scene_tok, toks, dets, gt, ego_t, ego_q,
                dataclasses.replace(cfg.graph_construction, match_method=m),
                img=img, lidar=lidar, radar=radar, camera_keep=cam_ok,
            )
            for m in ("center_dist", "iou")
        ]
        scenes.append(mod.scene_from_frames(scene_tok, toks, dets, None, ego_t, ego_q))
        out.append((mods, scenes))
    assert_same(out[0], out[1])
    scene = out[0][1][0]
    assert scene.num_detections > 10 and (scene.token_id >= 0).sum() > 5
    if "lidar" in modalities:
        # (the fabricated radar returns carry ambig_state 0, which the
        # devkit filter drops: the radar rows stay zero on both sides)
        assert np.abs(scene.lidar).sum(axis=(1, 2)).astype(bool).sum() > 3


def test_camera_keep_drops_invisible(fab_single, tmp_path):
    """A detection behind the single forward camera is omitted."""
    results = {f"s{i}": [
        {"sample_token": f"s{i}", "translation": [x, 0.1, 0.5], "size": [2, 4, 1.5],
         "rotation": [1, 0, 0, 0], "velocity": [2.0, 0.0], "detection_name": "car",
         "detection_score": s}
        for x, s in ((10.3 + 2 * i, 0.9), (-15.0, 0.2))] for i in range(3)}
    p = tmp_path / "d.json"
    p.write_text(json.dumps({"results": results}))
    out = []
    for mod, tabmod, pre in ((tdet, ttab, tpre), (jdet, jtab, jpre)):
        tables = tabmod.NuScenesTables(fab_single, "v1.0-mini")
        toks, ego_t, ego_q = tables.scene_ego_poses("scene0")
        dets = mod.load_detection_results(str(p))
        mods = pre.extract_detection_modalities(tables, toks, dets)
        out.append((mods, mod.scene_from_frames(
            "scene0", toks, dets, tables.scene_gt("scene0"), ego_t, ego_q,
            img=mods[0], lidar=mods[1], radar=mods[2], camera_keep=mods[3])))
    assert_same(out[0], out[1])
    assert out[0][1].num_detections == 3 and (out[0][1].token_id == 0).all()


# L2 preprocessing --------------------------------------------------------------


def _tree_bytes(d):
    return {p.relative_to(d).as_posix(): p.read_bytes()
            for p in sorted(Path(d).rglob("*")) if p.is_file()}


def _preprocess(tables, pre, cfg, out, splits_json):
    img = pre.generate_image_annotations(tables, cfg, splits_json=splits_json)
    lid = pre.preprocess_lidar_annotations(tables, os.path.join(out, "lidar"), img, cfg,
                                           splits_json=splits_json)
    rad = pre.preprocess_radar_annotations(tables, os.path.join(out, "radar"), img, cfg,
                                           splits_json=splits_json)
    for kind, anns in (("img", img), ("lidar", lid), ("radar", rad)):
        with open(os.path.join(out, f"processed_{kind}_anns.json"), "w") as f:
            json.dump(anns, f)
    return img, lid, rad


def _by_instance(root, dst):
    """The tree at ``root`` with sample_annotation.json in instance order
    (each instance's annotations in a row, so consecutive annotations
    belong to other samples); the sensor files are linked."""
    os.makedirs(dst)
    for entry in os.listdir(root):
        if entry != "v1.0-mini":
            os.symlink(os.path.join(root, entry), os.path.join(dst, entry))
    shutil.copytree(os.path.join(root, "v1.0-mini"), os.path.join(dst, "v1.0-mini"))
    path = os.path.join(dst, "v1.0-mini", "sample_annotation.json")
    rows = json.load(open(path))
    json.dump(sorted(rows, key=lambda r: r["instance_token"]), open(path, "w"))
    return dst


@pytest.mark.parametrize("tree", ["single", "multi", "multi_by_instance"])
def test_preprocess_artifacts_byte_equal(tree, fab_single, fab_multi, tmp_path,
                                        monkeypatch):
    root, sj = (fab_single, None) if tree == "single" else fab_multi[:2]
    if tree == "multi_by_instance":
        root = _by_instance(root, str(tmp_path / "by_instance"))
    clouds = []  # the port's multisweep aggregations, by sample
    make = tpre.sample_lidar_ego
    monkeypatch.setattr(tpre, "sample_lidar_ego",
                        lambda tables, tok, n: clouds.append(tok) or make(tables, tok, n))
    outs = []
    for tabmod, pre, cfg, name in ((ttab, tpre, Config(), "port"), (jtab, jpre, JaxConfig(), "jax")):
        out = str(tmp_path / name)
        anns = _preprocess(tabmod.NuScenesTables(root, "v1.0-mini"), pre, cfg, out, sj)
        outs.append((anns, _tree_bytes(out)))
    # sample order: one aggregation per sample; instance order: one per run
    # of consecutive annotations of a sample, so more
    assert (len(clouds) > len(set(clouds))) == (tree == "multi_by_instance"), clouds
    assert_same(outs[0][0], outs[1][0])
    assert outs[0][1].keys() == outs[1][1].keys()
    for name in outs[1][1]:
        assert outs[0][1][name] == outs[1][1][name], name
    img, lid, rad = outs[0][0]
    assert sum(map(len, lid.values())) > 0 and sum(map(len, rad.values())) > 0
    if tree == "multi":
        assert set(img) == {"mini_train", "mini_val"}


# the data doctor ---------------------------------------------------------------


def _findings(fs):
    return [(f.level, f.where, f.msg) for f in fs]


def _broken_trees(root, tmp_path):
    """Copies of the fabricated tree with one fault each."""
    trees = {"clean": root}
    for name, table, edit in (
        ("no_instance", "instance", None),
        ("broken_chain", "sample", lambda rows: rows[0].update(next="missing")),
        ("no_lidar", "sample_data", lambda rows: [r.update(is_key_frame=False)
                                                   for r in rows if "LIDAR" in r["token"]]),
        ("bad_category", "instance", lambda rows: rows[0].update(category_token="nope")),
    ):
        dst = tmp_path / name
        (dst / "v1.0-mini").mkdir(parents=True)
        for f in (Path(root) / "v1.0-mini").iterdir():
            if edit is None and f.stem == table:
                continue
            rows = json.loads(f.read_text())
            if edit is not None and f.stem == table:
                edit(rows)
            (dst / "v1.0-mini" / f.name).write_text(json.dumps(rows))
        trees[name] = str(dst)
    return trees


def test_validate_tables_equal(fab_multi, tmp_path):
    root, _, _ = fab_multi
    for name, tree in _broken_trees(root, tmp_path).items():
        got = _findings(tval.validate_tables(tree, "v1.0-mini"))
        assert got == _findings(jval.validate_tables(tree, "v1.0-mini")), name
        assert (name == "clean") == (not any(lvl == "error" for lvl, _, _ in got)), name
    assert _findings(tval.validate_tables(str(tmp_path), "v9")) == \
        _findings(jval.validate_tables(str(tmp_path), "v9"))


def test_validate_detections_and_splits_equal(fab_multi, tmp_path):
    root, splits_json, dets = fab_multi
    tokens = [s["token"] for s in json.loads((Path(root) / "v1.0-mini" / "sample.json").read_text())]
    box = {"sample_token": "s0", "translation": [1.0, 2, 0], "size": [2, 4, 1.5],
           "rotation": [1, 0, 0, 0], "detection_name": "car", "detection_score": 0.5}
    docs = {
        "bare": {"s0": [box]},
        "empty": {"results": {}},
        "schema": {"results": {"s0": [dict(box, size=[1, 2])], "s1": [dict(box, velocity=None)]}},
        "no_tracking": {"results": {"s0": [dict(box, detection_name="barrier")]}},
        "nan": {"meta": {}, "results": {"s0": [dict(box, velocity=[float("nan"), 0.0])]}},
        "not_list": {"results": {"s0": {"x": 1}}},
        "list": [1, 2],
    }
    paths = {"fab": dets, "missing": str(tmp_path / "none.json")}
    for name, doc in docs.items():
        paths[name] = str(tmp_path / f"{name}.json")
        Path(paths[name]).write_text(json.dumps(doc))
    Path(tmp_path / "garbled.json").write_text("{not json")
    paths["garbled"] = str(tmp_path / "garbled.json")
    for name, p in paths.items():
        for toks in (tokens, None, ["zzz"]):
            assert _findings(tval.validate_detection_json(p, toks)) == \
                _findings(jval.validate_detection_json(p, toks)), name
    names = [f"scene-{k:04d}" for k in (1, 2, 3)]
    Path(tmp_path / "s_bad.json").write_text(json.dumps({"train": ["x"], "val": names}))
    Path(tmp_path / "s_shape.json").write_text(json.dumps({"train": "x"}))
    for p in (splits_json, str(tmp_path / "s_bad.json"), str(tmp_path / "s_shape.json"),
              str(tmp_path / "none.json")):
        for split in (None, "mini_val", "val"):
            assert _findings(tval.validate_splits_json(p, names, split)) == \
                _findings(jval.validate_splits_json(p, names, split)), (p, split)


@pytest.mark.parametrize("case", ["clean", "trainval_no_splits", "no_detections"])
def test_validate_config_data_equal(fab_multi, case):
    root, splits_json, dets = fab_multi
    overrides = [f"paths.data={root}", f"paths.detections_dir={os.path.dirname(dets)}",
                 "detections.megvii.mini=dets.json", f"paths.splits_json={splits_json}"]
    if case == "trainval_no_splits":
        overrides += ["main.version=v1.0-trainval", "paths.splits_json="]
    if case == "no_detections":
        overrides[2] = "detections.megvii.val=dets.json"
    cfgs = []
    for C in (Config, JaxConfig):
        cfg = C()
        cfg.apply_overrides(overrides)
        cfgs.append(cfg)
    for split in (None, "mini_train"):  # None: graph_construction.split, 'train'
        got = _findings(tval.validate_config_data(cfgs[0], split=split))
        assert got == _findings(jval.validate_config_data(cfgs[1], split=split))
    assert (case == "clean") == (not any(lvl in ("error", "warn") for lvl, _, _ in got)), got


# store statistics --------------------------------------------------------------


def test_store_statistics_equal(tmp_path):
    from batch3dmot_tpu.graphs import statistics as jstat
    from batch3dmot_tpu_torch.config import GraphConstructionConfig
    from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
    from batch3dmot_tpu_torch.graphs import build_scene_graphs
    from batch3dmot_tpu_torch.graphs import statistics as tstat
    from batch3dmot_tpu_torch.io import save_scene_graphs

    paths = []
    for seed in (0, 1):
        scene = make_synthetic_scene(seed=seed, num_frames=5, num_tracks=6,
                                     classes=["car", "pedestrian", "truck", "bus"])
        windows = list(build_scene_graphs(scene, 3, GraphConstructionConfig(top_knn_nodes=4)))
        paths.append(save_scene_graphs(windows, str(tmp_path / f"s{seed}"),
                                       metadata=scene.metadata))
    hist = tstat.edge_class_histogram(paths)
    assert hist == jstat.edge_class_histogram(paths) and sum(hist.values()) > 0
    assert tstat.relative_frequencies(hist) == jstat.relative_frequencies(hist)
    assert tstat.positive_rate(paths) == jstat.positive_rate(paths) > 0


# encode_dtype --------------------------------------------------------------------


def test_encode_dtype_bfloat16_within_tolerance():
    """The port's bf16 encode against the JAX package's on the same weights
    and inputs: embeddings and scores at rtol 2e-4, atol 2e-5 (their f32
    noise; a point encoder computing in bf16, or on weights not rounded to
    bf16, lands about as far away as the bf16 cast itself moves them,
    which is held above 5e-3 below). Beside it, each package within 0.06 of its float32 scores
    (tests/test_infer.py:216-220), presence flags equal to the float32 ones,
    and the port's float32 scores at the JAX ones."""
    import jax
    import jax.numpy as jnp

    from batch3dmot_tpu.config import GraphConstructionConfig as JaxGC
    from batch3dmot_tpu.data.synthetic import make_synthetic_scene as jax_scene
    from batch3dmot_tpu.graphs import build_scene_graphs as jax_build
    from batch3dmot_tpu.infer.predict import make_scene_encoded_scorer as jax_scorer
    from batch3dmot_tpu.models import MultimodalGNN as JaxMM
    from batch3dmot_tpu.train.data import to_padded
    from batch3dmot_tpu_torch.config import GraphConstructionConfig
    from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
    from batch3dmot_tpu_torch.graphs import build_scene_graphs
    from batch3dmot_tpu_torch.infer.predict import make_scene_encoded_scorer
    from batch3dmot_tpu_torch.models import make_model
    from batch3dmot_tpu_torch.utils.weights import load_flax_variables

    kw = dict(seed=4, num_frames=6, num_tracks=4, with_modalities=True, modality_dropout=0.3)
    buckets = ((64, 256),)
    jscene = jax_scene(**kw)
    jwin = list(jax_build(jscene, 3, JaxGC(top_knn_nodes=3)))
    jm = JaxMM(depth=2)
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.key(0), to_padded(jwin[0], *buckets[0])))
    js32 = jax_scorer(jm, variables, fused=False)
    js16 = jax_scorer(jm, variables, fused=False, encode_dtype="bfloat16")
    j32 = js32.score_scene(jscene, jwin, 4, buckets)
    j16 = js16.score_scene(jscene, jwin, 4, buckets)
    je16 = [np.asarray(x) for x in js16._encode(
        *(jnp.asarray(x) for x in (jscene.img, jscene.lidar, jscene.radar)))]

    scene = make_synthetic_scene(**kw)
    windows = list(build_scene_graphs(scene, 3, GraphConstructionConfig(top_knn_nodes=3)))
    port = load_flax_variables(make_model("mm", depth=2), variables)
    t32 = make_scene_encoded_scorer(port, device="cpu")
    t16 = make_scene_encoded_scorer(port, device="cpu", encode_dtype="bfloat16")
    assert next(port.resnet.parameters()).dtype == torch.float32  # the copy is cast
    s32 = t32.score_scene(scene, windows, 4, buckets)
    s16 = t16.score_scene(scene, windows, 4, buckets)
    for a, b, c, d in zip(s32, s16, j32, j16):
        np.testing.assert_allclose(a, c, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(b, d, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(b, a, atol=0.06)
        np.testing.assert_allclose(d, c, atol=0.06)
    tensors = [torch.from_numpy(x) for x in (scene.img, scene.lidar, scene.radar)]
    with torch.inference_mode():
        e32, e16 = t32._encode(*tensors), t16._encode(*tensors)
    for name, got, want in zip(("x_img", "pn", "rn"), e16[:3], je16[:3]):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5, err_msg=name)
    for got, want in zip(e16[3:], je16[3:]):
        np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(e32[3], e16[3]) and torch.equal(e32[4], e16[4])
    assert 0 < int(e16[3].sum()) < len(e16[3])  # modality dropout left absent clouds
    assert all(t.dtype == torch.float32 for t in e16[:3])
    # the cast moves every embedding far more than the tolerance above
    assert min((a - b).abs().max().item() for a, b in zip(e32[:3], e16[:3])) > 5e-3
