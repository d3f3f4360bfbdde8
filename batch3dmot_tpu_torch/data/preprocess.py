"""The L2 modality preprocessing of a nuScenes tree, the per-detection
modality extraction of the real-data graph build, and the encoder datasets
(numpy; a copy of ``batch3dmot_tpu/data/preprocess.py``).

  * image annotations: generated natively from the tables (camera calib +
    GT boxes + corner-visibility camera selection), class-filtered and
    ego-radius-gated into the split-keyed ``processed_img_anns.json``;
  * lidar: multisweep cloud -> ego frame -> box mask -> per-annotation
    ``<ann_token>.npy`` + ``processed_lidar_anns.json``;
  * radar: camera-mapped radar channels, velocity-rotated multisweep,
    1.05x box, z-ignoring mask -> ``<ann_token>.npy`` +
    ``processed_radar_anns.json``;
  * ``extract_detection_modalities``: the raw per-detection crops and clouds
    that ``build-graphs`` and ``predict --pipeline device`` read;
  * the encoder datasets: host batch loaders and the stacked datasets of
    device-resident encoder training, over what ``preprocess`` writes
    (entries of the ``processed_*_anns.json`` lists, per-annotation ``.npy``
    clouds, LiDAR [4, K]: x, y, z, intensity; radar [18, K]; and, for the
    images, the camera files under ``dataroot``).

Two differences from the JAX module, neither visible in what is written:
the lidar and radar preprocessing aggregate a sample's sweeps once per
sample (the JAX module re-aggregates them for every annotation; the same
float operations run on the same inputs, so the artifacts are byte-equal),
and ``extract_detection_modalities`` imports PIL only when ``"img"`` is
requested, so the lidar and radar paths run where PIL is absent. PIL is
otherwise imported inside the image functions only.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from batch3dmot_tpu_torch import geometry as geo
from batch3dmot_tpu_torch.config import (
    CATEGORY_TO_TRACKING_NAME,
    TRACKING_CLASSES,
    Config,
)
from batch3dmot_tpu_torch.data import modality as mod
from batch3dmot_tpu_torch.data.nuscenes_tables import NuScenesTables


# ---------------------------------------------------------------------------
# L2 preprocessing from the tables
# ---------------------------------------------------------------------------


def _ann_box(ann: dict):
    return (
        np.array(ann["translation"], float),
        np.array(ann["size"], float),
        np.array(ann["rotation"], float),
    )


def _ann_ego(tables: NuScenesTables, ann: dict):
    """(wlh, ego-frame center, ego-frame quat, ego radius) of an
    annotation."""
    ego_t, ego_q = tables.ego_pose_of_sample(ann["sample_token"])
    center, wlh, quat = _ann_box(ann)
    c_e, q_e, _ = geo.boxes_global_to_ego(
        center[None], quat[None], np.zeros((1, 3)), ego_t, ego_q
    )
    radius = float(np.linalg.norm(center[:2] - ego_t[:2]))
    return wlh, c_e[0], q_e[0], radius


def _tracking_category(tables: NuScenesTables, ann: dict) -> Optional[str]:
    """The raw category name of a tracking-class annotation, else None."""
    inst = tables.get("instance", ann["instance_token"])
    cat = tables.get("category", inst["category_token"])["name"]
    return cat if CATEGORY_TO_TRACKING_NAME.get(cat) is not None else None


def _cameras_of_sample(tables: NuScenesTables, sample_token: str) -> List[dict]:
    cams = []
    for channel, sd_tok in tables.sample_channels(sample_token).items():
        if not channel.startswith("CAM"):
            continue
        sd = tables.get("sample_data", sd_tok)
        cs = tables.get("calibrated_sensor", sd["calibrated_sensor_token"])
        cams.append(
            {
                "channel": channel,
                "filename": sd["filename"],
                "cs_translation": np.array(cs["translation"]),
                "cs_rotation": np.array(cs["rotation"]),
                "intrinsic": np.array(cs["camera_intrinsic"]),
                "imsize": (sd.get("width", 1600), sd.get("height", 900)),
            }
        )
    return cams


def _split_of_scene(tables: NuScenesTables, scene_token: str, splits) -> List[str]:
    name = tables.get("scene", scene_token)["name"]
    out = []
    for split, metas in splits.items():
        if any(m["name"] == name for m in metas):
            out.append(split)
    return out or ["all"]


def _to_ego(tables: NuScenesTables, sample_token: str, pts: np.ndarray) -> np.ndarray:
    """Points in the sample's LIDAR_TOP sensor frame -> its ego frame."""
    ref_sd = tables.sample_lidar_sd(sample_token)
    cs = tables.get("calibrated_sensor", ref_sd["calibrated_sensor_token"])
    return mod.sensor_to_ego(pts, cs["translation"], np.array(cs["rotation"]))


def sample_lidar_ego(tables: NuScenesTables, sample_token: str, nsweeps: int) -> np.ndarray:
    """The sample's LIDAR_TOP multisweep cloud in its ego frame, [4, K]."""
    pts = mod.multisweep_points(
        tables, sample_token, "LIDAR_TOP", nsweeps, mod.load_lidar_bin
    )
    return _to_ego(tables, sample_token, pts)


def sample_radar_ego(
    tables: NuScenesTables, sample_token: str, radar_channels: Sequence[str],
    nsweeps: int,
) -> Optional[np.ndarray]:
    """The velocity-rotated multisweep clouds of ``radar_channels`` (those
    the sample has) concatenated in its ego frame, [18, K]; None when the
    sample has none of them."""
    chunks = []
    for rc in radar_channels:
        try:
            chunks.append(
                mod.multisweep_points(
                    tables, sample_token, rc, nsweeps,
                    mod.load_radar_pcd_filtered, rotate_velocity_rows=(8, 9),
                )
            )
        except KeyError:
            continue  # channel absent from this sample
    if not chunks:
        return None
    return _to_ego(tables, sample_token, np.concatenate(chunks, axis=1))


class _LastSample:
    """The values computed for the last sample seen: consecutive
    annotations of one sample (a table in sample order) share its
    multisweep clouds; in any other order each annotation recomputes them,
    as the JAX package does for every annotation. Holds one sample's values
    at a time."""

    def __init__(self):
        self._token, self._values = None, {}

    def get(self, sample_token: str, key, make):
        if sample_token != self._token:
            self._token, self._values = sample_token, {}
        if key not in self._values:
            self._values[key] = make()
        return self._values[key]


def generate_image_annotations(
    tables: NuScenesTables,
    cfg: Optional[Config] = None,
    splits_json: Optional[str] = None,
) -> Dict[str, List[dict]]:
    """Split-keyed processed image annotations (the ``processed_img_anns.json``
    contract: filename, bbox_corners, category_name, sample_annotation_token,
    visibility_token, ann_ego_radius).

    One entry per (annotation, camera) pair, like the devkit's
    ``export_2d_annotations_as_json``, which the upstream feeds to all three
    preprocessors: an annotation visible in two cameras contributes two
    crops (and duplicate lidar/radar entries downstream), one visible in no
    camera is absent from every encoder dataset. Camera membership is the
    devkit's ``box_in_image(BoxVisibility.ANY)`` (>= 1 corner visible with
    z > 1, all corners z > 0.1); the table's ``num_lidar_pts`` and
    ``num_radar_pts`` ride on each entry for the load-time count filters."""
    cfg = cfg or Config()
    splits = tables.split_scene_lists(splits_json)
    out: Dict[str, List[dict]] = {s: [] for s in splits}

    for ann in tables.table("sample_annotation"):
        cat = _tracking_category(tables, ann)
        if cat is None:
            continue
        sample_token = ann["sample_token"]
        wlh, c_e, q_e, radius = _ann_ego(tables, ann)
        if not (cfg.resnet.ego_rad_min < radius < cfg.resnet.ego_rad_max):
            continue
        cams = _cameras_of_sample(tables, sample_token)
        scene_tok = tables.get("sample", sample_token)["scene_token"]
        ann_splits = _split_of_scene(tables, scene_tok, splits)
        for cam in cams:
            c, q = mod.box_to_camera_frame(
                c_e, wlh, q_e, cam["cs_translation"], cam["cs_rotation"]
            )
            corners = geo.box_corners(c, wlh, q)
            vis, in_front = geo.count_box_corners_in_image(
                corners, cam["intrinsic"], cam["imsize"]
            )
            if vis < 1 or in_front < 8:  # BoxVisibility.ANY
                continue
            coords = mod.crop_coords_for_box(c_e, wlh, q_e, cam)
            if coords is None:
                continue
            entry = {
                "sample_annotation_token": ann["token"],
                "sample_token": sample_token,
                "filename": cam["filename"],
                "camera_channel": cam["channel"],
                "bbox_corners": list(coords),
                "category_name": cat,
                "visibility_token": ann.get("visibility_token", "4"),
                "ann_ego_radius": radius,
                # the table's counts (absent on minimal fabricated tables;
                # downstream then falls back to the masked counts)
                "num_lidar_pts": ann.get("num_lidar_pts"),
                "num_radar_pts": ann.get("num_radar_pts"),
            }
            for split in ann_splits:
                out[split].append(entry)
    return out


def _img_records_by_ann(
    img_anns: Dict[str, List[dict]]
) -> "Dict[str, List[Tuple[str, dict]]]":
    """(split, entry) image-annotation records grouped by annotation token:
    lidar/radar dataset membership follows the image annotations, so a
    camera-invisible annotation is absent from every modality and a
    two-camera annotation contributes two entries."""
    by_ann: Dict[str, List[Tuple[str, dict]]] = {}
    for split, entries in img_anns.items():
        for e in entries:
            by_ann.setdefault(e["sample_annotation_token"], []).append(
                (split, e)
            )
    return by_ann


def _gated_annotations(tables: NuScenesTables, img_anns, count_key: str, min_pts: int):
    """(ann, records, category, table count) of the camera-visible
    tracking-class annotations whose table count (when present) reaches
    ``min_pts``, in table order."""
    by_ann = _img_records_by_ann(img_anns)
    out = []
    for ann in tables.table("sample_annotation"):
        recs = by_ann.get(ann["token"])
        if not recs:
            continue  # not camera-visible: absent from every dataset
        cat = _tracking_category(tables, ann)
        if cat is None:
            continue
        table_pts = ann.get(count_key)
        if table_pts is not None and table_pts < min_pts:
            continue  # the preprocess gate on the table's count
        out.append((ann, recs, cat, table_pts))
    return out


def preprocess_lidar_annotations(
    tables: NuScenesTables,
    out_dir: str,
    img_anns: Dict[str, List[dict]],
    cfg: Optional[Config] = None,
    splits_json: Optional[str] = None,
) -> Dict[str, List[dict]]:
    """Masked per-annotation lidar clouds -> ``<ann_token>.npy`` (un-augmented,
    deterministic) + split-keyed metadata entries.

    Iterates the image annotation records, pre-gates on the table's
    ``num_lidar_pts >= min_lidar_pts`` (the load-time filter then applies
    the stricter ``>``), and emits one entry per image record (multi-camera
    annotations duplicate, camera-invisible ones are absent). The
    multisweep cloud is aggregated once per run of consecutive annotations
    of one sample (:class:`_LastSample`), the masked cloud once per
    annotation."""
    cfg = cfg or Config()
    os.makedirs(out_dir, exist_ok=True)
    splits = tables.split_scene_lists(splits_json)
    out: Dict[str, List[dict]] = {s: [] for s in splits}
    gated = _gated_annotations(
        tables, img_anns, "num_lidar_pts", cfg.pointnet.min_lidar_pts
    )
    clouds = _LastSample()

    for ann, recs, cat, table_pts in gated:
        sample_token = ann["sample_token"]
        pts_ego = clouds.get(
            sample_token, "lidar",
            lambda: sample_lidar_ego(
                tables, sample_token, cfg.preprocessing.nsweeps_lidar
            ),
        )
        wlh, c_e, q_e, radius = _ann_ego(tables, ann)
        masked = pts_ego[:, geo.points_in_box(c_e, wlh, q_e, pts_ego[0:3])]

        np.save(os.path.join(out_dir, f"{ann['token']}.npy"), masked.astype(np.float32))
        entry = {
            "sample_annotation_token": ann["token"],
            "sample_token": sample_token,
            "category_name": cat,
            # the table's count when present (the load-time filter reads
            # it); the masked multisweep count on tables without the field
            "num_lidar_pts": (
                int(table_pts) if table_pts is not None
                else int(masked.shape[1])
            ),
            "ann_ego_radius": radius,
        }
        for split, _e in recs:
            out[split].append(dict(entry))
    return out


def preprocess_radar_annotations(
    tables: NuScenesTables,
    out_dir: str,
    img_anns: Dict[str, List[dict]],
    cfg: Optional[Config] = None,
    splits_json: Optional[str] = None,
) -> Dict[str, List[dict]]:
    """Per-annotation radar clouds via the camera->radar channel map of
    each image-annotation record's camera (the channel comes from the
    record, one record per visible camera; the ``.npy`` is keyed by
    annotation token alone, so with several records the last camera's
    cloud is what persists, as upstream; entries duplicate per record).
    A sample's radar clouds are aggregated once per camera channel and run
    of its consecutive annotations (:class:`_LastSample`)."""
    cfg = cfg or Config()
    os.makedirs(out_dir, exist_ok=True)
    splits = tables.split_scene_lists(splits_json)
    out: Dict[str, List[dict]] = {s: [] for s in splits}
    gated = _gated_annotations(
        tables, img_anns, "num_radar_pts", cfg.radarnet.min_radar_pts
    )
    clouds = _LastSample()

    for ann, recs, cat, table_pts in gated:
        sample_token = ann["sample_token"]
        wlh, c_e, q_e, radius = _ann_ego(tables, ann)

        masked_by_channel: Dict[str, np.ndarray] = {}
        for split, e in recs:
            channel = e.get("camera_channel", "CAM_FRONT")
            if channel not in masked_by_channel:
                radar_channels = mod.CAM_TO_RADAR[channel]
                pts_ego = clouds.get(
                    sample_token, channel,
                    lambda: sample_radar_ego(
                        tables, sample_token, radar_channels,
                        cfg.preprocessing.nsweeps_radar,
                    ),
                )
                if pts_ego is None:
                    continue
                mask = geo.points_in_box(
                    c_e, wlh * 1.05, q_e, pts_ego[0:3], ignore_z=True
                )
                masked_by_channel[channel] = pts_ego[:, mask]
            masked = masked_by_channel[channel]
            # per-record overwrite: the last record's camera wins the .npy
            np.save(
                os.path.join(out_dir, f"{ann['token']}.npy"),
                masked.astype(np.float32),
            )
            out[split].append({
                "sample_annotation_token": ann["token"],
                "sample_token": sample_token,
                "category_name": cat,
                "num_radar_pts": (
                    int(table_pts) if table_pts is not None
                    else int(masked.shape[1])
                ),
                "ann_ego_radius": radius,
            })
    return out


def extract_detection_modalities(
    tables: NuScenesTables,
    sample_tokens: List[str],
    detections: Dict[str, "FrameBoxes"],  # noqa: F821 (columnar det boxes)
    cfg: Optional[Config] = None,
    modalities: Tuple[str, ...] = ("img", "lidar", "radar"),
    rng: Optional[np.random.Generator] = None,
):
    """Raw per-detection modality features for the real-data graph build,
    with the per-sample work (multisweep accumulation, image decode) done
    once per frame and shared across that frame's boxes.

    Returns ``(img, lidar, radar, cam_ok)`` dicts keyed by sample token
    with arrays aligned to the *unfiltered* detection list of each frame
    (uint8 [K, 32, 32, 3], [K, 128, 3], [K, 64, 4], bool [K]), the
    alignment contract of :func:`batch3dmot_tpu_torch.data.detections.
    scene_from_frames`. Modalities not requested map to None; ``cam_ok`` is
    None unless img is requested. ``cam_ok[i]`` False marks a detection
    whose projected corner hull misses every camera canvas: the upstream
    omits such detections from the graph ("Detection omitted") rather than
    keeping a zero crop; pass ``cam_ok`` to ``scene_from_frames(
    camera_keep=...)``. The crop is attempted whenever the hull intersects
    the canvas, even with zero individually-visible corners (a close large
    object): corner visibility picks the camera, the hull decides the crop.
    PIL is imported only when ``"img"`` is requested; without it that
    request raises.
    """
    cfg = cfg or Config()
    rng = rng or np.random.default_rng(0)
    want_img = "img" in modalities
    want_lidar = "lidar" in modalities
    want_radar = "radar" in modalities
    if want_img:
        from PIL import Image
    img_out: Optional[Dict[str, np.ndarray]] = {} if want_img else None
    lidar_out: Optional[Dict[str, np.ndarray]] = {} if want_lidar else None
    radar_out: Optional[Dict[str, np.ndarray]] = {} if want_radar else None
    cam_ok_out: Optional[Dict[str, np.ndarray]] = {} if want_img else None
    res = cfg.preprocessing.res_size

    for tok in sample_tokens:
        dets = detections.get(tok)
        k = len(dets) if dets is not None else 0
        cam_ok = np.ones(k, bool)
        # uint8 crops (PIL's resize output is uint8); /255 on the device
        imgs = np.zeros((k, res, res, 3), np.uint8)
        lids = np.zeros((k, cfg.pointnet.num_points, 3), np.float32)
        rads = np.zeros((k, cfg.radarnet.num_points, 4), np.float32)
        if k:
            ego_t, ego_q = tables.ego_pose_of_sample(tok)
            c_e, q_e, _ = geo.boxes_global_to_ego(
                dets.center, dets.quat, dets.velocity, ego_t, ego_q
            )
            cams = (
                _cameras_of_sample(tables, tok)
                if (want_img or want_radar)
                else []
            )
            image_cache: Dict[str, np.ndarray] = {}
            radar_cache: Dict[str, np.ndarray] = {}
            pts_ego = (
                sample_lidar_ego(tables, tok, cfg.preprocessing.nsweeps_lidar)
                if want_lidar else None
            )

            for i in range(k):
                cam_idx, vis = (
                    mod.select_camera(c_e[i], dets.wlh[i], q_e[i], cams)
                    if cams
                    else (None, 0)
                )
                if want_img and cams:
                    # corner visibility picks the camera; the projected hull
                    # decides the crop. A hull that misses every canvas
                    # marks the detection omitted
                    cam = cams[cam_idx]
                    coords = mod.crop_coords_for_box(
                        c_e[i], dets.wlh[i], q_e[i], cam
                    )
                    if coords is None:
                        cam_ok[i] = False
                    else:
                        fname = cam["filename"]
                        if fname not in image_cache:
                            image_cache[fname] = np.asarray(
                                Image.open(
                                    os.path.join(tables.dataroot, fname)
                                ).convert("RGB")
                            )
                        imgs[i] = mod.crop_and_resize(
                            image_cache[fname], coords, res
                        )
                if want_lidar and pts_ego is not None:
                    feat, _ = mod.lidar_node_feature(
                        pts_ego, c_e[i], dets.wlh[i], q_e[i],
                        min_pts=cfg.pointnet.min_lidar_pts,
                        pc_length=cfg.pointnet.num_points, rng=rng,
                    )
                    lids[i] = feat.T
                if want_radar and cams and cam_idx is not None:
                    channel = cams[cam_idx]["channel"]
                    if channel not in radar_cache:
                        rp = sample_radar_ego(
                            tables, tok, mod.CAM_TO_RADAR.get(channel, ()),
                            cfg.preprocessing.nsweeps_radar,
                        )
                        radar_cache[channel] = (
                            rp if rp is not None else np.zeros((18, 0), np.float32)
                        )
                    rp = radar_cache[channel]
                    if rp.shape[1]:
                        feat, _ = mod.radar_node_feature(
                            rp, c_e[i], dets.wlh[i], q_e[i],
                            min_pts=cfg.radarnet.min_radar_pts,
                            pc_length=cfg.radarnet.num_points, rng=rng,
                        )
                        rads[i] = feat.T
        if want_img:
            img_out[tok] = imgs
            cam_ok_out[tok] = cam_ok
        if want_lidar:
            lidar_out[tok] = lids
        if want_radar:
            radar_out[tok] = rads
    return img_out, lidar_out, radar_out, cam_ok_out


# ---------------------------------------------------------------------------
# Encoder datasets
# ---------------------------------------------------------------------------


def _entry_label(e: dict) -> int:
    """0-indexed tracking class of an annotation entry."""
    return TRACKING_CLASSES[CATEGORY_TO_TRACKING_NAME[e["category_name"]]] - 1


def _load_npy(npy_dir: str, e: dict) -> np.ndarray:
    return np.load(os.path.join(npy_dir, f"{e['sample_annotation_token']}.npy"))


def _lidar_valid(entries, min_pts, ego_rad):
    return [e for e in entries if e["num_lidar_pts"] > min_pts
            and ego_rad[0] < e["ann_ego_radius"] < ego_rad[1]]


def _radar_valid(entries, min_pts, ego_rad):
    return [e for e in entries if e["num_radar_pts"] >= min_pts
            and ego_rad[0] < e["ann_ego_radius"] < ego_rad[1]]


def _crop(dataroot: str, e: dict, res_size: int, color_enhance: float):
    """The entry's box cropped from its camera image, colour-enhanced and
    resized (a PIL image)."""
    from PIL import Image, ImageEnhance

    img = Image.open(os.path.join(dataroot, e["filename"])).convert("RGB")
    c = e["bbox_corners"]
    crop = img.crop((round(c[0]), round(c[1]), round(c[2]), round(c[3])))
    crop = ImageEnhance.Color(crop).enhance(color_enhance)
    return crop.resize((res_size, res_size), Image.BILINEAR)


def _batch_rows(n: int, batch_size: int, rng: np.random.Generator, shuffle: bool):
    """Index rows of the full batches of an epoch over n items (the
    remainder is dropped)."""
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    for lo in range(0, n - batch_size + 1, batch_size):
        yield idx[lo: lo + batch_size]


# ---------------------------------------------------------------------------
# Host batch loaders
# ---------------------------------------------------------------------------


def image_batches(
    dataroot: str,
    entries: List[dict],
    batch_size: int,
    res_size: int = 32,
    color_enhance: float = 2.0,
    rng: Optional[np.random.Generator] = None,
    shuffle: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Cropped, colour-enhanced (x2.0) image batches, float32 [B, R, R, 3]
    in [0, 1], with 0-indexed class labels."""
    rng = rng or np.random.default_rng()
    for rows in _batch_rows(len(entries), batch_size, rng, shuffle):
        imgs, labels = [], []
        for i in rows:
            e = entries[i]
            crop = _crop(dataroot, e, res_size, color_enhance)
            imgs.append(np.asarray(crop, np.float32) / 255.0)
            labels.append(_entry_label(e))
        yield np.stack(imgs), np.array(labels, np.int32)


def lidar_batches(
    npy_dir: str,
    entries: List[dict],
    batch_size: int,
    min_pts: int = 6,
    ego_rad: Tuple[float, float] = (1.0, 50.0),
    num_points: int = 128,
    augment: bool = False,
    rng: Optional[np.random.Generator] = None,
    shuffle: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Normalised fixed-size LiDAR clouds [B, num_points, 3] and labels;
    ``augment``: a random yaw in +-pi/10 about the xyz centroid first."""
    rng = rng or np.random.default_rng()
    valid = _lidar_valid(entries, min_pts, ego_rad)
    for rows in _batch_rows(len(valid), batch_size, rng, shuffle):
        pcs, labels = [], []
        for i in rows:
            e = valid[i]
            pc = _load_npy(npy_dir, e)
            if augment:
                yaw = rng.uniform(-np.pi / 10, np.pi / 10)
                R = geo.quat_rotation_matrix(geo.yaw_to_quat(yaw))
                centroid = pc[0:3].mean(axis=1, keepdims=True)
                pc = pc.copy()
                pc[0:3] = R @ (pc[0:3] - centroid) + centroid
            pc = mod.reference_normalize(pc)
            pcs.append(mod.collate_fixed_size(pc, num_points, 3, rng).T)
            labels.append(_entry_label(e))
        yield np.stack(pcs), np.array(labels, np.int32)


def radar_batches(
    npy_dir: str,
    entries: List[dict],
    batch_size: int,
    min_pts: int = 2,
    ego_rad: Tuple[float, float] = (1.0, 50.0),
    num_points: int = 64,
    rng: Optional[np.random.Generator] = None,
    shuffle: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Radar 4-vectors [x, y, vx_comp, vy_comp] per point, fixed-size
    [B, num_points, 4], and labels (the dataset-variant normalisation)."""
    rng = rng or np.random.default_rng()
    valid = _radar_valid(entries, min_pts, ego_rad)
    for rows in _batch_rows(len(valid), batch_size, rng, shuffle):
        pcs, labels = [], []
        for i in rows:
            e = valid[i]
            pc = mod.encoder_dataset_normalize(_load_npy(npy_dir, e))
            vec = pc[[0, 1, 8, 9], :]
            pcs.append(mod.collate_fixed_size(vec, num_points, 4, rng).T)
            labels.append(_entry_label(e))
        yield np.stack(pcs), np.array(labels, np.int32)


# ---------------------------------------------------------------------------
# Stacked datasets for device-resident training (one host pass; the
# per-epoch randomness runs on the device, train/encoders.py transforms)
# ---------------------------------------------------------------------------


def materialize_image_dataset(
    dataroot: str, entries: List[dict], res_size: int = 32,
    color_enhance: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Every crop decoded once -> (uint8 [N, R, R, 3], labels [N]); the
    device transform divides by 255, as ``image_batches`` does on the
    host."""
    imgs, labels = [], []
    for e in entries:
        imgs.append(np.asarray(_crop(dataroot, e, res_size, color_enhance), np.uint8))
        labels.append(_entry_label(e))
    return np.stack(imgs), np.array(labels, np.int32)


def _stack_padded(rows, counts, labels, nch, kcap):
    if not rows:
        return (np.zeros((0, nch, kcap), np.float32), np.zeros((0,), np.int32),
                np.zeros((0,), np.int32))
    return np.stack(rows), np.array(counts, np.int32), np.array(labels, np.int32)


def _pad_cloud(pc: np.ndarray, kcap: int, rng: np.random.Generator):
    """pc [C, K] zero-padded to [C, kcap] float32 (a cloud beyond kcap
    subsampled once), and its column count."""
    k = pc.shape[1]
    if k > kcap:
        pc = pc[:, rng.choice(k, size=kcap, replace=False)]
        k = kcap
    out = np.zeros((pc.shape[0], kcap), np.float32)
    out[:, :k] = pc
    return out, k


def materialize_lidar_dataset(
    npy_dir: str,
    entries: List[dict],
    min_pts: int = 6,
    ego_rad: Tuple[float, float] = (1.0, 50.0),
    num_points: int = 128,
    cap_factor: int = 4,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Raw (not augmented, not normalised) clouds zero-padded to one width
    -> (clouds float32 [N, C, Kcap], counts int32 [N], labels [N]), every
    stored channel kept (the normalisation mixes them all). Clouds beyond
    Kcap = cap_factor * num_points are subsampled once here."""
    rng = rng or np.random.default_rng(0)
    kcap = max(1, cap_factor * num_points)
    clouds, counts, labels = [], [], []
    nch = None
    for e in _lidar_valid(entries, min_pts, ego_rad):
        pc = _load_npy(npy_dir, e)
        if nch is None:
            nch = pc.shape[0]
        if pc.shape[0] != nch:
            raise ValueError(f"{e['sample_annotation_token']}: {pc.shape[0]} channels, "
                             f"the first cloud has {nch}")
        out, k = _pad_cloud(pc, kcap, rng)
        clouds.append(out)
        counts.append(k)
        labels.append(_entry_label(e))
    return _stack_padded(clouds, counts, labels, 4, kcap)


def materialize_radar_dataset(
    npy_dir: str,
    entries: List[dict],
    min_pts: int = 2,
    ego_rad: Tuple[float, float] = (1.0, 50.0),
    num_points: int = 64,
    cap_factor: int = 4,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Normalised radar 4-vectors [x, y, vx_comp, vy_comp] zero-padded to
    one width -> (vecs float32 [N, 4, Kcap], counts int32 [N], labels [N]).
    Only the collate's subsample is random per epoch (on the device)."""
    rng = rng or np.random.default_rng(0)
    kcap = max(1, cap_factor * num_points)
    vecs, counts, labels = [], [], []
    for e in _radar_valid(entries, min_pts, ego_rad):
        pc = mod.encoder_dataset_normalize(_load_npy(npy_dir, e))
        out, k = _pad_cloud(pc[[0, 1, 8, 9], :].astype(np.float32), kcap, rng)
        vecs.append(out)
        counts.append(k)
        labels.append(_entry_label(e))
    return _stack_padded(vecs, counts, labels, 4, kcap)
