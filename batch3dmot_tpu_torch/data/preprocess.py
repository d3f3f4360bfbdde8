"""Encoder datasets: host batch loaders and the stacked datasets of
device-resident encoder training (a copy of
``batch3dmot_tpu/data/preprocess.py:505-753``, numpy).

They read what the JAX package's ``preprocess`` writes: entries of the
``processed_{img,lidar,radar}_anns.json`` lists, per-annotation ``.npy``
clouds (LiDAR [4, K]: x, y, z, intensity; radar [18, K]) and, for the
images, the camera files under ``dataroot``. The preprocessing itself (from
a nuScenes tree) is not ported yet. PIL is imported inside the two image
functions only.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from batch3dmot_tpu_torch import geometry as geo
from batch3dmot_tpu_torch.config import CATEGORY_TO_TRACKING_NAME, TRACKING_CLASSES
from batch3dmot_tpu_torch.data import modality as mod


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
