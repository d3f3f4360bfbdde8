"""Native nuScenes table reader (no devkit dependency; a copy of
``batch3dmot_tpu/data/nuscenes_tables.py``).

The nuScenes "database" is a set of JSON tables; the devkit is a convenience
layer over them. This module reads the tables directly and provides exactly
what the pipeline needs from the reference's L1 layer
(``utils/load_scenes.py``, ``utils/nuscenes.py``, devkit calls inside
``construct...parallel.py``):

  * scene / sample traversal (ordered sample tokens per scene);
  * ego poses + calibrated sensors per sample_data;
  * GT boxes per sample with tracking-class mapping and devkit-compatible
    box velocity (finite differences over neighboring annotations of the
    same instance);
  * train/val/test splits: uses the official devkit split lists when the
    devkit is importable, else a user-provided splits JSON, else
    "every scene" (documented fallback — the official lists are name
    enumerations that cannot be derived from the tables).
"""

from __future__ import annotations

import json
import os
from functools import cached_property
from typing import Dict, List, Optional

import numpy as np


from batch3dmot_tpu_torch.config import CATEGORY_TO_TRACKING_NAME, TRACKING_CLASSES
from batch3dmot_tpu_torch.data.detections import FrameBoxes

_TABLES = (
    "scene",
    "sample",
    "sample_data",
    "ego_pose",
    "calibrated_sensor",
    "sensor",
    "sample_annotation",
    "instance",
    "category",
    "attribute",
)


class NuScenesTables:
    def __init__(self, dataroot: str, version: str = "v1.0-mini"):
        self.dataroot = dataroot
        self.version = version
        self.table_dir = os.path.join(dataroot, version)
        self._tables: Dict[str, List[dict]] = {}
        self._index: Dict[str, Dict[str, dict]] = {}

    def table(self, name: str) -> List[dict]:
        if name not in self._tables:
            path = os.path.join(self.table_dir, f"{name}.json")
            with open(path, "r") as f:
                self._tables[name] = json.load(f)
        return self._tables[name]

    def get(self, name: str, token: str) -> dict:
        if name not in self._index:
            self._index[name] = {r["token"]: r for r in self.table(name)}
        return self._index[name][token]

    # ---- scenes & samples ------------------------------------------------

    @cached_property
    def scenes(self) -> List[dict]:
        return self.table("scene")

    def scene_sample_tokens(self, scene_token: str) -> List[str]:
        """Ordered sample tokens of a scene (first -> last)."""
        scene = self.get("scene", scene_token)
        tokens = []
        tok = scene["first_sample_token"]
        while tok:
            tokens.append(tok)
            tok = self.get("sample", tok)["next"]
        return tokens

    def sample_lidar_sd(self, sample_token: str) -> dict:
        """The LIDAR_TOP keyframe sample_data record of a sample."""
        return self.get("sample_data", self._sample_channel_sd(sample_token, "LIDAR_TOP"))

    @cached_property
    def _keyframe_sd_by_sample(self) -> Dict[str, Dict[str, str]]:
        out: Dict[str, Dict[str, str]] = {}
        for sd in self.table("sample_data"):
            if not sd["is_key_frame"]:
                continue
            cs = self.get("calibrated_sensor", sd["calibrated_sensor_token"])
            channel = self.get("sensor", cs["sensor_token"])["channel"]
            out.setdefault(sd["sample_token"], {})[channel] = sd["token"]
        return out

    def _sample_channel_sd(self, sample_token: str, channel: str) -> str:
        return self._keyframe_sd_by_sample[sample_token][channel]

    def sample_channels(self, sample_token: str) -> Dict[str, str]:
        """channel -> keyframe sample_data token."""
        return dict(self._keyframe_sd_by_sample.get(sample_token, {}))

    def ego_pose_of_sample(self, sample_token: str):
        """(translation [3], rotation quat [4]) of the LIDAR_TOP keyframe."""
        sd = self.sample_lidar_sd(sample_token)
        pose = self.get("ego_pose", sd["ego_pose_token"])
        return np.array(pose["translation"]), np.array(pose["rotation"])

    def scene_ego_poses(self, scene_token: str):
        toks = self.scene_sample_tokens(scene_token)
        t = np.zeros((len(toks), 3))
        q = np.zeros((len(toks), 4))
        for i, tok in enumerate(toks):
            t[i], q[i] = self.ego_pose_of_sample(tok)
        return toks, t, q

    # ---- ground truth ----------------------------------------------------

    @cached_property
    def _anns_by_sample(self) -> Dict[str, List[dict]]:
        out: Dict[str, List[dict]] = {}
        for ann in self.table("sample_annotation"):
            out.setdefault(ann["sample_token"], []).append(ann)
        return out

    def box_velocity(self, ann: dict, max_time_diff: float = 1.5) -> np.ndarray:
        """Devkit-compatible annotation velocity: central finite difference
        between the neighboring annotations of the same instance; NaN when no
        neighbor is temporally close enough."""
        has_prev = bool(ann["prev"])
        has_next = bool(ann["next"])
        if not has_prev and not has_next:
            return np.array([np.nan, np.nan, np.nan])
        first = self.get("sample_annotation", ann["prev"]) if has_prev else ann
        last = self.get("sample_annotation", ann["next"]) if has_next else ann
        pos_first = np.array(first["translation"])
        pos_last = np.array(last["translation"])
        t_first = 1e-6 * self.get("sample", first["sample_token"])["timestamp"]
        t_last = 1e-6 * self.get("sample", last["sample_token"])["timestamp"]
        # devkit NuScenes.box_velocity: a centered difference (both
        # neighbors exist) allows up to DOUBLE the max time gap
        if has_prev and has_next:
            max_time_diff *= 2
        if t_last - t_first > max_time_diff:
            return np.array([np.nan, np.nan, np.nan])
        return (pos_last - pos_first) / max(t_last - t_first, 1e-6)

    def gt_frame_boxes(self, sample_token: str) -> FrameBoxes:
        """Tracking-class GT boxes of a sample (global frame), carrying the
        *instance* token as the persistent identity."""
        anns = self._anns_by_sample.get(sample_token, [])
        rows = []
        for ann in anns:
            inst = self.get("instance", ann["instance_token"])
            cat = self.get("category", inst["category_token"])["name"]
            tname = CATEGORY_TO_TRACKING_NAME.get(cat)
            if tname is None:
                continue
            vel = self.box_velocity(ann)
            rows.append((ann, tname, np.nan_to_num(vel)))
        if not rows:
            return FrameBoxes.empty()
        return FrameBoxes(
            center=np.array([r[0]["translation"] for r in rows], float),
            wlh=np.array([r[0]["size"] for r in rows], float),
            quat=np.array([r[0]["rotation"] for r in rows], float),
            velocity=np.array([r[2] for r in rows], float),
            class_id=np.array([TRACKING_CLASSES[r[1]] for r in rows], np.int32),
            score=np.ones(len(rows)),
            instance=[r[0]["instance_token"] for r in rows],
        )

    def scene_gt(self, scene_token: str) -> Dict[str, FrameBoxes]:
        return {
            tok: self.gt_frame_boxes(tok)
            for tok in self.scene_sample_tokens(scene_token)
        }

    # ---- splits ----------------------------------------------------------

    def split_scene_lists(
        self, splits_json: Optional[str] = None
    ) -> Dict[str, List[dict]]:
        """scene-metadata lists per split (the reference's
        ``load_scene_meta_list``, ``utils/load_scenes.py:5-59``)."""
        split_names = _official_splits(splits_json)
        by_name = {s["name"]: s for s in self.scenes}
        if split_names is None:
            # fallback: every scene in one 'all' split
            return {"all": [self._scene_meta(s) for s in self.scenes]}
        out: Dict[str, List[dict]] = {}
        wanted = {
            "v1.0-mini": ("mini_train", "mini_val"),
            "v1.0-trainval": ("train", "val"),
            "v1.0-test": ("test",),
        }.get(self.version, tuple(split_names.keys()))
        for split in wanted:
            names = split_names.get(split, [])
            out[split] = [
                self._scene_meta(by_name[n]) for n in names if n in by_name
            ]
        return out

    def scene_metas_for_split(
        self, split: str, splits_json: Optional[str] = None
    ) -> List[dict]:
        """Scene metas for ONE named split.

        The reference walks only the configured split's scenes
        (``utils/load_scenes.py:5-59``; ``predict.py:632-635``) — callers
        must never iterate every split against a single split's detection
        JSON. Mini versions accept ``train``/``val`` and map them to
        ``mini_train``/``mini_val``. Without the devkit or a splits JSON
        every scene lands in a single ``'all'`` split, which is returned
        for any requested name (single-split fallback for fabricated /
        synthetic datasets).
        """
        lists = self.split_scene_lists(splits_json)
        if set(lists) == {"all"}:
            # the single-split fallback is safe only for small/fabricated
            # datasets: silently returning ALL 850 trainval scenes for a
            # requested 'val' would score ~700 sceneless-in-the-JSON
            # scenes as pure misses instead of erroring
            if self.version in ("v1.0-trainval", "v1.0-test"):
                raise KeyError(
                    f"split '{split}' of {self.version} requires the "
                    "official scene lists: install nuscenes-devkit or set "
                    "paths.splits_json to a {split: [scene names]} JSON "
                    "(see docs/RUNBOOK.md) — refusing the all-scenes "
                    "fallback at this dataset scale"
                )
            return lists["all"]
        if self.version == "v1.0-mini" and not split.startswith("mini"):
            split = f"mini_{split}"
        if split not in lists:
            raise KeyError(
                f"unknown split '{split}' for {self.version}; "
                f"available: {sorted(lists)}"
            )
        return lists[split]

    def _scene_meta(self, scene: dict) -> dict:
        return {
            "token": scene["token"],
            "name": scene["name"],
            "nbr_samples": scene["nbr_samples"],
            "first_sample_token": scene["first_sample_token"],
            "last_sample_token": scene["last_sample_token"],
        }


def _official_splits(splits_json: Optional[str] = None) -> Optional[Dict[str, List[str]]]:
    """Official split name lists: devkit if importable, else a JSON file
    ({split: [scene names]}), else None."""
    try:
        from nuscenes.utils.splits import create_splits_scenes  # type: ignore

        return create_splits_scenes()
    except ImportError:
        pass
    if splits_json and os.path.exists(splits_json):
        with open(splits_json, "r") as f:
            return json.load(f)
    return None
