"""Data-plane doctor: validate a nuScenes dataroot + detection JSON before
any expensive pipeline stage (``cli validate-data``); a copy of
``batch3dmot_tpu/data/validate.py``.

The fabricated-table dress rehearsal (tests/test_dress_rehearsal.py)
exercises the pipeline against tables written by this repo's own
assumptions; a REAL dataroot can deviate in ways that would otherwise
surface as a KeyError hours into preprocessing. This module checks the
schema facts the pipeline actually depends on — written from the devkit's
documented table format, not from fab-table round-trips — and reports
actionable findings.

What it guards (reference equivalents):
  * table presence + referential integrity — the devkit constructor and
    ``utils/load_scenes.py:5-59`` assume all tables load;
  * per-sample LIDAR_TOP keyframe coverage — the pipeline's ego-pose source
    (``data/nuscenes_tables.sample_lidar_sd``); camera/radar channel
    availability per sample (graph construction degrades gracefully but the
    user should know, ``construct...parallel.py:162-385``);
  * detection-JSON schema — Megvii/CenterPoint submission variants
    (``cl_config.yaml:84-94``): results/meta blocks, box field shapes, NaN
    velocities, token resolvability, tracking-class coverage;
  * splits-JSON consistency with the scene table
    (``paths.splits_json``, devkit ``create_splits_scenes`` stand-in).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence

from batch3dmot_tpu_torch.config import (
    CATEGORY_TO_TRACKING_NAME,
    TRACKING_CLASSES,
    Config,
)

REQUIRED_TABLES = (
    "scene",
    "sample",
    "sample_data",
    "ego_pose",
    "calibrated_sensor",
    "sensor",
    "sample_annotation",
    "instance",
    "category",
)
# tables the pipeline never reads but the devkit ships; absence is a warning
OPTIONAL_TABLES = ("attribute", "visibility", "log", "map")

_BOX_FIELDS = {
    "translation": 3,
    "size": 3,
    "rotation": 4,
}


@dataclasses.dataclass
class Finding:
    level: str  # "error" | "warn" | "info"
    where: str
    msg: str

    def __str__(self) -> str:
        return f"[{self.level.upper():5s}] {self.where}: {self.msg}"


def _err(where, msg):
    return Finding("error", where, msg)


def _warn(where, msg):
    return Finding("warn", where, msg)


def _info(where, msg):
    return Finding("info", where, msg)


def _load_table(table_dir: str, name: str, findings: List[Finding]):
    path = os.path.join(table_dir, f"{name}.json")
    if not os.path.exists(path):
        findings.append(_err(f"tables/{name}", f"missing file {path}"))
        return None
    try:
        with open(path, "r") as f:
            rows = json.load(f)
    except Exception as e:  # malformed JSON
        findings.append(_err(f"tables/{name}", f"unparseable JSON: {e}"))
        return None
    if not isinstance(rows, list):
        findings.append(
            _err(f"tables/{name}", f"expected a list, got {type(rows).__name__}")
        )
        return None
    if rows and not (isinstance(rows[0], dict) and "token" in rows[0]):
        findings.append(
            _err(f"tables/{name}", "rows are not token-keyed records")
        )
        return None
    return rows


def validate_tables(
    dataroot: str, version: str, max_file_probe: int = 8
) -> List[Finding]:
    """Schema + referential-integrity checks over the nuScenes table dir."""
    findings: List[Finding] = []
    table_dir = os.path.join(dataroot, version)
    if not os.path.isdir(table_dir):
        return [
            _err(
                "dataroot",
                f"{table_dir} is not a directory — paths.data should hold "
                f"the devkit layout <dataroot>/{version}/<table>.json",
            )
        ]

    tables: Dict[str, Optional[list]] = {
        name: _load_table(table_dir, name, findings)
        for name in REQUIRED_TABLES
    }
    for name in OPTIONAL_TABLES:
        if not os.path.exists(os.path.join(table_dir, f"{name}.json")):
            findings.append(
                _info(f"tables/{name}", "absent (unused by this pipeline)")
            )
    if any(tables[n] is None for n in REQUIRED_TABLES):
        return findings  # structural errors make the rest meaningless

    by_token = {
        name: {r["token"]: r for r in rows} for name, rows in tables.items()
    }
    scenes, samples = tables["scene"], tables["sample"]
    if not scenes:
        findings.append(_err("tables/scene", "no scenes"))
        return findings

    # scene sample chains
    for scene in scenes:
        tok, seen = scene.get("first_sample_token"), 0
        name = scene.get("name", scene["token"][:8])
        while tok:
            rec = by_token["sample"].get(tok)
            if rec is None:
                findings.append(
                    _err(
                        "tables/sample",
                        f"scene '{name}': sample chain hits unknown token "
                        f"{tok!r} after {seen} samples",
                    )
                )
                break
            seen += 1
            if seen > 10000:
                findings.append(
                    _err("tables/sample", f"scene '{name}': sample chain cycles")
                )
                break
            tok = rec.get("next")
        nbr = scene.get("nbr_samples")
        if nbr is not None and seen != nbr:
            findings.append(
                _warn(
                    "tables/scene",
                    f"scene '{name}': nbr_samples={nbr} but chain has {seen}",
                )
            )

    # keyframe coverage per sample + channel availability
    channel_of = {}
    for cs in tables["calibrated_sensor"]:
        sensor = by_token["sensor"].get(cs.get("sensor_token"))
        if sensor is None:
            findings.append(
                _err(
                    "tables/calibrated_sensor",
                    f"{cs['token']}: unresolvable sensor_token",
                )
            )
            continue
        channel_of[cs["token"]] = sensor.get("channel", "?")

    kf_channels: Dict[str, set] = {s["token"]: set() for s in samples}
    files_to_probe: List[str] = []
    for sd in tables["sample_data"]:
        if not sd.get("is_key_frame"):
            continue
        ch = channel_of.get(sd.get("calibrated_sensor_token"))
        if ch is None:
            findings.append(
                _err(
                    "tables/sample_data",
                    f"{sd['token']}: unresolvable calibrated_sensor_token",
                )
            )
            continue
        if sd.get("ego_pose_token") not in by_token["ego_pose"]:
            findings.append(
                _err(
                    "tables/sample_data",
                    f"{sd['token']}: unresolvable ego_pose_token",
                )
            )
        if sd["sample_token"] in kf_channels:
            kf_channels[sd["sample_token"]].add(ch)
        if sd.get("filename") and len(files_to_probe) < max_file_probe:
            files_to_probe.append(sd["filename"])

    missing_lidar = sum(
        1 for chs in kf_channels.values() if "LIDAR_TOP" not in chs
    )
    if missing_lidar:
        findings.append(
            _err(
                "tables/sample_data",
                f"{missing_lidar}/{len(kf_channels)} samples have no "
                "LIDAR_TOP keyframe — the pipeline reads ego pose from it "
                "(data/nuscenes_tables.sample_lidar_sd)",
            )
        )
    no_cam = sum(
        1
        for chs in kf_channels.values()
        if not any(c.startswith("CAM") for c in chs)
    )
    no_radar = sum(
        1
        for chs in kf_channels.values()
        if not any(c.startswith("RADAR") for c in chs)
    )
    if no_cam:
        findings.append(
            _warn(
                "tables/sample_data",
                f"{no_cam}/{len(kf_channels)} samples have no camera "
                "keyframe — img modality will be zero for their detections",
            )
        )
    if no_radar:
        findings.append(
            _warn(
                "tables/sample_data",
                f"{no_radar}/{len(kf_channels)} samples have no radar "
                "keyframe — radar modality will be zero for their detections",
            )
        )

    missing_files = [
        f
        for f in files_to_probe
        if not os.path.exists(os.path.join(dataroot, f))
    ]
    if missing_files and len(missing_files) == len(files_to_probe):
        findings.append(
            _err(
                "sensor files",
                f"none of {len(files_to_probe)} probed sensor files exist "
                f"under {dataroot} (first: {missing_files[0]}) — blobs not "
                "downloaded or dataroot points at the tables only",
            )
        )
    elif missing_files:
        findings.append(
            _warn(
                "sensor files",
                f"{len(missing_files)}/{len(files_to_probe)} probed sensor "
                f"files missing (first: {missing_files[0]})",
            )
        )

    # annotations: instance/category resolvability + tracking-class coverage
    n_track, n_total = 0, 0
    for ann in tables["sample_annotation"]:
        n_total += 1
        inst = by_token["instance"].get(ann.get("instance_token"))
        if inst is None:
            findings.append(
                _err(
                    "tables/sample_annotation",
                    f"{ann['token']}: unresolvable instance_token",
                )
            )
            continue
        cat = by_token["category"].get(inst.get("category_token"))
        if cat is None:
            findings.append(
                _err(
                    "tables/instance",
                    f"{inst['token']}: unresolvable category_token",
                )
            )
            continue
        if CATEGORY_TO_TRACKING_NAME.get(cat.get("name")):
            n_track += 1
    if n_total and n_track == 0:
        findings.append(
            _warn(
                "tables/sample_annotation",
                "no annotation maps to a tracking class — GT edge labels "
                "will all be negative",
            )
        )
    else:
        findings.append(
            _info(
                "tables/sample_annotation",
                f"{n_track}/{n_total} annotations in tracking classes",
            )
        )
    return findings


def validate_detection_json(
    path: str, sample_tokens: Optional[Sequence[str]] = None,
    max_boxes_probe: int = 2000,
) -> List[Finding]:
    """Detection submission JSON schema checks (Megvii / CenterPoint
    variants both use the nuScenes detection-submission format)."""
    findings: List[Finding] = []
    where = f"detections ({os.path.basename(path)})"
    if not os.path.exists(path):
        return [_err(where, f"missing file {path}")]
    try:
        with open(path, "r") as f:
            raw = json.load(f)
    except Exception as e:
        return [_err(where, f"unparseable JSON: {e}")]
    if not isinstance(raw, dict):
        return [_err(where, f"expected an object, got {type(raw).__name__}")]
    if "results" in raw:
        results = raw["results"]
        if "meta" not in raw:
            findings.append(
                _warn(
                    where,
                    "no 'meta' block (use_camera/use_lidar/... flags) — "
                    "tolerated, the submission writer sets its own",
                )
            )
    else:
        results = raw
        findings.append(
            _warn(where, "bare {sample_token: boxes} mapping without a "
                         "'results' wrapper — tolerated")
        )
    if not isinstance(results, dict) or not results:
        findings.append(_err(where, "'results' is empty or not an object"))
        return findings

    if sample_tokens is not None:
        known = set(sample_tokens)
        hit = sum(1 for t in results if t in known)
        if hit == 0:
            findings.append(
                _err(
                    where,
                    f"none of {len(results)} sample tokens exist in this "
                    "dataroot/version — wrong split or wrong dataset",
                )
            )
        else:
            uncovered = len(known) - hit
            findings.append(
                _info(
                    where,
                    f"{hit}/{len(results)} result tokens match this "
                    f"dataroot; {uncovered} dataroot samples uncovered",
                )
            )

    n_boxes = n_track = n_nan_vel = n_no_vel = 0
    bad_schema: Optional[str] = None
    for stok, boxes in results.items():
        if not isinstance(boxes, list):
            findings.append(
                _err(where, f"results[{stok!r}] is not a list of boxes")
            )
            return findings
        for b in boxes:
            if n_boxes >= max_boxes_probe:
                break
            n_boxes += 1
            for field, ln in _BOX_FIELDS.items():
                v = b.get(field)
                if not isinstance(v, list) or len(v) != ln:
                    bad_schema = bad_schema or (
                        f"box field '{field}' of results[{stok!r}][...] is "
                        f"{v!r} (expected list of {ln})"
                    )
            name = b.get("detection_name")
            if name is None:
                bad_schema = bad_schema or (
                    f"box in results[{stok!r}] has no detection_name"
                )
            elif name in TRACKING_CLASSES:
                n_track += 1
            if not isinstance(b.get("detection_score"), (int, float)):
                bad_schema = bad_schema or (
                    f"box in results[{stok!r}] has no numeric detection_score"
                )
            vel = b.get("velocity")
            if vel is None:
                n_no_vel += 1
            elif any(
                isinstance(x, float) and math.isnan(x) for x in vel
            ):
                n_nan_vel += 1
    if bad_schema:
        findings.append(_err(where, bad_schema))
    if n_boxes and n_track == 0:
        findings.append(
            _err(
                where,
                f"0/{n_boxes} probed boxes carry a tracking-class "
                "detection_name — wrong detector output?",
            )
        )
    if n_no_vel:
        findings.append(
            _warn(
                where,
                f"{n_no_vel}/{n_boxes} probed boxes have no velocity field "
                "(treated as zero)",
            )
        )
    if n_nan_vel:
        findings.append(
            _info(
                where,
                f"{n_nan_vel}/{n_boxes} probed boxes carry NaN velocities "
                "(zeroed at load, data/detections.load_detection_results)",
            )
        )
    return findings


def validate_splits_json(
    path: str, scene_names: Sequence[str], split: Optional[str] = None
) -> List[Finding]:
    findings: List[Finding] = []
    where = f"splits ({os.path.basename(path)})"
    if not os.path.exists(path):
        return [_err(where, f"missing file {path}")]
    try:
        with open(path, "r") as f:
            splits = json.load(f)
    except Exception as e:
        return [_err(where, f"unparseable JSON: {e}")]
    if not isinstance(splits, dict) or not all(
        isinstance(v, list) for v in splits.values()
    ):
        return [_err(where, "expected {split: [scene names]}")]
    known = set(scene_names)
    for name, members in splits.items():
        missing = [m for m in members if m not in known]
        if missing:
            findings.append(
                _warn(
                    where,
                    f"split '{name}': {len(missing)}/{len(members)} scenes "
                    f"not in the scene table (first: {missing[0]!r}) — fine "
                    "for full-trainval lists against a mini dataroot",
                )
            )
        if members and len(missing) == len(members):
            findings.append(
                _err(
                    where,
                    f"split '{name}' matches NO scene in this dataroot",
                )
            )
    unassigned = known - {m for v in splits.values() for m in v}
    if unassigned:
        findings.append(
            _info(
                where,
                f"{len(unassigned)} dataroot scenes in no split "
                f"(first: {sorted(unassigned)[0]!r})",
            )
        )
    if split is not None and split not in splits:
        findings.append(
            _err(where, f"configured split '{split}' not present "
                        f"(has: {sorted(splits)})")
        )
    return findings


def validate_config_data(cfg: Config, split: Optional[str] = None) -> List[Finding]:
    """Full doctor pass over the data plane a run would touch: tables,
    splits membership, and the detection JSON the configured detector/split
    resolves to (the same resolution the build/predict CLIs use)."""
    findings = validate_tables(cfg.paths.data, cfg.main.version)
    # stop on ANY table-layer error ('dataroot' included: with a wrong
    # paths.data everything downstream would cascade into split/JSON noise
    # burying the one actionable finding)
    if any(
        f.level == "error"
        and (f.where.startswith("tables") or f.where.startswith("dataroot"))
        for f in findings
    ):
        return findings

    # scene names for splits consistency
    table_dir = os.path.join(cfg.paths.data, cfg.main.version)
    try:
        with open(os.path.join(table_dir, "scene.json")) as f:
            scene_names = [s.get("name", "") for s in json.load(f)]
    except Exception:
        scene_names = []

    split = split or cfg.graph_construction.split
    if cfg.paths.splits_json:
        findings += validate_splits_json(
            cfg.paths.splits_json, scene_names, split=split
        )
    elif cfg.main.version in ("v1.0-trainval", "v1.0-test"):
        # without the devkit or a splits JSON, scene_metas_for_split
        # REFUSES trainval/test-scale runs (nuscenes_tables.py) rather
        # than walking all 850 scenes for any requested split — surface
        # that before the run does
        try:
            from nuscenes.utils.splits import create_splits_scenes  # noqa: F401
        except ImportError:
            findings.append(
                _err(
                    "splits",
                    f"{cfg.main.version} needs official scene lists: no "
                    "nuscenes-devkit on this machine and paths.splits_json "
                    "is unset — build/predict will refuse to resolve "
                    f"split '{split}'",
                )
            )

    split_key = "mini" if cfg.main.version == "v1.0-mini" else split
    det_rel = (
        cfg.detections.get(cfg.main.detections, {}).get(split_key)
        if cfg.detections
        else None
    )
    if det_rel is None:
        findings.append(
            _warn(
                "config",
                f"no detection JSON configured for detector="
                f"{cfg.main.detections} split={split_key} "
                f"(set detections.{cfg.main.detections}.{split_key}) — "
                "build-graphs will refuse to run",
            )
        )
    else:
        try:
            with open(os.path.join(table_dir, "sample.json")) as f:
                sample_tokens = [s["token"] for s in json.load(f)]
        except Exception:
            sample_tokens = None
        findings += validate_detection_json(
            os.path.join(cfg.paths.detections_dir, det_rel), sample_tokens
        )
    return findings
