"""Trajectory assembly: hierarchical clustering, interpolation, submission.

Re-implements the reference's ``create_trajectories(mode='hier')``
(``predict.py:262-375``), track-dict traversal (``predict.py:437-546``), the
*missing* ``utils.interpolation.interpolate_linear`` (rebuilt from its call
site, ``predict.py:524-530``: fill temporal gaps in a track with linearly
interpolated boxes), and the submission-dict conversion
(``predict.py:549-573``).

Known reference quirks handled here:
  * the trailer-interpolation guard compares a dict against the string
    "trailer" (``predict.py:524``) and thus never fires; interpolation here
    is correctly gated on the track category and the
    ``predict.interpolate_trailer_tracks`` config flag;
  * a cluster-join edge whose endpoints lie in the same cluster would
    corrupt the reference's bookkeeping (duplicate then delete); such an
    edge cannot occur for time-directed edges but is guarded anyway.

A copy of ``batch3dmot_tpu/infer/tracks.py`` (numpy only): the port imports nothing
of the JAX package.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from batch3dmot_tpu_torch import geometry as geo
from batch3dmot_tpu_torch.config import DEFAULT_EDGE_SCORE_THRESHOLDS
from batch3dmot_tpu_torch.data.types import SceneDetections


def hierarchical_clusters(
    pred_edges: Sequence[Tuple[Tuple[int, int], float]],
    node_category: Dict[int, str],
    join_thresholds: Optional[Dict[str, float]] = None,
) -> List[List[int]]:
    """Greedy agglomerative track building over score-descending edges.

    Each cluster is an ordered node chain. For edge (j -> i):
      * both nodes free: new cluster [j, i];
      * i is the head of a cluster and j free: prepend j;
      * j is the tail of a cluster and i free: append i;
      * j tail of one cluster and i head of another: join iff the edge score
        clears the per-class join threshold.
    (reference ``predict.py:290-373``)
    """
    join_thresholds = join_thresholds or DEFAULT_EDGE_SCORE_THRESHOLDS
    edges_desc = sorted(pred_edges, key=lambda kv: kv[1], reverse=True)

    clusters: Dict[int, List[int]] = {}
    vis: Dict[int, int] = {}
    next_cluster = 0

    # (the reference also tracks a per-cluster score list, but no code path
    # ever reads it — the join condition uses only the edge score; dropped)
    for (j, i), score in edges_desc:
        cat = node_category[i]
        j_vis, i_vis = j in vis, i in vis
        if not j_vis and not i_vis:
            cid = next_cluster
            next_cluster += 1
            clusters[cid] = [j, i]
            vis[j] = vis[i] = cid
        elif not j_vis and i_vis:
            cid = vis[i]
            if clusters[cid][0] == i:
                clusters[cid].insert(0, j)
                vis[j] = cid
        elif j_vis and not i_vis:
            cid = vis[j]
            if clusters[cid][-1] == j:
                clusters[cid].append(i)
                vis[i] = cid
        else:
            c0, c1 = vis[j], vis[i]
            if c0 == c1:
                continue  # cycle guard (impossible for time-directed edges)
            if (
                clusters[c0][-1] == j
                and clusters[c1][0] == i
                and score > join_thresholds[cat]
            ):
                clusters[c0] = clusters[c0] + clusters[c1]
                for node in clusters[c1]:
                    vis[node] = c0
                del clusters[c1]

    return [nodes for nodes in clusters.values()]


def interpolate_track_linear(
    track_dets: List[int], scene: SceneDetections
) -> List[Dict]:
    """Linearly interpolate missing frames inside a track.

    Rebuild of the missing ``batch_3dmot.utils.interpolation
    .interpolate_linear`` from its call-site contract (``predict.py:524-530``):
    for each gap between consecutive track detections spanning >1 frame, emit
    synthetic boxes with linearly interpolated center/size and slerp-free
    yaw interpolation, carrying the category and the mean score.
    """
    out: List[Dict] = []
    order = np.argsort(scene.frame_idx[track_dets])
    dets = [track_dets[k] for k in order]
    for a, b in zip(dets[:-1], dets[1:]):
        fa, fb = int(scene.frame_idx[a]), int(scene.frame_idx[b])
        if fb - fa <= 1:
            continue
        meta_a = scene.metadata[a]
        c_a, c_b = scene.center_g[a], scene.center_g[b]
        s_a, s_b = scene.wlh[a], scene.wlh[b]
        y_a, y_b = scene.yaw_g[a], scene.yaw_g[b]
        dyaw = geo.angle_diff(y_b, y_a)
        score = 0.5 * (float(scene.score[a]) + float(scene.score[b]))
        for f in range(fa + 1, fb):
            t = (f - fa) / (fb - fa)
            center = (1 - t) * c_a + t * c_b
            size = (1 - t) * s_a + t * s_b
            yaw = float(y_a + t * dyaw)
            out.append(
                {
                    "sample_token": _frame_sample_token(scene, f),
                    "translation": center.tolist(),
                    "size": size.tolist(),
                    "rotation": geo.yaw_to_quat(yaw).tolist(),
                    "velocity": ((c_b - c_a)[:2] / (fb - fa) * 2.0).tolist(),
                    "category_name": meta_a["category_name"],
                    "score": score,
                    "time": f,
                }
            )
    return out


def _frame_sample_token(scene: SceneDetections, frame: int) -> str:
    """sample_token of a frame. `scene.frame_tokens` is authoritative (the
    only source that covers frames whose detections were ALL filtered out —
    the submission must list their real token, reference
    ``predict.py:472-495``); legacy scenes without it infer from any
    detection in the frame, then from the synthetic token pattern."""
    if scene.frame_tokens is not None:
        return scene.frame_tokens[frame]
    sel = np.nonzero(scene.frame_idx == frame)[0]
    if len(sel):
        return scene.metadata[int(sel[0])]["sample_token"]
    # synthetic/derived token naming: <scene>_f<frame>
    return f"{scene.scene_token}_f{frame}"


def scene_results(
    tracks: List[List[int]],
    scene: SceneDetections,
    interpolate_trailers: bool = True,
    track_id_offset: int = 0,
) -> Dict[str, List[Dict]]:
    """Per-sample-token tracking boxes for one scene
    (reference ``Batch3DMOTSceneEval.traverse_generated_tracks``,
    ``predict.py:497-546``)."""
    results: Dict[str, List[Dict]] = defaultdict(list)
    for tid, track in enumerate(tracks):
        track_id = str(track_id_offset + tid)
        cat = scene.metadata[track[0]]["category_name"]
        boxes: List[Dict] = []
        for det in track:
            meta = scene.metadata[det]
            boxes.append(
                {
                    "sample_token": meta["sample_token"],
                    "translation": list(meta["translation"]),
                    "size": list(meta["size"]),
                    "rotation": list(meta["rotation"]),
                    "velocity": list(meta.get("velocity", [0.0, 0.0]))[:2],
                    "tracking_id": track_id,
                    "tracking_name": cat,
                    "tracking_score": float(meta["score"]),
                }
            )
        if interpolate_trailers and cat == "trailer":
            for interp in interpolate_track_linear(track, scene):
                boxes.append(
                    {
                        "sample_token": interp["sample_token"],
                        "translation": interp["translation"],
                        "size": interp["size"],
                        "rotation": interp["rotation"],
                        "velocity": interp["velocity"][:2],
                        "tracking_id": track_id,
                        "tracking_name": cat,
                        "tracking_score": interp["score"],
                    }
                )
        for box in boxes:
            results[box["sample_token"]].append(box)
    return dict(results)


def all_scene_sample_tokens(scene: SceneDetections) -> List[str]:
    """Every sample token of the scene (frames without detections included),
    so the submission carries empty lists for them as the reference does
    (``predict.py:472-495,574``)."""
    return [
        _frame_sample_token(scene, f) for f in range(scene.num_frames)
    ]


def assemble_submission(
    per_scene_results: Sequence[Dict[str, List[Dict]]],
    all_sample_tokens: Sequence[str],
    use_camera: bool = True,
    use_lidar: bool = True,
    use_radar: bool = False,
) -> Dict:
    """nuScenes tracking submission dict (reference ``predict.py:549-573``)."""
    results: Dict[str, List[Dict]] = {tok: [] for tok in all_sample_tokens}
    for scene_res in per_scene_results:
        for tok, boxes in scene_res.items():
            results.setdefault(tok, []).extend(boxes)
    return {
        "meta": {
            "use_camera": use_camera,
            "use_lidar": use_lidar,
            "use_radar": use_radar,
            "use_map": False,
            "use_external": False,
        },
        "results": results,
    }
