"""Native nuScenes-style tracking metrics (AMOTA / AMOTP / MOTA ...).

A copy of ``batch3dmot_tpu/eval/tracking_metrics.py`` (numpy and scipy
only). Per class, predictions are swept over ``n_recalls`` recall targets;
each threshold is interpolated over the (recall, score) staircase of the
matched predictions of an unthresholded pass (the devkit's
``compute_thresholds``); frames are matched GT<->prediction by BEV center
distance <= 2 m with match persistence and Hungarian assignment on the rest;
unachieved recall bins enter AMOTA at 0 and AMOTP at 2.0 m. The JAX
package's module docstring carries the field-by-field derivation.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from batch3dmot_tpu_torch.config import TRACKING_CLASSES

DIST_TH = 2.0  # nuScenes tracking matching threshold (meters, BEV center)
# the devkit fills unachieved recall bins with a WORST value before
# averaging: metric_worst['amota'] = 0, metric_worst['amotp'] = 2.0 (the
# match gate) in the tracking config (nuscenes/eval/tracking/ config +
# evaluate.py AVG_METRIC_MAP handling)
MOTP_WORST = 2.0


@dataclasses.dataclass
class TrackingEvalResult:
    per_class: Dict[str, Dict[str, float]]
    amota: float
    amotp: float

    def summary(self) -> str:
        lines = [
            f"{'class':<12} {'AMOTA':>7} {'AMOTP':>7} {'MOTA':>7} "
            f"{'IDS':>5} {'FRAG':>5} {'MT':>4} {'ML':>4}"
        ]
        for c, m in self.per_class.items():
            lines.append(
                f"{c:<12} {m['amota']:7.3f} {m['amotp']:7.3f} "
                f"{m['mota']:7.3f} {int(m['ids']):5d} "
                f"{int(m.get('frag', 0)):5d} {int(m.get('mt', 0)):4d} "
                f"{int(m.get('ml', 0)):4d}"
            )
        lines.append(f"{'avg':<12} {self.amota:7.3f} {self.amotp:7.3f}")
        return "\n".join(lines)


def _frames_view(boxes: Sequence[dict], key_class: str):
    """Group box dicts by (sample_token) for one class."""
    by_frame: Dict[str, List[dict]] = defaultdict(list)
    for b in boxes:
        if b["tracking_name"] == key_class:
            by_frame[b["sample_token"]].append(b)
    return by_frame


def _match_frames(
    gt_frames: Dict[str, List[dict]],
    pred_frames: Dict[str, List[dict]],
    frame_order: Sequence[str],
    score_thresh: float,
):
    """CLEAR-MOT accumulation for one class at one score threshold.

    Returns (tp, fp, fn, ids, dist_sum, n_match, match_scores, tracks)
    where match_scores are the tracking scores of the matched predictions
    (the devkit derives its recall-sweep thresholds from these) and tracks
    is a (mt, ml, frag) triple of GT-track coverage stats (motmetrics
    semantics: MT = tracks matched >= 80% of their present frames, ML =
    < 20%, FRAG = tracked -> untracked -> tracked transitions).
    """
    tp = fp = fn = ids = 0
    dist_sum = 0.0
    n_match = 0
    match_scores: List[float] = []
    last_match: Dict[str, str] = {}  # gt instance -> track id
    present: Dict[str, int] = defaultdict(int)  # inst -> frames present
    covered: Dict[str, int] = defaultdict(int)  # inst -> frames matched
    frag_state: Dict[str, str] = {}  # inst -> 'tracked' | 'gap'
    frag = 0

    for tok in frame_order:
        gts = gt_frames.get(tok, [])
        preds = [p for p in pred_frames.get(tok, []) if p["tracking_score"] >= score_thresh]
        if not gts and not preds:
            continue
        gt_centers = np.array([g["translation"][:2] for g in gts], float).reshape(-1, 2)
        pr_centers = np.array([p["translation"][:2] for p in preds], float).reshape(-1, 2)
        if len(gts) and len(preds):
            d = np.linalg.norm(
                gt_centers[:, None, :] - pr_centers[None, :, :], axis=-1
            )
        else:
            d = np.zeros((len(gts), len(preds)))

        matched_gt = set()
        matched_pr = set()
        pairs: List[Tuple[int, int]] = []

        # 1) persist previous (instance, track) pairs when still valid
        track_of_pred = {i: p["tracking_id"] for i, p in enumerate(preds)}
        inst_of_gt = {i: g["instance"] for i, g in enumerate(gts)}
        for gi in range(len(gts)):
            want = last_match.get(inst_of_gt[gi])
            if want is None:
                continue
            for pi in range(len(preds)):
                if (
                    pi not in matched_pr
                    and track_of_pred[pi] == want
                    and d[gi, pi] <= DIST_TH
                ):
                    pairs.append((gi, pi))
                    matched_gt.add(gi)
                    matched_pr.add(pi)
                    break

        # 2) Hungarian on the remainder
        rem_g = [i for i in range(len(gts)) if i not in matched_gt]
        rem_p = [i for i in range(len(preds)) if i not in matched_pr]
        if rem_g and rem_p:
            sub = d[np.ix_(rem_g, rem_p)]
            cost = np.where(sub <= DIST_TH, sub, 1e6)
            ri, ci = linear_sum_assignment(cost)
            for a, b in zip(ri, ci):
                if sub[a, b] <= DIST_TH:
                    pairs.append((rem_g[a], rem_p[b]))
                    matched_gt.add(rem_g[a])
                    matched_pr.add(rem_p[b])

        for gi, pi in pairs:
            inst = inst_of_gt[gi]
            track = track_of_pred[pi]
            if inst in last_match and last_match[inst] != track:
                ids += 1
            last_match[inst] = track
            dist_sum += float(d[gi, pi])
            n_match += 1
            match_scores.append(float(preds[pi]["tracking_score"]))

        # per-GT-track coverage bookkeeping (MT/ML/FRAG)
        for gi in range(len(gts)):
            inst = inst_of_gt[gi]
            present[inst] += 1
            if gi in matched_gt:
                covered[inst] += 1
                if frag_state.get(inst) == "gap":
                    frag += 1  # re-acquired after an interruption
                frag_state[inst] = "tracked"
            elif frag_state.get(inst) == "tracked":
                frag_state[inst] = "gap"

        tp += len(pairs)
        fp += len(preds) - len(matched_pr)
        fn += len(gts) - len(matched_gt)

    mt = sum(1 for i, n in present.items() if covered[i] / n >= 0.8)
    ml = sum(1 for i, n in present.items() if covered[i] / n < 0.2)
    return tp, fp, fn, ids, dist_sum, n_match, match_scores, (mt, ml, frag)


def _unmatched_stats(gt_frames, num_gt: int) -> Dict[str, float]:
    """Worst-case traditional metrics for a class with GT but no achieved
    recall bin (nothing ever matched at any swept threshold): every GT box
    is a miss and every GT track is mostly-lost."""
    n_tracks = len({g["instance"] for v in gt_frames.values() for g in v})
    return dict(mota=0.0, ids=0, tp=0, fp=0, fn=num_gt, recall=0.0,
                mt=0, ml=n_tracks, frag=0, faf=0.0)


def json_safe(obj):
    """Recursive copy with non-finite floats replaced by None: the scorer
    reports devkit-accurate NaN for a class that never matched (excluded
    from the class mean, see `evaluate_tracking`), but `json.dumps`
    serializes NaN as a bare ``NaN`` literal that strict JSON parsers
    (jq, JSON.parse, non-Python consumers) reject — sanitize at every
    emission boundary."""
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def evaluate_tracking(
    gt_boxes: Sequence[dict],
    pred_boxes: Sequence[dict],
    frame_order: Sequence[str],
    classes: Optional[Sequence[str]] = None,
    n_recalls: int = 40,
    min_recall: float = 0.1,
) -> TrackingEvalResult:
    """Native AMOTA/AMOTP evaluation.

    gt_boxes: dicts with sample_token, translation, tracking_name, instance.
    pred_boxes: dicts with sample_token, translation, tracking_name,
    tracking_id, tracking_score (the submission format).
    frame_order: temporally ordered sample tokens (all scenes concatenated;
    scene boundaries only matter for match persistence, which GT instance
    tokens already scope).
    """
    classes = list(classes or TRACKING_CLASSES.keys())
    per_class: Dict[str, Dict[str, float]] = {}

    for cls in classes:
        gt_frames = _frames_view(gt_boxes, cls)
        pred_frames = _frames_view(pred_boxes, cls)
        num_gt = sum(len(v) for v in gt_frames.values())
        if num_gt == 0:
            continue

        # Sweep thresholds come from the scores of MATCHED predictions in
        # an unthresholded pass — the devkit's compute_thresholds semantics
        # (nuscenes/eval/tracking/algo.py). Selecting from ALL prediction
        # scores is subtly wrong: any high-scoring FP shifts every bin's
        # threshold so the achieved recall lands just below target, and
        # classes with a few confident FPs (e.g. interpolated trailer
        # boxes) silently zero out (trailer AMOTA could drop to exactly
        # 1/40 because 39 of 40 bins were skipped this way).
        *_, match_scores, _tracks = _match_frames(
            gt_frames, pred_frames, frame_order, -np.inf
        )
        scores = np.sort(np.asarray(match_scores, float))[::-1]
        if scores.size == 0:
            # GT exists but NO prediction ever matched: every bin is NaN, so
            # the devkit reports amota/amotp as NaN for the class and the
            # class-level nanmean EXCLUDES it (evaluate.py: `if np.all(
            # np.isnan(values)): value = np.nan`). Reporting amota = 0 here
            # instead would deflate the headline vs the protocol.
            per_class[cls] = dict(
                amota=float("nan"), amotp=float("nan"),
                **_unmatched_stats(gt_frames, num_gt),
            )
            continue

        # Thresholds are interpolated at the target recalls over the
        # (recall, score) staircase of the unthresholded matches — the
        # devkit's exact formula (np.interp(rec_interp, rec, scores) with
        # rec = cumsum(1)/num_gt); targets beyond the max achieved recall
        # get NaN there and contribute the worst value (0) to AMOTA, which
        # the skip below reproduces.
        match_rec = np.arange(1, scores.size + 1) / num_gt
        recalls = np.linspace(min_recall, 1.0, n_recalls)
        thresholds = np.interp(recalls, match_rec, scores)
        max_recall = float(match_rec[-1])
        motars, motps, bins = [], [], []
        cache: Dict[float, tuple] = {}
        for r, thresh in zip(recalls, thresholds):
            if r > max_recall + 1e-12:
                break
            thresh = float(thresh)
            if thresh not in cache:
                cache[thresh] = _match_frames(
                    gt_frames, pred_frames, frame_order, thresh
                )
            tp, fp_, fn_, ids, dsum, nm, _, trk = cache[thresh]
            rec = tp / num_gt
            if tp == 0:
                # devkit motar: rec == 0 -> NaN -> worst-filled (0 for
                # amota, 2.0 for amotp) — the skip makes the bin count as
                # unachieved below, which is the same fill. (Only reachable
                # if thresholding removes every match the staircase
                # promised — persistence/Hungarian make that ~impossible.)
                continue
            # MOTAR with the achieved recall: since FN == (1 - rec) * P per
            # construction, 1 - (IDS+FP+FN-(1-rec)P)/(rec P) reduces to
            # 1 - (IDS + FP) / (rec * P).
            motar = max(0.0, 1.0 - (ids + fp_) / (rec * num_gt))
            motars.append(motar)
            motps.append(dsum / max(nm, 1))
            bins.append(dict(
                mota=max(0.0, 1.0 - (ids + fp_ + fn_) / num_gt),
                ids=ids, tp=tp, fp=fp_, fn=fn_, recall=rec,
                mt=trk[0], ml=trk[1], frag=trk[2],
                # false alarms per 100 frames over ALL frames of the split
                # (the devkit updates its accumulator for every frame,
                # matched or not)
                faf=100.0 * fp_ / max(len(frame_order), 1),
            ))

        # Unachieved (NaN) bins enter the averages at the protocol's worst
        # value: 0 for MOTAR (so sum/n_recalls), 2.0 m for MOTP. All-NaN
        # (no achieved bin at all) -> NaN, excluded from the class mean.
        amota = float(np.sum(motars) / n_recalls) if motars else float("nan")
        amotp = (
            float((np.sum(motps) + (n_recalls - len(motps)) * MOTP_WORST)
                  / n_recalls)
            if motps else float("nan")
        )
        entry = dict(amota=amota, amotp=amotp)
        if bins:
            # traditional metrics report at the best-MOTA bin; bins ascend
            # in recall and np.argmax takes the FIRST max — exactly the
            # devkit's nanargmax(md.mota) over its ascending-recall bins
            # with NaN (unachieved) entries ignored, which the achieved-only
            # `bins` list reproduces (see module docstring table)
            motas = np.array([b["mota"] for b in bins])
            best = bins[int(np.argmax(motas))]
        else:
            best = _unmatched_stats(gt_frames, num_gt)
        entry.update(best)
        per_class[cls] = entry

    def _nanmean(vals: List[float]) -> float:
        finite = [v for v in vals if np.isfinite(v)]
        return float(np.mean(finite)) if finite else float("nan")

    amota = _nanmean([m["amota"] for m in per_class.values()])
    amotp = _nanmean([m["amotp"] for m in per_class.values()])
    return TrackingEvalResult(per_class=per_class, amota=amota, amotp=amotp)


def gt_boxes_from_scene(scene) -> List[dict]:
    """GT box dicts for :func:`evaluate_tracking` from a SceneDetections'
    matched ground truth (synthetic scenes carry exact GT via token_id)."""
    out = []
    seen = set()
    for i, meta in enumerate(scene.metadata):
        tok = scene.token_id[i]
        if tok < 0:
            continue
        key = (meta["sample_token"], int(tok))
        if key in seen:  # one GT box per instance per frame
            continue
        seen.add(key)
        out.append(
            {
                "sample_token": meta["sample_token"],
                "translation": list(meta["translation"]),
                "tracking_name": meta["category_name"],
                "instance": f"{scene.scene_token}_inst{int(tok)}",
            }
        )
    return out
