"""Official nuScenes TrackingEval wrapper (devkit-gated); a copy of
``batch3dmot_tpu/eval/nuscenes_eval.py``.

Thin equivalent of the reference's ``eval/eval_nuscenes.py:72-81`` /
``predict.py:663-678``: writes the submission JSON and invokes the official
``TrackingEval`` with the ``tracking_nips_2019`` config. Requires the
nuscenes-devkit and the dataset on disk; when either is absent, callers
should fall back to :mod:`batch3dmot_tpu_torch.eval.tracking_metrics`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from batch3dmot_tpu_torch.config import Config


def devkit_available() -> bool:
    try:
        import nuscenes.eval.tracking.evaluate  # noqa: F401

        return True
    except ImportError:
        return False


def run_official_eval(
    submission: Dict,
    cfg: Config,
    output_name: str = "submission.json",
    render_curves: Optional[bool] = None,
) -> Dict:
    """Dump the submission and score it with the official TrackingEval.

    Returns the devkit metrics summary dict (amota, amotp, per-class ...).
    """
    if not devkit_available():
        raise RuntimeError(
            "nuscenes-devkit not installed; use "
            "batch3dmot_tpu_torch.eval.tracking_metrics.evaluate_tracking instead"
        )
    from nuscenes.eval.common.config import config_factory
    from nuscenes.eval.tracking.data_classes import TrackingConfig
    from nuscenes.eval.tracking.evaluate import TrackingEval

    os.makedirs(cfg.paths.eval, exist_ok=True)
    result_path = os.path.join(cfg.paths.eval, output_name)
    with open(result_path, "w") as f:
        json.dump(submission, f)

    if cfg.eval.eval_config == "tracking_nips_2019":
        eval_cfg = config_factory("tracking_nips_2019")
    else:
        with open(cfg.eval.eval_config, "r") as f:
            eval_cfg = TrackingConfig.deserialize(json.load(f))

    nusc_eval = TrackingEval(
        config=eval_cfg,
        result_path=result_path,
        eval_set=cfg.eval.eval_set,
        output_dir=cfg.paths.eval,
        nusc_version=cfg.main.version,
        nusc_dataroot=cfg.paths.data,
        verbose=bool(cfg.eval.verbose),
    )
    render = bool(cfg.eval.render_curves) if render_curves is None else render_curves
    return nusc_eval.main(render_curves=render)
