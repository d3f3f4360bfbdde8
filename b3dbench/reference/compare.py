"""The comparisons that decide ``correct``: what the timed path produced
against the reference (or, for a control, what the lower-precision
reference produced in the program's place).

Training (three steps from one state): the first step's loss; the first
gradient as the optimizer takes it (recovered from Adam's first moment
after one step); the parameters' change after the three steps. Norms are
taken by leaf, each leaf's gap is |norm_program - norm_reference| over the
larger of the reference's norm of that leaf and the median leaf's, and
the median leaf's gap is the number. Leaves whose reference gradient lies
under a thousandth of the median leaf's move by Adam's normalisation of
round-off alone and are left out of the change.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    """Each leaf's |norm_program - norm_reference| over the larger of the
    reference's norm of the leaf and the median leaf's."""
    floor = float(np.median([ref[k] for k in keys]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor) for k in keys}


def train_leaf_gaps(prog: dict, ref: dict):
    """(each step's relative loss gap, each leaf's first-gradient gap, each
    moved leaf's change gap)."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    g_r = _norms(ref["grad"])
    keys = sorted(g_r)
    g_floor = float(np.median([g_r[k] for k in keys]))
    moved = [k for k in keys if g_r[k] >= 1e-3 * g_floor]
    return (losses, leaf_gaps(_norms(prog["grad"]), g_r, keys),
            leaf_gaps(_norms(prog["change"]), _norms(ref["change"]), moved))


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog``/``ref``: {"losses": [3], "grad": {leaf: tensor}, "change":
    {leaf: tensor}}. The numbers compared: the first step's loss, and the
    median leaf's gaps (steady from seed to seed: on the card, float32's
    own rounding moves a few small leaves' norms and the later steps'
    losses by up to a third of TF32's whole error, PERF.md)."""
    losses, grad, change = train_leaf_gaps(prog, ref)
    return {"loss_gap": losses[0],
            "grad_norm_gap": float(np.median(list(grad.values()))),
            "change_norm_gap": float(np.median(list(change.values())))}

