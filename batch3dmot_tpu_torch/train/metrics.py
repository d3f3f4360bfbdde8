"""Losses and masked metrics (counterpart of
``batch3dmot_tpu/train/metrics.py``).

Mask-aware versions of ``torch.nn.BCELoss(weight=...)`` and torchmetrics'
``average_precision`` over padded edge arrays, with the JAX package's
semantics: the BCE clips probabilities at 1e-7 (``BCELoss`` instead clamps
the log at -100), and tied scores form ONE threshold of the AP.
"""

from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-7


def masked_bce(
    scores: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    from_logits: bool = False,
) -> torch.Tensor:
    """Mean BCE over real (masked-in) edges, optionally per-edge weighted:
    mean of w * bce over the real edges. ``from_logits=True`` is the stable
    BCE-with-logits form for the sigmoid-less PoseGNN head."""
    total, count = masked_bce_terms(scores, labels, mask, weights, from_logits)
    return total / torch.clamp(count, min=1.0)


def masked_bce_terms(
    scores: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    from_logits: bool = False,
):
    """(sum of w * bce over the real edges, number of real edges): the two
    terms of :func:`masked_bce`, which a data-parallel caller sums over its
    ranks' batches separately (the count outside autograd)."""
    if from_logits:
        z = scores
        per_edge = torch.clamp(z, min=0) - z * labels + torch.log1p(torch.exp(-z.abs()))
    else:
        s = torch.clamp(scores, _EPS, 1.0 - _EPS)
        per_edge = -(labels * torch.log(s) + (1.0 - labels) * torch.log(1.0 - s))
    if weights is not None:
        per_edge = per_edge * weights
    m = mask.to(per_edge.dtype)
    return torch.sum(per_edge * m), torch.sum(m)


def _tie_group_ends(s_sorted: torch.Tensor) -> torch.Tensor:
    """For each position of a descending score vector, the index of the
    last element of its tie group."""
    n = s_sorted.shape[0]
    is_last = torch.ones(n, dtype=torch.bool, device=s_sorted.device)
    is_last[:-1] = s_sorted[1:] != s_sorted[:-1]
    idx = torch.arange(n, device=s_sorted.device)
    end = torch.where(is_last, idx, torch.full_like(idx, n))
    return torch.cummin(end.flip(0), 0).values.flip(0)


def average_precision(
    scores: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Binary average precision: the sum over score thresholds of
    ``(recall_n - recall_{n-1}) * precision_n``; tied scores form one
    threshold. Masked entries sort last (their own tie group) and count for
    nothing. NaN when there is no positive."""
    if mask is None:
        mask = torch.ones_like(scores, dtype=torch.bool)
    return average_precision_multi(scores, labels, mask[None, :])[0]


def average_precision_multi(
    scores: torch.Tensor,
    labels: torch.Tensor,
    sels: torch.Tensor,
) -> torch.Tensor:
    """Binary AP of each selection row of ``sels`` [C, n] (bool), off one
    shared sort: row c equals ``average_precision(scores, labels, sels[c])``.
    Tie groups are defined by the score values, and a row's cumulative
    counts at a group's end count only its own entries, so sharing the sort
    is exact. Rows without a positive give NaN."""
    neg_inf = torch.finfo(scores.dtype).min
    s = torch.where(sels.any(dim=0), scores, torch.full_like(scores, neg_inf))
    order = torch.argsort(-s, stable=True)
    end = _tie_group_ends(s[order])
    y_sorted = labels[order].to(scores.dtype)
    sel_s = sels[:, order].to(scores.dtype)  # [C, n]
    yc = y_sorted[None, :] * sel_s
    tp = torch.cumsum(yc, dim=1)
    seen = torch.cumsum(sel_s, dim=1)
    precision = tp[:, end] / torch.clamp(seen[:, end], min=1.0)
    return torch.sum(precision * yc, dim=1) / torch.sum(yc, dim=1)


def masked_accuracy(
    scores: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    threshold: float = 0.5,
) -> torch.Tensor:
    pred = (scores > threshold).to(labels.dtype)
    m = mask.to(torch.float32)
    correct = (pred == labels).to(torch.float32) * m
    return torch.sum(correct) / torch.clamp(torch.sum(m), min=1.0)
