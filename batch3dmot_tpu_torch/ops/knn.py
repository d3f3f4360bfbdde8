"""Masked kNN graph construction over padded windows (counterpart of
``batch3dmot_tpu/ops/knn.py``).

One padded [N, N] distance matrix per window, invalid pairs (padding,
different timestamps, self-loops) filled with 1e30, and the k nearest per
row: a fixed-size edge list of N * k entries with a validity mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_INF = 1e30


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances [..., N, N] of x [..., N, D] by the
    JAX package's expansion ||a||^2 + ||b||^2 - 2 a.b, clamped at 0 (not
    ``torch.cdist``, whose rounding differs). The product is float32: the
    port's entry points keep TF32 off."""
    sq = (x * x).sum(-1)
    cross = x @ x.transpose(-1, -2)
    d = sq[..., :, None] + sq[..., None, :] - 2.0 * cross
    return d.clamp_min(0.0)


def knn_graph_masked(
    x: torch.Tensor,
    k: int,
    valid: Optional[torch.Tensor] = None,
    pair_valid: Optional[torch.Tensor] = None,
    loop: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kNN edges (src = neighbour j, dst = query i) over masked points.

    x: [..., N, D]; valid: [..., N] bool node mask; pair_valid: [..., N, N]
    bool extra pair constraint (e.g. same timestamp). Each valid query node
    i receives edges from its k nearest allowed neighbours j (j -> i).
    ``jax.lax.top_k`` puts the lower index first among equal distances; a
    stable ascending sort does the same, so the neighbour set at the k-th
    boundary is the JAX one (``torch.topk`` promises no order).

    Returns (src [..., N*k], dst [..., N*k], mask [..., N*k]); masked
    entries have src = dst = 0.
    """
    n = x.shape[-2]
    d = pairwise_sq_dists(x)
    allowed = torch.ones(d.shape, dtype=torch.bool, device=x.device)
    if valid is not None:
        allowed &= valid[..., None, :] & valid[..., :, None]
    if pair_valid is not None:
        allowed &= pair_valid
    if not loop:
        allowed &= ~torch.eye(n, dtype=torch.bool, device=x.device)
    d = torch.where(allowed, d, _INF)

    k = min(k, n)
    dist, idx = torch.sort(d, dim=-1, stable=True)
    mask = (dist[..., :k] < _INF).flatten(-2)
    src = idx[..., :k].flatten(-2)
    dst = torch.arange(n, device=x.device).repeat_interleave(k).expand_as(src)
    zero = torch.zeros_like(src)
    return torch.where(mask, src, zero), torch.where(mask, dst, zero), mask
