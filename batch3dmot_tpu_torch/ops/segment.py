"""Segment reductions over padded edge arrays (counterpart of
``batch3dmot_tpu/ops/segment.py``).

Every message-passing layer scatters past messages by destination node and
future messages by source node, and the kNN GATConv sums its softmax
denominator and its messages by destination: all through
:func:`segment_sum`, the dispatcher of the Hopper kernel
(``ops/segment_kernel.py``). :func:`segment_max`, :func:`segment_mean` and
:func:`segment_softmax` build on it. Every function takes leading window
dimensions ``[..., E]``; masked edges reach no segment.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from batch3dmot_tpu_torch.ops.segment_kernel import gather_segments, segment_sum

__all__ = ["segment_max", "segment_mean", "segment_softmax", "segment_sum"]


def segment_max(
    data: torch.Tensor,
    ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    initial: float = float("-inf"),
) -> torch.Tensor:
    """Max-reduce ``data[..., e, :]`` into ``out[..., ids[..., e], :]``;
    empty segments get ``initial``. data: [..., E, H]. Masked edges are
    parked in an extra segment that is dropped."""
    lead = ids.shape[:-1]
    h = data.shape[-1]
    extra = 0
    if mask is not None:
        data = torch.where(mask[..., None], data, float("-inf"))
        ids = torch.where(mask, ids.long(), num_segments)
        extra = 1
    seg = num_segments + extra
    nb = math.prod(lead)
    offsets = torch.arange(nb, device=ids.device).reshape(*lead, 1) * seg
    flat_ids = (ids.long() + offsets).reshape(-1, 1).expand(-1, h)
    out = torch.full((nb * seg, h), float("-inf"), dtype=data.dtype, device=data.device)
    out = out.scatter_reduce(0, flat_ids, data.reshape(-1, h), "amax", include_self=False)
    out = out.reshape(*lead, seg, h)[..., :num_segments, :]
    return torch.where(torch.isfinite(out), out, initial)


def segment_mean(
    data: torch.Tensor,
    ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean of ``data[..., e, :]`` per segment (0 for an empty one).
    data: [..., E, H]."""
    total = segment_sum(data, ids, num_segments, mask)
    ones = torch.ones(*ids.shape, 1, dtype=data.dtype, device=data.device)
    count = segment_sum(ones, ids, num_segments, mask)
    return total / count.clamp_min(1.0)


def segment_softmax(
    scores: torch.Tensor,
    ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Numerically stable softmax of ``scores`` within each segment, the
    scatter softmax of torch_geometric's GATConv. scores: [..., E] (one per
    edge) or [..., E, H] (per head); masked entries return 0."""
    squeeze = scores.dim() == ids.dim()
    if squeeze:
        scores = scores[..., None]
    seg_max = segment_max(scores, ids, num_segments, mask, initial=0.0)
    shifted = scores - gather_segments(seg_max, ids)
    if mask is not None:
        shifted = torch.where(mask[..., None], shifted, float("-inf"))
    expd = torch.exp(shifted)
    expd = torch.where(torch.isfinite(expd), expd, 0.0)
    denom = segment_sum(expd, ids, num_segments, mask)
    out = expd / gather_segments(denom, ids).clamp_min(1e-16)
    return out[..., 0] if squeeze else out
