"""Masked segment sum over padded edge arrays (counterpart of
``batch3dmot_tpu/ops/segment.py::segment_sum``).

Every message-passing layer scatters past messages by destination node and
future messages by source node. Here that is ``index_add_`` over the valid
edges only, so masked edges add exactly zero (they are never touched).
"""

from __future__ import annotations

from typing import Optional

import torch


def segment_sum(
    data: torch.Tensor,
    ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum ``data[..., e, :]`` into ``out[..., ids[..., e], :]``.

    data: [..., E, D]; ids: [..., E] int; mask: [..., E] bool or None.
    Leading dimensions are independent windows.
    """
    lead = ids.shape[:-1]
    d = data.shape[-1]
    nb = 1
    for s in lead:
        nb *= s
    offsets = torch.arange(nb, device=ids.device).reshape(*lead, 1) * num_segments
    flat_ids = (ids.long() + offsets).reshape(-1)
    flat_data = data.reshape(-1, d)
    if mask is not None:
        keep = mask.reshape(-1)
        flat_ids = flat_ids[keep]
        flat_data = flat_data[keep]
    out = torch.zeros(nb * num_segments, d, dtype=data.dtype, device=data.device)
    out.index_add_(0, flat_ids, flat_data)
    return out.reshape(*lead, num_segments, d)
