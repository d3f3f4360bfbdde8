"""Masked segment sum: the Hopper kernel and its plain PyTorch version
(counterpart of ``batch3dmot_tpu/ops/pallas_segment.py::segment_sum_pallas``
and of the ``segment_sum`` it computes, ``batch3dmot_tpu/ops/segment.py``).

The CUDA kernel (``csrc/segment_sum.cu``) replaces the Pallas TPU kernel B8
(``_make_kernel``); its source note says what bounds it and how the design
answers that. It lists each node's edges itself (a stable counting sort per
block in shared memory), so a call is one launch: no sort, search or count
on the host's side of the card. :func:`segment_plan` picks its node tile
and edge chunk. :func:`segment_sum` is the dispatcher the models call: it
launches the kernel for CUDA tensors (or raises) and runs
:func:`segment_sum_plain`, ``index_add_`` over the valid edges, for CPU
tensors. Both sit behind one ``torch.autograd.Function`` whose backward is
the masked gather ``grad_data = grad_out[ids] * mask`` (B8 has no backward
kernel in the JAX package).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from batch3dmot_tpu_torch.ops import cuda_build
from batch3dmot_tpu_torch.ops.fused_mp import H100_SMS, SMEM_LIMIT, host_ptr, ptr, sm_count

# csrc/segment_sum.cu: threads per block, the largest node tile (one warp
# scans a tile's counts) and the largest edge chunk a block lists at once
THREADS, MAX_TILE, MAX_CHUNK = 256, 32, 8192
ACC_BYTES = 64 * 1024  # accumulator budget of a block's shared memory


def segment_sum_plain(
    data: torch.Tensor,
    ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``index_add_`` of the valid edges only: masked edges are never
    touched, so they add exactly zero whatever their id or data."""
    lead = ids.shape[:-1]
    d = data.shape[-1]
    nb = math.prod(lead)
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


def segment_plan(windows: int, num_segments: int, edges: int, d: int,
                 sms: int = H100_SMS):
    """Launch plan of the kernel: (node tile T, edge chunk CH, shared-memory
    bytes). T halves from 32 down to 8 until the (tile, window) grid has two
    blocks per SM, and further while the tile's accumulators [T, D] outgrow
    ACC_BYTES; CH covers the window's edges in multiples of THREADS, at
    most MAX_CHUNK (a block walks longer windows chunk by chunk)."""
    tile = MAX_TILE
    while tile > 8 and windows * -(-num_segments // tile) < 2 * sms:
        tile //= 2
    while tile > 1 and tile * d * 4 > ACC_BYTES:
        tile //= 2
    chunk = min(max(-(-edges // THREADS), 1) * THREADS, MAX_CHUNK)
    warps = THREADS // 32
    smem = 4 * tile * d + 4 * chunk + 4 * warps * tile + 4 * (tile + 1) + chunk
    smem = -(-smem // 16) * 16
    if smem > SMEM_LIMIT:
        raise ValueError(f"segment_sum kernel: D = {d} needs {smem} bytes of shared memory")
    return tile, chunk, smem


def segment_sum_cuda(
    data: torch.Tensor,
    ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream: one launch that
    lists each node's valid edges in edge order and sums them."""
    lead, e = tuple(ids.shape[:-1]), ids.shape[-1]
    d = data.shape[-1]
    if (data.device.type != "cuda" or data.dtype != torch.float32
            or tuple(data.shape) != (*lead, e, d)):
        raise ValueError(
            f"segment_sum kernel: data must be float32 {(*lead, e, d)} on cuda, "
            f"got {data.dtype} {tuple(data.shape)} on {data.device}")
    if ids.device != data.device or (mask is not None and (
            mask.device != data.device or mask.shape != ids.shape
            or mask.dtype != torch.bool)):
        raise ValueError("segment_sum kernel: ids and a bool mask must be [..., E] "
                         "on the data's device")
    nb = math.prod(lead)
    out = torch.empty(*lead, num_segments, d, dtype=torch.float32, device=data.device)
    if out.numel() == 0:
        return out
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int32)
    ids = ids.contiguous()
    data = data.contiguous()
    if mask is not None:
        mask = mask.contiguous()
    vec4 = d % 4 == 0 and data.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    tile, chunk, smem = segment_plan(nb, num_segments, e, d, sm_count(data.device.index or 0))
    dims = np.array([nb, num_segments, e, d, int(vec4), tile, chunk, smem,
                     int(ids.dtype == torch.int64)], np.int32)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = cuda_build.load("segment_sum").segment_sum_forward(
        host_ptr(dims), ptr(data), ptr(ids), ptr(mask), ptr(out),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error {err}")
    segment_sum.launches += 1
    return out


def gather_segments(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of x [..., N, H] at ids [..., E] -> [..., E, H]; ids outside
    [0, N) are clamped, as a JAX gather clamps them."""
    n, h = x.shape[-2:]
    idx = ids.long().clamp(0, n - 1)
    return torch.gather(x, -2, idx[..., None].expand(*ids.shape, h))


def segment_sum_grad(
    grad_out: torch.Tensor,
    ids: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The backward of a segment sum: ``grad_out[..., ids, :]`` on valid
    edges, zero on masked ones."""
    g = gather_segments(grad_out, ids)
    if mask is not None:
        g = g * mask[..., None].to(g.dtype)
    return g


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ids, num_segments, mask):
        ctx.save_for_backward(ids, mask)
        if data.device.type == "cuda":
            return segment_sum_cuda(data, ids, num_segments, mask)
        return segment_sum_plain(data, ids, num_segments, mask)

    @staticmethod
    def backward(ctx, grad_out):
        ids, mask = ctx.saved_tensors
        return segment_sum_grad(grad_out, ids, mask), None, None, None


def segment_sum(
    data: torch.Tensor,
    ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum ``data[..., e, :]`` into ``out[..., ids[..., e], :]`` over the
    valid edges; differentiable in ``data``.

    data: [..., E, D] float; ids: [..., E] int, in [0, num_segments) on
    valid edges (on the card a valid edge whose id lies outside that range
    reaches no segment: checking would wait for the device); mask: [..., E]
    bool or None. Leading dimensions are
    independent windows. CUDA tensors go through the Hopper kernel (a
    launch failure raises); CPU tensors through :func:`segment_sum_plain`.
    ``segment_sum.launches`` counts the kernel runs."""
    if data.device.type not in ("cuda", "cpu"):
        raise ValueError(f"segment_sum: unsupported device {data.device}")
    return _SegmentSum.apply(data, ids, num_segments, mask)


segment_sum.launches = 0
