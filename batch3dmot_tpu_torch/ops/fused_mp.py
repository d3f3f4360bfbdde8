"""Fused causal message passing + edge classifier: the Hopper kernel and its
plain PyTorch version (counterpart of ``batch3dmot_tpu/ops/pallas_mp.py``).

The CUDA kernel (``csrc/fused_mp.cu``) replaces the Pallas TPU kernels
``_mp_kernel``, ``_mp_kernel_tiled`` and ``_mp_kernel_tiled_hbm`` and covers
every bucket of ``graph.DEFAULT_BUCKETS``; its source note says what bounds
it and how the design answers that (3xTF32 products on the tensor cores).
:func:`fused_mp_plan` picks its tiles and shared memory; :func:`tc_weights`
splits its weights into TF32 parts (:func:`split_tf32`) once per call and
lays them out as the streams its tensor-core products read.
:func:`fused_mp_scores`
launches it for CUDA tensors (or raises) and runs
:func:`fused_mp_scores_plain`, the layer loop with ``index_add_``, for CPU
tensors.

Weight contract (``extract_mp_params``), the same as the JAX package's:
every first layer is split by rows along its concatenated input,
  edge_update in  = [x_i, x_j, edge_attr, att_edge_attr?]
  future_msgs in  = [x_i, updated_edge, initial_x_i]
  past_msgs  in   = [x_j, updated_edge, initial_x_j]
  combine    in   = [agg_past, agg_future]
with weights [in, out] and biases [1, out].
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from batch3dmot_tpu_torch.ops import cuda_build

SMEM_LIMIT = 232_448  # shared memory a block can use on Hopper
H100_SMS = 132
# csrc/fused_mp.cu: the largest shape the inference kernel covers: the
# largest bucket's 1024 nodes, and the device pipeline's windows of
# (max_nodes, max_nodes * k) up to kNN 40 (shared memory does not grow with
# E, and int32 edge ids hold B * E); the training pair keeps the largest
# bucket (TRAIN_COVER, ops/fused_mp_train.py); the edge kernel's rows, weight slice depth (K), ring slots and
# most slices per layer; the node kernels' rows, slice depth, ring slots
# and most slices per block; the room for a ring's mbarriers; the
# activations' row padding; the classifier's rows and fp32 weight stages
COVER = (1024, 40960)
_EDGE_R, _EDGE_KC, _EDGE_STAGES, _MAX_SLICES = 64, 16, 3, 128
_NODE_T, _NODE_KC, _NODE_STAGES, _MAX_NODE_SLICES = 16, 16, 3, 128
_BAR, _PAD, _CLS_ROWS, _CLS_SW = 16, 4, 32, 2 * 16 * 256


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count

# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _split_rows(w, sizes):
    out = []
    lo = 0
    for s in sizes:
        out.append(w[lo: lo + s])
        lo += s
    return tuple(out)


def _chain(seq: nn.Sequential):
    """[in, out] weights and [1, out] biases of an MLP's linear layers, as
    views of the parameters (still in the autograd graph)."""
    lins = [m for m in seq if isinstance(m, nn.Linear)]
    return (
        [m.weight.t() for m in lins],
        [m.bias[None, :] for m in lins],
    )


def extract_mp_params(model: nn.Module, with_attention: bool, node_dim: int,
                      edge_dim: int, trainable: bool = False) -> Tuple[tuple, dict]:
    """Flatten a model's message-passing and edge-classifier weights into the
    kernel's weight tuple ([in, out] weights, [1, out] biases) and meta.

    ``trainable=True`` keeps the weights in the autograd graph (views of
    the ``nn.Linear`` parameters), so a loss differentiates through them to
    the parameters; otherwise they are detached, as scoring needs."""
    mp = model.message_passing
    eu_w, eu_b = _chain(mp.edge_update)
    fut_w, fut_b = _chain(mp.create_future_msgs)
    past_w, past_b = _chain(mp.create_past_msgs)
    comb_w, comb_b = _chain(mp.combine_future_past)
    cls_w, cls_b = _chain(model.edge_classifier)

    eu_sizes = [node_dim, node_dim, edge_dim] + ([edge_dim] if with_attention else [])
    eu0 = _split_rows(eu_w[0], eu_sizes)
    msg_sizes = [node_dim, edge_dim, node_dim]
    fut0 = _split_rows(fut_w[0], msg_sizes)
    past0 = _split_rows(past_w[0], msg_sizes)
    m = comb_w[0].shape[0] // 2
    comb0 = _split_rows(comb_w[0], [m, m])

    flat = (
        *eu0, *eu_w[1:], *eu_b,
        *fut0, *fut_w[1:], *fut_b,
        *past0, *past_w[1:], *past_b,
        *comb0, *comb_w[1:], *comb_b,
        *cls_w, *cls_b,
    )
    meta = dict(
        n_eu0=len(eu0), n_eu=len(eu_w) - 1, n_eub=len(eu_b),
        n_fut=len(fut_w) - 1, n_futb=len(fut_b),
        n_past=len(past_w) - 1, n_pastb=len(past_b),
        n_comb=len(comb_w) - 1, n_combb=len(comb_b),
        n_cls=len(cls_w), n_clsb=len(cls_b),
    )
    if not trainable:
        flat = tuple(w.detach() for w in flat)
    return flat, meta


def _unpack(meta, ws):
    it = iter(ws)
    take = lambda k: tuple(next(it) for _ in range(k))  # noqa: E731
    eu0 = take(meta["n_eu0"])
    eu_rest = take(meta["n_eu"])
    eu_b = take(meta["n_eub"])
    fut0 = take(3)
    fut_rest = take(meta["n_fut"])
    fut_b = take(meta["n_futb"])
    past0 = take(3)
    past_rest = take(meta["n_past"])
    past_b = take(meta["n_pastb"])
    comb0 = take(2)
    comb_rest = take(meta["n_comb"])
    comb_b = take(meta["n_combb"])
    cls_w = take(meta["n_cls"])
    cls_b = take(meta["n_clsb"])
    return (eu0, eu_rest, eu_b, fut0, fut_rest, fut_b, past0, past_rest,
            past_b, comb0, comb_rest, comb_b, cls_w, cls_b)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _mlp_tail(h, rest, biases, relu=torch.relu):
    """Finish an MLP whose first product (bias not yet added) is h: relu
    after every layer but the last."""
    h = relu(h + biases[0])
    for k, (w, b) in enumerate(zip(rest, biases[1:])):
        h = h @ w + b
        if k < len(rest) - 1:
            h = relu(h)
    return h


def relu_preactivations_from_stashes(stashes, att, src, dst, edge_mask, flat_weights,
                                     meta, depth):
    """The pre-activation z of every ReLU unit of the training kernels'
    layers and its scale, ``[(z, scale), ...]`` in the order the plain loop
    applies its ReLUs: each layer recomputed, as the backward kernel
    recomputes it, from the forward kernel's stashes ``(x_t, e_t, agg_t)``
    (``ops/fused_mp_train.py::train_forward_cuda``): the edge update from
    x_t and e_t, the messages from x_t, x_0 and e_{t+1}, the combine from
    the stashed message sums agg_t ([past by destination, future by
    source]), the classifier from e_depth. The recompute runs in the
    stashes' dtype.

    ``scale`` is sum_k |w_k a_k| + |b| for a layer whose inputs a_k are
    stashes; for a layer fed by a recomputed hidden layer, that layer's
    own scale takes the place of |a_k| (an upper bound of it): what bounds
    the rounding error of z in any summation order."""
    (eu0, eu_rest, eu_b, fut0, fut_rest, fut_b, past0, past_rest, past_b,
     comb0, comb_rest, comb_b, cls_w, cls_b) = _unpack(meta, flat_weights)
    xs, es, agg = stashes
    b, _, n, _ = xs.shape
    offs = torch.arange(b, device=xs.device)[:, None] * n
    src_f = (src.long() + offs).reshape(-1)
    dst_f = (dst.long() + offs).reshape(-1)
    mask_f = edge_mask[..., None].to(xs.dtype)
    out = []

    def gather(x, idx):
        return x.reshape(b * n, -1)[idx].reshape(*src.shape, -1) * mask_f

    def product(pairs):
        """sum of a @ w over (a, w) and its scale, sum of |a| @ |w|."""
        z = pairs[0][0] @ pairs[0][1]
        for a, w in pairs[1:]:
            z = z + a @ w
        return z, sum(a.abs() @ w.abs() for a, w in pairs)

    def tail(h, scale, rest, biases):
        """The ReLU layers of an MLP whose first product is h: after the
        first layer and after every later one but the last."""
        z, scale = h + biases[0], scale + biases[0].abs()
        out.append((z, scale))
        for w, bias in zip(rest[:-1], biases[1:]):
            z, scale = torch.relu(z) @ w + bias, scale @ w.abs() + bias.abs()
            out.append((z, scale))

    with torch.no_grad():
        init_i, init_j = gather(xs[:, 0], dst_f), gather(xs[:, 0], src_f)
        for t in range(depth):
            x_i, x_j = gather(xs[:, t], dst_f), gather(xs[:, t], src_f)
            parts = [(x_i, eu0[0]), (x_j, eu0[1]), (es[:, t], eu0[2])]
            if att is not None:
                parts.append((att, eu0[3]))
            tail(*product(parts), eu_rest, eu_b)
            ue = es[:, t + 1]
            tail(*product([(x_i, fut0[0]), (ue, fut0[1]), (init_i, fut0[2])]), fut_rest, fut_b)
            tail(*product([(x_j, past0[0]), (ue, past0[1]), (init_j, past0[2])]), past_rest,
                 past_b)
            tail(*product([(agg[:, t], torch.cat(comb0, dim=0))]), comb_rest, comb_b)
        h, scale = product([(es[:, depth], cls_w[0])])
        tail(h, scale, cls_w[1:], cls_b)
    return out


def relu_masks_from_stashes(stashes, att, src, dst, edge_mask, flat_weights, meta, depth):
    """The ReLU masks (z > 0) of :func:`relu_preactivations_from_stashes`:
    float64 stashes and weights give the exact signs for the stashed
    inputs. ``ops/fused_mp_train.py::fused_mp_train_masks`` returns the
    masks the backward kernel itself took, in this order and these shapes;
    ``fused_mp_scores_plain(..., relu_masks=)`` replays either."""
    return [z > 0 for z, _ in relu_preactivations_from_stashes(
        stashes, att, src, dst, edge_mask, flat_weights, meta, depth)]


def fused_mp_scores_plain(x0, e0, att, src, dst, edge_mask, flat_weights,
                          meta, depth, logits=False, carries=False, relu_masks=None):
    """The layer loop the kernel computes, in plain PyTorch. A masked edge
    gathers zero rows (as the TPU kernels' one-hot rows) and is left out
    of both sums; its score is still defined. ``carries=True`` also returns
    the layer inputs and message sums the training forward stashes: x_t
    [B, depth, N, nd] (t < depth), e_t [B, depth + 1, E, ed] (t <= depth)
    and agg_t [B, depth, N, 2M] ([past by destination, future by source]).

    ``relu_masks`` (:func:`relu_masks_from_stashes`, or the backward
    kernel's own from ``fused_mp_train_masks``; off by default) replays
    given ReLU masks instead of the signs of this run's pre-activations, to
    compare gradients under one set of branches (a unit whose
    pre-activation lies within rounding of zero may take either branch in
    two summation orders)."""
    (eu0, eu_rest, eu_b, fut0, fut_rest, fut_b, past0, past_rest, past_b,
     comb0, comb_rest, comb_b, cls_w, cls_b) = _unpack(meta, flat_weights)
    if relu_masks is None:
        relu = torch.relu
    else:
        replay = iter(relu_masks)

        def relu(v):
            return v * next(replay).to(v.dtype)
    b, n, _ = x0.shape
    keep = edge_mask.reshape(-1)
    offs = torch.arange(b, device=x0.device)[:, None] * n
    src_f = (src.long() + offs).reshape(-1)
    dst_f = (dst.long() + offs).reshape(-1)
    mask_f = edge_mask[..., None].to(x0.dtype)

    def gather(x, idx):
        return x.reshape(b * n, -1)[idx].reshape(*src.shape, -1) * mask_f

    def scatter(v, idx):
        out = torch.zeros(b * n, v.shape[-1], dtype=v.dtype, device=v.device)
        out.index_add_(0, idx[keep], v.reshape(-1, v.shape[-1])[keep])
        return out.reshape(b, n, -1)

    x, e = x0, e0
    xs, es, aggs = [], [e0], []
    init_i, init_j = gather(x0, dst_f), gather(x0, src_f)
    for _ in range(depth):
        xs.append(x)
        x_i, x_j = gather(x, dst_f), gather(x, src_f)
        h = x_i @ eu0[0] + x_j @ eu0[1] + e @ eu0[2]
        if att is not None:
            h = h + att @ eu0[3]
        ue = _mlp_tail(h, eu_rest, eu_b, relu)
        f = _mlp_tail(x_i @ fut0[0] + ue @ fut0[1] + init_i @ fut0[2],
                      fut_rest, fut_b, relu)
        p = _mlp_tail(x_j @ past0[0] + ue @ past0[1] + init_j @ past0[2],
                      past_rest, past_b, relu)
        agg_p, agg_f = scatter(p, dst_f), scatter(f, src_f)
        aggs.append(torch.cat([agg_p, agg_f], dim=-1))
        x = _mlp_tail(agg_p @ comb0[0] + agg_f @ comb0[1], comb_rest, comb_b, relu)
        e = ue
        es.append(e)
    h = e
    for i, (w, bias) in enumerate(zip(cls_w, cls_b)):
        h = h @ w + bias
        if i < len(cls_w) - 1:
            h = relu(h)
    out = h[..., 0]
    out = out if logits else torch.sigmoid(out)
    if carries:
        return out, torch.stack(xs, dim=1), torch.stack(es, dim=1), torch.stack(aggs, dim=1)
    return out


# ---------------------------------------------------------------------------
# Hopper kernel
# ---------------------------------------------------------------------------


def mp_arrays(flat_weights, meta):
    """The 29 arrays of the kernel's weight blob (``Params`` order in
    ``csrc/mp_common.cuh``), built from ``flat_weights`` with differentiable
    operations. The x parts of the first layers and the x0 parts of the
    message layers become one [node_dim, PW] node projection."""
    shape = {k: meta[k] for k in ("n_eu", "n_fut", "n_past", "n_comb", "n_cls")}
    if shape != dict(n_eu=2, n_fut=1, n_past=1, n_comb=2, n_cls=4):
        raise ValueError(f"fused MP kernel: unsupported layer counts {shape}")
    (eu0, eu_rest, eu_b, fut0, fut_rest, fut_b, past0, past_rest, past_b,
     comb0, comb_rest, comb_b, cls_w, cls_b) = _unpack(meta, flat_weights)
    w_ea = torch.cat(eu0[2:], dim=0)  # rows of [edge_attr, att_edge_attr?]
    w_p = torch.cat([eu0[0], eu0[1], fut0[0], past0[0], fut0[2], past0[2]], dim=1)
    return [
        w_ea, eu_b[0], eu_rest[0], eu_b[1], eu_rest[1], eu_b[2],
        fut0[1], fut_b[0], fut_rest[0], fut_b[1],
        past0[1], past_b[0], past_rest[0], past_b[1],
        torch.cat(comb0, dim=0), comb_b[0], comb_rest[0], comb_b[1],
        comb_rest[1], comb_b[2],
        w_p,
        cls_w[0], cls_b[0], cls_w[1], cls_b[1], cls_w[2], cls_b[2],
        cls_w[3], cls_b[3],
    ]


def pack_arrays(arrays):
    """One contiguous, detached f32 blob of ``arrays`` and the float offset
    of each; every array starts on a 16-byte boundary (the kernels copy
    weights in 16-byte pieces)."""
    pieces, offs, pos = [], [], 0
    for a in arrays:
        a = a.detach().reshape(-1).float()
        pad = -a.numel() % 4
        pieces += [a, a.new_zeros(pad)]
        offs.append(pos)
        pos += a.numel() + pad
    return torch.cat(pieces), np.array(offs, np.int64)


def pack_mp_weights(flat_weights, meta, node_dim: int, edge_dim: int,
                    with_attention: bool):
    """The kernel's weight blob (a detached copy): one contiguous f32
    tensor of :func:`mp_arrays`, the float offset (a multiple of 4) of each
    of its 29 arrays and the widths (``nd``, ``ed`` and the hidden widths)."""
    arrays = mp_arrays(flat_weights, meta)
    blob, woff = pack_arrays(arrays)
    w_ea, w1, w2, fue, f1, c1w, c2w, l1w, l2w, l3w = (
        arrays[i] for i in (0, 2, 4, 6, 8, 16, 18, 23, 25, 27))
    widths = dict(
        nd=node_dim, ed=edge_dim,
        H1=w1.shape[0], H2=w2.shape[0], M1=f1.shape[0], M=f1.shape[1],
        C1=c1w.shape[0], C2=c2w.shape[0],
        L1=l1w.shape[0], L2=l2w.shape[0], L3=l3w.shape[0],
    )
    return blob, woff, widths


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Finite f32 x rounded to TF32 (10 mantissa bits, half away from zero)
    in integer arithmetic: (bits + 0x1000) & 0xffffe000 on the bit pattern
    (no finite value's int32 pattern overflows the addition)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(w: torch.Tensor) -> torch.Tensor:
    """The TF32 big and small parts of the finite f32 tensor ``w``,
    flattened and concatenated (big first): big = tf32(w), small =
    tf32(w - big), bit for bit what ``csrc/tc_gemm.cuh::split_tf32``
    computes on the card."""
    big = _tf32_rna(w.reshape(-1))
    return torch.cat([big, _tf32_rna(w.reshape(-1) - big)])


def _streams(w: dict, with_att: bool):
    """The products of the kernels' weight streams, in stream order: (mp_arrays
    index, K, N, the array's row length, its first column). The edge
    kernel's (Wea, W1, W2, Fue, F1, Pue, P1); the node kernels' (C0, C1w,
    C2w, the node projection's x columns Wp[:, :QW], its x0 columns)."""
    ea = w["ed"] * (2 if with_att else 1)
    pw, qw = 2 * w["H1"] + 4 * w["M1"], 2 * w["H1"] + 2 * w["M1"]
    edge = ((0, ea, w["H1"]), (2, w["H1"], w["H2"]), (4, w["H2"], w["ed"]),
            (6, w["ed"], w["M1"]), (8, w["M1"], w["M"]), (10, w["ed"], w["M1"]),
            (12, w["M1"], w["M"]))
    node = ((14, 2 * w["M"], w["C1"], w["C1"], 0), (16, w["C1"], w["C2"], w["C2"], 0),
            (18, w["C2"], w["nd"], w["nd"], 0), (20, w["nd"], qw, pw, 0),
            (20, w["nd"], pw - qw, pw, qw))
    return tuple((i, k, n, n, 0) for i, k, n in edge), node


def stream_slices(k: int, n: int, kc: int):
    """The slices of one product's weights W [k, n] in a weight stream
    (``csrc/tc_stream.cuh``): per pass of up to 256 output columns, per
    slice of kc inputs, the (W row, W column) of every element of the
    slice's [rows / 8][kc / 4][8][4] core-matrix layout of W^T (rows: the
    pass's columns rounded up to a multiple of 32), -1 past W. A slice holds
    these as big parts, then as small parts."""
    out = []
    for c0 in range(0, n, 256):
        rows = -(-min(256, n - c0) // 32) * 32
        ng, kg, r, c = np.meshgrid(np.arange(rows // 8), np.arange(kc // 4),
                                   np.arange(8), np.arange(4), indexing="ij")
        col = (c0 + ng * 8 + r).reshape(-1)
        for k0 in range(0, k, kc):
            row = (k0 + kg * 4 + c).reshape(-1)
            bad = (row >= k) | (col >= n)
            out.append((np.where(bad, -1, row), np.where(bad, -1, col)))
    return out


@functools.cache
def _tc_layout(woff: tuple, widths: tuple, with_att: bool, device: torch.device):
    """Blob positions (``len(blob)`` for a zero) and small-part flags of
    every element of :func:`tc_weights`' tensor, and the node stream's
    offset."""
    zero = woff[-1]
    src, small = [], []
    edge, node = _streams(dict(widths), with_att)
    for products, kc in ((edge, _EDGE_KC), (node, _NODE_KC)):
        if products is node:
            node_at = sum(a.size for a in src)
        for i, k, n, ld, col0 in products:
            for row, col in stream_slices(k, n, kc):
                pos = np.where(row >= 0, woff[i] + row * ld + col0 + col, zero)
                src += [pos, pos]
                small += [np.zeros(pos.size, bool), np.ones(pos.size, bool)]
    return (torch.from_numpy(np.concatenate(src)).to(device),
            torch.from_numpy(np.concatenate(small)).to(device), node_at)


def tc_weights(blob: torch.Tensor, woff, widths: dict, with_att: bool):
    """The tensor-core products' weights as ``csrc/fused_mp.cu`` reads them:
    two weight streams (:func:`stream_slices`; the edge kernel's, then the
    node kernels'), each weight split into its TF32 big and small parts once
    per call with :func:`split_tf32`'s rounding. Returns the tensor and the
    float offset of the node stream in it."""
    index, small, node_at = _tc_layout(
        (*(int(o) for o in woff), blob.numel()), tuple(widths.items()), with_att, blob.device)
    x = torch.cat([blob, blob.new_zeros(1)])[index]
    big = _tf32_rna(x)
    return torch.where(small, _tf32_rna(x - big), big), node_at


def _ring_buf(kc, stages, split_rows=0):
    """Floats of a kernel's mbarriers, ring slots (a slice of up to 256
    columns, big and small parts) and two split activation slices of
    split_rows rows (the node kernels'; the edge kernel splits into
    registers)."""
    return _BAR + stages * 2 * 256 * kc + 2 * 2 * split_rows * kc


def fused_mp_plan(b: int, n: int, e: int, widths: dict, with_att: bool,
                  sm_count: int = H100_SMS) -> dict:
    """Launch plan of the forward kernel family for b windows of (n, e) at
    ``widths`` (``pack_mp_weights``' dict): the edge kernel's row tile (64
    rows, wgmma's M), the column shares of the node projections (whole
    256-column passes: enough (node tile, window, share) blocks to fill the
    ``sm_count`` SMs, at most one share per pass), and the shared-memory
    bytes of each kernel, as ``csrc/fused_mp.cu`` lays them out (it refuses
    a plan that differs from its own arithmetic). Raises for a shape outside
    the cover: beyond ``COVER``, a width that is not a multiple of 4, a
    message width the per-node sums cannot lay over a warp's lanes, more
    weight slices than a block's slice table holds, or a kernel over the
    shared memory of a block."""
    w = widths
    if not (b >= 1 and 1 <= n <= COVER[0] and 1 <= e <= COVER[1]):
        raise ValueError(f"fused MP kernel: {b} windows of ({n}, {e}) lie outside "
                         f"its cover (up to {COVER})")
    if any(v % 4 for v in w.values()):
        raise ValueError(f"fused MP kernel: widths must be multiples of 4, got {w}")
    m4 = w["M"] // 4
    lanes = min(32, m4)
    if 32 % lanes or m4 % lanes:
        raise ValueError(f"fused MP kernel: message width {w['M']} does not tile a warp")
    edge, node = _streams(w, with_att)
    slices = sum(-(-n_out // 256) * -(-k // _EDGE_KC) for _, k, n_out, _, _ in edge)
    if slices > _MAX_SLICES:
        raise ValueError(f"fused MP kernel: {slices} weight slices per layer, over {_MAX_SLICES}")
    # column shares: whole 256-column passes of the node projection's x part
    # (node kernel) and of both its parts (x0 projection), as many as fill
    # the SMs with (node tile, window, share) blocks; share 0 has the most
    tiles = b * -(-n // _NODE_T)
    px, p0 = -(-node[3][2] // 256), -(-node[4][2] // 256)
    node_split = min(px, max(1, sm_count // tiles))
    proj_split = min(px + p0, max(1, sm_count // tiles))
    chain = sum(-(-n_out // 256) * -(-k // _NODE_KC) for _, k, n_out, _, _ in node[:3])
    per_pass = -(-w["nd"] // _NODE_KC)
    most = max(chain + per_pass * -(-px // node_split), per_pass * -(-(px + p0) // proj_split))
    if most > _MAX_NODE_SLICES:
        raise ValueError(f"fused MP kernel: {most} weight slices per node block, "
                         f"over {_MAX_NODE_SLICES}")
    ea = w["ed"] * (2 if with_att else 1)
    l_a = max(ea, w["H2"], w["M"]) + _PAD
    l_h = max(w["H1"], w["M1"]) + _PAD
    node_buf = _ring_buf(_NODE_KC, _NODE_STAGES, _NODE_T) + 2 * _MAX_NODE_SLICES
    smem = dict(
        edge=4 * (_ring_buf(_EDGE_KC, _EDGE_STAGES) + 2 * _MAX_SLICES
                  + _EDGE_R * (l_a + l_h + w["ed"] + _PAD + 2)
                  + w["H1"] + w["H2"] + w["ed"] + 2 * (w["M1"] + w["M"])),
        node=4 * (node_buf + _NODE_T * (max(2 * w["M"], w["C2"]) + max(w["C1"], w["nd"])
                                        + 2 * _PAD)),
        proj=4 * (node_buf + _NODE_T * (w["nd"] + _PAD)),
        cls=4 * (2 * _CLS_ROWS * max(w["ed"], w["L1"], w["L2"], w["L3"]) + _CLS_SW),
    )
    over = {k: v for k, v in smem.items() if v > SMEM_LIMIT}
    if over:
        raise ValueError(f"fused MP kernel: shared memory over {SMEM_LIMIT} bytes: {over}")
    return dict(edge_rows=_EDGE_R, node_split=node_split, proj_split=proj_split, smem=smem)


def edge_csr(idx: torch.Tensor, num_nodes: int):
    """Per-window CSR of edges by node for idx [B, E] (-1 = masked edge):
    offsets [B * (N + 1) + 1] and the global edge ids (b * E + e) of each
    node's edges in edge order. Masked edges land in a sentinel row N that
    no node reads. The offsets come from a binary search of the sorted
    keys: no device-to-host copy (``bincount`` would wait for the device
    to size its output)."""
    b, e = idx.shape
    key = torch.where(idx >= 0, idx.long(), num_nodes)
    key = (key + torch.arange(b, device=idx.device)[:, None] * (num_nodes + 1))
    sorted_key, perm = torch.sort(key.reshape(-1), stable=True)
    rows = torch.arange(b * (num_nodes + 1) + 1, device=idx.device)
    off = torch.searchsorted(sorted_key, rows).to(torch.int32)
    return off, perm.to(torch.int32)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _check(name, t, dtype, shape):
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"fused MP kernel: {name} must be {dtype} {tuple(shape)} on cuda, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"fused MP kernel: {name} must be contiguous")


def kernel_inputs(x0, e0, att, src, dst, edge_mask, flat_weights, meta,
                  depth, logits):
    """Check the inputs and stage what every launch of the kernel family
    reads: the weight blob and its offsets, the tensor-core weights' streams
    (:func:`tc_weights`), the widths, ``dims`` (the C entries' int32
    header: the shapes and widths, then the :func:`fused_mp_plan` and the
    node stream's offset), the masked indices (-1 for a masked edge) and
    the destination and source CSRs."""
    b, n, nd = x0.shape
    e, ed = e0.shape[1], e0.shape[2]
    with_att = att is not None
    _check("x0", x0, torch.float32, (b, n, nd))
    _check("e0", e0, torch.float32, (b, e, ed))
    if with_att:
        _check("att", att, torch.float32, (b, e, ed))
    for name, t in (("src", src), ("dst", dst), ("edge_mask", edge_mask)):
        if t.device != x0.device or tuple(t.shape) != (b, e):
            raise ValueError(f"fused MP kernel: {name} must be [{b}, {e}] on {x0.device}")

    blob, woff, w = pack_mp_weights(flat_weights, meta, nd, ed, with_att)
    blob = blob.to(x0.device)
    plan = fused_mp_plan(b, n, e, w, with_att, sm_count(x0.device.index or 0))
    tc, node_at = tc_weights(blob, woff, w, with_att)
    neg = torch.full_like(src, -1, dtype=torch.int32)
    src_m = torch.where(edge_mask, src.to(torch.int32), neg).contiguous()
    dst_m = torch.where(edge_mask, dst.to(torch.int32), neg).contiguous()
    doff, dperm = edge_csr(dst_m, n)
    soff, sperm = edge_csr(src_m, n)
    dims = np.array(
        [b, n, e, nd, ed, int(with_att), depth, int(logits),
         w["H1"], w["H2"], w["M1"], w["M"], w["C1"], w["C2"],
         w["L1"], w["L2"], w["L3"], plan["edge_rows"], plan["node_split"],
         plan["proj_split"], *(plan["smem"][k] for k in ("edge", "node", "proj", "cls")),
         node_at],
        np.int32,
    )
    return dict(blob=blob, woff=woff, tc=tc, widths=w, dims=dims,
                src=src_m, dst=dst_m, doff=doff, dperm=dperm, soff=soff, sperm=sperm)


def host_ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def fused_mp_scores_cuda(x0, e0, att, src, dst, edge_mask, flat_weights, meta,
                         depth, logits=False) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream; scores [B, E]."""
    k = kernel_inputs(x0, e0, att, src, dst, edge_mask, flat_weights, meta,
                      depth, logits)
    b, n, _ = x0.shape
    e = e0.shape[1]
    w = k["widths"]
    pw = 2 * w["H1"] + 4 * w["M1"]
    e_state = e0.clone()
    npb = torch.empty(b, n, pw, dtype=torch.float32, device=x0.device)
    pbuf = torch.empty(b, e, w["M"], dtype=torch.float32, device=x0.device)
    fbuf = torch.empty_like(pbuf)
    out = torch.empty(b, e, dtype=torch.float32, device=x0.device)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    lib = cuda_build.load("fused_mp")
    err = lib.fused_mp_forward(
        host_ptr(k["dims"]), host_ptr(k["woff"]),
        ptr(k["blob"]), ptr(k["tc"]), ptr(x0), ptr(e_state), ptr(att),
        ptr(k["src"]), ptr(k["dst"]), ptr(k["doff"]), ptr(k["dperm"]), ptr(k["soff"]),
        ptr(k["sperm"]), ptr(npb), ptr(pbuf), ptr(fbuf), ptr(out),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"fused MP kernel launch failed: CUDA error {err}")
    fused_mp_scores.launches += 1
    return out


def fused_mp_scores(x0, e0, att, src, dst, edge_mask, flat_weights, meta,
                    depth, logits=False) -> torch.Tensor:
    """Scores [B, E] (sigmoid unless ``logits``) of the depth-``depth``
    message-passing loop and the edge classifier.

    x0 [B, N, node_dim], e0 and att [B, E, edge_dim] (att may be None),
    src/dst [B, E] int, edge_mask [B, E] bool. CUDA tensors go through the
    Hopper kernel (a launch failure raises); CPU tensors through
    :func:`fused_mp_scores_plain`. ``fused_mp_scores.launches`` counts the
    kernel runs."""
    if x0.device.type == "cuda":
        return fused_mp_scores_cuda(
            x0, e0, att, src, dst, edge_mask, flat_weights, meta, depth, logits
        )
    if x0.device.type != "cpu":
        raise ValueError(f"fused MP: unsupported device {x0.device}")
    return fused_mp_scores_plain(
        x0, e0, att, src, dst, edge_mask, flat_weights, meta, depth, logits
    )


fused_mp_scores.launches = 0


# ---------------------------------------------------------------------------
# Model-level entry points
# ---------------------------------------------------------------------------


def _require_noop(model) -> None:
    """The kernel has no kNN GATConv: it serves ``knn_conv_mode='noop'``
    models only (the JAX package's guard, ``pallas_mp.py:751,796``)."""
    if model.knn_conv_mode != "noop":
        raise ValueError("fused MP kernel: knn_conv_mode must be 'noop'")


def fused_scores_from_encodings(model, batch, x_img, pn, rn, lp, rp) -> torch.Tensor:
    """Batched ``forward_from_encodings`` scores of a MultimodalGNN: the
    module computes the pre-message-passing stage, the fused kernel (or its
    plain version on the CPU) the loop and the classifier."""
    _require_noop(model)
    x0, e0, att, _ = model.pre_message_passing(batch, x_img, pn, rn, lp, rp)
    # the message passing always consumes att_edge_attr; use_attention only
    # changes how it is computed
    flat, meta = extract_mp_params(model, True, model.node_dim, model.edge_dim)
    return fused_mp_scores(
        x0, e0, att, batch.edge_src, batch.edge_dst, batch.edge_mask,
        flat, meta, model.depth,
    )


def fused_scores_full(model, batch) -> torch.Tensor:
    """Fused replacement of the batched full MultimodalGNN forward: the
    frozen encoders run per window node, then the kernel."""
    _require_noop(model)
    b, n = batch.pose.shape[:2]
    flat = lambda t: t.reshape(b * n, *t.shape[2:])  # noqa: E731
    xi, pn, rn = model.encode_frozen(flat(batch.img), flat(batch.lidar), flat(batch.radar))
    lp = batch.lidar.sum(dim=(-2, -1)) != 0
    rp = batch.radar.sum(dim=(-2, -1)) != 0
    unflat = lambda t: t.reshape(b, n, -1)  # noqa: E731
    return fused_scores_from_encodings(
        model, batch, unflat(xi), unflat(pn), unflat(rn), lp, rp
    )


def fused_logits_pose(model, batch) -> torch.Tensor:
    """Fused replacement of the batched PoseGNN forward: LOGITS [B, E]."""
    _require_noop(model)
    x0, e0 = model.pre_message_passing(batch)
    flat, meta = extract_mp_params(model, False, model.node_dim, model.edge_dim)
    return fused_mp_scores(
        x0, e0, None, batch.edge_src, batch.edge_dst, batch.edge_mask,
        flat, meta, model.depth, logits=True,
    )
