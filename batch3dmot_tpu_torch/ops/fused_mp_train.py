"""Fused message-passing TRAINING: a forward kernel that stashes the layer
carries and a hand-written backward kernel, both for Hopper, behind a
``torch.autograd.Function`` (counterpart of
``batch3dmot_tpu/ops/pallas_mp_train.py``).

The kernels replace the Pallas training pairs B4/B5 (``_train_fwd_kernel``,
``_train_bwd_kernel``) and B6/B7 (their edge-tiled variants): the
forward is ``csrc/fused_mp.cu::fused_mp_forward_stash`` and the backward
``csrc/fused_mp_train.cu::fused_mp_backward``, whose products run on the
tensor cores at float32 accuracy (3xTF32, ``csrc/tc_gemm.cuh``); their
source notes say what bounds them and how the design answers that. One pair covers every bucket
of ``graph.DEFAULT_BUCKETS``, so the JAX cover logic and its XLA-autodiff
fallback have no counterpart here.

:func:`fused_mp_train_scores` launches the pair for CUDA tensors (or
raises) and differentiates :func:`fused_mp_scores_plain` with autograd for
CPU tensors. :func:`fused_mp_train_masks`, a debug entry beside it, runs the
pair once with the backward's ReLU masks written out (the training path
writes none). The training path's backward skips each window's edge rows
past its live extent (:func:`live_extent_plain`), whose cotangents are
exactly zero; :func:`bwd_tiles` counts the edge tiles it ran. Gradients
reach the ``nn.Linear`` parameters through ``extract_mp_params(...,
trainable=True)``; the stages before the loop (encoders, attention,
attribute encoders) are differentiated by autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from batch3dmot_tpu_torch.models.gnn import PoseGNN
from batch3dmot_tpu_torch.ops import cuda_build
from batch3dmot_tpu_torch.ops.fused_mp import (
    _check,
    extract_mp_params,
    fused_mp_scores_cuda,
    fused_mp_scores_plain,
    host_ptr,
    kernel_inputs,
    mp_arrays,
    pack_arrays,
    ptr,
    relu_masks_from_stashes,
)
from batch3dmot_tpu_torch.utils import profiling

# Arrays of the weight blob (``mp_arrays`` order) whose transposes the
# backward multiplies by, in ``TParams`` order (csrc/fused_mp_train.cu):
# P1, F1, Pue, Fue, W2, W1, Wea, C2w, C1w, C0, Wp, L2w, L1w, L0.
_TRANSPOSED = (12, 8, 10, 6, 4, 2, 0, 18, 16, 14, 20, 25, 23, 21)
# The largest shape the training pair covers: the largest bucket of
# graph.DEFAULT_BUCKETS (the inference kernel's COVER reaches further)
TRAIN_COVER = (1024, 32768)


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The training kernels' library, built and loaded on first use; from
    then on the training loop's counters (``utils.profiling``) clear and
    read its edge-tile counts."""
    lib = cuda_build.load("fused_mp_train")
    profiling.add_device_counter(clear_bwd_tiles, _tile_counts)
    return lib


def _flat_grads(dblob, woff, flat, meta):
    """Gradients of ``flat`` from the gradient of the packed blob: the
    transpose of the (differentiable) packing, by autograd."""
    with torch.enable_grad():
        leaves = [w.detach().requires_grad_() for w in flat]
        arrays = mp_arrays(leaves, meta)
        grads = [dblob[o: o + a.numel()].view(a.shape) for a, o in zip(arrays, woff)]
        return torch.autograd.grad(arrays, leaves, grads)


def train_forward_cuda(x0, e0, att, src, dst, edge_mask, flat, meta, depth,
                       logits=False):
    """Launch the stashing forward on the current stream. Returns the
    scores [B, E], the stashes x_t [B, depth, N, nd], e_t [B, depth + 1, E,
    ed] and agg_t [B, depth, N, 2M], and the staged kernel inputs."""
    if x0.shape[1] > TRAIN_COVER[0] or e0.shape[1] > TRAIN_COVER[1]:
        raise ValueError(f"fused MP training: windows of {tuple(src.shape)} edges and "
                         f"{x0.shape[1]} nodes lie outside its cover (up to {TRAIN_COVER})")
    k = kernel_inputs(x0, e0, att, src, dst, edge_mask, flat, meta, depth, logits)
    b, n, nd = x0.shape
    e, ed = e0.shape[1], e0.shape[2]
    w = k["widths"]
    f32 = dict(dtype=torch.float32, device=x0.device)
    xs = torch.empty(b, depth, n, nd, **f32)
    xs[:, 0] = x0
    es = torch.empty(b, depth + 1, e, ed, **f32)
    es[:, 0] = e0
    agg = torch.empty(b, depth, n, 2 * w["M"], **f32)
    npb = torch.empty(b, n, 2 * w["H1"] + 4 * w["M1"], **f32)
    pbuf = torch.empty(b, e, w["M"], **f32)
    fbuf = torch.empty_like(pbuf)
    out = torch.empty(b, e, **f32)
    err = cuda_build.load("fused_mp").fused_mp_forward_stash(
        host_ptr(k["dims"]), host_ptr(k["woff"]), ptr(k["blob"]), ptr(k["tc"]), ptr(att),
        ptr(k["src"]), ptr(k["dst"]), ptr(k["doff"]), ptr(k["dperm"]),
        ptr(k["soff"]), ptr(k["sperm"]), ptr(npb), ptr(pbuf), ptr(fbuf),
        ptr(xs), ptr(es), ptr(agg), ptr(out), _stream(x0),
    )
    if err != 0:
        raise RuntimeError(f"fused MP training forward failed: CUDA error {err}")
    fused_mp_train_scores.fwd_launches += 1
    return out, xs, es, agg, k


def _mask_views(buf, widths, b, n, e, depth):
    """The backward's mask buffer as boolean views in
    :func:`relu_masks_from_stashes`' order and shapes (per layer h1, h2, f1,
    p1 [B, E, .], c1, c2 [B, N, .]; then the classifier's three [B, E, .]),
    the layout of ``fused_mp_train_mask_bytes``."""
    w = widths
    shapes = [(e, w["H1"]), (e, w["H2"]), (e, w["M1"]), (e, w["M1"]),
              (n, w["C1"]), (n, w["C2"])] * depth
    shapes += [(e, w["L1"]), (e, w["L2"]), (e, w["L3"])]
    total = sum(b * rows * cols for rows, cols in shapes)
    if total != buf.numel():
        raise ValueError(f"fused MP training backward: {buf.numel()} mask bytes, "
                         f"the layout has {total}")
    views, pos = [], 0
    for rows, cols in shapes:
        size = b * rows * cols
        views.append(buf[pos: pos + size].view(torch.bool).view(b, rows, cols))
        pos += size
    return views


def train_backward_cuda(saved, meta, kdims, woff, widths, d_out, masks=False):
    """Launch the backward kernel on the current stream from the forward's
    saved tensors (:class:`_FusedMPTrain`'s ``save_for_backward`` order).
    Returns (dx0, de0, datt, gradients of the flat weights) and, with
    ``masks``, the ReLU masks the kernel took (:func:`_mask_views`)."""
    (xs, es, agg, att, src_m, dst_m, doff, dperm, soff, sperm, blob, *flat) = saved
    b, _, n, nd = xs.shape
    e, ed = es.shape[2], es.shape[3]
    arrays = mp_arrays(flat, meta)
    tblob, toff = pack_arrays([arrays[i].t() for i in _TRANSPOSED])
    lib = _lib()
    n_work = lib.fused_mp_train_workspace(host_ptr(kdims))
    if n_work < 0:
        raise ValueError("fused MP training backward: unsupported widths")
    f32 = dict(dtype=torch.float32, device=xs.device)
    work = torch.empty(n_work, **f32)
    ds = d_out.to(torch.float32).contiguous()
    dx0 = torch.empty(b, n, nd, **f32)
    de0 = torch.empty(b, e, ed, **f32)
    datt = None if att is None else torch.zeros(b, e, ed, **f32)
    dblob = torch.zeros_like(blob)
    mbuf = None
    if masks:
        mbuf = torch.empty(lib.fused_mp_train_mask_bytes(host_ptr(kdims)),
                           dtype=torch.uint8, device=xs.device)
    err = lib.fused_mp_backward(
        host_ptr(kdims), host_ptr(woff), ptr(blob), host_ptr(toff),
        ptr(tblob), ptr(ds), ptr(xs), ptr(es), ptr(agg), ptr(att),
        ptr(src_m), ptr(dst_m), ptr(doff), ptr(dperm), ptr(soff),
        ptr(sperm), ptr(work), ptr(dx0), ptr(de0), ptr(datt), ptr(dblob),
        ptr(mbuf), _stream(xs),
    )
    if err != 0:
        raise RuntimeError(f"fused MP training backward failed: CUDA error {err}")
    fused_mp_train_scores.bwd_launches += 1
    grads = (dx0, de0, datt, *_flat_grads(dblob, woff, flat, meta))
    if not masks:
        return grads
    return grads, _mask_views(mbuf, widths, b, n, e, xs.shape[1])


def live_extent_plain(src, dst, ds) -> torch.Tensor:
    """Each window's live extent [B] (int32), the reference of the backward
    kernel's: 1 + the last edge row with ``src >= 0``, ``dst >= 0`` or a
    non-zero ``ds`` (NaN counts as non-zero), 0 where no row has one.
    ``src`` and ``dst`` [B, E] are the kernels' edge inputs (-1 for a masked
    edge, ``kernel_inputs``), ``ds`` [B, E] the cotangent of the scores.
    Every row past it has an exactly zero cotangent at every layer, so the
    training backward skips those rows (``csrc/fused_mp_train.cu``)."""
    hot = (src >= 0) | (dst >= 0) | (ds != 0)
    rows = torch.arange(1, hot.shape[1] + 1, device=hot.device)
    return (hot * rows).amax(dim=1).to(torch.int32)


def live_extent(src, dst, ds) -> torch.Tensor:
    """:func:`live_extent_plain` of CPU tensors; of CUDA tensors (``src``,
    ``dst`` int32, ``ds`` float32, contiguous [B, E]) the backward's own
    kernel on the current stream."""
    if src.device.type == "cpu":
        return live_extent_plain(src, dst, ds)
    if src.device.type != "cuda":
        raise ValueError(f"live extent: unsupported device {src.device}")
    shape = tuple(src.shape)
    for name, t, dtype in (("src", src, torch.int32), ("dst", dst, torch.int32),
                           ("ds", ds, torch.float32)):
        _check(name, t, dtype, shape)
    live = torch.empty(shape[0], dtype=torch.int32, device=src.device)
    be = np.array(shape, np.int32)
    err = _lib().fused_mp_train_live(
        host_ptr(be), ptr(src), ptr(dst), ptr(ds), ptr(live), _stream(src))
    if err != 0:
        raise RuntimeError(f"live extent kernel failed: CUDA error {err}")
    return live


def _current_stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def bwd_tiles() -> Tuple[int, int]:
    """(tiles run, tiles launched) of the training backward's edge tiles
    (``edge_bwd_kernel``'s blocks over every layer, CUDA-graph replays
    included) since the last :func:`clear_bwd_tiles`, on the current CUDA
    device. Waits for the current stream."""
    out = np.zeros(2, np.int64)
    err = _lib().fused_mp_train_tiles(host_ptr(out), _current_stream())
    if err != 0:
        raise RuntimeError(f"fused MP training: reading the tile counts failed: CUDA error {err}")
    return int(out[0]), int(out[1])


def _tile_counts() -> dict:
    run, launched = bwd_tiles()
    return dict(bwd_tiles_run=run, bwd_tiles=launched) if launched else {}


def clear_bwd_tiles() -> None:
    """Zero :func:`bwd_tiles`' counts in the current stream's order (no
    wait)."""
    err = _lib().fused_mp_train_tiles_clear(_current_stream())
    if err != 0:
        raise RuntimeError(f"fused MP training: clearing the tile counts failed: CUDA error {err}")


class _FusedMPTrain(torch.autograd.Function):
    """Scores [B, E] of the message-passing loop and the edge classifier;
    the forward kernel stashes x_t, e_t and the per-node message sums, the
    backward kernel recomputes each layer from them."""

    @staticmethod
    def forward(ctx, x0, e0, att, src, dst, edge_mask, meta, depth, logits, *flat):
        out, xs, es, agg, k = train_forward_cuda(
            x0, e0, att, src, dst, edge_mask, flat, meta, depth, logits)
        ctx.meta, ctx.kdims, ctx.woff, ctx.widths = meta, k["dims"], k["woff"], k["widths"]
        ctx.save_for_backward(
            xs, es, agg, att, k["src"], k["dst"], k["doff"], k["dperm"],
            k["soff"], k["sperm"], k["blob"], *flat,
        )
        return out

    @staticmethod
    def backward(ctx, d_out):
        dx0, de0, datt, *dflat = train_backward_cuda(
            ctx.saved_tensors, ctx.meta, ctx.kdims, ctx.woff, ctx.widths, d_out)
        return (dx0, de0, datt, None, None, None, None, None, None, *dflat)


def fused_mp_train_masks(x0, e0, att, src, dst, edge_mask, flat, meta, depth,
                         d_out, logits=False):
    """Debug entry: the training pair once, outside autograd, under the
    cotangent ``d_out`` [B, E] of the scores, with the ReLU masks its
    backward took. Returns (scores, stashes (x_t, e_t, agg_t), gradients
    (dx0, de0, datt, then one per flat weight), masks in
    :func:`relu_masks_from_stashes`' order).

    CUDA tensors: the forward kernel, then the backward kernel writing each
    mask from the value its ``> 0`` test reads (the arithmetic is the
    training path's). CPU tensors: autograd of :func:`fused_mp_scores_plain`
    and :func:`relu_masks_from_stashes` on its own stashes, in their dtype."""
    flat = tuple(w.detach() for w in flat)
    if x0.device.type == "cuda":
        with torch.no_grad():
            out, xs, es, agg, k = train_forward_cuda(
                x0, e0, att, src, dst, edge_mask, flat, meta, depth, logits)
            saved = (xs, es, agg, att, k["src"], k["dst"], k["doff"], k["dperm"],
                     k["soff"], k["sperm"], k["blob"], *flat)
            grads, masks = train_backward_cuda(saved, meta, k["dims"], k["woff"],
                                               k["widths"], d_out, masks=True)
        return out, (xs, es, agg), grads, masks
    if x0.device.type != "cpu":
        raise ValueError(f"fused MP training: unsupported device {x0.device}")
    leaves = [None if t is None else t.detach().requires_grad_() for t in (x0, e0, att, *flat)]
    with torch.enable_grad():
        out, xs, es, agg = fused_mp_scores_plain(*leaves[:3], src, dst, edge_mask, leaves[3:],
                                                 meta, depth, logits, carries=True)
        wanted = [t for t in leaves if t is not None]
        got = iter(torch.autograd.grad(out, wanted, d_out, allow_unused=True))
    grads = tuple(None if t is None else next(got) for t in leaves)
    stashes = (xs.detach(), es.detach(), agg.detach())
    masks = relu_masks_from_stashes(stashes, att, src, dst, edge_mask, flat, meta, depth)
    return out.detach(), stashes, grads, masks


def fused_mp_train_scores(x0, e0, att, src, dst, edge_mask, flat, meta, depth,
                          logits=False) -> torch.Tensor:
    """Differentiable scores [B, E] (sigmoid unless ``logits``) of the
    depth-``depth`` message-passing loop and the edge classifier.

    Arguments as :func:`fused_mp_scores`. CUDA tensors go through the
    Hopper kernel pair when a gradient is wanted (a launch failure raises)
    and through the inference kernel otherwise; CPU tensors through
    autograd of :func:`fused_mp_scores_plain`.
    ``fused_mp_train_scores.fwd_launches`` / ``.bwd_launches`` count the
    pair's runs."""
    if x0.device.type == "cuda":
        wants_grad = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x0, e0, att, *flat)
        )
        if not wants_grad:
            return fused_mp_scores_cuda(
                x0, e0, att, src, dst, edge_mask, flat, meta, depth, logits
            )
        return _FusedMPTrain.apply(
            x0, e0, att, src, dst, edge_mask, meta, depth, logits, *flat
        )
    if x0.device.type != "cpu":
        raise ValueError(f"fused MP training: unsupported device {x0.device}")
    return fused_mp_scores_plain(
        x0, e0, att, src, dst, edge_mask, flat, meta, depth, logits
    )


fused_mp_train_scores.fwd_launches = 0
fused_mp_train_scores.bwd_launches = 0


def fused_training_scores(model, batch,
                          encodings: Optional[Tuple] = None) -> torch.Tensor:
    """Differentiable fused scores [B, E] for the GNN trainer: ``PoseGNN``
    gives LOGITS, ``MultimodalGNN`` sigmoid scores.

    ``encodings=(x_img, pn, rn, lidar_present, radar_present)`` are the
    frozen-encoder outputs per window node ([B, N, .]); without them the
    encoders run here (with gradient only when the model's
    ``freeze_encoders`` is False)."""
    if getattr(model, "knn_conv_mode", "noop") != "noop":
        raise ValueError("fused training: knn_conv_mode must be 'noop'")
    if isinstance(model, PoseGNN):
        x0, e0 = model.pre_message_passing(batch)
        att, logits = None, True
    else:
        if encodings is None:
            b, n = batch.pose.shape[:2]
            flat = lambda t: t.reshape(b * n, *t.shape[2:])  # noqa: E731
            xi, pn, rn = model.encode_frozen(
                flat(batch.img), flat(batch.lidar), flat(batch.radar))
            encodings = (
                xi.reshape(b, n, -1), pn.reshape(b, n, -1), rn.reshape(b, n, -1),
                batch.lidar.sum(dim=(-2, -1)) != 0,
                batch.radar.sum(dim=(-2, -1)) != 0,
            )
        x0, e0, att, _ = model.pre_message_passing(batch, *encodings)
        logits = False
    flat_w, meta = extract_mp_params(
        model, att is not None, model.node_dim, model.edge_dim, trainable=True
    )
    return fused_mp_train_scores(
        x0, e0, att, batch.edge_src, batch.edge_dst, batch.edge_mask,
        flat_w, meta, model.depth, logits,
    )
