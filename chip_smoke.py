#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``batch3dmot_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build: every CUDA source of the port from ``batch3dmot_tpu_torch/csrc``
     (one ``nvcc`` per source, started together);
  2. kernels: the inference kernel against its plain PyTorch version on the
     card, on inputs made from a numpy seed, at the shapes the main path
     gives it and beyond (up to the largest bucket, and the device
     pipeline's windows up to (1024, 40960)), compared on valid edges, and
     bit-identical across two runs; then the training pair (the stashing forward and the
     hand-written backward) against autograd of the plain version: scores
     and stashes, and dx0, de0, datt and every weight gradient under a
     random cotangent that is non-zero on every edge, masked ones too; the
     backward run twice must give bit-identical gradients;
  2c. the segment-sum kernel against its plain version at the shapes of the
     knn_conv_mode='active' path (message passing, GAT messages and softmax
     denominators), the largest bucket (D 128 and D 1), int64 ids (as the
     kNN graph gives them), the active device pipeline's windows up to
     (1024, 40960), an all-padding window and empty segments:
     forward, bit-identical across two runs, and its backward against
     autograd of the plain version;
  3. inference path: the ``bench.py`` workload (4 synthetic scenes, 16
     frames, 40 tracks, trainval class mix, window 5, kNN 40) rebuilt from
     the port's modules and driven through ``SceneEncodedScorer.score_scenes``,
     ``predict_scenes``, track assembly and ``evaluate_tracking`` with a
     full-width depth-6 ``MultimodalGNN`` of seeded random weights; its
     scores are held against the plain version; the kernel's launch counter
     must show that the path went through it; then a ``'noop'`` ``PoseGNN``
     through ``make_scorer``/``score_windows`` over the same windows (the
     windows path, ``fused_logits_pose``): one launch per window batch,
     scores held against the plain version window by window;
  3b. training path: the same scenes' encodings (``precompute_scene_encodings``)
     and one epoch of ``GNNTrainer.fit`` of a full-width depth-6
     ``MultimodalGNN`` with the ``configs/clr.yaml`` GNN settings from an
     ``EncodedGraphBatcher``; the training pair's launch counters must
     equal the steps, the frozen encoders must not move, the epoch
     checkpoint must load into a fresh model; on one fixed batch, 3 steps
     through the kernels and 3 through the plain version give the same
     losses, and 10 more steps lower the loss; 3 ``train_step``s on raw
     window batches (crops, points, radar; the frozen encoders inside the
     step) give the losses of the same steps from the encodings;
  3c. active inference: the same workload through ``score_scenes``,
     ``predict_scenes``, tracks and AMOTA with a full-width depth-6
     ``MultimodalGNN(knn_conv_mode='active')``, then an active ``PoseGNN``
     through ``make_scorer``; 18 segment-sum launches per forward; scores
     held against the same path with the plain segment sum, window by
     window, where both picked the same kNN graphs (a window whose graphs
     differ must show a near-tie at the k-th neighbour; they are counted),
     and on every window with the kernel run's kNN graphs replayed in the
     plain run;
  3d. active training: ``GNNTrainer`` steps for ``mm`` from encodings and
     ``pose`` from window batches; 18 launches per step, frozen encoders
     unchanged, 3 steps through the kernel and 3 through the plain version
     agree, 10 more lower the loss;
  3e. device-resident training on the same 48 windows and encodings: one
     epoch of ``fit_device`` (each step a replay of one captured CUDA graph)
     against host ``train_step``s on the same index rows, loss by loss; the
     dedup form against the dense one (the gathered batches bit-identical);
     ``fused_steps=4`` against eager steps, with one host wait per group;
     the ``'noop'`` ``PoseGNN`` through ``fit`` and ``fit_device``; the
     active ``mm`` through ``fit_device`` (18 segment sums per step) against
     eager steps; for each graphed path an epoch of replays alone, traced
     by the profiler, runs each of the port's kernels exactly steps times
     as often as one eager step does, and no wrapper launches anything;
  3f. the device inference pipeline on the same 4 scenes (window 5, kNN
     40, the phase-3 model): every window built on the card against the
     host builder (edge sets equal but at kNN near-ties, counted); averaged
     scores per scene against ``SceneEncodedScorer`` + ``average_scene_edges``
     on the same graphs and against the pipeline with the kernel's plain
     version; grouped against per-scene; one fused launch per scene
     dispatch and one per group; no host sync inside a dispatch;
     ``predict_scene_device`` -> tracks -> AMOTA (its predicted edges
     against phase 3's, every difference at a near-tie of the two paths'
     averages; ``predict_scenes_device`` equal to it); float16 point
     uploads (``point_dtype``) against float32 ones; the active model's
     pipeline (18 segment sums per forward) against the plain segment sum
     with its kNN graphs replayed; scoring from 3b's precomputed encodings
     (float32 and float16 transport) against the raw encode;
  3g. training and checkpoints from disk: the 4 scenes written as ``.b3d``
     stores with their metadata sidecars; the native loader built by g++
     from ``native/graphstore.cc`` (its failure fails the phase, with the
     compiler's text); every window read back through the numpy reader and
     the native fill at its bucket equal to ``to_padded`` of the in-memory
     window; ``make_batcher`` returns a ``StoreGraphBatcher``, whose batches
     equal the in-memory ``GraphBatcher``'s; the ``'noop'`` ``PoseGNN``
     through ``fit`` from it (launches equal the steps, losses those of the
     in-memory epoch) and 3 ``mm`` steps on raw store batches (the losses of
     3b's raw-window steps); ``scene_encodings_cached`` writes each
     ``.enc.npz`` (tables against 3b's), a second pass calls the encoder 0
     times, a truncated cache is reported and re-encoded; the
     ``StreamingEncodedBatcher`` through one epoch of
     ``fit(fused_steps=4)`` with a ``MetricWriter`` (0 encoder calls, one
     replay per step, losses those of eager steps on the same batches, one
     ``metrics.jsonl`` record), then an epoch of replays alone traced as in
     3e; ``fit_device`` over the dedup dataset of the cached tables (3e's
     losses); the epoch checkpoint loaded into a fresh model scores
     bit-identically through B1-B3; ``merge_encoder_params`` grafts the
     phase-3 encoders (in the JAX layout) into a fresh GNN, whose encodings
     are bit-identical. The flax msgpack decoder is tested on the CPU only:
     the smoke imports no JAX, so it cannot write such a file;
  3h. encoder training at full width with the ``configs/clr.yaml`` batch
     sizes (ResNet 32, PointNet 64 at 128 points, RadarNet 256 at 64): (a)
     3 ``fit`` steps on fixed host batches on the card against the same
     steps on the CPU from the same weights (dropout 0, lr 1e-4): losses
     ``rtol=1e-4``, parameters within ``2·lr·steps``, running means within
     that and variances ``rtol=1e-4``; (b) ``fit_device`` over synthetic
     datasets (8,192 uint8 crops; 8,192 four-channel LiDAR clouds padded to
     512; 16,384 radar vectors padded to 256; separable classes; counts
     beyond ``num_points``) for 3 epochs with validation (the loss falls),
     each epoch's ``.pt`` checkpoint read back equal, the device collate's
     invariants on the card; (c) the three epoch checkpoints grafted into a
     ``MultimodalGNN`` through ``merge_encoder_params``, its
     ``encode_frozen`` bit-identical to the trainers' eval paths, one GNN
     step with ``freeze_encoders=False`` moving the encoders and one with
     the default leaving them; then a ``fit_device`` epoch each over its
     validation set with at most one host wait (the epoch-end fetch);
  4. timing: each kernel and its plain version with CUDA events on real
     main-path batches (inference, and the training pair at (256, 4096) x8,
     the device time per call by sub-kernel of the inference forward, the
     stashing forward (also at the epoch's (256, 4096) x2) and the
     backward), each beside its bounds (fp32 and 3xTF32), the train step,
     the paths' edges/s, and device-time profiles; the four training epoch
     forms (``fit``, ``fit_device`` dense and dedup, ``fused_steps=4``):
     wall ms, edges/s, device busy share and Adam's device ms; the segment-sum kernel
     beside its plain version and ``index_add_`` with its device time per
     call, the active paths' edges/s, profile and train step; (4d) the
     device pipeline's wall ms, valid edges/s and device busy share, per
     scene and grouped, beside ``score_scenes``; singles against a group in
     turns at window 5 (above the grouping ceiling) and window 3 (under
     it); and the kernel at its window grids with its bound over valid
     edges and over every slot; (4e) the host ms to assemble one
     (256, 4096) x2 batch by the native fill, the numpy reader and the
     in-memory windows; the ``PoseGNN`` fit epoch from the store batcher
     and from the in-memory one in turns (wall ms, training edges/s,
     device busy share), and each batcher's epoch assembled on the host
     alone and copied to the card alone; the streaming epoch cold (caches deleted) and
     warm beside the ``EncodedGraphBatcher`` epoch, in turns; (4f) per encoder, in
     turns, a ``fit_device`` epoch and a ``fit`` epoch from host batches of the same
     data, the first 2,048 items (RadarNet 4,096) of 3h's (PointNet and RadarNet
     through ``lidar_batches``/``radar_batches`` over ``.npy`` files, ResNet from
     in-memory uint8 batches: the card's machine has no PIL): wall ms and items/s;
     8 steps of each profiled: the device's busy share, kernels per step, Adam's
     device ms, the top device rows and the host events;
  3i. data parallelism (``parallel/``): (a) one NCCL rank in this process
     (``make_mesh(1)``): ``fit_device`` dense and dedup and
     ``fit(fused_steps=4)`` of 3b's model, each step a replay whose
     collectives were captured (none is issued during an epoch of replays),
     against the same runs without a mesh (losses at ``RTOL, ATOL``,
     parameters at ``RTOL`` and the largest of ``ATOL``, one Adam step
     (``lr``) and ten times the spread of two mesh-free runs; the kernels
     launched by the mesh run alone counted); (b) two gloo ranks sharing the card (``python -m
     batch3dmot_tpu_torch.parallel.dryrun 2 --device cuda``: a sharded
     ``mm`` train step in each kNN-conv mode, sharded ``PoseGNN`` and dedup
     ``fit_device`` epochs, grouped pipeline inference, cached-embedding
     scoring and a ResNet ``fit_device`` epoch): every kernel launched on
     each rank, parameters and one-step gradients bit-identical across the
     ranks, losses, trained states, one-step gradients and scores against
     the same paths in this process at ``RTOL, ATOL``; (4g) the
     ``fit_device`` dense epoch with and without ``make_mesh(1)`` in turns.

Prints an ``{"encoders": [...]}`` line (4f's timings and 3h's checks),
the card's name and power limit, a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Exits non-zero, without the last
line, when there is no CUDA device or any phase fails. The AMOTA and AP it
prints come from random or barely trained weights.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import itertools
import json
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

# relative tolerance and absolute floor for kernel vs plain version: both
# are float32; sums run in another order (per-node projections, CSR order)
RTOL, ATOL = 2e-4, 2e-5
# gradients: the JAX package's own gradient tolerance (f32 sums over up to
# 32k edges in another order); atol is relative to max|plain| per tensor.
# A ReLU whose f32 pre-activation lies within rounding of zero takes
# different branches in two summation orders, and the flipped unit's
# cotangent spreads through the layers below it in its window, so at the
# larger shapes some elements of a tensor fall outside that tolerance; such
# a tensor is held as a whole to a relative L2 error of MAX_REL_L2 (a wrong
# or missing term gives O(1)), and its distance, and the f32 plain
# version's, from a float64 run of the plain version are printed
GRAD_RTOL, GRAD_ATOL = 5e-3, 2e-4
MAX_REL_L2 = 1e-2
# kNN graphs of two runs may differ only where the k-th and (k+1)-th
# neighbour distances lie within this relative gap (f32 summation orders)
NEAR_TIE = 1e-4
FP32_PEAK = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores
# H100 SXM TF32 tensor-core FLOP/s; a float32-accurate product runs as three
# TF32 products (3xTF32), so its peak is a third of this
TF32_PEAK = 495e12
HBM_RATE = 3.35e12  # H100 SXM bytes/s
TRAINVAL_CLASS_MIX = (
    ["car"] * 5 + ["pedestrian"] * 3 + ["truck"] * 2
    + ["bus", "bicycle", "motorcycle", "trailer"]
)


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds per call with CUDA events, after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_inputs(rng, windows, n, e, nd, ed, with_att, empty=0):
    """Window batch of random features and edges; window k keeps a random
    number of valid edges, the last ``empty`` windows none."""
    import torch

    x0 = rng.standard_normal((windows, n, nd)).astype(np.float32)
    e0 = rng.standard_normal((windows, e, ed)).astype(np.float32)
    att = rng.standard_normal((windows, e, ed)).astype(np.float32) if with_att else None
    src = rng.integers(0, n, (windows, e)).astype(np.int32)
    dst = rng.integers(0, n, (windows, e)).astype(np.int32)
    n_valid = rng.integers(e // 2, e + 1, windows)
    n_valid[windows - empty:] = 0
    mask = np.arange(e)[None, :] < n_valid[:, None]
    src[~mask] = 0
    dst[~mask] = 0
    return tuple(None if a is None else torch.from_numpy(a).cuda()
                 for a in (x0, e0, att, src, dst, mask))


def mp_work(inputs, widths, depth, all_slots=False):
    """(FLOP, bytes) that one fused MP forward needs on these inputs: the
    per-node-projected formulation over the valid edges and the nodes they
    touch (``all_slots``: over every edge and node slot, padding included,
    as the kernel computes them); each input read once and the scores
    written once."""
    x0, e0, att, src, dst, mask = inputs
    b, n, nd = x0.shape
    ed = e0.shape[-1]
    w = widths
    n_edges = b * e0.shape[1] if all_slots else int(mask.sum())
    touched = b * n if all_slots else touched_nodes(src, dst, mask)
    ea = ed * (2 if att is not None else 1)
    pw, qw = 2 * w["H1"] + 4 * w["M1"], 2 * w["H1"] + 2 * w["M1"]
    edge_layer = 2 * (ea * w["H1"] + w["H1"] * w["H2"] + w["H2"] * ed
                      + 2 * (ed * w["M1"] + w["M1"] * w["M"]))
    edge_layer += 2 * w["M"]  # the two message sums
    node_layer = 2 * (2 * w["M"] * w["C1"] + w["C1"] * w["C2"] + w["C2"] * nd)
    cls = 2 * (ed * w["L1"] + w["L1"] * w["L2"] + w["L2"] * w["L3"] + w["L3"])
    flops = (touched * 2 * nd * pw + depth * (n_edges * edge_layer + touched * node_layer)
             + (depth - 1) * touched * 2 * nd * qw + n_edges * cls)
    nbytes = sum(t.numel() * t.element_size() for t in inputs if t is not None)
    nbytes += b * e0.shape[1] * 4
    return flops, nbytes


def touched_nodes(src, dst, mask):
    """Nodes that valid edges touch, summed over windows."""
    s, d, m = (t.cpu().numpy() for t in (src, dst, mask))
    return sum(len(np.unique(np.concatenate([s[k][m[k]], d[k][m[k]]])))
               for k in range(len(m)))


def build_scenes():
    from batch3dmot_tpu_torch.config import GraphConstructionConfig
    from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
    from batch3dmot_tpu_torch.graphs import build_scene_graphs

    cfg = GraphConstructionConfig(top_knn_nodes=40)
    items = []
    for seed in range(4):
        scene = make_synthetic_scene(
            seed=seed, num_frames=16, num_tracks=40, with_modalities=True,
            modality_dropout=0.2, classes=list(TRAINVAL_CLASS_MIX),
        )
        windows = [w for w in build_scene_graphs(scene, 5, cfg) if w.num_edges > 0]
        items.append((scene, windows))
    return items


def submission_and_amota(items, preds):
    from batch3dmot_tpu_torch.eval.tracking_metrics import (
        evaluate_tracking,
        gt_boxes_from_scene,
    )
    from batch3dmot_tpu_torch.infer.tracks import (
        all_scene_sample_tokens,
        assemble_submission,
        hierarchical_clusters,
        scene_results,
    )

    results, tokens, offset = [], [], 0
    for (scene, _), (pred_edges, _) in zip(items, preds):
        cats = {i: m["category_name"] for i, m in enumerate(scene.metadata)}
        tracks = hierarchical_clusters(pred_edges, cats)
        results.append(scene_results(tracks, scene, track_id_offset=offset))
        offset += len(tracks)
        tokens += all_scene_sample_tokens(scene)
    sub = assemble_submission(results, tokens)
    boxes = [b for v in sub["results"].values() for b in v]
    gt = [b for s, _ in items for b in gt_boxes_from_scene(s)]
    res = evaluate_tracking(gt, boxes, list(sub["results"].keys()))
    return sub, boxes, offset, res


def blob_floats(widths, nd, ed, with_att):
    """Weights of the message-passing loop and the classifier (floats)."""
    w = widths
    h1, h2, m1, m, c1, c2 = (w[k] for k in ("H1", "H2", "M1", "M", "C1", "C2"))
    l1, l2, l3 = w["L1"], w["L2"], w["L3"]
    ea = ed * (2 if with_att else 1)
    return (2 * nd * h1 + ea * h1 + h1 + h1 * h2 + h2 + h2 * ed + ed
            + 2 * (2 * nd * m1 + ed * m1 + m1 + m1 * m + m)
            + 2 * m * c1 + c1 + c1 * c2 + c2 + c2 * nd + nd
            + ed * l1 + l1 + l1 * l2 + l2 + l2 * l3 + l3 + l3 + 1)


def train_work(inputs, widths, depth):
    """(forward FLOP, backward FLOP, forward bytes, backward bytes) of the
    training pair on these inputs, counted term by term as mp_work counts
    the forward: products over the valid edges and the nodes they touch,
    the column sums and the per-node sums. Forward: mp_work's, plus the
    stashes written. Backward: the classifier recomputed and
    back-propagated, per layer the edge side recomputed (ue comes from the
    stash), its cotangent chain and weight products, the per-node sums,
    the combine MLP recomputed and back-propagated, the node projections
    and their transposes; bytes read once and written once."""
    x0, e0, att, src, dst, mask = inputs
    b, n, nd = x0.shape
    e, ed = e0.shape[1], e0.shape[2]
    w = widths
    h1, h2, m1, m, c1, c2 = (w[k] for k in ("H1", "H2", "M1", "M", "C1", "C2"))
    l1, l2, l3 = w["L1"], w["L2"], w["L3"]
    n_e = int(mask.sum())
    n_t = touched_nodes(src, dst, mask)
    ea = ed * (2 if att is not None else 1)
    pw, qw = 2 * h1 + 4 * m1, 2 * h1 + 2 * m1
    fwd_flops, in_bytes = mp_work(inputs, widths, depth)
    cls = 2 * (ed * l1 + l1 * l2 + l2 * l3 + l3)
    cls_bwd = 2 * cls + 2 * (l3 * l2 + l2 * l1 + l1 * ed) + l3 + (l1 + l2 + l3 + 1)
    edge = (2 * (ea * h1 + h1 * h2 + 2 * ed * m1)
            + 2 * (2 * m * m1 + 2 * m1 * ed + ed * h2 + h2 * h1 + h1 * ea)
            + 2 * (2 * m1 * m + 2 * ed * m1 + h2 * ed + h1 * h2 + ea * h1)
            + (2 * m + 2 * m1 + ed + h2 + h1) + (2 * h1 + 2 * m1))
    node = (2 * nd * qw + 2 * (2 * m * c1 + c1 * c2) + 2 * (nd * c2 + c2 * c1 + c1 * 2 * m)
            + 2 * qw * nd + 2 * (c2 * nd + c1 * c2 + 2 * m * c1 + nd * qw) + (nd + c2 + c1))
    once = 2 * nd * pw + 4 * m1 * nd + 4 * nd * m1
    bwd_flops = n_e * cls_bwd + depth * (n_e * edge + n_t * node) + n_t * once
    f = 4
    stash = b * (depth * n * nd + (depth + 1) * e * ed + depth * n * 2 * m) * f
    weights = blob_floats(widths, nd, ed, att is not None) * f
    index = sum(t.numel() * t.element_size() for t in (src, dst, mask))
    att_b = 0 if att is None else att.numel() * f
    fwd_bytes = in_bytes + weights + stash
    bwd_bytes = (b * e * f + stash + att_b + index + weights
                 + b * n * nd * f + b * e * ed * f + att_b + weights)
    return fwd_flops, bwd_flops, fwd_bytes, bwd_bytes


def bound(flops, nbytes, peak=TF32_PEAK / 3):
    """The least ms for this work: the larger of flops over ``peak`` (the
    3xTF32 tensor-core rate the message-passing kernels run at, unless
    given) and bytes over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def kernel_rows(rows, calls, width=40):
    """Device ms per call of each row of a profile over ``calls`` calls."""
    return "; ".join(f"{us / 1e3 / calls:.3f} ms x{count // calls} {key[:width]}"
                     for us, key, count in rows)


def train_grads(model, inputs, ct, depth, logits, fn):
    """Scores and gradients (dx0, de0, datt, every parameter) of ``fn``
    under the cotangent ``ct``."""
    from batch3dmot_tpu_torch.ops.fused_mp import extract_mp_params

    x0, e0, att, src, dst, mask = inputs
    leaves = [None if t is None else t.detach().clone().requires_grad_()
              for t in (x0, e0, att)]
    model.zero_grad(set_to_none=True)
    flat, meta = extract_mp_params(model, att is not None, model.node_dim,
                                   model.edge_dim, trainable=True)
    s = fn(*leaves, src, dst, mask, flat, meta, depth, logits)
    s.backward(ct)
    grads = {k: t.grad for k, t in zip(("dx0", "de0", "datt"), leaves) if t is not None}
    grads.update({k: p.grad.clone() for k, p in model.named_parameters()
                  if p.grad is not None})
    return s.detach(), grads


def compare_grads(got, ref, ref64_fn, what):
    """Holds every gradient tensor at the gradient tolerance (see
    MAX_REL_L2). Returns max |got - ref| and, for the tensors with
    elements outside the tolerance, (name, outside, size, relative L2
    error, RMS of kernel - float64, RMS of f32 plain - float64)."""
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    worst, tied, ref64 = 0.0, [], None
    for k, r in ref.items():
        g = got[k]
        diff = (g - r).abs()
        worst = max(worst, float(diff.max()))
        outside = int((diff > GRAD_ATOL * float(r.abs().max()) + GRAD_RTOL * r.abs()).sum())
        if outside == 0:
            continue
        rel_l2 = float(diff.double().norm() / r.double().norm())
        if ref64 is None:
            ref64 = ref64_fn()
        r64 = ref64[k]

        def rms(a):
            return float(((a.double() - r64) ** 2).mean().sqrt())

        tied.append((k, outside, r.numel(), rel_l2, rms(g), rms(r)))
        assert rel_l2 <= MAX_REL_L2, (what, k, rel_l2)
    return worst, tied


@contextlib.contextmanager
def plain_training():
    """Training scores through the plain version called directly (autograd
    differentiates it), instead of the kernel pair."""
    from batch3dmot_tpu_torch.ops import fused_mp_train as fmt

    kernels = fmt.fused_mp_train_scores
    fmt.fused_mp_train_scores = fmt.fused_mp_scores_plain
    try:
        yield
    finally:
        fmt.fused_mp_train_scores = kernels


def profile_device(run, host_rows=None):
    """Wall ms, device-busy ms and the device rows (ms, name, count) of one
    call of ``run`` under torch.profiler, started ``TRACE_LEAD_S`` into the
    trace (whose first milliseconds' records the profiler can drop). A list
    passed as ``host_rows`` receives the host events' rows (self CPU ms,
    name, count), the largest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from batch3dmot_tpu_torch.ops.cuda_build import TRACE_LEAD_S

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_LEAD_S)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the operator rows repeat their kernels' time,
    # and a record_function's span on the device (Adam.step's) repeats that
    # of the kernels inside it
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA
                   and not getattr(ev, "is_user_annotation", False)),
                  reverse=True)
    if host_rows is not None:
        host_rows.extend(sorted(((ev.self_cpu_time_total / 1e3, ev.key, ev.count)
                                 for ev in prof.key_averages()
                                 if ev.device_type == DeviceType.CPU), reverse=True))
    return wall_ms, sum(r[0] for r in rows) / 1e3, rows


def counters(reset=False):
    """The kernel wrappers' launch counters, set to 0 first when ``reset``."""
    from batch3dmot_tpu_torch.ops.fused_mp import fused_mp_scores
    from batch3dmot_tpu_torch.ops.fused_mp_train import fused_mp_train_scores
    from batch3dmot_tpu_torch.ops.segment_kernel import segment_sum

    table = dict(fused_mp=(fused_mp_scores, "launches"),
                 fwd=(fused_mp_train_scores, "fwd_launches"),
                 bwd=(fused_mp_train_scores, "bwd_launches"),
                 segment_sum=(segment_sum, "launches"))
    if reset:
        for fn, attr in table.values():
            setattr(fn, attr, 0)
    return {k: getattr(fn, attr) for k, (fn, attr) in table.items()}


def record_losses(trainer):
    """A list that receives the loss of every step ``trainer`` runs on the
    device (fit_device, fused_steps) from the rows its groups fetch."""
    losses = []
    accumulate = trainer._accumulate_device_metrics

    def recording(metrics, prefix, rows):
        if prefix == "train":
            losses.extend(float(r[0]) for r in rows)
        accumulate(metrics, prefix, rows)

    trainer._accumulate_device_metrics = recording
    return losses


def record_step_losses(trainer):
    """A list that receives the loss of every host ``train_step`` of
    ``trainer`` (``fit`` without fused steps)."""
    losses = []
    train_step = trainer.train_step

    def recording(batch):
        out = train_step(batch)
        losses.append(float(out[0]))
        return out

    trainer.train_step = recording
    return losses


def count_calls(obj, name):
    """A one-element list counting the calls of ``obj.<name>`` from now on,
    through an instance attribute over the method (``del obj.<name>``
    removes it)."""
    calls = [0]
    method = getattr(obj, name)

    def counting(*args, **kw):
        calls[0] += 1
        return method(*args, **kw)

    setattr(obj, name, counting)
    return calls


def take_slot(graph, k):
    """Window ``k`` of a stacked PaddedGraph."""
    return type(graph)(**{f.name: getattr(graph, f.name)[k] for f in dataclasses.fields(graph)})


def graphs_equal(a, b):
    """Every field of two PaddedGraphs of the same dtype and equal."""
    import torch

    return all(getattr(a, f.name).dtype == getattr(b, f.name).dtype
               and torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def batch_tensors(batch):
    """Every tensor of a (PaddedGraph, encodings) batch."""
    graph, enc = batch
    return [getattr(graph, f.name) for f in dataclasses.fields(graph)] + list(enc)


def max_param_diff(a, b):
    """Largest |difference| between two trainers' model states, and the
    name of the tensor that holds it."""
    return max((float((x - y).abs().max()), k)
               for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()))


def params_close(a, b, rtol, atol):
    """The name of the first tensor of two trainers' model states that
    differs beyond ``rtol``, ``atol`` element-wise, or None."""
    import torch

    return next((k for (k, x), y in zip(a.model.state_dict().items(),
                                        b.model.state_dict().values())
                 if not torch.allclose(x, y, rtol=rtol, atol=atol)), None)


def max_rel_diff(got, want):
    """Largest |got - want| / |want| over two sequences of losses."""
    return float(np.max(np.abs(np.subtract(got, want)) / np.abs(want)))


def count_syncs(run):
    """Times ``run()`` made the host wait for the card, as PyTorch's
    synchronisation debug mode reports them (one warning per wait)."""
    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def segment_inputs(rng, lead, n, e, d, empty=False):
    """data [*lead, E, D], ids [*lead, E] in [0, N - 2] (segment N - 1
    stays empty) and mask on the card; masked edges carry id 0 and data
    1e30, which must reach no sum; ``empty`` masks every edge of the first
    window."""
    import torch

    data = rng.standard_normal((*lead, e, d)).astype(np.float32)
    ids = rng.integers(0, n - 1, (*lead, e)).astype(np.int32)
    mask = rng.random((*lead, e)) < 0.7
    if empty:
        mask.reshape(-1, e)[0] = False
    ids[~mask] = 0
    data[~mask] = 1e30
    return tuple(torch.from_numpy(a).cuda() for a in (data, ids, mask))


def segment_work(data, ids, mask, n):
    """(FLOP, bytes) one masked segment sum needs on these inputs: an add
    per valid element; ids and mask read once, the valid rows of data read
    once, the output written once."""
    d = data.shape[-1]
    valid = int(mask.sum())
    nbytes = (ids.numel() * ids.element_size() + mask.numel() * mask.element_size()
              + valid * d * 4 + mask[..., 0].numel() * n * d * 4)
    return valid * d, nbytes


@contextlib.contextmanager
def plain_segment_sum():
    """The segment-sum dispatcher runs the plain version on the card
    (autograd still takes the dispatcher's backward)."""
    from batch3dmot_tpu_torch.ops import segment_kernel

    kernel = segment_kernel.segment_sum_cuda
    segment_kernel.segment_sum_cuda = segment_kernel.segment_sum_plain
    try:
        yield
    finally:
        segment_kernel.segment_sum_cuda = kernel


@contextlib.contextmanager
def capture_knn(store):
    """Record (x, k, valid, pair_valid, (src, dst, mask)) of every kNN
    graph the models build."""
    from batch3dmot_tpu_torch.models import gnn

    build = gnn.knn_graph_masked

    def record(x, k, valid=None, pair_valid=None, loop=False):
        out = build(x, k, valid=valid, pair_valid=pair_valid, loop=loop)
        store.append((x.detach().clone(), k, valid, pair_valid, out))
        return out

    gnn.knn_graph_masked = record
    try:
        yield
    finally:
        gnn.knn_graph_masked = build


@contextlib.contextmanager
def replay_knn(caps):
    """The models take the recorded kNN graphs ``caps``, in order, instead
    of building their own."""
    from batch3dmot_tpu_torch.models import gnn

    build = gnn.knn_graph_masked
    recorded = iter(caps)
    gnn.knn_graph_masked = lambda *args, **kw: next(recorded)[4]
    try:
        yield
    finally:
        gnn.knn_graph_masked = build


def replayed_err(run, kernel):
    """The plain segment sum's run with the kernel run's kNN graphs
    replayed, held to the kernel run's scores on every window's valid
    edges; returns max |kernel - plain|."""
    import torch

    outs = []
    with replay_knn(kernel[1]), plain_segment_sum():
        run(outs)
    torch.cuda.synchronize()
    assert len(outs) == len(kernel[0])
    worst = 0.0
    for (mask, sk), (_, sp) in zip(kernel[0], outs):
        valid = mask.to(sk.device)
        torch.testing.assert_close(sk[valid], sp[valid], rtol=RTOL, atol=ATOL)
        worst = max(worst, float((sk[valid] - sp[valid]).abs().max()))
    return worst


def active_run(run, plain=False):
    """(per-forward [(edge_mask, scores)], kNN graphs of every conv) of
    ``run(outs)``, through the kernel or the plain segment sum."""
    import torch

    outs, knn = [], []
    with capture_knn(knn), (plain_segment_sum() if plain else contextlib.nullcontext()):
        run(outs)
    torch.cuda.synchronize()
    return outs, knn


def knn_rows(cap, slot):
    """Window ``slot``'s neighbour set per query node: [N, k] sorted source
    ids, -1 for a masked edge."""
    import torch

    x, k, _, _, (src, _, mask) = cap
    n = x.shape[1]
    return torch.where(mask[slot], src[slot], -1).view(n, min(k, n)).sort(-1).values


def compare_active(kernel, plain, convs):
    """Holds the kernel run's scores to the plain run's, window by window,
    where both built the same kNN graphs at every conv; a window whose
    graphs differ must differ first at rows where the k-th and (k+1)-th
    allowed distances of the kernel run's x lie within NEAR_TIE of each
    other (after a flip the window's x legitimately differ). Returns max
    |kernel - plain| over the agreeing windows' valid edges, the number of
    windows and the flips (forward, slot, conv, rows, largest gap, largest
    k-th distance over the window's largest squared norm |x|^2: the f32
    expansion |x_i|^2 + |x_j|^2 - 2 x_i.x_j rounds at about 1e-7 of it)."""
    import torch

    from batch3dmot_tpu_torch.ops.knn import pairwise_sq_dists

    (outs_k, knn_k), (outs_p, knn_p) = kernel, plain
    assert len(outs_k) == len(outs_p) and len(knn_k) == len(knn_p) == convs * len(outs_k)
    worst, windows, flips = 0.0, 0, []
    for f, ((mask, sk), (_, sp)) in enumerate(zip(outs_k, outs_p)):
        for slot in range(mask.shape[0]):
            windows += 1
            caps = list(zip(knn_k[f * convs:(f + 1) * convs], knn_p[f * convs:(f + 1) * convs]))
            rows_k = rows_p = None
            for conv, (ck, cp) in enumerate(caps):
                rows_k, rows_p = knn_rows(ck, slot), knn_rows(cp, slot)
                if not torch.equal(rows_k, rows_p):
                    break
            else:
                valid = mask[slot].to(sk.device)
                a, b = sk[slot][valid], sp[slot][valid]
                torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
                if a.numel():
                    worst = max(worst, float((a - b).abs().max()))
                continue
            x, k, node_valid, pair_valid, _ = caps[conv][0]
            n = x.shape[1]
            assert k < n, "kNN graphs differ though every allowed neighbour is taken"
            allowed = (node_valid[slot][None, :] & node_valid[slot][:, None]
                       & pair_valid[slot] & ~torch.eye(n, dtype=torch.bool, device=x.device))
            d = torch.where(allowed, pairwise_sq_dists(x[slot]), 1e30).sort(-1).values
            rows = (rows_k != rows_p).any(-1).nonzero()[:, 0]
            gaps = ((d[rows, k] - d[rows, k - 1]).abs() / d[rows, k - 1].clamp_min(1e-30))
            assert float(gaps.max()) <= NEAR_TIE, (f, slot, conv, gaps.tolist())
            scale = float((x[slot] ** 2).sum(-1).max())
            flips.append((f, slot, conv, len(rows), float(gaps.max()),
                          float(d[rows, k - 1].max()) / max(scale, 1e-30)))
    return worst, windows, flips


def flip_summary(flips):
    """Windows per conv of the first flip, the largest k-th/(k+1)-th gap
    and the largest k-th distance over |x|^2 among the flips."""
    if not flips:
        return "none"
    per_conv = {}
    for f in flips:
        per_conv[f[2]] = per_conv.get(f[2], 0) + 1
    return (", ".join(f"{v} first at conv {c}" for c, v in sorted(per_conv.items()))
            + f"; largest gap {max(f[4] for f in flips):.1e}, rows {sum(f[3] for f in flips)}"
            + f", d_k/|x|^2 up to {max(f[5] for f in flips):.1e}")


def knn_gaps(scene, start, window_len, k):
    """Per node of a window, the relative gap between its k-th and (k+1)-th
    candidate distances in the host builder's float64 arithmetic (inf where
    the node has at most k candidates): a float32 build may take either side
    of a gap within its rounding."""
    from batch3dmot_tpu_torch import geometry as geo
    from batch3dmot_tpu_torch.graphs.build import _normalized

    idx = scene.window_indices(start, window_len)
    t, c = scene.frame_idx[idx], scene.class_id[idx]
    xy, yaw, vel = scene.center_g[idx], scene.yaw_g[idx], scene.vel_g[idx]
    cand = (t[None, :] < t[:, None]) & (c[None, :] == c[:, None])
    comb = (0.5 * _normalized(geo.center_distance_xy(xy[:, None], xy[None]), cand)
            + 0.25 * _normalized(np.abs(geo.angle_diff(yaw[:, None], yaw[None])), cand)
            + 0.25 * _normalized(np.abs(geo.velocity_l2(vel[:, None], vel[None])), cand))
    d = np.sort(np.where(cand, comb, np.inf), axis=1)
    if d.shape[1] <= k:
        return np.full(len(idx), np.inf)
    with np.errstate(invalid="ignore"):
        gap = (d[:, k] - d[:, k - 1]) / np.maximum(d[:, k - 1], 1e-30)
    return np.where(np.isfinite(d[:, k]), gap, np.inf)


def compare_builds(scene, host, dev, window_len, k):
    """Holds device-built windows to the host builder's, window by window:
    the same nodes and pose features; per destination node the same
    labelled sources with the same attributes, except at a node whose k-th
    and (k+1)-th candidates lie within NEAR_TIE (f32 against f64). Returns
    (windows with such a flip, max |pose or attribute difference|)."""
    flips, worst = 0, 0.0
    assert len(host) == len(dev), (len(host), len(dev))
    for start, (a, b) in enumerate(zip(host, dev)):
        np.testing.assert_array_equal(a.det_index, b.det_index)
        np.testing.assert_allclose(b.pose, a.pose, rtol=1e-5, atol=1e-5)
        worst = max(worst, float(np.abs(a.pose - b.pose).max(initial=0.0)))
        rows = {}
        for w, side in ((a, 0), (b, 1)):
            for s_, d_, lab, attr in zip(w.edge_src, w.edge_dst, w.edge_label, w.edge_attr):
                rows.setdefault(int(d_), ({}, {}))[side][int(s_)] = (float(lab), attr)
        gaps = None
        flipped = False
        for d_, (ha, hb) in rows.items():
            if ha.keys() != hb.keys():
                if gaps is None:
                    gaps = knn_gaps(scene, start, window_len, k)
                assert gaps[d_] <= NEAR_TIE, (start, d_, gaps[d_])
                flipped = True
            for s_ in ha.keys() & hb.keys():
                assert ha[s_][0] == hb[s_][0], (start, d_, s_)
                np.testing.assert_allclose(hb[s_][1], ha[s_][1], rtol=1e-5, atol=1e-5)
                worst = max(worst, float(np.abs(hb[s_][1] - ha[s_][1]).max()))
        flips += flipped
    return flips, worst


@contextlib.contextmanager
def grouping_forced():
    """The device pipeline groups scenes whatever their work (its density
    routing sends scenes that fill the card one by one)."""
    from batch3dmot_tpu_torch.infer import device_pipeline

    ceiling = device_pipeline._GROUP_WORK_CEILING
    device_pipeline._GROUP_WORK_CEILING = float("inf")
    try:
        yield
    finally:
        device_pipeline._GROUP_WORK_CEILING = ceiling


def rounding_flips(preds_a, preds_b, scenes):
    """Edges predicted by only one of two roundings, per scene, of nearly
    equal averages, and how many of them the averages' differences cannot
    explain. An edge kept in one and dropped in the other won its node's
    out- or in-edge in one rounding only, or cleared its class threshold
    in one only; either needs its mean within twice the averages' largest
    difference of a rival's sharing its source or destination, or within
    that difference of the threshold."""
    from batch3dmot_tpu_torch.config import (
        DEFAULT_EDGE_SCORE_THRESHOLDS,
        TRACKING_CLASS_NAMES,
    )

    flips = unexplained = 0
    for (pa, aa), (pb, ab), scene in zip(preds_a, preds_b, scenes):
        assert aa.keys() == ab.keys()
        noise = max(abs(aa[e] - ab[e]) for e in aa)
        by_node = {}
        for e in aa:
            by_node.setdefault(("out", e[0]), []).append(e)
            by_node.setdefault(("in", e[1]), []).append(e)
        for e in {e for e, _ in pa} ^ {e for e, _ in pb}:
            flips += 1
            thr = DEFAULT_EDGE_SCORE_THRESHOLDS[TRACKING_CLASS_NAMES[int(scene.class_id[e[0]])]]
            rivals = by_node[("out", e[0])] + by_node[("in", e[1])]
            explained = abs(aa[e] - thr) <= noise or any(
                r != e and abs(aa[r] - aa[e]) <= 2 * noise for r in rivals)
            unexplained += not explained
    return flips, unexplained


def max_avg_diff(got, want, rtol=RTOL, atol=ATOL):
    """Holds two {(src, dst): mean} dicts to the same keys and each mean
    within rtol |want| + atol; returns the largest difference."""
    assert got.keys() == want.keys() and want, (len(got), len(want))
    worst = 0.0
    for key, v in want.items():
        diff = abs(got[key] - v)
        assert diff <= rtol * abs(v) + atol, (key, got[key], v)
        worst = max(worst, diff)
    return worst


# ---- encoder training (phases 3h and 4f) ----------------------------------

ENCODERS = ("resnet", "pointnet", "radarnet")
# synthetic encoder datasets: items per encoder and per validation set
ENC_ITEMS = {"resnet": 8192, "pointnet": 8192, "radarnet": 16384}
ENC_VAL_ITEMS = 1024
# 4f times both forms on the first items of each dataset (items/s does not
# depend on the count; the host loaders take ~1.5 ms per cloud on the
# card's machine)
ENC_TIME_ITEMS = {"resnet": 2048, "pointnet": 2048, "radarnet": 4096}
ENC_PROFILE_STEPS = 8
# the channels of a LiDAR annotation cloud as the JAX package's
# preprocess_lidar_annotations writes it: x, y, z, intensity (its
# data/modality.py::load_lidar_bin keeps 4 of the 5 stored rows)
LIDAR_CHANNELS = 4
# radar annotation clouds hold 18 rows; the loaders take [0, 1, 8, 9]
RADAR_ROWS = 18
# 3h (a), the card against the CPU: Adam turns float32 noise into whole
# steps of about lr (a bias right before a batch norm has an analytically
# zero gradient in train mode; PointNet's T-Net gets its first gradients,
# at noise level, only once its zero-initialised fc3 has moved; cuDNN's
# noise differs from the CPU's), and those steps move the next steps'
# activations. The comparison runs at a learning rate where three steps
# stay within the loss tolerance, and holds the running statistics after
# the first step, whose forward ran on the same weights
ENC_CMP_LR = 1e-4
ENC_CMP_STEPS = 3


def encoder_configs():
    """configs/clr.yaml's encoder settings: (config, num_points) per
    encoder (ResNet batch 32, PointNet 64 at 128 points, RadarNet 256 at 64
    points)."""
    from batch3dmot_tpu_torch.config import PointNetConfig, RadarNetConfig, ResNetConfig

    return {"resnet": (ResNetConfig(), None),
            "pointnet": (PointNetConfig(), PointNetConfig().num_points),
            "radarnet": (RadarNetConfig(), RadarNetConfig().num_points)}


def encoder_datasets(rng, items, num_lidar=128, num_radar=64):
    """Synthetic stacked datasets in the layout of ``data/preprocess.
    materialize_*_dataset``: smooth uint8 crops (random low-frequency
    sinusoids per channel) with labels; LiDAR clouds [N, 4, 4 x num_lidar]
    and radar 4-vectors [N, 4, 4 x num_radar], zero beyond counts drawn
    from [16, Kcap] and [2, Kcap] (many longer than num_points), with
    separable classes: a LiDAR cloud of class k spreads (k + 1) / 7 as far
    along y as along x and 0.1 + 0.1 k along z; a radar point of class k
    moves at (k - 3) / 2 along x and (3 - k) / 4 along y."""
    out = {}
    n = items["resnet"]
    grid = np.arange(32, dtype=np.float32)
    f = rng.uniform(0.0, 0.4, (n, 2, 3)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, (n, 1, 1, 3)).astype(np.float32)
    wave = np.sin(grid[None, :, None, None] * f[:, None, None, 0]
                  + grid[None, None, :, None] * f[:, None, None, 1] + phase)
    amp = rng.uniform(40, 120, (n, 1, 1, 3))
    out["resnet"] = (np.clip(128 + amp * wave, 0, 255).astype(np.uint8),
                     rng.integers(0, 7, n).astype(np.int32))

    n, kcap = items["pointnet"], 4 * num_lidar
    labels = rng.integers(0, 7, n).astype(np.int32)
    counts = rng.integers(16, kcap + 1, n).astype(np.int32)
    spread = np.stack([np.ones(n), (labels + 1) / 7, 0.1 + 0.1 * labels, np.full(n, 0.5)], 1)
    clouds = rng.normal(size=(n, LIDAR_CHANNELS, kcap)).astype(np.float32)
    clouds *= spread[:, :, None].astype(np.float32)
    clouds *= (np.arange(kcap) < counts[:, None])[:, None, :]
    out["pointnet"] = (clouds, counts, labels)

    n, kcap = items["radarnet"], 4 * num_radar
    labels = rng.integers(0, 7, n).astype(np.int32)
    counts = rng.integers(2, kcap + 1, n).astype(np.int32)
    vecs = rng.normal(0, 0.3, (n, 4, kcap)).astype(np.float32)
    vecs[:, 2] += ((labels - 3) / 2)[:, None]
    vecs[:, 3] += ((3 - labels) / 4)[:, None]
    vecs *= (np.arange(kcap) < counts[:, None])[:, None, :]
    out["radarnet"] = (vecs, counts, labels)
    return out


def encoder_trainer(name, cfg, device=None, dropout=None):
    """The encoder's trainer through its make_* entry point; ``dropout``
    sets the classifiers' rate (None keeps 0.3)."""
    from batch3dmot_tpu_torch.train import encoders as enc_train

    make = {"resnet": enc_train.make_resnet_trainer,
            "pointnet": enc_train.make_pointnet_trainer,
            "radarnet": enc_train.make_radarnet_trainer}[name]
    trainer = make(cfg, device=device)
    if dropout is not None and name != "resnet":
        trainer.model.dropout = dropout
    return trainer


def encoder_transform(name, num_points):
    from batch3dmot_tpu_torch.train import encoders as enc_train

    if name == "resnet":
        return enc_train.image_transform()
    if name == "pointnet":
        return enc_train.lidar_transform(num_points=num_points)
    return enc_train.radar_transform(num_points=num_points)


def fixed_host_batches(name, data, num_points, bsz, count):
    """``count`` fixed host batches of the dataset's first rows, in the
    model's input layout: crops / 255, the first num_points columns of each
    cloud (LiDAR: its xyz rows)."""
    out = []
    for i in range(count):
        rows = slice(i * bsz, (i + 1) * bsz)
        if name == "resnet":
            out.append((data[0][rows].astype(np.float32) / 255.0, data[1][rows]))
        else:
            x = data[0][rows, : 3 if name == "pointnet" else 4, :num_points]
            out.append((np.ascontiguousarray(x.transpose(0, 2, 1)), data[2][rows]))
    return out


def stats_close(got, want, where=""):
    """Running statistics of two JAX-layout trees at rtol 1e-4 (atol 1e-6);
    returns the share of that tolerance used (at most 1)."""
    if isinstance(want, dict):
        return max(stats_close(got[k], want[k], f"{where}/{k}") for k in want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=where)
    return tolerance_used(got, want)


def tolerance_used(a, b):
    """Largest |a - b| / (1e-6 + 1e-4 |b|) over two trees: at most 1 where
    they agree to rtol 1e-4, atol 1e-6."""
    if isinstance(a, dict):
        return max(tolerance_used(a[k], b[k]) for k in a)
    return float(np.max(np.abs(a - b) / (1e-6 + 1e-4 * np.abs(b))))


def tree_max_diff(a, b):
    if isinstance(a, dict):
        return max(tree_max_diff(a[k], b[k]) for k in a)
    return float(np.max(np.abs(a - b)))


def collate_invariants(trainer, data, num_points, rows=256):
    """The device collate on the card, on a radar dataset's first rows:
    every taken column is one of the cloud's valid columns, the columns of
    a cloud longer than num_points are distinct, zeros beyond the count.
    Returns (rows checked, rows longer than num_points)."""
    import torch

    from batch3dmot_tpu_torch.train.encoders import _collate

    pts = torch.from_numpy(data[0][:rows]).to(trainer.device)
    counts = torch.from_numpy(data[1][:rows]).to(trainer.device)
    out = _collate(trainer.generator, pts, counts, num_points).cpu().numpy()
    pts, counts = pts.cpu().numpy(), counts.cpu().numpy()
    longer = 0
    for i, c in enumerate(counts):
        m = min(int(c), num_points)
        valid = {tuple(v) for v in pts[i, :, :c].T.tolist()}
        taken = [tuple(v) for v in out[i, :, :m].T.tolist()]
        assert set(taken) <= valid and len(set(taken)) == m, (i, c)
        assert not out[i, :, m:].any(), (i, c)
        longer += int(c > num_points)
    assert longer > 0
    return rows, longer


def write_npy_clouds(name, data, npy_dir):
    """The dataset's clouds as per-annotation .npy files and entries, as the
    JAX package's preprocess writes them (LiDAR [4, count]; radar
    [18, count] with the 4-vector in rows 0, 1, 8, 9)."""
    entries = []
    key = "num_lidar_pts" if name == "pointnet" else "num_radar_pts"
    cats = ("vehicle.car", "vehicle.truck", "vehicle.bus.rigid", "vehicle.trailer",
            "human.pedestrian.adult", "vehicle.motorcycle", "vehicle.bicycle")
    for i, (c, label) in enumerate(zip(data[1], data[2])):
        if name == "pointnet":
            arr = data[0][i, :, :c]
        else:
            arr = np.zeros((RADAR_ROWS, c), np.float32)
            arr[[0, 1, 8, 9]] = data[0][i, :, :c]
        tok = f"{name}{i:06d}"
        np.save(f"{npy_dir}/{tok}.npy", arr)
        entries.append({"sample_annotation_token": tok, "category_name": cats[label],
                        key: int(c), "ann_ego_radius": 10.0})
    return entries


def train_encoders(clr, all_windows):
    """Phase 3h: the three encoders at full width with the configs/clr.yaml
    batch sizes: (a) 3 fit steps on the card against the same steps on the
    CPU; (b) fit_device over synthetic datasets for 3 epochs with
    validation, the epoch checkpoints read back, the device collate's
    invariants; (c) the checkpoints grafted into a MultimodalGNN, one GNN
    step with trainable encoders and one with frozen ones; one more
    fit_device epoch each (over the validation set) counted for host waits.
    Returns what 4f times."""
    import torch

    from batch3dmot_tpu_torch.config import GNNConfig
    from batch3dmot_tpu_torch.models import init_params_, make_model
    from batch3dmot_tpu_torch.train.data import GraphBatcher
    from batch3dmot_tpu_torch.train.trainer import GNNTrainer
    from batch3dmot_tpu_torch.utils.checkpoint import load_checkpoint, merge_encoder_params

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    enc_cfgs = encoder_configs()
    rng = np.random.default_rng(21)
    enc_data = encoder_datasets(rng, ENC_ITEMS)
    enc_val = encoder_datasets(rng, {k: ENC_VAL_ITEMS for k in ENCODERS})
    enc_report = {name: {} for name in ENCODERS}
    for name in ENCODERS:
        cfg, num_points = enc_cfgs[name]
        cmp_cfg = dataclasses.replace(cfg, lr=ENC_CMP_LR)
        batches = fixed_host_batches(name, enc_data[name], num_points, cfg.batch_size,
                                     ENC_CMP_STEPS)
        t_card = encoder_trainer(name, cmp_cfg, dropout=0.0)
        t_cpu = encoder_trainer(name, cmp_cfg, device="cpu", dropout=0.0)
        assert tree_max_diff(t_card.variables, t_cpu.variables) == 0.0
        l_card, l_cpu = [], []
        for step, b in enumerate(batches):
            for t, losses in ((t_card, l_card), (t_cpu, l_cpu)):
                (h,) = t.fit(lambda: iter([b]), epochs=1, verbose=False)
                losses.append(h["train/loss"])
            if step == 0:
                # the first step's forward ran on the same weights
                stats_1 = stats_close(t_card.variables["batch_stats"],
                                      t_cpu.variables["batch_stats"])
        assert np.all(np.isfinite(l_card)), (name, l_card)
        np.testing.assert_allclose(l_card, l_cpu, rtol=1e-4)
        p_bound = 2 * ENC_CMP_LR * ENC_CMP_STEPS + 1e-6
        v_card, v_cpu = t_card.variables, t_cpu.variables
        p_diff = tree_max_diff(v_card["params"], v_cpu["params"])
        assert p_diff <= p_bound, (name, p_diff, p_bound)
        stats_3 = tolerance_used(v_card["batch_stats"], v_cpu["batch_stats"])
        enc_report[name]["card_vs_cpu"] = dict(
            losses=l_card, cpu_losses=l_cpu, max_rel_loss=max_rel_diff(l_card, l_cpu),
            max_param_diff=p_diff, param_bound=p_bound, stats_tolerance_used_step1=stats_1,
            stats_tolerance_used_step3=stats_3)
        log(f"encoder {name} card vs CPU: 3 fit steps of batch {cfg.batch_size}"
            + (f" at {num_points} points" if num_points else "") + f" (lr {ENC_CMP_LR}, "
            f"dropout 0): losses {[f'{v:.6f}' for v in l_card]} vs "
            f"{[f'{v:.6f}' for v in l_cpu]} (max rel {max_rel_diff(l_card, l_cpu):.2e}); "
            f"parameters within {p_diff:.2e} (bound {p_bound:.1e}); running statistics after "
            f"the first step use {stats_1:.3f} of rtol 1e-4 + atol 1e-6 (after 3 steps "
            f"{stats_3:.3f}, not held)")
        del t_card, t_cpu

    enc_tmp = tempfile.TemporaryDirectory()
    trained, ckpts = {}, {}
    for name in ENCODERS:
        cfg, num_points = enc_cfgs[name]
        t = encoder_trainer(name, cfg)
        transform = encoder_transform(name, num_points)
        t0 = time.perf_counter()
        hist = t.fit_device(enc_data[name], transform=transform, val_dataset=enc_val[name],
                            epochs=3, verbose=False, log_dir=enc_tmp.name, prefix=name)
        fit_s = time.perf_counter() - t0
        losses = [h["train/loss"] for h in hist]
        assert losses[-1] < losses[0], (name, losses)
        assert all(np.isfinite(h["val/loss"]) for h in hist), hist
        (ckpts[name],) = Path(enc_tmp.name).glob(f"{name}_epoch2_loss*.pt")
        saved = load_checkpoint(str(ckpts[name]))
        for (k, v), w in zip(t.model.state_dict().items(), saved.values(), strict=True):
            assert torch.equal(v.cpu(), w), (name, k)
        trained[name] = t
        steps = len(enc_data[name][0]) // cfg.batch_size
        metric = "mse" if name == "resnet" else "accuracy"
        enc_report[name].update(fit_device=dict(
            items=len(enc_data[name][0]), steps_per_epoch=steps, epochs=3, seconds=fit_s,
            train_loss=losses, val_loss=[h["val/loss"] for h in hist],
            **{f"val_{metric}": [h[f"val/{metric}"] for h in hist]}))
        log(f"encoder {name} fit_device: {len(enc_data[name][0])} items, 3 epochs of {steps} "
            f"steps with validation ({ENC_VAL_ITEMS} items) in {fit_s:.2f} s; train loss "
            + " -> ".join(f"{v:.4f}" for v in losses) + f"; val {metric} "
            + " -> ".join(f"{h[f'val/{metric}']:.4f}" for h in hist)
            + f"; checkpoint {ckpts[name].name} reads back equal")
    rows, longer = collate_invariants(trained["radarnet"], enc_data["radarnet"],
                                      enc_cfgs["radarnet"][1])
    log(f"device collate on the card: {rows} radar rows ({longer} longer than "
        f"{enc_cfgs['radarnet'][1]} points): taken columns distinct and valid, zeros beyond "
        "the count")

    # (c) the three trained encoders grafted from their .pt checkpoints; the
    # GNN's encodings bit-identical to the trainers' models' eval paths on
    # the same rows; one GNN step with trainable encoders moves them, one
    # with the default frozen ones does not
    graft = init_params_(make_model("mm"), torch.Generator().manual_seed(5)).to(dev)
    merge_encoder_params(graft, **{n: str(p) for n, p in ckpts.items()})
    rows = slice(0, 512)
    with torch.inference_mode():
        img = torch.from_numpy(enc_data["resnet"][0][rows]).to(dev)
        pts, _ = encoder_transform("pointnet", 128)(
            torch.Generator(device=dev).manual_seed(0),
            tuple(torch.from_numpy(a[rows]).to(dev) for a in enc_data["pointnet"]), False)
        vec, _ = encoder_transform("radarnet", 64)(
            torch.Generator(device=dev).manual_seed(0),
            tuple(torch.from_numpy(a[rows]).to(dev) for a in enc_data["radarnet"]), False)
        got = graft.encode_frozen(img, pts, vec)
        want = (trained["resnet"].model.encode(img), trained["pointnet"].model.feat_256(pts),
                trained["radarnet"].model.feat_256(vec))
    for g, w, n in zip(got, want, ENCODERS, strict=True):
        assert torch.equal(g, w), n
    raw_b = next(GraphBatcher(all_windows, 2, seed=3, uniform=True).epoch())
    graft_sd = {k: v.clone() for k, v in graft.state_dict().items()}
    moved = {}
    for freeze in (False, True):
        t_g = GNNTrainer(make_model("mm", freeze_encoders=freeze), GNNConfig(**clr),
                         init_state_dict=graft_sd)
        loss, _ = t_g.train_step(raw_b)
        assert np.isfinite(float(loss))
        after = t_g.model.state_dict()
        moved[freeze] = sorted({k.split(".")[0] for k, v in after.items()
                                if k.split(".")[0] in ENCODERS and not torch.equal(v, graft_sd[k])})
        del t_g
    assert moved[False] == sorted(ENCODERS) and moved[True] == [], moved
    syncs = {}
    for name in ENCODERS:
        cfg, num_points = enc_cfgs[name]
        syncs[name] = count_syncs(lambda: trained[name].fit_device(
            enc_val[name], transform=encoder_transform(name, num_points), epochs=1,
            verbose=False))
        assert syncs[name] <= 1, (name, syncs)
        enc_report[name]["host_waits_per_epoch"] = syncs[name]
    phase_3h_s = time.perf_counter() - t_phase
    log(f"grafting: the three trained encoders from their .pt checkpoints into a MultimodalGNN "
        f"through merge_encoder_params: encode_frozen bit-identical to the trainers' eval "
        f"paths on {rows.stop} rows; one GNN step (raw window batch) with freeze_encoders=False "
        f"moves {moved[False]}, the default moves none; host waits per fit_device epoch "
        f"({ENC_VAL_ITEMS} items) {syncs}; phase 3h {phase_3h_s:.1f} s")

    return dict(cfgs=enc_cfgs, data=enc_data, report=enc_report, trained=trained,
                tmp=enc_tmp)


def time_encoders(card, enc):
    """Phase 4f: per encoder, in turns device/host/host/device, a fit_device
    epoch over the first ENC_TIME_ITEMS items of the 3h dataset (wall ms of
    the epoch, items/s) and a fit epoch from host batches of the same items
    (PointNet and RadarNet through lidar_batches / radar_batches over .npy
    files, ResNet from in-memory uint8 batches: the card's machine has no
    PIL to decode crops); then ENC_PROFILE_STEPS steps of each form under
    the profiler (device busy share, kernels per step, top device rows, and
    the host events of the fit_device steps by self time). Returns the rows
    of the encoders line."""
    from batch3dmot_tpu_torch.data.preprocess import lidar_batches, radar_batches

    enc_cfgs, enc_data, enc_report, trained = enc["cfgs"], enc["data"], enc["report"], enc["trained"]
    t_phase = time.perf_counter()
    npy_tmp = tempfile.TemporaryDirectory()
    enc_timing = []
    for name in ENCODERS:
        cfg, num_points = enc_cfgs[name]
        t = trained[name]
        data = tuple(a[:ENC_TIME_ITEMS[name]] for a in enc_data[name])
        bsz = cfg.batch_size
        n_items = (len(data[0]) // bsz) * bsz
        transform = encoder_transform(name, num_points)
        if name == "resnet":
            perm = np.random.default_rng(0)

            def host_epoch(imgs=data[0], labels=data[1]):
                order = perm.permutation(len(imgs))
                return ((imgs[order[i:i + bsz]], labels[order[i:i + bsz]])
                        for i in range(0, n_items, bsz))
        else:
            t0 = time.perf_counter()
            entries = write_npy_clouds(name, data, npy_tmp.name)
            write_s = time.perf_counter() - t0
            loader_rng = np.random.default_rng(0)
            if name == "pointnet":
                host_epoch = lambda e=entries: lidar_batches(  # noqa: E731
                    npy_tmp.name, e, bsz, num_points=num_points, augment=True, rng=loader_rng)
            else:
                host_epoch = lambda e=entries: radar_batches(  # noqa: E731
                    npy_tmp.name, e, bsz, num_points=num_points, rng=loader_rng)
        dev_run = lambda: t.fit_device(data, transform=transform, epochs=1,  # noqa: E731
                                       verbose=False)
        host_run = lambda: t.fit(host_epoch, epochs=1, verbose=False)  # noqa: E731
        turns = [run()[0]["epoch_time_s"] * 1e3 for run in (dev_run, host_run, host_run, dev_run)]
        dev_ms, host_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        # the profiles cover ENC_PROFILE_STEPS steps of each form (the
        # profiler's own cost grows with the events it records)
        k_items = ENC_PROFILE_STEPS * bsz
        host_rows = []
        prof_dev = profile_device(lambda: t.fit_device(
            tuple(a[:k_items] for a in data), transform=transform, epochs=1, verbose=False),
            host_rows)
        prof_host = profile_device(lambda: t.fit(
            lambda: itertools.islice(host_epoch(), ENC_PROFILE_STEPS), epochs=1, verbose=False))
        top = [(round(us / 1e3, 3), key[:80], count) for us, key, count in prof_dev[2][:8]]
        adam_ms = sum(us for us, key, _ in prof_dev[2] if "adam" in key.lower()) / 1e3
        steps = n_items // bsz
        kernels_per_step = sum(count for _, _, count in prof_dev[2]) / ENC_PROFILE_STEPS
        host_top = [(round(ms, 3), key[:60], count) for ms, key, count in host_rows[:8]]
        host_total = sum(r[0] for r in host_rows)
        row = dict(
            name=name, batch=bsz, num_points=num_points, items=n_items, steps=steps,
            fit_device_epoch_ms=dev_ms, fit_device_items_per_s=n_items / (dev_ms / 1e3),
            fit_device_busy=prof_dev[1] / prof_dev[0], fit_device_device_ms=prof_dev[1],
            fit_epoch_ms=host_ms, fit_items_per_s=n_items / (host_ms / 1e3),
            fit_busy=prof_host[1] / prof_host[0],
            adam_device_ms_per_step=adam_ms / ENC_PROFILE_STEPS,
            kernels_per_step=kernels_per_step, turns_ms=turns, top_device_rows=top,
            host_ops_ms=host_total, top_host_rows=host_top,
            **({} if name == "resnet" else dict(npy_write_s=write_s)),
            **enc_report[name])
        enc_timing.append(row)
        log(f"timing encoder {name} ({steps} steps of batch {bsz}; {card}): fit_device epoch "
            f"{dev_ms:.2f} ms, {row['fit_device_items_per_s']:.0f} items/s, device busy "
            f"{100 * row['fit_device_busy']:.1f}% ({prof_dev[1]:.2f} ms of {prof_dev[0]:.2f}), "
            f"{kernels_per_step:.1f} kernels per step; fit from host batches {host_ms:.2f} ms, "
            f"{row['fit_items_per_s']:.0f} items/s, device busy {100 * row['fit_busy']:.1f}%"
            + ("" if name == "resnet" else f" ({n_items} .npy files written in {write_s:.2f} s)")
            + f"; Adam {adam_ms / ENC_PROFILE_STEPS:.3f} ms per step (turns device/host/host/device "
            + "/".join(f"{v:.2f}" for v in turns) + " ms)")
        for ms, key, count in top:
            log(f"  {ms:9.3f} ms  x{count:<5d} {key}")
        log(f"  host events of the profiled {ENC_PROFILE_STEPS} fit_device steps, self CPU "
            f"{host_total:.1f} ms:")
        for ms, key, count in host_top:
            log(f"  {ms:9.3f} ms  x{count:<5d} {key}")
    npy_tmp.cleanup()
    enc["tmp"].cleanup()
    log(f"phase 4f {time.perf_counter() - t_phase:.1f} s")
    return enc_timing



# ---- data parallelism (phase 3i, timing 4g) ---------------------------------


def data_parallel(card, pairs, start_sd, clr_cfg, dense_ds, dedup_ds):
    """Phase 3i: (a) one NCCL rank (``make_mesh(1)``) in this process:
    ``fit_device`` dense and dedup and ``fit(fused_steps=4)`` of the phase-3b
    model against the same runs without a mesh, then 4g, the ``fit_device``
    epoch with and without the mesh in turns; (b) two gloo ranks sharing the
    card (``python -m batch3dmot_tpu_torch.parallel.dryrun 2 --device
    cuda``: the six paths, the 'active' train step among them, held by the
    dry run to the same paths in one process). Returns the launches per
    rank and the timings for the kernels line."""
    import torch

    from batch3dmot_tpu_torch.models import make_model
    from batch3dmot_tpu_torch.parallel import make_mesh
    from batch3dmot_tpu_torch.train.encoded import EncodedGraphBatcher
    from batch3dmot_tpu_torch.train.trainer import WARMUP_STEPS, GNNTrainer

    t_phase = time.perf_counter()

    # no fallback: two NCCL ranks on one card are refused before any
    # process group exists
    try:
        make_mesh(2, rank=0)
    except ValueError as err:
        assert "backend='gloo'" in str(err), err
    else:
        raise AssertionError("make_mesh(2) over NCCL ran on one card")

    # (a) one rank over NCCL: every step a replay, its collectives inside
    mesh = make_mesh(1)
    assert (mesh.backend, mesh.size, mesh.device.type) == ("nccl", 1, "cuda"), mesh
    runs = {}
    # the kernels launched by the mesh runs alone (their warm-up steps and
    # captures: the replays run without the wrappers), and by the mesh-free
    # ones they are held against
    path_launches = dict.fromkeys(counters(), 0)
    free_launches = dict.fromkeys(counters(), 0)
    for form, ds in (("dense", dense_ds), ("dedup", dedup_ds), ("fused_steps=4", None)):
        # ref2: the mesh-free run again, the card's own run-to-run spread
        # (autograd's gathers sum with atomics; Adam turns a gradient within
        # rounding of zero into a step of about lr either way)
        ref, ref2 = (GNNTrainer(make_model("mm"), clr_cfg, init_state_dict=start_sd)
                     for _ in range(2))
        dp = GNNTrainer(make_model("mm"), clr_cfg, init_state_dict=start_sd, mesh=mesh)
        ref_losses, dp_losses = record_losses(ref), record_losses(dp)

        def train(tr, ds=ds):
            if ds is None:
                tr.train_epoch(EncodedGraphBatcher(pairs, 2, seed=0, uniform=True), fused_steps=4)
            else:
                tr.fit_device(ds, epochs=1, verbose=False, seed=7)

        counters(reset=True)
        train(ref), train(ref2)
        for k, v in counters().items():
            free_launches[k] += v
        c0 = mesh.collectives
        counters(reset=True)
        train(dp)
        launched = counters()
        captured = mesh.collectives - c0  # issued by the warm-up steps and the capture
        # the training pair's kernels (the 'noop' model runs no segment sum)
        assert launched["fwd"] > 0 and launched["bwd"] > 0, (form, launched)
        for k, v in launched.items():
            path_launches[k] += v
        steps = ref.step
        assert dp.graph_replays == ref.graph_replays == steps, (dp.graph_replays, steps)
        np.testing.assert_allclose(dp_losses, ref_losses, rtol=RTOL, atol=ATOL)
        rel = max_rel_diff(dp_losses, ref_losses)  # the replay epoch below adds to the lists
        (diff, at), (spread, _) = max_param_diff(dp, ref), max_param_diff(ref2, ref)
        # an element whose gradient is rounding noise may take an Adam step
        # on one run and not on another (either mesh-free run may be the
        # one: 4.4e-5 on one element of the fused form), so the floor is
        # one step, lr; a step of the wrong sign anywhere moves 2 * lr
        p_atol = max(ATOL, clr_cfg.lr, 10 * spread)
        far = params_close(dp, ref, RTOL, p_atol)
        assert far is None, (form, far, diff, at, p_atol)
        # an epoch of replays alone, traced: no collective leaves Python
        c1 = mesh.collectives
        if ds is None:
            run = lambda tr=dp: tr.train_epoch(  # noqa: E731
                EncodedGraphBatcher(pairs, 2, seed=1, uniform=True), fused_steps=4)
        else:
            run = lambda tr=dp, ds=ds: tr.fit_device(ds, epochs=1, verbose=False)  # noqa: E731
        _, dev_ms, rows = profile_device(run)
        assert mesh.collectives == c1, (mesh.collectives, c1)
        assert dp.graph_replays == 2 * steps, (dp.graph_replays, steps)
        nccl_rows = sum(c for _, key, c in rows if "nccl" in key.lower())
        copies = sum(c for _, key, c in rows if "memcpy" in key.lower())
        runs[form] = dict(steps=steps, collectives_captured=captured, nccl_kernels=nccl_rows,
                          copies=copies, max_param_diff=diff, mesh_free_spread=spread,
                          param_atol=p_atol, max_rel_loss=rel, launches=launched)
        log(f"3i (a) {form} on make_mesh(1) (NCCL): {steps} steps, {dp.graph_replays} replays; "
            f"{captured} collectives issued while capturing ({WARMUP_STEPS} warm-up steps and "
            f"the capture: {captured // (WARMUP_STEPS + 1)} per step), none during an epoch of "
            f"replays, whose trace holds {nccl_rows} NCCL kernels and {copies} copies "
            f"(NCCL runs a one-rank collective as a copy or nothing); losses vs the mesh-free "
            f"run max rel diff {rel:.2e}, max |param diff| {diff:.2e} ({at}; held at rtol "
            f"{RTOL:.0e}, atol {p_atol:.2e}; two mesh-free runs {spread:.2e} apart); kernels "
            f"launched by the mesh run {launched}")
        del ref, ref2, dp, run
    log(f"3i (a) kernels launched by the mesh runs {path_launches}, by the mesh-free runs "
        f"held against them {free_launches}")

    # 4g: the fit_device epoch with make_mesh(1) against without, in turns
    ref = GNNTrainer(make_model("mm"), clr_cfg, init_state_dict=start_sd)
    dp = GNNTrainer(make_model("mm"), clr_cfg, init_state_dict=start_sd, mesh=mesh)

    def epoch_ms(tr):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.fit_device(dense_ds, epochs=1, verbose=False)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    epoch_ms(ref), epoch_ms(dp)  # capture
    turns = [epoch_ms(ref), epoch_ms(dp), epoch_ms(dp), epoch_ms(ref)]
    ref_ms, dp_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    prof = {tag: profile_device(lambda tr=tr: tr.fit_device(dense_ds, epochs=1, verbose=False))
            for tag, tr in (("mesh-free", ref), ("make_mesh(1)", dp))}
    timing = dict(mesh_free_ms=ref_ms, mesh_ms=dp_ms, steps=runs["dense"]["steps"],
                  busy={k: v[1] / v[0] for k, v in prof.items()})
    log(f"4g fit_device dense epoch ({runs['dense']['steps']} steps; {card}): mesh-free "
        f"{ref_ms:.2f} ms, make_mesh(1) {dp_ms:.2f} ms, ratio {dp_ms / ref_ms:.3f} (turns "
        "free/mesh/mesh/free " + "/".join(f"{t:.2f}" for t in turns) + " ms); device busy "
        + ", ".join(f"{k} {100 * v:.1f}%" for k, v in timing["busy"].items()))
    del ref, dp
    mesh.close()

    # (b) two gloo ranks sharing the card; the dry run holds them to the
    # same paths in one process (parallel.dryrun.compare) and writes the
    # comparison
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "batch3dmot_tpu_torch.parallel.dryrun", "2", "--device",
             "cuda", "--out", out_dir], capture_output=True, text=True, timeout=600)
        dryrun_s = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            log(f"  {line}")
        assert proc.returncode == 0, proc.stderr[-4000:]
        check = json.loads(Path(out_dir, "check.json").read_text())
    for r, launches in enumerate(check["counters"]):
        assert all(v > 0 for v in launches.values()), (r, launches)
    log(f"3i (b) dryrun 2 --device cuda (gloo, both ranks on {card}) in {dryrun_s:.1f} s, "
        f"its one-process comparison included: every kernel launched on each rank "
        f"{check['counters']}; ranks bit-identical; vs one process (at rtol {RTOL:.0e}, atol "
        f"{ATOL:.0e}) max |trained state diff| {check['param']:.2e}, one-step gradients "
        f"{check['grad']:.2e}, averaged edges {check['pipeline']:.2e}, cached-embedding scores "
        f"{check['cached']:.2e}; phase 3i and 4g {time.perf_counter() - t_phase:.1f} s")
    return dict(one_rank=dict(runs=runs, launches=path_launches, mesh_free=free_launches),
                timing=timing, ranks=check["counters"], dryrun_s=dryrun_s)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from batch3dmot_tpu_torch.config import (
        Config,
        GNNConfig,
        GraphConstructionConfig,
        PredictConfig,
    )
    from batch3dmot_tpu_torch.graph import batch_graphs, pick_bucket
    from batch3dmot_tpu_torch.graphs import build_scene_graphs
    from batch3dmot_tpu_torch.graphs.build_device import build_scene_graphs_device
    from batch3dmot_tpu_torch.infer.device_pipeline import (
        DeviceScenePipeline,
        predict_scene_device,
        predict_scenes_device,
    )
    from batch3dmot_tpu_torch.io import GraphStoreReader, native, save_scene_graphs
    from batch3dmot_tpu_torch.io.native import NativeGraphStore, batch_to_padded_graph
    from batch3dmot_tpu_torch.infer.predict import (
        SceneEncodedScorer,
        average_scene_edges,
        make_scorer,
        predict_scenes,
        score_windows,
    )
    from batch3dmot_tpu_torch.models import init_params_, make_model
    from batch3dmot_tpu_torch.ops import cuda_build, fused_mp, segment_kernel
    from batch3dmot_tpu_torch.ops.fused_mp import (
        extract_mp_params,
        fused_mp_scores,
        fused_mp_scores_cuda,
        fused_mp_scores_plain,
        pack_mp_weights,
    )
    from batch3dmot_tpu_torch.ops.fused_mp_train import (
        fused_mp_train_scores,
        train_forward_cuda,
    )
    from batch3dmot_tpu_torch.ops.segment_kernel import (
        segment_sum,
        segment_sum_cuda,
        segment_sum_plain,
    )
    from batch3dmot_tpu_torch.train.data import (
        GraphBatcher,
        materialize_graph_dataset,
        to_padded,
    )
    from batch3dmot_tpu_torch.train.encoded import (
        ENC_KEYS,
        EncodedGraphBatcher,
        StreamingEncodedBatcher,
        _encoder_digest,
        materialize_encoded_dataset,
        materialize_encoded_datasets_dedup,
        precompute_scene_encodings,
        scene_encodings_cached,
    )
    from batch3dmot_tpu_torch.train.store_data import StoreGraphBatcher, make_batcher
    from batch3dmot_tpu_torch.train.trainer import (
        FROZEN_ENCODERS,
        WARMUP_STEPS,
        GNNTrainer,
        epoch_batches,
        index_rows,
    )
    from batch3dmot_tpu_torch.utils.checkpoint import load_checkpoint, merge_encoder_params
    from batch3dmot_tpu_torch.utils.metric_logging import MetricWriter
    from batch3dmot_tpu_torch.utils.weights import encoder_variables

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---- 1. build -----------------------------------------------------
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    report = cuda_build.build(["fused_mp", "fused_mp_train", "segment_sum"])
    for name, r in report.items():
        log(f"build {name}: {r['seconds']:.1f} s ({nvcc})")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    # ---- 2. kernels against their plain versions -----------------------
    gen = torch.Generator().manual_seed(0)
    models = {name: init_params_(make_model(name), gen).cuda().eval()
              for name in ("mm", "cl_gnn_trad", "pose")}
    cases = [
        ("mm", (64, 512), 8, 0),
        ("mm", (256, 4096), 8, 0),
        ("mm", (1024, 32768), 1, 0),
        ("mm", (256, 10240), 16, 0),  # a scene of the device pipeline (3f)
        ("mm", (1024, 40960), 1, 0),  # its largest: 1024 nodes at kNN 40
        ("cl_gnn_trad", (64, 512), 8, 0),
        ("pose", (128, 1024), 8, 0),
        ("mm", (64, 512), 2, 1),  # the second window is all padding
    ]
    rng = np.random.default_rng(0)
    max_err = 0.0
    with torch.inference_mode():
        for name, (n, e), windows, empty in cases:
            model = models[name]
            pose = name == "pose"
            nd, ed = model.node_dim, model.edge_dim
            inputs = random_inputs(rng, windows, n, e, nd, ed, not pose, empty)
            flat, meta = extract_mp_params(model, not pose, nd, ed)
            got = fused_mp_scores_cuda(*inputs, flat, meta, 6, logits=pose)
            again = fused_mp_scores_cuda(*inputs, flat, meta, 6, logits=pose)
            ref = fused_mp_scores_plain(*inputs, flat, meta, 6, logits=pose)
            torch.cuda.synchronize()
            assert torch.equal(got, again), "two fused_mp runs differ"
            mask = inputs[-1]
            if empty:
                assert torch.isfinite(got).all(), "padding window not finite"
                torch.testing.assert_close(got[-1], ref[-1], rtol=RTOL, atol=ATOL)
            if mask.any():
                torch.testing.assert_close(got[mask], ref[mask], rtol=RTOL, atol=ATOL)
                err = float((got[mask] - ref[mask]).abs().max())
                max_err = max(max_err, err)
            else:
                err = float((got - ref).abs().max())
            log(f"kernel fused_mp {name} ({n},{e}) x{windows} empty={empty}: "
                f"max|kernel-plain| {err:.3e} over {int(mask.sum())} valid edges; "
                "bit-identical across two runs")
            if (n, e) == (1024, 32768):
                k_ms = cuda_ms(lambda: fused_mp_scores_cuda(*inputs, flat, meta, 6), 5)
                p_ms = cuda_ms(lambda: fused_mp_scores_plain(*inputs, flat, meta, 6), 3)
                _, _, w = pack_mp_weights(flat, meta, nd, ed, True)
                flops, nbytes = mp_work(inputs, w, 6)
                log(f"timing fused_mp at ({n},{e}) x1: kernel {k_ms:.3f} ms, plain "
                    f"{p_ms:.3f} ms, bound {bound(flops, nbytes)[0]:.3f} ms 3xTF32, "
                    f"{bound(flops, nbytes, FP32_PEAK)[0]:.3f} ms fp32 "
                    f"({flops / 1e9:.2f} GFLOP; operations)")

    # ---- 2b. the training pair against autograd of the plain version ----
    train_cases = [
        ("mm", (64, 512), 8, 0),
        ("mm", (256, 4096), 8, 0),
        ("mm", (512, 4096), 2, 0),
        ("pose", (128, 1024), 8, 0),
        ("mm", (1024, 32768), 1, 0),
        ("mm", (64, 512), 2, 1),  # the second window is all padding
    ]
    fwd_err = bwd_err = 0.0
    for name, (n, e), windows, empty in train_cases:
        model = models[name]
        pose = name == "pose"
        nd, ed = model.node_dim, model.edge_dim
        inputs = random_inputs(rng, windows, n, e, nd, ed, not pose, empty)
        ct = torch.from_numpy(rng.uniform(-1.0, 1.0, (windows, e)).astype(np.float32)).cuda()
        flat, meta = extract_mp_params(model, not pose, nd, ed)
        with torch.no_grad():
            got = train_forward_cuda(*inputs, flat, meta, 6, pose)[:3]
            ref = fused_mp_scores_plain(*inputs, flat, meta, 6, pose, carries=True)
        torch.cuda.synchronize()
        f_err = 0.0
        for what, a, b in zip(("scores", "x_t", "e_t"), got, ref):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL, msg=what)
            f_err = max(f_err, float((a - b).abs().max()))
        fwd_err = max(fwd_err, f_err)
        _, g_k = train_grads(model, inputs, ct, 6, pose, fused_mp_train_scores)
        _, g_p = train_grads(model, inputs, ct, 6, pose, fused_mp_scores_plain)

        def plain64(model=model, inputs=inputs, ct=ct, pose=pose):
            m64 = copy.deepcopy(model).double()
            i64 = [t.double() if t is not None and t.is_floating_point() else t
                   for t in inputs]
            return train_grads(m64, i64, ct.double(), 6, pose, fused_mp_scores_plain)[1]

        err, tied = compare_grads(g_k, g_p, plain64, f"{name} ({n},{e}) x{windows}")
        bwd_err = max(bwd_err, err)
        _, again = train_grads(model, inputs, ct, 6, pose, fused_mp_train_scores)
        torch.cuda.synchronize()
        for k in g_k:
            assert torch.equal(g_k[k], again[k]), f"{k}: two backward runs differ"
        log(f"kernel fused_mp_train {name} ({n},{e}) x{windows} empty={empty}: "
            f"max|kernel-plain| scores and stashes {f_err:.3e}, gradients {err:.3e} "
            f"over {len(g_k)} tensors; backward bit-identical across two runs")
        for k, outside, size, rel_l2, rk, rp in tied:
            log(f"  {k}: {outside}/{size} elements outside the gradient tolerance, "
                f"relative L2 error {rel_l2:.2e}; RMS from a float64 plain run: "
                f"kernel {rk:.3e}, f32 plain {rp:.3e}")
        model.zero_grad(set_to_none=True)
        del inputs, got, ref, g_k, g_p, again

    # ---- 2c. the segment-sum kernel against its plain version ------------
    # the active path's shapes: mm message passing (D 128), its GAT messages
    # (D 96) and softmax denominators (D 1) over N * k = 5120 kNN edges, pose
    # message passing and GAT (D 64, 48), the largest bucket, the active
    # device pipeline's group (64 windows of (256, 10240)) and its largest
    # window (1024, 40960), and windows with no valid edge next to real ones
    seg_cases = [
        ((8,), 256, 4096, 128, False, False),
        ((8,), 256, 5120, 96, False, True),
        ((8,), 256, 5120, 1, False, True),
        ((8,), 128, 1024, 64, False, False),
        ((8,), 128, 1024, 48, False, False),
        ((8,), 128, 2560, 48, False, True),
        ((1,), 1024, 32768, 128, False, False),
        ((1,), 1024, 32768, 1, False, False),
        ((64,), 256, 10240, 128, False, False),  # the active device pipeline's group
        ((64,), 256, 5120, 96, False, True),  # its GAT messages over kNN 20
        ((1,), 1024, 40960, 128, False, False),  # the pipeline's largest window
        ((2,), 64, 512, 128, True, False),
    ]
    seg_err = 0.0
    for lead, n, e, d, empty, ids64 in seg_cases:
        data, ids, mask = segment_inputs(rng, lead, n, e, d, empty)
        if ids64:
            ids = ids.long()
        got = segment_sum_cuda(data, ids, n, mask)
        again = segment_sum_cuda(data, ids, n, mask)
        ref = segment_sum_plain(data, ids, n, mask)
        torch.cuda.synchronize()
        assert torch.equal(got, again), "two segment-sum runs differ"
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        assert not got[..., n - 1, :].any(), "an empty segment is not 0"
        if empty:
            assert not got[0].any(), "the all-padding window is not 0"
        err = float((got - ref).abs().max())
        seg_err = max(seg_err, err)
        x = torch.where(mask[..., None], data, 0.5).requires_grad_()
        ct = torch.from_numpy(rng.standard_normal((*lead, n, d)).astype(np.float32)).cuda()
        (g_k,) = torch.autograd.grad(segment_sum(x, ids, n, mask), x, ct)
        (g_p,) = torch.autograd.grad(segment_sum_plain(x, ids, n, mask), x, ct)
        torch.cuda.synchronize()
        assert torch.equal(g_k, g_p), "segment-sum backward differs from autograd of the plain"
        log(f"kernel segment_sum {lead} N={n} E={e} D={d} empty={empty} "
            f"ids {'int64' if ids64 else 'int32'}: max|kernel-plain| "
            f"{err:.3e} over {int(mask.sum())} valid edges; bit-identical across two runs; "
            "backward equals autograd of the plain version")
        del data, ids, mask, got, again, ref, x, ct, g_k, g_p

    # ---- 3. the main path ----------------------------------------------
    items = build_scenes()
    model = models["mm"]
    scorer = SceneEncodedScorer(model)
    scenes = [s for s, _ in items]
    windows_list = [ws for _, ws in items]
    n_windows = sum(len(ws) for ws in windows_list)
    n_edges = sum(w.num_edges for ws in windows_list for w in ws)
    buckets = {}
    for ws in windows_list:
        for w in ws:
            b = pick_bucket(w.num_nodes, w.num_edges)
            buckets[b] = buckets.get(b, 0) + 1
    log(f"main path: {len(items)} scenes, {sum(s.num_detections for s in scenes)} "
        f"detections, {n_windows} windows, {n_edges} edges, buckets "
        + ", ".join(f"{k}: {v}" for k, v in sorted(buckets.items())))
    scorer.score_scenes(scenes, windows_list)  # warm-up
    torch.cuda.synchronize()

    fused_mp_scores.launches = 0
    t0 = time.perf_counter()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    scores = scorer.score_scenes(scenes, windows_list)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    score_ms = start.elapsed_time(end)
    preds = predict_scenes(scorer, items)
    sub, boxes, n_tracks, res = submission_and_amota(items, preds)
    launches = {"fused_mp": fused_mp_scores.launches}
    log(f"main path launches: {launches}")
    assert launches["fused_mp"] > 0, "the main path never launched the kernel"

    for ws, ss in zip(windows_list, scores):
        for w, s in zip(ws, ss):
            assert s.shape == (w.num_edges,) and np.isfinite(s).all()
            assert ((s >= 0) & (s <= 1)).all()
    assert set(sub["results"]) == {f"{s.scene_token}_f{f}" for s in scenes
                                   for f in range(s.num_frames)}
    assert boxes and np.isfinite(res.amota)
    log(f"main path: score_scenes {score_ms:.2f} ms (CUDA events), host "
        f"{host_ms:.2f} ms, {n_edges / (score_ms / 1e3):.0f} edges/s; "
        f"{sum(len(p) for p, _ in preds)} predicted edges, {n_tracks} tracks, "
        f"{len(boxes)} boxes; AMOTA {res.amota:.4f} (untrained random weights)")

    class PlainScorer(SceneEncodedScorer):
        """The same scorer with the plain message-passing version."""

        def _forward(self, batch, det_index, enc):
            x_img, pn, rn, lp, rp = (t[det_index] for t in enc)
            m = self.model
            x0, e0, att, _ = m.pre_message_passing(batch, x_img, pn, rn, lp, rp)
            flat, meta = extract_mp_params(m, True, m.node_dim, m.edge_dim)
            return fused_mp_scores_plain(x0, e0, att, batch.edge_src, batch.edge_dst,
                                         batch.edge_mask, flat, meta, m.depth)

    plain_scores = PlainScorer(model).score_scenes(scenes, windows_list)
    path_err = max(float(np.abs(a - b).max())
                   for ss, ps in zip(scores, plain_scores) for a, b in zip(ss, ps))
    for ss, ps in zip(scores, plain_scores):
        for a, b in zip(ss, ps):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    max_err = max(max_err, path_err)
    log(f"main path scores: max|kernel-plain| {path_err:.3e}")

    # the windows path through the fused kernel: a 'noop' PoseGNN through
    # make_scorer (fused_logits_pose, then a sigmoid) over the same windows,
    # one launch per window batch, held window by window against the plain
    # version on the same batches
    all_windows = [w for ws in windows_list for w in ws]
    noop_pose = init_params_(make_model("pose"),
                             torch.Generator().manual_seed(5)).cuda().eval()
    noop_scorer = make_scorer(noop_pose)
    score_windows(noop_scorer, all_windows)  # warm-up
    torch.cuda.synchronize()
    fused_mp_scores.launches = 0
    pose_scores = score_windows(noop_scorer, all_windows)
    pose_launches = fused_mp_scores.launches
    batches = sum(-(-v // 8) for v in buckets.values())
    assert pose_launches == batches, (pose_launches, batches)
    fused_mp.fused_mp_scores_cuda = fused_mp_scores_plain
    try:
        pose_plain = score_windows(noop_scorer, all_windows)
    finally:
        fused_mp.fused_mp_scores_cuda = fused_mp_scores_cuda
    noop_pose_err = 0.0
    for w, a, b in zip(all_windows, pose_scores, pose_plain):
        assert a.shape == (w.num_edges,) and np.isfinite(a).all()
        assert ((a >= 0) & (a <= 1)).all()
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        noop_pose_err = max(noop_pose_err, float(np.abs(a - b).max()))
    max_err = max(max_err, noop_pose_err)
    log(f"'noop' PoseGNN windows path: {len(all_windows)} windows in {pose_launches} "
        f"fused_mp launches; max|kernel-plain| {noop_pose_err:.3e} window by window")

    # ---- 3b. the training path -------------------------------------------
    # the scenes' frozen-encoder outputs once, then one epoch of a full-width
    # depth-6 MultimodalGNN (configs/clr.yaml gnn: batch 2, lr 1e-4, weight
    # decay 1e-4, class-balanced BCE) from precomputed encodings, starting
    # from the inference model's weights (so its frozen encoders are the
    # ones the encodings came from)
    t0 = time.perf_counter()
    encs = [precompute_scene_encodings(model, sc) for sc in scenes]
    torch.cuda.synchronize()
    log(f"training path: encodings of {sum(sc.num_detections for sc in scenes)} "
        f"detections in {(time.perf_counter() - t0) * 1e3:.1f} ms")
    pairs = [(w, enc) for ws, enc in zip(windows_list, encs) for w in ws]
    clr = dict(batch_size=2, lr=1e-4, weight_decay=1e-4, loss="cb")
    start_sd = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = GNNTrainer(make_model("mm"), GNNConfig(**clr), init_state_dict=start_sd)
    train_b = EncodedGraphBatcher(pairs, 2, seed=0, uniform=True)
    val_b = EncodedGraphBatcher(pairs, 2, uniform=True)
    train_edges = sum(w.num_edges for w, _ in pairs)
    frozen0 = {k: v.clone() for k, v in trainer.model.state_dict().items()
               if k.split(".")[0] in FROZEN_ENCODERS}
    with tempfile.TemporaryDirectory() as log_dir:
        fused_mp_scores.launches = 0
        fused_mp_train_scores.fwd_launches = fused_mp_train_scores.bwd_launches = 0
        t0 = time.perf_counter()
        (hist,) = trainer.fit(train_b, val_b, epochs=1, log_dir=log_dir, verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        train_launches = {"fused_mp_train_fwd": fused_mp_train_scores.fwd_launches,
                          "fused_mp_train_bwd": fused_mp_train_scores.bwd_launches,
                          "fused_mp": fused_mp_scores.launches}
        log(f"training path launches: {train_launches} over {len(train_b)} steps "
            f"(fused_mp: the validation pass, no gradient)")
        assert train_launches["fused_mp_train_fwd"] == len(train_b), train_launches
        assert train_launches["fused_mp_train_bwd"] == len(train_b), train_launches
        for key in ("train/loss", "train/avgprec", "val/loss", "val/avgprec"):
            assert np.isfinite(hist[key]), (key, hist)
        state = trainer.model.state_dict()
        for k, v in frozen0.items():
            assert torch.equal(state[k], v), f"frozen {k} moved"
        (ckpt,) = Path(log_dir).glob("gnn_epoch0_*.pt")
        fresh = make_model("mm")
        fresh.load_state_dict(load_checkpoint(str(ckpt), map_location="cpu"))
        for k, v in fresh.state_dict().items():
            assert torch.equal(v, state[k].cpu()), f"checkpoint {k}"
    log(f"training path: 1 epoch of {len(train_b)} steps ((256, 4096) x2, {train_edges} "
        f"valid edges) + validation in {fit_s:.2f} s; loss {hist['train/loss']:.4f}, AP "
        f"{hist['train/avgprec']:.4f}, val loss {hist['val/loss']:.4f}, val AP "
        f"{hist['val/avgprec']:.4f}; frozen encoders unchanged; checkpoint {ckpt.name} "
        "loads into a fresh model")

    # one fixed batch: 3 steps through the kernels and 3 through the plain
    # version from the same start, then 10 more kernel steps (lr 1e-3, no
    # decay, as the JAX package's descent test)
    batch = next(EncodedGraphBatcher(pairs, 2, seed=1, uniform=True).epoch())
    step_cfg = GNNConfig(batch_size=2, lr=1e-3, weight_decay=0.0)
    tk = GNNTrainer(make_model("mm"), step_cfg, init_state_dict=start_sd)
    tp = GNNTrainer(make_model("mm"), step_cfg, init_state_dict=start_sd)
    lk = [float(tk.train_step(batch)[0]) for _ in range(3)]
    with plain_training():
        lp = [float(tp.train_step(batch)[0]) for _ in range(3)]
    np.testing.assert_allclose(lk, lp, rtol=1e-4)
    more = [float(tk.train_step(batch)[0]) for _ in range(10)]
    assert more[-1] < lk[0], (lk, more)
    log(f"training steps on one batch: kernel losses {[f'{v:.6f}' for v in lk]}, plain "
        f"{[f'{v:.6f}' for v in lp]}; after 10 more steps {more[-1]:.6f}")
    del tk, tp

    # mm on raw window batches (crops, points and radar): the frozen encoders
    # run inside each step; 3 steps against the same steps from the
    # precomputed encodings (the two batchers draw the same batches)
    raw = list(GraphBatcher(all_windows, 2, seed=3, uniform=True).epoch())[:3]
    encoded = list(EncodedGraphBatcher(pairs, 2, seed=3, uniform=True).epoch())[:3]
    for rb, (eg, _) in zip(raw, encoded):
        assert torch.equal(rb.edge_src, eg.edge_src) and torch.equal(rb.pose, eg.pose)
    assert raw[0].img.shape[-3:] == (32, 32, 3) and raw[0].lidar.shape[-2:] == (128, 3)
    t_raw = GNNTrainer(make_model("mm"), GNNConfig(**clr), init_state_dict=start_sd)
    t_enc = GNNTrainer(make_model("mm"), GNNConfig(**clr), init_state_dict=start_sd)
    fused_mp_train_scores.fwd_launches = 0
    l_raw = [float(t_raw.train_step(b)[0]) for b in raw]
    raw_launches = fused_mp_train_scores.fwd_launches
    l_enc = [float(t_enc.train_step(b)[0]) for b in encoded]
    np.testing.assert_allclose(l_raw, l_enc, rtol=1e-4)
    assert raw_launches == 3, raw_launches
    state = t_raw.model.state_dict()
    for k, v in frozen0.items():
        assert torch.equal(state[k], v), f"frozen {k} moved"
    log(f"raw-window training mm: 3 train_steps of {tuple(raw[0].img.shape)} crops, encoders "
        f"inside the step: losses {[f'{v:.6f}' for v in l_raw]}, from precomputed encodings "
        f"{[f'{v:.6f}' for v in l_enc]}; max rel diff "
        f"{max(abs(a - b) / abs(b) for a, b in zip(l_raw, l_enc)):.2e}; frozen encoders unchanged")
    del t_raw, t_enc, raw, encoded

    # ---- 3c. active inference: the kNN GATConv path -----------------------
    # a full-width depth-6 MultimodalGNN in knn_conv_mode='active' (k = 20):
    # the module loop, where every segment sum (2 per layer, 2 per conv on
    # layers 0, 2, 4) launches the segment-sum kernel
    convs = 3
    active_mm = init_params_(make_model("mm", knn_conv_mode="active"),
                             torch.Generator().manual_seed(3)).cuda().eval()
    scorer_a = SceneEncodedScorer(active_mm)

    class RecordingScorer(SceneEncodedScorer):
        """Records (edge_mask, scores) of every window-batch forward."""

        outs = None

        def _forward(self, batch, det_index, enc):
            out = super()._forward(batch, det_index, enc)
            self.outs.append((batch.edge_mask, out))
            return out

    def mm_run(outs):
        rec = RecordingScorer(active_mm)
        rec.outs = outs
        rec.score_scenes(scenes, windows_list)

    run_k = active_run(mm_run)
    run_p = active_run(mm_run, plain=True)
    n_fwd = len(run_k[0])
    scorer_a.score_scenes(scenes, windows_list)  # warm-up
    torch.cuda.synchronize()
    segment_sum.launches = 0
    t0 = time.perf_counter()
    start.record()
    scores_a = scorer_a.score_scenes(scenes, windows_list)
    end.record()
    end.synchronize()
    active_host_ms = (time.perf_counter() - t0) * 1e3
    active_ms = start.elapsed_time(end)
    active_launches = segment_sum.launches
    log(f"active path launches: segment_sum {active_launches} over {n_fwd} forwards")
    assert active_launches == 18 * n_fwd, (active_launches, n_fwd)
    preds_a = predict_scenes(scorer_a, items)
    sub_a, boxes_a, n_tracks_a, res_a = submission_and_amota(items, preds_a)
    for ws, ss in zip(windows_list, scores_a):
        for w, sc in zip(ws, ss):
            assert sc.shape == (w.num_edges,) and np.isfinite(sc).all()
            assert ((sc >= 0) & (sc <= 1)).all()
    assert set(sub_a["results"]) == set(sub["results"])
    assert boxes_a and np.isfinite(res_a.amota)
    act_err, act_windows, flips = compare_active(run_k, run_p, convs)
    seg_err = max(seg_err, act_err)
    log(f"active path: score_scenes {active_ms:.2f} ms (CUDA events), host "
        f"{active_host_ms:.2f} ms, {n_edges / (active_ms / 1e3):.0f} edges/s; "
        f"{sum(len(p) for p, _ in preds_a)} predicted edges, {n_tracks_a} tracks, "
        f"{len(boxes_a)} boxes; AMOTA {res_a.amota:.4f} (untrained random weights)")
    log(f"active path scores vs the plain segment sum: max|kernel-plain| {act_err:.3e} "
        f"over {act_windows - len(flips)} of {act_windows} windows with the same kNN "
        f"graphs; kNN flips at near-ties: {len(flips)} windows ({flip_summary(flips)})")
    replay_err = replayed_err(mm_run, run_k)
    seg_err = max(seg_err, replay_err)
    log(f"active path with the kernel run's kNN graphs replayed in the plain run: "
        f"max|kernel-plain| {replay_err:.3e} over all {act_windows} windows")
    del run_k, run_p

    # the windows path: an active PoseGNN through make_scorer
    active_pose = init_params_(make_model("pose", knn_conv_mode="active"),
                               torch.Generator().manual_seed(4)).cuda().eval()
    pose_scorer = make_scorer(active_pose)

    def pose_run(outs):
        def rec(batch):
            out = pose_scorer(batch)
            outs.append((batch.edge_mask, out))
            return out

        score_windows(rec, all_windows)

    segment_sum.launches = 0
    run_k = active_run(pose_run)
    pose_launches = segment_sum.launches
    run_p = active_run(pose_run, plain=True)
    assert pose_launches == 18 * len(run_k[0]), (pose_launches, len(run_k[0]))
    for _, sc in run_k[0]:
        assert torch.isfinite(sc).all() and ((sc >= 0) & (sc <= 1)).all()
    pose_err, pose_windows, pose_flips = compare_active(run_k, run_p, convs)
    seg_err = max(seg_err, pose_err)
    pose_replay = replayed_err(pose_run, run_k)
    seg_err = max(seg_err, pose_replay)
    log(f"active PoseGNN windows path: {len(run_k[0])} forwards, segment_sum launches "
        f"{pose_launches}; max|kernel-plain| {pose_err:.3e} over "
        f"{pose_windows - len(pose_flips)} of {pose_windows} windows; kNN flips at "
        f"near-ties: {len(pose_flips)} windows ({flip_summary(pose_flips)}); with the kNN graphs "
        f"replayed: max|kernel-plain| {pose_replay:.3e} over all {pose_windows} windows")
    del run_k, run_p

    # ---- 3d. active training ------------------------------------------------
    # GNNTrainer steps through the module loop under autograd: mm from the
    # precomputed encodings ((256, 4096) x2) and pose from window batches
    # ((128, 1024) x2); the segment sum's backward is a gather
    active_sd = {k: v.clone() for k, v in active_mm.state_dict().items()}
    pose_sd = {k: v.clone() for k, v in active_pose.state_dict().items()}
    encs_a = [precompute_scene_encodings(active_mm, sc) for sc in scenes]
    pairs_a = [(w, enc) for ws, enc in zip(windows_list, encs_a) for w in ws]
    small = [w for w in all_windows if pick_bucket(w.num_nodes, w.num_edges) == (128, 1024)]
    pose_b = GraphBatcher(small, 2, buckets=((128, 1024),), seed=0)
    active_train = {}
    for name, sd, batcher in (
        ("mm", active_sd, EncodedGraphBatcher(pairs_a, 2, seed=0, uniform=True)),
        ("pose", pose_sd, pose_b),
    ):
        batches = list(batcher.epoch())[:4]
        tr = GNNTrainer(make_model(name, knn_conv_mode="active"), GNNConfig(**clr),
                        init_state_dict=sd)
        frozen_a = {k: v.clone() for k, v in tr.model.state_dict().items()
                    if k.split(".")[0] in FROZEN_ENCODERS}
        segment_sum.launches = 0
        losses = [float(tr.train_step(b)[0]) for b in batches]
        torch.cuda.synchronize()
        steps_launches = segment_sum.launches
        assert steps_launches == 18 * len(batches), (name, steps_launches)
        assert np.isfinite(losses).all(), losses
        state = tr.model.state_dict()
        for k, v in frozen_a.items():
            assert torch.equal(state[k], v), f"frozen {k} moved"
        batch = batches[0]
        tk = GNNTrainer(make_model(name, knn_conv_mode="active"), step_cfg, init_state_dict=sd)
        tp = GNNTrainer(make_model(name, knn_conv_mode="active"), step_cfg, init_state_dict=sd)
        lk = [float(tk.train_step(batch)[0]) for _ in range(3)]
        with plain_segment_sum():
            lp = [float(tp.train_step(batch)[0]) for _ in range(3)]
        np.testing.assert_allclose(lk, lp, rtol=1e-4)
        more = [float(tk.train_step(batch)[0]) for _ in range(10)]
        assert more[-1] < lk[0], (name, lk, more)
        shape = tuple(batch[0].edge_src.shape if isinstance(batch, tuple)
                      else batch.edge_src.shape)
        active_train[name] = (tk, batch)
        log(f"active training {name}: {len(batches)} steps of {shape}, segment_sum "
            f"launches {steps_launches}, losses {[f'{v:.6f}' for v in losses]}"
            + ("; frozen encoders unchanged" if frozen_a else "")
            + f"; one batch: kernel losses {[f'{v:.6f}' for v in lk]}, plain "
            f"{[f'{v:.6f}' for v in lp]}; after 10 more steps {more[-1]:.6f}")
        del tr, tp

    # ---- 3e. device-resident training --------------------------------------
    # the 48 windows and encodings of 3b stacked once; fit_device (one epoch,
    # seed 7) gathers every batch on the card by index, and each step is one
    # replay of a captured CUDA graph (forward, the kernel pair, backward,
    # fused Adam, the metrics): held step by step against host train_steps
    # on the same index rows; then the dedup form against the dense one, K =
    # 4 steps per dispatch against eager steps, the 'noop' PoseGNN through
    # fit and fit_device, and the active mm through fit_device. A replay
    # runs its kernels without their wrappers: an epoch of replays only runs
    # under the profiler, its wrappers must count nothing, and it must run
    # each of the port's kernels steps times as often as one eager step does
    # (whose wrappers count one launch each)
    clr_cfg = GNNConfig(**clr)
    lr = clr["lr"]
    dense_ds = materialize_encoded_dataset(pairs)
    dedup_ds = materialize_encoded_datasets_dedup(pairs)
    assert len(dedup_ds) == 1, len(dedup_ds)
    host_batches = epoch_batches(dense_ds, 2, 7)
    steps = len(host_batches)

    def resident(name, sd, ds, mode="noop"):
        """A fresh trainer from ``sd`` after one fit_device epoch (seed 7),
        its history and the loss of each step."""
        tr = GNNTrainer(make_model(name, knn_conv_mode=mode), clr_cfg, init_state_dict=sd)
        losses = record_losses(tr)
        (hist,) = tr.fit_device(ds, epochs=1, verbose=False, seed=7)
        return tr, hist, losses

    def eager_steps(tr, batches):
        """The losses of train_steps on ``batches``, the kernels of the
        first step (traced) and its wrappers' launches."""
        first = []
        counters(reset=True)
        per_step = cuda_build.traced_launches(
            lambda: first.append(float(tr.train_step(batches[0])[0])))
        launched = counters()
        return first + [float(tr.train_step(b)[0]) for b in batches[1:]], per_step, launched

    def replayed(tr, run, n, per_step):
        """``run()``, an epoch of ``n`` replays and nothing else, traced:
        the port's kernels it ran, n times one eager step's."""
        before = tr.graph_replays
        counters(reset=True)
        got = cuda_build.traced_launches(run)
        assert tr.graph_replays - before == n, (tr.graph_replays, before, n)
        assert not any(counters().values()), counters()
        assert per_step and got == {k: n * v for k, v in per_step.items()}, (got, per_step, n)
        return ", ".join(f"{k} {v}" for k, v in sorted(got.items()))

    t_dense, h_dense, dense_losses = resident("mm", start_sd, dense_ds)
    t_host = GNNTrainer(make_model("mm"), clr_cfg, init_state_dict=start_sd)
    host_losses, mm_step, c_step = eager_steps(t_host, host_batches)
    assert c_step["fwd"] == c_step["bwd"] == 1, c_step
    np.testing.assert_allclose(dense_losses, host_losses, rtol=1e-4)
    np.testing.assert_allclose(h_dense["train/loss"], np.mean(host_losses), rtol=1e-4)
    dense_diff, dense_at = max_param_diff(t_dense, t_host)
    assert dense_diff <= 2 * lr * steps, dense_diff
    state = t_dense.model.state_dict()
    for k, v in frozen0.items():
        assert torch.equal(state[k], v), f"frozen {k} moved"
    log(f"fit_device dense mm: {steps} steps, {t_dense.graph_replays} graph replays; losses "
        f"step by step vs host train_steps: max rel diff "
        f"{max_rel_diff(dense_losses, host_losses):.2e} "
        f"(epoch {h_dense['train/loss']:.6f}); max |param diff| {dense_diff:.2e} ({dense_at}; "
        f"bound {2 * lr * steps:.1e}); frozen encoders unchanged")

    # the same epoch in dedup form: the gather through det_index returns the
    # dense gather's batch bit for bit, row by row
    t_dedup, h_dedup, dedup_losses = resident("mm", start_sd, dedup_ds)
    (r_dense,) = t_dense._upload_dataset_groups([dense_ds])
    (r_dedup,) = t_dedup._upload_dataset_groups(dedup_ds)
    rows = torch.from_numpy(index_rows(np.random.default_rng(7).permutation(r_dense.n_items),
                                       r_dense.n_items, 2)).cuda()
    for row in rows:
        got = batch_tensors(GNNTrainer._gather_device_batch(r_dedup.graphs, r_dedup.enc, row))
        want = batch_tensors(GNNTrainer._gather_device_batch(r_dense.graphs, r_dense.enc, row))
        assert all(torch.equal(x, y) for x, y in zip(got, want)), row
    np.testing.assert_allclose(dedup_losses, dense_losses, rtol=1e-4)
    dedup_diff, dedup_at = max_param_diff(t_dedup, t_dense)
    assert dedup_diff <= 2 * lr * steps, dedup_diff
    dense_bytes = sum(t.numel() * t.element_size() for t in dense_ds[1])
    dedup_bytes = sum(g[1].det_index.numel() * 4 for g in dedup_ds) + sum(
        t.numel() * t.element_size() for t in dedup_ds[0][1].table)
    log(f"fit_device dedup mm: {len(dedup_ds)} group, the {len(rows)} gathered batches "
        f"bit-identical to the dense form's; losses step by step vs dense: max rel diff "
        f"{max_rel_diff(dedup_losses, dense_losses):.2e}; "
        f"max |param diff| from dense {dedup_diff:.2e} ({dedup_at}); encodings on the card "
        f"{dense_bytes / 2**20:.2f} MiB dense vs {dedup_bytes / 2**20:.2f} MiB dedup")

    syncs_dense = count_syncs(lambda: t_dense.fit_device(dense_ds, epochs=1, verbose=False))
    assert syncs_dense == 1, syncs_dense
    rep_dense = replayed(t_dense, lambda: t_dense.fit_device(dense_ds, epochs=1, verbose=False),
                         steps, mm_step)
    rep_dedup = replayed(t_dedup, lambda: t_dedup.fit_device(dedup_ds, epochs=1, verbose=False),
                         steps, mm_step)
    log(f"fit_device replays: host syncs in an epoch {syncs_dense} (one group); one eager step "
        f"(wrappers fwd/bwd {c_step['fwd']}/{c_step['bwd']}) runs "
        + ", ".join(f"{k} x{v}" for k, v in sorted(mm_step.items()))
        + f"; an epoch of {steps} replays, no wrapper launch: dense {rep_dense}; dedup "
        + ("the same" if rep_dedup == rep_dense else rep_dedup))
    del t_host, t_dedup, r_dense, r_dedup

    t_fused = GNNTrainer(make_model("mm"), clr_cfg, init_state_dict=start_sd)
    t_eager = GNNTrainer(make_model("mm"), clr_cfg, init_state_dict=start_sd)
    fused_losses = record_losses(t_fused)
    m_fused = t_fused.train_epoch(EncodedGraphBatcher(pairs, 2, seed=0, uniform=True),
                                  fused_steps=4)
    eager_batches = list(EncodedGraphBatcher(pairs, 2, seed=0, uniform=True).epoch())
    eager_losses = [float(t_eager.train_step(b)[0]) for b in eager_batches]
    np.testing.assert_allclose(fused_losses, eager_losses, rtol=1e-4)
    fused_rel = max_rel_diff(fused_losses, eager_losses)  # the later epochs add to the list
    np.testing.assert_allclose(m_fused["train/loss"], np.mean(eager_losses), rtol=1e-4)
    fused_diff, fused_at = max_param_diff(t_fused, t_eager)
    assert fused_diff <= 2 * lr * t_eager.step, fused_diff
    assert t_fused.graph_replays == t_eager.step == 24, (t_fused.graph_replays, t_eager.step)
    groups = -(-t_eager.step // 4)
    syncs_fused = count_syncs(lambda: t_fused.train_epoch(
        EncodedGraphBatcher(pairs, 2, seed=1, uniform=True), fused_steps=4))
    assert syncs_fused == groups, (syncs_fused, groups)
    rep_fused = replayed(t_fused, lambda: t_fused.train_epoch(
        EncodedGraphBatcher(pairs, 2, seed=2, uniform=True), fused_steps=4), 24, mm_step)
    log(f"fused_steps=4 mm: {t_eager.step} steps in {groups} groups, 24 graph replays; losses "
        f"step by step vs eager: max rel diff "
        f"{fused_rel:.2e} "
        f"(epoch {m_fused['train/loss']:.6f}), max |param diff| {fused_diff:.2e} ({fused_at}); "
        f"host syncs per group in a second epoch: {syncs_fused / groups:g}; a third epoch, "
        f"no wrapper launch: " + ("as fit_device's" if rep_fused == rep_dense else rep_fused))
    del t_fused, t_eager

    # the 'noop' PoseGNN (the windows path's model) through GNNTrainer: fit
    # on window batches, then fit_device on the stacked windows (one epoch,
    # then one of replays only), then 10 more steps on one batch lower the
    # loss
    pose_cfg = GNNConfig(batch_size=2, lr=1e-3, weight_decay=0.0)
    pose_start = {k: v.clone() for k, v in noop_pose.state_dict().items()}
    t_pose = GNNTrainer(make_model("pose"), pose_cfg, init_state_dict=pose_start)
    pose_b = GraphBatcher(all_windows, 2, seed=0)
    counters(reset=True)
    (h_pose,) = t_pose.fit(pose_b, epochs=1, verbose=False)
    c_fit = counters()
    assert c_fit["fwd"] == c_fit["bwd"] == len(pose_b), (c_fit, len(pose_b))
    pose_ds = materialize_graph_dataset(all_windows)
    (h_pose_dev,) = t_pose.fit_device(pose_ds, epochs=1, verbose=False, seed=7)
    pose_steps = -(-(pose_ds[0].pose.shape[0] - 1) // 2)
    t_cal = GNNTrainer(make_model("pose"), pose_cfg, init_state_dict=pose_start)
    _, pose_step, c_cal = eager_steps(t_cal, epoch_batches(pose_ds, 2, 7)[:1])
    assert c_cal["fwd"] == c_cal["bwd"] == 1, c_cal
    rep_pose = replayed(t_pose, lambda: t_pose.fit_device(pose_ds, epochs=1, verbose=False,
                                                          seed=8), pose_steps, pose_step)
    batch = next(GraphBatcher(all_windows, 2, seed=2).epoch())
    first = float(t_pose.train_step(batch)[0])
    more = [float(t_pose.train_step(batch)[0]) for _ in range(10)]
    assert np.isfinite([h_pose["train/loss"], h_pose_dev["train/loss"]]).all()
    assert more[-1] < first, (first, more)
    log(f"'noop' PoseGNN training: fit {len(pose_b)} steps (launches {c_fit['fwd']}/"
        f"{c_fit['bwd']}), loss {h_pose['train/loss']:.6f}; fit_device {pose_steps} steps, "
        f"loss {h_pose_dev['train/loss']:.6f}; an epoch of {pose_steps} replays, no wrapper "
        f"launch: {rep_pose}; one batch {first:.6f} -> {more[-1]:.6f} after 10 more steps")
    del t_pose, t_cal

    # the active mm: the module loop with the kNN GATConv, 18 segment sums
    # per forward, through fit_device on 8 windows of the active encodings,
    # against eager train_steps on the same rows
    act_ds = materialize_encoded_dataset(pairs_a[:8])
    act_batches = epoch_batches(act_ds, 2, 7)
    t_act, h_act, act_dev_losses = resident("mm", active_sd, act_ds, mode="active")
    t_ref = GNNTrainer(make_model("mm", knn_conv_mode="active"), clr_cfg,
                       init_state_dict=active_sd)
    act_losses, act_step, c_act = eager_steps(t_ref, act_batches)
    assert c_act["segment_sum"] == act_step.get("segment_sum_kernel") == 18, (c_act, act_step)
    np.testing.assert_allclose(act_dev_losses, act_losses, rtol=1e-4)
    act_rel = max_rel_diff(act_dev_losses, act_losses)
    act_diff, act_at = max_param_diff(t_act, t_ref)
    assert act_diff <= 2 * lr * len(act_batches), act_diff
    rep_act = replayed(t_act, lambda: t_act.fit_device(act_ds, epochs=1, verbose=False),
                       len(act_batches), act_step)
    log(f"fit_device active mm: {len(act_batches)} steps; losses step by step vs eager: max "
        f"rel diff {act_rel:.2e} (epoch "
        f"{h_act['train/loss']:.6f}); max |param diff| {act_diff:.2e} ({act_at}); an "
        f"epoch of {len(act_batches)} replays, no wrapper launch: {rep_act}")
    del t_act, t_ref

    # ---- 3f. the device inference pipeline ---------------------------------
    # the same 4 scenes through DeviceScenePipeline (window 5, kNN 40) with
    # the main path's model: every window built on the card (held to the
    # host builder), every detection encoded once, the windows scored by the
    # fused kernel in one launch per scene, or per group of scenes, and the
    # edge scores averaged across windows on the card; then the active
    # model's pipeline (18 segment sums per forward) and scoring from the
    # precomputed encodings of 3b
    gc40 = GraphConstructionConfig(top_knn_nodes=40)
    pipe = DeviceScenePipeline(model, 5, 40)
    quanta = [pipe._quanta(sc) for sc in scenes]
    dev_windows, build_flips, build_err, n_built = [], 0, 0.0, 0
    for sc, q in zip(scenes, quanta):
        dev = build_scene_graphs_device(sc, 5, gc40, max_nodes=q[2])
        flips_b, err_b = compare_builds(sc, list(build_scene_graphs(sc, 5, gc40)), dev, 5, 40)
        build_flips += flips_b
        build_err = max(build_err, err_b)
        n_built += len(dev)
        dev_windows.append([w for w in dev if w.num_edges > 0])
    pipe_edges = sum(w.num_edges for ws in dev_windows for w in ws)
    log(f"device pipeline build: {n_built} windows built on the card against the host "
        f"builder: same nodes, pose features and labelled edges (attributes within 1e-5, max "
        f"|difference| {build_err:.2e}); windows with a kNN flip at a near-tie: {build_flips}; "
        f"{pipe_edges} valid edges; quanta (m_pad, windows, max_nodes) per scene {quanta}")

    with grouping_forced():  # warm-up: lazy uploads and libraries
        pipe.score_scenes(scenes)
    for sc in scenes:
        pipe.score_scene(sc)
    torch.cuda.synchronize()
    pending = []
    counters(reset=True)
    syncs_single = count_syncs(lambda: pending.extend(pipe.dispatch_scene(sc) for sc in scenes))
    single_launches = counters()["fused_mp"]
    singles = [pipe.finalize_scene(p) for p in pending]
    # the group's work W * N * E decides the route: these scenes' windows
    # fill the card (above _GROUP_WORK_CEILING), so score_scenes sends them
    # one by one; with the ceiling lifted they go as one batch of S * W
    routed = pipe.dispatch_scenes(scenes)
    routed_scores = pipe.finalize_scenes(routed)
    group_pending = []
    counters(reset=True)
    with grouping_forced():
        syncs_group = count_syncs(lambda: group_pending.append(pipe.dispatch_scenes(scenes)))
    group_launches = counters()["fused_mp"]
    grouped = pipe.finalize_scenes(group_pending[0])
    routed_diff = max(max_avg_diff(r, a) for r, a in zip(routed_scores, singles))
    log(f"device pipeline launches: fused_mp {single_launches} over {len(scenes)} scene "
        f"dispatches, {group_launches} for the forced group of {len(scenes)}; score_scenes' "
        f"own route at this density: {routed[0]}; host syncs inside dispatch: "
        f"{syncs_single} per-scene, {syncs_group} grouped; max|routed - singles| "
        f"{routed_diff:.3e}")
    assert single_launches == len(scenes) and group_launches == 1, (single_launches,
                                                                    group_launches)
    assert group_pending[0][0] == "group"
    assert syncs_single == 0 and syncs_group == 0, (syncs_single, syncs_group)
    for avg in singles:
        vals = np.array(list(avg.values()))
        assert vals.size and np.isfinite(vals).all() and ((vals >= 0) & (vals <= 1)).all()
    host_scores = scorer.score_scenes(scenes, dev_windows)
    pipe_host_err = max(max_avg_diff(a, average_scene_edges(ws, ss))
                        for a, ws, ss in zip(singles, dev_windows, host_scores))
    assert sum(len(a) for a in singles) == len(
        {(i, k) for i, ws in enumerate(dev_windows) for w in ws
         for k in zip(w.det_index[w.edge_src].tolist(), w.det_index[w.edge_dst].tolist())})
    fused_mp.fused_mp_scores_cuda = fused_mp_scores_plain
    try:
        pipe_plain = [pipe.score_scene(sc) for sc in scenes]
    finally:
        fused_mp.fused_mp_scores_cuda = fused_mp_scores_cuda
    pipe_plain_err = max(max_avg_diff(a, b) for a, b in zip(singles, pipe_plain))
    group_diff = max(max_avg_diff(g, a) for g, a in zip(grouped, singles))
    group_shape = (len(scenes) * -(-quanta[0][1] // 8) * 8, max(q[2] for q in quanta))
    max_err = max(max_err, pipe_plain_err)
    log(f"device pipeline scores: {sum(len(a) for a in singles)} averaged edges; max|pipeline - "
        f"host path (SceneEncodedScorer + average_scene_edges on the same graphs)| "
        f"{pipe_host_err:.3e}; max|kernel - plain| {pipe_plain_err:.3e}; max|grouped - "
        f"singles| {group_diff:.3e} (group: {group_shape[0]} windows of {group_shape[1]} "
        "nodes in one launch)")

    # float32 point uploads, as phase 3's predict_scenes had them; the
    # default float16 uploads are held to float32 ones below
    cfg_dev = Config(graph_construction=gc40,
                     predict=PredictConfig(batch_size_graph=5, point_dtype="float32"))
    preds_dev = [predict_scene_device(model, sc, cfg_dev) for sc in scenes]
    assert predict_scenes_device(model, scenes, cfg_dev) == preds_dev
    _, boxes_dev, n_tracks_dev, res_dev = submission_and_amota(items, preds_dev)
    assert boxes_dev and np.isfinite(res_dev.amota)
    # both paths round the same way (per-class thresholds, then per node
    # the best edge, the first in (src, dst) order at a tie); their
    # averages differ in the last bits, so an edge may flip only where its
    # mean lies that close to a rival's or to its class threshold
    pred_diff, unexplained = rounding_flips(preds_dev, preds, scenes)
    assert unexplained == 0, unexplained
    log(f"device pipeline tracks: predict_scene_device -> {sum(len(p) for p, _ in preds_dev)} "
        f"predicted edges ({pred_diff} in only one of it and phase 3's predict_scenes, each "
        f"at a near-tie of the two paths' averages), equal to predict_scenes_device's (one "
        f"group of {len(scenes)}); {n_tracks_dev} tracks, {len(boxes_dev)} boxes; AMOTA "
        f"{res_dev.amota:.4f} (phase 3's score_scenes: {res.amota:.4f}; untrained random "
        "weights)")

    # float16 points (predict.point_dtype): float32 points cast for the
    # upload give the scores of float16 points, upcast by the encoders on
    # the card: the same edges, within 5e-3 of float32 uploads
    pipe16 = DeviceScenePipeline(model, 5, 40, point_dtype="float16")
    half = [dataclasses.replace(sc, lidar=sc.lidar.astype(np.float16),
                                radar=sc.radar.astype(np.float16)) for sc in scenes]
    cast = [pipe16.score_scene(sc) for sc in scenes]
    assert all(c == pipe.score_scene(h) for c, h in zip(cast, half))
    half_err = max(max_avg_diff(c, a, 0, 5e-3) for c, a in zip(cast, singles))
    del pipe16
    log(f"device pipeline with float16 points: the same averaged edges, max|diff| from "
        f"float32 points {half_err:.3e}")

    # the active model: kNN graphs of the kernel run replayed in the plain
    # run; grouped against singles only reported (a group's batch shapes
    # change the summation order of x, and a kNN near-tie may flip)
    pipe_a = DeviceScenePipeline(active_mm, 5, 40)
    assert not pipe_a.fused
    pipe_a.score_scenes(scenes)  # warm-up
    knn_caps = []
    counters(reset=True)
    with capture_knn(knn_caps):
        act_singles = [pipe_a.score_scene(sc) for sc in scenes]
    act_single_launches = counters()["segment_sum"]
    counters(reset=True)
    with grouping_forced():
        act_grouped = pipe_a.score_scenes(scenes)
    act_group_launches = counters()["segment_sum"]
    assert act_single_launches == 18 * len(scenes), act_single_launches
    assert act_group_launches == 18, act_group_launches
    with replay_knn(knn_caps), plain_segment_sum():
        act_plain = [pipe_a.score_scene(sc) for sc in scenes]
    act_pipe_err = max(max_avg_diff(a, b) for a, b in zip(act_singles, act_plain))
    seg_err = max(seg_err, act_pipe_err)
    assert all(g.keys() == a.keys() for g, a in zip(act_grouped, act_singles))
    act_group_diff = max(abs(g[k] - a[k]) for g, a in zip(act_grouped, act_singles) for k in a)
    log(f"active device pipeline: segment_sum {act_single_launches} over {len(scenes)} scene "
        f"forwards, {act_group_launches} for the group; max|kernel - plain| with the kNN "
        f"graphs replayed {act_pipe_err:.3e}; max|grouped - singles| {act_group_diff:.3e}")

    # scoring from the precomputed encodings of 3b (encoders run in 512-row
    # chunks there, over the group's rows in phase 3)
    counters(reset=True)
    s32 = SceneEncodedScorer(model, embedding_dtype="float32").score_scenes(
        scenes, windows_list, encodings_list=encs)
    enc_launches = counters()["fused_mp"]
    s16 = SceneEncodedScorer(model).score_scenes(scenes, windows_list, encodings_list=encs)
    n_batches = sum(-(-v // 8) for v in buckets.values())
    assert enc_launches == n_batches, (enc_launches, n_batches)
    pairs_s = [(a, b, c) for ss, e32, e16 in zip(scores, s32, s16)
               for a, b, c in zip(ss, e32, e16)]
    same32 = all(np.array_equal(a, b) for a, b, _ in pairs_s)
    enc32_err = max(float(np.abs(a - b).max()) for a, b, _ in pairs_s)
    enc16_err = max(float(np.abs(a - c).max()) for a, _, c in pairs_s)
    for a, b, c in pairs_s:
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
        assert c.shape == a.shape
        np.testing.assert_allclose(c, a, atol=5e-3)
    log(f"encodings path: {enc_launches} fused_mp launches; float32 transport vs the raw "
        f"encode {'bit-identical' if same32 else f'max|diff| {enc32_err:.3e}'}; float16 "
        f"max|diff| {enc16_err:.3e}")

    # ---- 3g. training and checkpoints from disk -----------------------------
    # the 4 scenes' windows as .b3d stores (with their metadata sidecars), read
    # back through the numpy reader and the native loader (built by g++ from
    # native/graphstore.cc into build/torch_kernels); the 'noop' PoseGNN
    # through fit from make_batcher's StoreGraphBatcher and 3 mm train_steps
    # on raw store batches; the encoding caches written, hit and repaired;
    # the streaming batcher through fit(fused_steps=4) with a metric writer,
    # and the cached tables through fit_device; the epoch checkpoint loaded
    # and scored; the encoders grafted into a fresh GNN
    store_tmp = tempfile.TemporaryDirectory()
    store_dir = store_tmp.name
    t_phase = time.perf_counter()
    native_fresh = not native.library_path().exists()
    assert native.native_available(), f"native loader did not build:\n{native.native_error()}"
    native_build_s = time.perf_counter() - t_phase
    paths = [save_scene_graphs(ws, store_dir, metadata=sc.metadata)
             for sc, ws in zip(scenes, windows_list)]
    loader = dict(zip(paths, scenes)).__getitem__
    store_mib = sum(Path(p).stat().st_size for p in paths) / 2**20
    for p, ws in zip(paths, windows_list):
        reader, nat = GraphStoreReader(p), NativeGraphStore(p)
        assert reader.num_windows == nat.num_windows == len(ws), (p, len(ws))
        for i, w in enumerate(ws):
            b = pick_bucket(w.num_nodes, w.num_edges)
            want = to_padded(w, *b)
            assert graphs_equal(to_padded(reader.window(i), *b), want), (p, i, "reader")
            filled = batch_to_padded_graph(nat.fill_padded_batch([i], *b))
            assert graphs_equal(take_slot(filled, 0), want), (p, i, "native")
        nat.close()
    log(f"stores: {len(paths)} .b3d files, {store_mib:.1f} MiB; native loader "
        f"{native.library_path().name} {'built' if native_fresh else 'loaded'} in "
        f"{native_build_s:.2f} s; all {n_windows} windows read back equal to_padded of the in-memory windows "
        "through the numpy reader and through the native fill at their buckets")

    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        store_b = make_batcher(paths, 2, seed=0, uniform=True)
    assert isinstance(store_b, StoreGraphBatcher), said.getvalue()
    mem_b = GraphBatcher(all_windows, 2, seed=0, uniform=True)
    for a, b in zip(StoreGraphBatcher(paths, 2, seed=9, uniform=True).epoch(),
                    GraphBatcher(all_windows, 2, seed=9, uniform=True).epoch(), strict=True):
        assert graphs_equal(a, b)
    t_ps = GNNTrainer(make_model("pose"), pose_cfg, init_state_dict=pose_start)
    t_pm = GNNTrainer(make_model("pose"), pose_cfg, init_state_dict=pose_start)
    l_ps, l_pm = record_step_losses(t_ps), record_step_losses(t_pm)
    counters(reset=True)
    (h_ps,) = t_ps.fit(store_b, epochs=1, verbose=False)
    c_store = counters()
    (h_pm,) = t_pm.fit(mem_b, epochs=1, verbose=False)
    assert c_store["fwd"] == c_store["bwd"] == len(store_b), (c_store, len(store_b))
    assert np.isfinite(l_ps).all() and len(l_ps) == len(store_b)
    np.testing.assert_allclose(l_ps, l_pm, rtol=1e-4)
    raw_store = list(StoreGraphBatcher(paths, 2, seed=3, uniform=True).epoch())[:3]
    assert raw_store[0].img.dtype == torch.uint8 and raw_store[0].lidar.shape[-2:] == (128, 3)
    t_rs = GNNTrainer(make_model("mm"), GNNConfig(**clr), init_state_dict=start_sd)
    counters(reset=True)
    l_store = [float(t_rs.train_step(b)[0]) for b in raw_store]
    c_raw = counters()
    assert c_raw["fwd"] == c_raw["bwd"] == 3, c_raw
    np.testing.assert_allclose(l_store, l_raw, rtol=1e-4)
    state = t_rs.model.state_dict()
    for k, v in frozen0.items():
        assert torch.equal(state[k], v), f"frozen {k} moved"
    del t_rs, raw_store
    log(f"store-fed training: {said.getvalue().strip()}; the 'noop' PoseGNN fit from the "
        f"StoreGraphBatcher: {len(store_b)} steps, launches {c_store['fwd']}/{c_store['bwd']}, "
        f"loss {h_ps['train/loss']:.6f}, step losses vs the same epoch from the in-memory "
        f"GraphBatcher: max rel diff {max_rel_diff(l_ps, l_pm):.2e}; mm on raw store batches "
        f"(uint8 crops, points, radar): 3 train_steps, losses {[f'{v:.6f}' for v in l_store]} "
        f"vs 3b's raw windows: max rel diff {max_rel_diff(l_store, l_raw):.2e}")

    encode_calls = count_calls(model, "encode_frozen")
    cached = [scene_encodings_cached(model, p, loader) for p in paths]
    assert encode_calls[0] > 0 and all(Path(p + ".enc.npz").exists() for p in paths)
    cache_err = 0.0
    for got, want in zip(cached, encs):
        for k in ENC_KEYS:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
            cache_err = max(cache_err, float(np.abs(got[k].astype(np.float32)
                                                    - want[k].astype(np.float32)).max()))
    encode_calls[0] = 0
    for p in paths:
        scene_encodings_cached(model, p, loader)
    hit_calls = encode_calls[0]
    assert hit_calls == 0, hit_calls
    blob = Path(paths[0] + ".enc.npz").read_bytes()
    Path(paths[0] + ".enc.npz").write_bytes(blob[: len(blob) // 3])
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        again = scene_encodings_cached(model, paths[0], loader)
    assert "ignoring unreadable embedding cache" in said.getvalue(), said.getvalue()
    assert encode_calls[0] > 0
    for k in ENC_KEYS:
        assert np.array_equal(again[k], cached[0][k]), k
    assert Path(paths[0] + ".enc.npz").stat().st_size == len(blob)
    del model.encode_frozen  # the counting wrapper
    log(f"encoding caches: {len(paths)} .enc.npz written, each table vs 3b's "
        f"precompute_scene_encodings max|diff| {cache_err:.3e}; second pass: {hit_calls} "
        f"encoder calls; a truncated cache reported and re-encoded ({encode_calls[0]} calls)")

    # the streaming batcher from warm caches: one epoch of fit(fused_steps=4)
    # with a metric writer and a checkpoint, against eager steps on the same
    # batches; an epoch of replays only under the profiler (launches = steps
    # x one eager step's); the cached tables through fit_device (dedup)
    t_s = GNNTrainer(make_model("mm"), clr_cfg, init_state_dict=start_sd)
    stream = StreamingEncodedBatcher(paths, t_s.model, loader, clr["batch_size"], seed=4,
                                     uniform=True)
    stream_steps = len(stream)
    stream_calls = count_calls(t_s.model, "encode_frozen")
    s_losses = record_losses(t_s)
    log_dir_s = Path(store_dir) / "log"
    writer = MetricWriter(str(log_dir_s), tensorboard=False)
    counters(reset=True)
    replays0 = t_s.graph_replays
    (h_s,) = t_s.fit(stream, epochs=1, log_dir=str(log_dir_s), verbose=False, fused_steps=4,
                     writer=writer)
    writer.close()
    c_stream = counters()
    assert stream_calls[0] == 0, stream_calls
    assert t_s.graph_replays - replays0 == stream_steps, (t_s.graph_replays, stream_steps)
    assert c_stream["fwd"] == c_stream["bwd"] == WARMUP_STEPS + 1, c_stream
    assert np.isfinite(h_s["train/loss"]) and len(s_losses) == stream_steps
    records = [json.loads(line) for line in (log_dir_s / "metrics.jsonl").read_text().splitlines()]
    assert len(records) == 1 and records[0]["step"] == 0, records
    assert records[0]["train/loss"] == h_s["train/loss"]
    (ckpt_s,) = log_dir_s.glob("gnn_epoch0_*.pt")
    t_e = GNNTrainer(make_model("mm"), clr_cfg, init_state_dict=start_sd)
    e_losses = [float(t_e.train_step(b)[0]) for b in
                StreamingEncodedBatcher(paths, t_e.model, loader, 2, seed=4, uniform=True).epoch()]
    np.testing.assert_allclose(s_losses, e_losses, rtol=1e-4)
    stream_rel = max_rel_diff(s_losses, e_losses)  # the later epochs add to the list
    stream_diff, stream_at = max_param_diff(t_s, t_e)
    assert stream_diff <= 2 * lr * stream_steps, stream_diff
    del t_e
    counters(reset=True)
    trained_scores = SceneEncodedScorer(t_s.model).score_scenes(scenes, windows_list)
    del t_s.model.encode_frozen
    rep_stream = replayed(t_s, lambda: t_s.fit(stream, epochs=1, verbose=False, fused_steps=4),
                          stream_steps, mm_step)
    log(f"streaming training: StreamingEncodedBatcher (uniform, batch 2) over the stores, "
        f"{stream_steps} steps in groups of 4 from warm caches: 0 encoder calls, "
        f"{stream_steps} graph replays (wrappers: {c_stream['fwd']} launches, the warm-up and "
        f"the capture), loss {h_s['train/loss']:.6f}; step losses vs eager train_steps on the "
        f"same batches: max rel diff {stream_rel:.2e}, max |param "
        f"diff| {stream_diff:.2e} ({stream_at}); metrics.jsonl 1 record; an epoch of "
        f"{stream_steps} replays, no wrapper launch: {rep_stream}")

    pairs_c = [(w, enc) for p, enc in zip(paths, cached) for w in GraphStoreReader(p).windows()
               if w.num_nodes > 0 and w.num_edges > 0]
    t_d, h_d, d_losses = resident("mm", start_sd, materialize_encoded_datasets_dedup(pairs_c))
    assert t_d.graph_replays == steps, (t_d.graph_replays, steps)
    first_dedup = dedup_losses[:steps]  # 3e's first epoch (later ones add to the list)
    np.testing.assert_allclose(d_losses, first_dedup, rtol=1e-4)
    log(f"fit_device dedup from the cached tables: {t_d.graph_replays} replays, loss "
        f"{h_d['train/loss']:.6f}; step losses vs 3e's dedup epoch from the in-memory "
        f"encodings: max rel diff {max_rel_diff(d_losses, first_dedup):.2e}")
    del t_d

    fresh = make_model("mm")
    fresh.load_state_dict(load_checkpoint(str(ckpt_s), map_location="cpu"))
    counters(reset=True)
    ckpt_scores = SceneEncodedScorer(fresh).score_scenes(scenes, windows_list)
    ckpt_launches = counters()["fused_mp"]
    assert ckpt_launches == n_batches, (ckpt_launches, n_batches)
    for a, b in zip((s for ss in ckpt_scores for s in ss),
                    (s for ss in trained_scores for s in ss), strict=True):
        assert np.array_equal(a, b)
    graft = make_model("mm")
    merge_encoder_params(graft, **{n: encoder_variables(model, n) for n in FROZEN_ENCODERS})
    assert _encoder_digest(graft) == _encoder_digest(model)
    enc_model = precompute_scene_encodings(model, scenes[0])
    enc_graft = precompute_scene_encodings(graft, scenes[0])
    for k in ENC_KEYS:
        assert np.array_equal(enc_graft[k], enc_model[k]), k
    del fresh, graft
    phase_3g_s = time.perf_counter() - t_phase
    log(f"checkpoints: {ckpt_s.name} loads into a fresh model, whose score_scenes ({ckpt_launches} "
        f"fused_mp launches) is bit-identical to the trained model's; merge_encoder_params "
        f"grafts the phase-3 encoders (in the JAX layout) into a fresh GNN: encodings "
        f"bit-identical, same digest; phase 3g {phase_3g_s:.1f} s (the flax msgpack decoder "
        "is held to flax on the CPU only: the smoke imports no JAX to write a file)")

    # ---- 3h. encoder training -------------------------------------------
    enc = train_encoders(clr, all_windows)

    # ---- 3i. data parallelism (and its timing, 4g) ---------------------------
    dp = data_parallel(card, pairs, start_sd, clr_cfg, dense_ds, dedup_ds)

    # ---- 4. timing -----------------------------------------------------
    # the first full batch of the (256, 4096) bucket, with the inputs the
    # main path gives the kernel (kept from one more run); plain and kernel
    # in turns
    captured = []

    def keep_inputs(*args, **kw):
        captured.append(args)
        return fused_mp_scores_cuda(*args, **kw)

    fused_mp.fused_mp_scores_cuda = keep_inputs
    scorer.score_scenes(scenes, windows_list)
    fused_mp.fused_mp_scores_cuda = fused_mp_scores_cuda
    timed = {}
    for bucket in ((128, 1024), (256, 4096)):
        args = next(a for a in captured if tuple(a[0].shape[1:2]) == (bucket[0],)
                    and a[1].shape[1] == bucket[1])
        inputs, flat, meta, depth = args[:6], args[6], args[7], args[8]
        _, _, widths = pack_mp_weights(flat, meta, model.node_dim, model.edge_dim, True)
        with torch.inference_mode():
            turns = [cuda_ms(lambda: fused_mp_scores_plain(*args), 5),
                     cuda_ms(lambda: fused_mp_scores_cuda(*args), 20),
                     cuda_ms(lambda: fused_mp_scores_cuda(*args), 20),
                     cuda_ms(lambda: fused_mp_scores_plain(*args), 5)]
        plain_ms, kernel_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        flops, nbytes = mp_work(inputs, widths, depth)
        bound_ms, bound_by = bound(flops, nbytes)
        fp32_ms = bound(flops, nbytes, FP32_PEAK)[0]
        timed[bucket] = (kernel_ms, plain_ms, bound_ms, bound_by)
        log(f"timing fused_mp at {bucket} x{inputs[0].shape[0]} ({int(inputs[-1].sum())} "
            f"valid edges): kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms (turns "
            "plain/kernel/kernel/plain " + "/".join(f"{t:.3f}" for t in turns) + " ms), "
            f"bound {bound_ms:.3f} ms 3xTF32 / {fp32_ms:.3f} ms fp32 ({flops / 1e9:.2f} "
            f"GFLOP, {nbytes / 2**20:.1f} MiB; {bound_by}), "
            f"{flops / (kernel_ms * 1e-3) / 1e12:.2f} TFLOP/s")
        reps = 5
        with torch.inference_mode():
            _, dev_ms, dev_rows = profile_device(
                lambda: [fused_mp_scores_cuda(*args) for _ in range(reps)])
        log(f"  device time per call {dev_ms / reps:.3f} ms; by sub-kernel: "
            + kernel_rows(dev_rows[:8], reps))
    kernel_ms, plain_ms, bound_ms, bound_by = timed[(256, 4096)]
    del captured, args, inputs

    wall_ms, device_ms, rows = profile_device(lambda: scorer.score_scenes(scenes, windows_list))
    noop_profile = (wall_ms, device_ms)
    log(f"profile score_scenes: wall {wall_ms:.2f} ms, device busy {device_ms:.2f} ms "
        f"({100 * device_ms / wall_ms:.1f}%)")
    for us, key, count in rows[:10]:
        log(f"  {us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")

    # ---- 4b. training timing -------------------------------------------
    # the training pair at (256, 4096) x8 on a batch of the training path
    # (inputs from pre_message_passing), forward and backward separately,
    # plain and kernel in turns; then the whole train step, Adam included
    g8, enc8 = next(EncodedGraphBatcher(pairs, 8, uniform=True).epoch(shuffle=False))
    assert tuple(g8.edge_src.shape) == (8, 4096) and g8.pose.shape[1] == 256, g8.pose.shape
    dev8 = trainer._to_device((g8, enc8))
    with torch.no_grad():
        x0, e0, att, _ = trainer.model.pre_message_passing(*dev8[:1], *dev8[1])
    inputs = (x0, e0, att, dev8[0].edge_src, dev8[0].edge_dst, dev8[0].edge_mask)
    leaves = [t.detach().clone().requires_grad_() for t in (x0, e0, att)]
    flat, meta = extract_mp_params(trainer.model, True, 96, 64, trainable=True)
    targets = [*leaves, *flat]
    ct = torch.from_numpy(rng.uniform(-1.0, 1.0, (8, 4096)).astype(np.float32)).cuda()

    def fwd(fn):
        return fn(*leaves, *inputs[3:], flat, meta, 6, False)

    def bwd(out):
        return torch.autograd.grad(out, targets, ct, retain_graph=True)

    out_k, out_p = fwd(fused_mp_train_scores), fwd(fused_mp_scores_plain)
    turns_f = [cuda_ms(lambda: fwd(fused_mp_scores_plain), 3),
               cuda_ms(lambda: fwd(fused_mp_train_scores), 10),
               cuda_ms(lambda: fwd(fused_mp_train_scores), 10),
               cuda_ms(lambda: fwd(fused_mp_scores_plain), 3)]
    turns_b = [cuda_ms(lambda: bwd(out_p), 3), cuda_ms(lambda: bwd(out_k), 10),
               cuda_ms(lambda: bwd(out_k), 10), cuda_ms(lambda: bwd(out_p), 3)]
    del out_k, out_p
    _, _, widths = pack_mp_weights(flat, meta, 96, 64, True)
    f_flops, b_flops, f_bytes, b_bytes = train_work(inputs, widths, 6)
    timed_train = {}
    for tag, turns, flops, nbytes in (("fwd", turns_f, f_flops, f_bytes),
                                      ("bwd", turns_b, b_flops, b_bytes)):
        k_ms, p_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        b_ms, b_by = bound(flops, nbytes)
        timed_train[tag] = (k_ms, p_ms, b_ms, b_by)
        log(f"timing fused_mp_train_{tag} at (256, 4096) x8 ({int(inputs[-1].sum())} valid "
            f"edges): kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms (turns plain/kernel/kernel/"
            "plain " + "/".join(f"{t:.3f}" for t in turns) + f" ms), bound {b_ms:.3f} ms "
            f"3xTF32 / {bound(flops, nbytes, FP32_PEAK)[0]:.3f} ms fp32 ({flops / 1e9:.2f} "
            f"GFLOP, {nbytes / 2**20:.1f} MiB; {b_by}), "
            f"{flops / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s")
    out_k = fwd(fused_mp_train_scores)
    reps = 5
    _, bwd_dev, bwd_rows = profile_device(lambda: [bwd(out_k) for _ in range(reps)])
    del out_k
    log(f"  backward device time per call {bwd_dev / reps:.3f} ms, "
        f"{b_flops / (bwd_dev / reps * 1e-3) / 1e12:.2f} TFLOP/s over the device time; by "
        "sub-kernel: " + kernel_rows(bwd_rows[:8], reps))
    # the stashing forward's device time by sub-kernel, at this batch and at
    # the epoch's own (256, 4096) x2
    g2, enc2 = next(EncodedGraphBatcher(pairs, 2, uniform=True).epoch(shuffle=False))
    dev2 = trainer._to_device((g2, enc2))
    with torch.no_grad():
        x2, e2, att2, _ = trainer.model.pre_message_passing(*dev2[:1], *dev2[1])
    for label, fwd_in in (("x8", inputs), ("x2", (x2, e2, att2, dev2[0].edge_src,
                                                  dev2[0].edge_dst, dev2[0].edge_mask))):
        with torch.no_grad():
            f_ms = cuda_ms(lambda: train_forward_cuda(*fwd_in, flat, meta, 6, False), 10)
            _, f_dev, f_rows = profile_device(
                lambda: [train_forward_cuda(*fwd_in, flat, meta, 6, False) for _ in range(reps)])
        ff, _, fb, _ = train_work(fwd_in, widths, 6)
        log(f"  stashing forward at (256, 4096) {label} ({int(fwd_in[-1].sum())} valid edges): "
            f"{f_ms:.3f} ms by events, device time per call {f_dev / reps:.3f} ms, bound "
            f"{bound(ff, fb)[0]:.3f} ms 3xTF32 / {bound(ff, fb, FP32_PEAK)[0]:.3f} ms fp32; by "
            "sub-kernel: " + kernel_rows(f_rows[:8], reps))
    del x2, e2, att2, dev2
    pair_k = timed_train["fwd"][0] + timed_train["bwd"][0]
    pair_p = timed_train["fwd"][1] + timed_train["bwd"][1]
    pair_b, pair_by = bound(f_flops + b_flops, f_bytes + b_bytes)
    log(f"timing training pair forward+backward at (256, 4096) x8: kernel {pair_k:.3f} ms, "
        f"plain {pair_p:.3f} ms, bound {pair_b:.3f} ms ({pair_by})")
    del inputs, leaves, flat, targets, x0, e0, att

    step8 = GNNTrainer(make_model("mm"), GNNConfig(**dict(clr, batch_size=8)),
                       init_state_dict=start_sd)

    def plain_step():
        with plain_training():
            step8.train_step((g8, enc8))

    turns_s = [cuda_ms(plain_step, 3), cuda_ms(lambda: step8.train_step((g8, enc8)), 5),
               cuda_ms(lambda: step8.train_step((g8, enc8)), 5), cuda_ms(plain_step, 3)]
    log(f"timing train step (Adam included) at (256, 4096) x8: kernel "
        f"{(turns_s[1] + turns_s[2]) / 2:.3f} ms, plain {(turns_s[0] + turns_s[3]) / 2:.3f} ms "
        "(turns plain/kernel/kernel/plain " + "/".join(f"{t:.3f}" for t in turns_s) + " ms)")
    del step8

    t0 = time.perf_counter()
    trainer.train_epoch(train_b)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    log(f"training epoch: {len(train_b)} steps of (256, 4096) x2, {train_edges} valid edges "
        f"in {epoch_s * 1e3:.1f} ms: {train_edges / epoch_s:.0f} training edges/s")
    wall_ms, device_ms, rows = profile_device(lambda: trainer.train_epoch(train_b))
    log(f"profile training epoch: wall {wall_ms:.2f} ms, device busy {device_ms:.2f} ms "
        f"({100 * device_ms / wall_ms:.1f}%)")
    for us, key, count in rows[:12]:
        log(f"  {us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")

    # the four epoch forms over the same 24 steps of (256, 4096) x2, each
    # warm (its graphs captured): host-batched fit, fit_device dense and
    # dedup, and fit with fused_steps=4; the wall time of one epoch ending
    # in a synchronise, then a profiled one (kernels' device time; Adam's
    # kernels summed)
    t4 = GNNTrainer(make_model("mm"), clr_cfg, init_state_dict=start_sd)
    form_b = EncodedGraphBatcher(pairs, 2, seed=0, uniform=True)
    forms = {
        "fit": lambda: t4.fit(form_b, epochs=1, verbose=False),
        "fit_device dense": lambda: t4.fit_device(dense_ds, epochs=1, verbose=False),
        "fit_device dedup": lambda: t4.fit_device(dedup_ds, epochs=1, verbose=False),
        "fit fused_steps=4": lambda: t4.fit(form_b, epochs=1, verbose=False, fused_steps=4),
    }
    for name, run in forms.items():
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        epoch_ms = (time.perf_counter() - t0) * 1e3
        wall_ms, device_ms, rows = profile_device(run)
        adam_ms = sum(us for us, key, _ in rows if "adam" in key.lower()) / 1e3
        log(f"epoch form {name}: {epoch_ms:.2f} ms, {train_edges / (epoch_ms / 1e3):.0f} "
            f"training edges/s; profiled: wall {wall_ms:.2f} ms, device busy {device_ms:.2f} ms "
            f"({100 * device_ms / wall_ms:.1f}%), Adam's kernels {adam_ms:.3f} ms; top: "
            + kernel_rows(rows[:4], 1, 50))
    del t4

    # ---- 4c. the segment-sum kernel and the active paths ------------------
    # the kernel's inputs at the first mm message-passing sum of a (256, 4096)
    # x8 batch of the active main path (past messages by destination, D 128),
    # kept from one more run; plain, kernel and index_add_ in turns
    kept = []

    def keep_segment(data, ids, n, mask=None):
        if not kept and tuple(data.shape) == (8, 4096, 128):
            kept.append((data, ids, n, mask))
        return segment_sum_cuda(data, ids, n, mask)

    segment_kernel.segment_sum_cuda = keep_segment
    scorer_a.score_scenes(scenes, windows_list)
    segment_kernel.segment_sum_cuda = segment_sum_cuda
    (data, ids, n, mask), = kept
    d = data.shape[-1]
    offs = torch.arange(8, device=data.device)[:, None] * (n + 1)

    def library():
        """index_add_ with the masked edges parked in a dropped extra row."""
        parked = (torch.where(mask, ids.long(), n) + offs).reshape(-1)
        out = torch.zeros(8 * (n + 1), d, device=data.device)
        out.index_add_(0, parked, data.reshape(-1, d))
        return out.view(8, n + 1, d)[:, :n]

    kernel_seg = lambda: segment_sum_cuda(data, ids, n, mask)  # noqa: E731
    plain_seg = lambda: segment_sum_plain(data, ids, n, mask)  # noqa: E731
    torch.testing.assert_close(library(), kernel_seg(), rtol=RTOL, atol=ATOL)
    with torch.inference_mode():
        turns = [cuda_ms(plain_seg, 20), cuda_ms(kernel_seg, 50), cuda_ms(library, 50),
                 cuda_ms(library, 50), cuda_ms(kernel_seg, 50), cuda_ms(plain_seg, 20)]
    seg_ms, seg_plain_ms = (turns[1] + turns[4]) / 2, (turns[0] + turns[5]) / 2
    seg_lib_ms = (turns[2] + turns[3]) / 2
    flops, nbytes = segment_work(data, ids, mask, n)
    seg_bound_ms, seg_bound_by = bound(flops, nbytes, FP32_PEAK)
    log(f"timing segment_sum at (256, 4096) x8, D=128 ({int(mask.sum())} valid edges, "
        f"main-path batch, ids {ids.dtype}): kernel {seg_ms:.4f} ms (one launch, no CSR "
        f"outside it), plain {seg_plain_ms:.4f} ms, index_add_ {seg_lib_ms:.4f} ms "
        "(turns plain/kernel/index_add_/index_add_/kernel/plain "
        + "/".join(f"{t:.4f}" for t in turns) + f" ms), bound {seg_bound_ms:.4f} ms "
        f"({nbytes / 2**20:.2f} MiB, {flops / 1e6:.2f} MFLOP; {seg_bound_by}), "
        f"{nbytes / (seg_ms * 1e-3) / 1e9:.1f} GB/s")
    _, dev_ms, seg_rows = profile_device(lambda: [kernel_seg() for _ in range(20)])
    assert all("segment_sum" in key for _, key, _ in seg_rows), seg_rows
    # one launch per call; the profiler may drop a launch, so divide by those it saw
    seg_seen = sum(count for _, _, count in seg_rows)
    _, lib_dev_ms, _ = profile_device(lambda: [library() for _ in range(20)])
    log(f"  device time per call: segment_sum {dev_ms / seg_seen:.4f} ms ({seg_seen} of 20 "
        f"launches traced, {dev_ms:.4f} ms), index_add_ with its staging "
        f"{lib_dev_ms / 20:.4f} ms (over 20 calls)")
    del kept, data, ids, mask

    wall_ms, device_ms, rows = profile_device(
        lambda: scorer_a.score_scenes(scenes, windows_list))
    active_profile = (wall_ms, device_ms)
    log(f"profile active score_scenes: wall {wall_ms:.2f} ms, device busy {device_ms:.2f} ms "
        f"({100 * device_ms / wall_ms:.1f}%)")
    for us, key, count in rows[:12]:
        log(f"  {us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")
    for us, key, count in rows:
        if "segment_sum" in key or "RadixSort" in key:
            log(f"  segment sum and sorts (the kNN graph's stable sort is one per conv): "
                f"{us / 1e3:.3f} ms x{count} {key[:70]}")

    for name, (tk, batch) in active_train.items():
        def plain_step(tk=tk, batch=batch):
            with plain_segment_sum():
                tk.train_step(batch)

        turns_s = [cuda_ms(plain_step, 3), cuda_ms(lambda: tk.train_step(batch), 5),
                   cuda_ms(lambda: tk.train_step(batch), 5), cuda_ms(plain_step, 3)]
        graph = batch[0] if isinstance(batch, tuple) else batch
        log(f"timing active train step {name} (Adam included) at "
            f"{tuple(graph.edge_src.shape)} ({int(graph.edge_mask.sum())} valid edges): "
            f"kernel {(turns_s[1] + turns_s[2]) / 2:.3f} ms, plain segment sum "
            f"{(turns_s[0] + turns_s[3]) / 2:.3f} ms (turns plain/kernel/kernel/plain "
            + "/".join(f"{t:.3f}" for t in turns_s) + " ms)")
    del active_train

    # ---- 4d. the device pipeline ------------------------------------------
    # warm: per-scene dispatches (all four enqueued, then fetched) and the
    # grouped dispatch, each by CUDA events around the whole call and then
    # profiled, beside phase 3/4's score_scenes; the kernel at the
    # pipeline's window grids (one scene, the group) with its bound over
    # the valid edges and over every slot; the active pipeline's group
    def run_singles(p=pipe):
        pend = [p.dispatch_scene(sc) for sc in scenes]
        return [p.finalize_scene(x) for x in pend]

    def run_group(p=pipe):
        with grouping_forced():
            return p.score_scenes(scenes)

    for name, run in (("singles", run_singles), ("grouped", run_group),
                      ("active grouped", lambda: run_group(pipe_a))):
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        run()
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev_ms = start.elapsed_time(end)
        wall_ms, device_ms, rows = profile_device(run)
        log(f"timing device pipeline {name}: {ev_ms:.2f} ms (CUDA events), host {host_ms:.2f} "
            f"ms, {pipe_edges / (ev_ms / 1e3):.0f} valid edges/s; profile wall {wall_ms:.2f} "
            f"ms, device busy {device_ms:.2f} ms ({100 * device_ms / wall_ms:.1f}%), "
            f"{sum(c for _, _, c in rows)} device operations")
        for us, key, count in rows[:10]:
            log(f"  {us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")
    # where the host's time goes: enqueueing the four scenes (no wait)
    # against waiting for their results
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pend = [pipe.dispatch_scene(sc) for sc in scenes]
    t1 = time.perf_counter()
    for x in pend:
        pipe.finalize_scene(x)
    t2 = time.perf_counter()
    log(f"  singles on the host: enqueue {(t1 - t0) * 1e3:.2f} ms for {len(scenes)} scenes, "
        f"then {(t2 - t1) * 1e3:.2f} ms waiting for and unpacking the results")
    log(f"  beside score_scenes (phase 3, the same scenes, bucketed host windows): "
        f"{score_ms:.2f} ms, {n_edges / (score_ms / 1e3):.0f} edges/s, device busy "
        f"{100 * noop_profile[1] / noop_profile[0]:.1f}%; active score_scenes {active_ms:.2f} "
        f"ms, busy {100 * active_profile[1] / active_profile[0]:.1f}%")

    # where grouping pays on this card: per-scene dispatches and one group
    # in turns (singles, group, group, singles; 3 timed runs each) at
    # window 5 (work W * N * E per scene above _GROUP_WORK_CEILING: the
    # group forced) and at window 3 (under it: score_scenes' own group)
    from batch3dmot_tpu_torch.infer.device_pipeline import _GROUP_WORK_CEILING

    pipe3 = DeviceScenePipeline(model, 3, 40)
    route3 = pipe3.dispatch_scenes(scenes)
    assert route3[0] == "group", route3[0]
    group3_diff = max(max_avg_diff(g, pipe3.score_scene(sc))
                      for g, sc in zip(pipe3.finalize_scenes(route3), scenes))
    edges3 = sum(w.num_edges for sc in scenes for w in build_scene_graphs(sc, 3, gc40))
    grouping = {}
    for label, p, forced, n_edges_p in (("window 5", pipe, True, pipe_edges),
                                        ("window 3", pipe3, False, edges3)):
        q = [p._quanta(sc) for sc in scenes]
        work = max(-(-w // 8) * 8 * n_ * n_ * min(40, n_) for _, w, n_ in q)

        def grouped_run(p=p, forced=forced):
            with grouping_forced() if forced else contextlib.nullcontext():
                return p.score_scenes(scenes)

        turns = [cuda_ms(lambda: run_singles(p), 3), cuda_ms(grouped_run, 3),
                 cuda_ms(grouped_run, 3), cuda_ms(lambda: run_singles(p), 3)]
        s_ms, g_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        grouping[label] = dict(work_per_scene=work, singles_ms=s_ms, grouped_ms=g_ms,
                               valid_edges=n_edges_p)
        log(f"grouping at {label}: work W*N*E per scene {work / 1e6:.1f}M (ceiling "
            f"{_GROUP_WORK_CEILING / 1e6:.0f}M), {n_edges_p} valid edges; singles "
            f"{s_ms:.2f} ms, grouped {g_ms:.2f} ms, singles/grouped {s_ms / g_ms:.3f} (turns "
            "singles/grouped/grouped/singles " + "/".join(f"{t:.2f}" for t in turns)
            + f" ms); grouped {n_edges_p / (g_ms / 1e3):.0f} valid edges/s")
    log(f"  window 3: max|grouped - singles| {group3_diff:.3e}")
    del pipe3

    kept_mp = []

    def keep_mp(*args, **kw):
        kept_mp.append(args)
        return fused_mp_scores_cuda(*args, **kw)

    fused_mp.fused_mp_scores_cuda = keep_mp
    try:
        pipe.score_scene(scenes[0])
        run_group()
    finally:
        fused_mp.fused_mp_scores_cuda = fused_mp_scores_cuda
    pipe_kernel = {}
    for label, args in zip(("one scene", "group"), kept_mp):
        inputs, flat, meta, depth = args[:6], args[6], args[7], args[8]
        _, _, widths = pack_mp_weights(flat, meta, model.node_dim, model.edge_dim, True)
        with torch.inference_mode():
            turns = [cuda_ms(lambda: fused_mp_scores_plain(*args), 3),
                     cuda_ms(lambda: fused_mp_scores_cuda(*args), 10),
                     cuda_ms(lambda: fused_mp_scores_cuda(*args), 10),
                     cuda_ms(lambda: fused_mp_scores_plain(*args), 3)]
            _, dev_ms, dev_rows = profile_device(
                lambda: [fused_mp_scores_cuda(*args) for _ in range(5)])
        k_ms, p_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        fv, bv = mp_work(inputs, widths, depth)
        fa, ba = mp_work(inputs, widths, depth, all_slots=True)
        (bv_ms, bv_by), (ba_ms, ba_by) = bound(fv, bv), bound(fa, ba)
        b_, n_, _ = inputs[0].shape
        shape = f"({n_}, {inputs[1].shape[1]}) x{b_}"
        pipe_kernel[label] = (k_ms, dev_ms / 5, p_ms, bv_ms, bv_by, ba_ms, shape)
        log(f"timing fused_mp at the pipeline's {label} grid {shape} ({int(inputs[-1].sum())} "
            f"valid of {inputs[-1].numel()} edge slots): kernel {k_ms:.3f} ms, device time per "
            f"call {dev_ms / 5:.3f} ms, plain {p_ms:.3f} ms (turns plain/kernel/kernel/plain "
            + "/".join(f"{t:.3f}" for t in turns) + f" ms); bound over valid edges "
            f"{bv_ms:.3f} ms ({fv / 1e9:.2f} GFLOP; {bv_by}), over every slot {ba_ms:.3f} ms "
            f"({fa / 1e9:.2f} GFLOP; {ba_by}); by sub-kernel: " + kernel_rows(dev_rows[:6], 5))
    del kept_mp, args, inputs

    # ---- 4e. the store paths ---------------------------------------------
    # host ms to assemble one (256, 4096) x2 batch of two windows of the
    # first store, three ways (the native fill, the numpy reader + to_padded,
    # the in-memory windows + to_padded); the 'noop' PoseGNN's fit epoch from
    # the StoreGraphBatcher and from the in-memory GraphBatcher in turns; the
    # streaming epoch cold (its caches deleted: the scenes are encoded inside
    # the epoch) and warm, beside the EncodedGraphBatcher epoch, in turns
    # (every form fused_steps=4, its graphs captured)
    mn, me = store_b.buckets[0]
    two = [0, 1]
    nat = NativeGraphStore(paths[0])
    reader = GraphStoreReader(paths[0])
    assembly = {
        "native fill": lambda: batch_to_padded_graph(nat.fill_padded_batch(two, mn, me)),
        "numpy reader + to_padded": lambda: batch_graphs(
            [to_padded(reader.window(i), mn, me) for i in two]),
        "in-memory GraphBatcher": lambda: batch_graphs(
            [to_padded(windows_list[0][i], mn, me) for i in two]),
    }
    fill_bytes = sum(a.nbytes for a in nat.fill_padded_batch(two, mn, me).values())
    host_ms = {}
    for name, run in assembly.items():
        run()
        t0 = time.perf_counter()
        for _ in range(20):
            run()
        host_ms[name] = (time.perf_counter() - t0) / 20 * 1e3
    nat.close()
    log(f"timing batch assembly ({mn}, {me}) x2 on the host ({card}): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in host_ms.items())
        + f"; the native fill writes {fill_bytes / 2**20:.2f} MiB")

    def wall_epoch_ms(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    store_run = lambda: t_ps.fit(store_b, epochs=1, verbose=False)  # noqa: E731
    mem_run = lambda: t_pm.fit(mem_b, epochs=1, verbose=False)  # noqa: E731
    store_edges = sum(w.num_edges for w in all_windows)
    turns = [wall_epoch_ms(store_run), wall_epoch_ms(mem_run), wall_epoch_ms(mem_run),
             wall_epoch_ms(store_run)]
    epoch_store, epoch_mem = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    prof_store, prof_mem = profile_device(store_run), profile_device(mem_run)
    store_timing = dict(store_ms=epoch_store, memory_ms=epoch_mem,
                        store_busy=prof_store[1] / prof_store[0],
                        memory_busy=prof_mem[1] / prof_mem[0])
    log(f"timing PoseGNN fit epoch ({len(store_b)} steps of ({mn}, {me}) x2, {store_edges} "
        f"valid edges; {card}): StoreGraphBatcher {epoch_store:.2f} ms, "
        f"{store_edges / (epoch_store / 1e3):.0f} training edges/s, device busy "
        f"{100 * store_timing['store_busy']:.1f}%; in-memory GraphBatcher {epoch_mem:.2f} ms, "
        f"{store_edges / (epoch_mem / 1e3):.0f} training edges/s, device busy "
        f"{100 * store_timing['memory_busy']:.1f}%; store/memory {epoch_store / epoch_mem:.3f} "
        "(turns store/memory/memory/store " + "/".join(f"{t:.2f}" for t in turns) + " ms)")

    # where the two epochs' gap lies: each batcher's epoch of batches
    # assembled on the host alone, then those batches copied to the card
    # alone (as fit's _to_device does), in turns store/memory/memory/store
    def host_epoch_ms(batcher):
        t0 = time.perf_counter()
        batches = list(batcher.epoch())
        assemble = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            b.to("cuda")
        torch.cuda.synchronize()
        return assemble, (time.perf_counter() - t0) * 1e3

    host_turns = [host_epoch_ms(b) for b in (store_b, mem_b, mem_b, store_b)]
    host_epoch = {name: [(host_turns[i][j] + host_turns[3 - i][j]) / 2 for j in range(2)]
                  for i, name in enumerate(("store", "memory"))}
    store_timing.update(host_epoch_ms=host_epoch)
    log(f"timing PoseGNN epoch's host side ({len(store_b)} batches; {card}): assembled "
        f"alone StoreGraphBatcher {host_epoch['store'][0]:.2f} ms, in-memory GraphBatcher "
        f"{host_epoch['memory'][0]:.2f} ms; copied to the card alone "
        f"{host_epoch['store'][1]:.2f} ms and {host_epoch['memory'][1]:.2f} ms; of the epochs' "
        f"gap {epoch_mem - epoch_store:.2f} ms these explain "
        f"{sum(host_epoch['memory']) - sum(host_epoch['store']):.2f} ms")

    t_form = GNNTrainer(make_model("mm"), clr_cfg, init_state_dict=start_sd)
    enc_b = EncodedGraphBatcher(pairs, 2, seed=0, uniform=True)
    warm_run = lambda: t_s.fit(stream, epochs=1, verbose=False, fused_steps=4)  # noqa: E731
    enc_run = lambda: t_form.fit(enc_b, epochs=1, verbose=False, fused_steps=4)  # noqa: E731
    enc_run()  # capture
    for p in paths:
        Path(p + ".enc.npz").unlink()
    cold_calls = count_calls(t_s.model, "encode_frozen")
    cold_ms = wall_epoch_ms(warm_run)
    del t_s.model.encode_frozen
    assert cold_calls[0] > 0 and all(Path(p + ".enc.npz").exists() for p in paths)
    turns = [wall_epoch_ms(warm_run), wall_epoch_ms(enc_run), wall_epoch_ms(enc_run),
             wall_epoch_ms(warm_run)]
    warm_ms, enc_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    prof_warm, prof_enc = profile_device(warm_run), profile_device(enc_run)
    store_timing.update(stream_cold_ms=cold_ms, stream_warm_ms=warm_ms, encoded_ms=enc_ms,
                        stream_busy=prof_warm[1] / prof_warm[0],
                        encoded_busy=prof_enc[1] / prof_enc[0],
                        assembly_ms=host_ms, fill_bytes=fill_bytes)
    log(f"timing streaming epoch fused_steps=4 ({stream_steps} steps, {train_edges} valid "
        f"edges; {card}): cold {cold_ms:.2f} ms ({cold_calls[0]} encoder calls), warm "
        f"{warm_ms:.2f} ms, {train_edges / (warm_ms / 1e3):.0f} training edges/s, device busy "
        f"{100 * store_timing['stream_busy']:.1f}%; EncodedGraphBatcher {enc_ms:.2f} ms, "
        f"{train_edges / (enc_ms / 1e3):.0f} training edges/s, device busy "
        f"{100 * store_timing['encoded_busy']:.1f}%; warm/encoded {warm_ms / enc_ms:.3f} "
        "(turns warm/encoded/encoded/warm " + "/".join(f"{t:.2f}" for t in turns) + " ms)")
    del t_s, t_form, t_ps, t_pm
    store_tmp.cleanup()

    # ---- 4f. encoder training timing ---------------------------------------
    enc_timing = time_encoders(card, enc)

    kernels = [dict(
        name="fused_mp", route="cuda",
        source="batch3dmot_tpu_torch/csrc/fused_mp.cu",
        replaces="batch3dmot_tpu/ops/pallas_mp.py:228 (+:313 tiled, :433 hbm)",
        launches=launches["fused_mp"], max_abs_err=max_err,
        ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None,
        # the device pipeline (3f, 4d): launches of its per-scene and grouped
        # runs, and the kernel at the group's window grid
        device_pipeline=dict(
            launches=single_launches, grouped_launches=group_launches,
            grid=pipe_kernel["group"][6], ms=pipe_kernel["group"][0],
            plain_ms=pipe_kernel["group"][2], bound_ms=pipe_kernel["group"][3],
            bound_by=pipe_kernel["group"][4], bound_all_slots_ms=pipe_kernel["group"][5],
            grouping=grouping),
        # 3g: scoring the epoch checkpoint loaded from disk
        store_path=dict(launches=ckpt_launches),
    )]
    for tag, src_file, replaces, err in (
        ("fwd", "batch3dmot_tpu_torch/csrc/fused_mp.cu",
         "batch3dmot_tpu/ops/pallas_mp_train.py:265 (+:523 tiled)", fwd_err),
        ("bwd", "batch3dmot_tpu_torch/csrc/fused_mp_train.cu",
         "batch3dmot_tpu/ops/pallas_mp_train.py:295 (+:680 tiled)", bwd_err),
    ):
        k_ms, p_ms, b_ms, b_by = timed_train[tag]
        kernels.append(dict(
            name=f"fused_mp_train_{tag}", route="cuda", source=src_file,
            replaces=replaces, launches=train_launches[f"fused_mp_train_{tag}"],
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None,
            # 3g: eager launches of the store-fed pose epoch and the 3 raw
            # store steps; the streaming and fit_device epochs' steps are
            # graph replays (the streaming one traced: steps x one eager
            # step's kernels); 4e's timings of the store paths, once
            store_path=dict(launches=c_store[tag] + c_raw[tag], streaming_replays=stream_steps,
                            fit_device_replays=steps,
                            **(dict(timing=store_timing) if tag == "fwd" else {})),
        ))
    kernels.append(dict(
        name="segment_sum", route="cuda", source="batch3dmot_tpu_torch/csrc/segment_sum.cu",
        replaces="batch3dmot_tpu/ops/pallas_segment.py:29 (via :56)",
        launches=active_launches, max_abs_err=seg_err, ms=seg_ms, plain_ms=seg_plain_ms,
        bound_ms=seg_bound_ms, bound_by=seg_bound_by, library_ms=seg_lib_ms,
        device_pipeline=dict(launches=act_single_launches,
                             grouped_launches=act_group_launches),
        # the store paths train and score 'noop' models: no segment sum
        store_path=dict(launches=0),
    ))
    # 3i: each kernel's launches per rank of the two gloo ranks' dry run,
    # and in 3i (a), the NCCL rank's runs alone and the mesh-free ones held
    # against them (the warm-up steps and the captures: the replays run
    # without the wrappers); 4g's timing once
    for k, key in zip(kernels, ("fused_mp", "fwd", "bwd", "segment_sum")):
        k["dp"] = dict(rank_launches=[r[key] for r in dp["ranks"]],
                       phase_3i_a_launches=dp["one_rank"]["launches"][key],
                       phase_3i_a_mesh_free_launches=dp["one_rank"]["mesh_free"][key],
                       **(dict(one_rank=dp["one_rank"]["runs"], timing=dp["timing"])
                          if key == "fwd" else {}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"encoders": enc_timing, "card": card}))
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
