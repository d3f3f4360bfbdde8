#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``batch3dmot_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build: every CUDA source of the port from ``batch3dmot_tpu_torch/csrc``
     (one ``nvcc`` per source, started together);
  1b. the tensor cores' arithmetic (``scripts/probe_tc_rounding.py``): how
     one ``mma.sync.m16n8k8`` and one ``wgmma.m64n16k8`` round the sums
     they accumulate (the models of the adder that give every crafted
     output), and one product through each of the kernels' product
     routines (``tc_gemm``, ``wg_gemm``) against float64, within F64_RATIO
     of the float32 matmul's distance, product and sums of 40 rows, while
     the float32 matmul with TF32 allowed must fall outside;
  2. kernels: the inference kernel against its plain PyTorch version on the
     card, on inputs made from a numpy seed, at the shapes the main path
     gives it and beyond (up to the largest bucket, and the device
     pipeline's windows up to (1024, 40960); 3l takes the cover's
     (2560, 102400)), scores and logits compared on valid edges
     (``held_to_plain``: RTOL, ATOL, and where float32 itself cannot hold
     them, a float64 run of the plain version decides), and bit-identical
     across two runs; at F64_CASES' shapes the logits' largest distance
     from float64 within F64_RATIO of the float32 plain version's;
  2b. the training pair (the stashing forward and the hand-written
     backward) against autograd of the plain version (``training_pair_
     checks``) through the logits (on init_params_'s draw random inputs
     saturate the sigmoid, whose gradient is then 0), six cases: logits
     and the stashes x_t, e_t, agg_t (``held_to_plain``); dx0, de0, datt
     and every weight gradient under a random
     cotangent, zero on masked edges as the masked loss gives it (the
     backward then skips each window's tail) at the main path's (256,
     4096) x8 and three more cases, non-zero on every edge in two; at
     F64_CASES' shapes (ROADMAP C.5) the logits and each stash within
     F64_RATIO of the float32 plain version's largest distance from
     float64, the plain version with TF32 matmuls allowed failing that
     (the control), and each gradient's RMS distance from float64 printed
     beside float32's; the gradients against
     the plain version's own branches (a reading: a tensor with ReLU-tie
     outliers is held to a relative L2 error of MAX_REL_L2) and against it
     replaying the float64 masks of the kernel's stashes (a reading); then
     the checks, under the ReLU masks the backward kernel itself took (its
     debug mask output, ``fused_mp_train_masks``): (a) every mask that
     differs from the float64 sign lies within RELU_TAU (a derived bound
     of the 3xTF32 recompute's error) of zero, counted per case; (b) the
     plain version replaying them gives every gradient tensor at
     GRAD_RTOL, GRAD_ATOL x max|plain| element by element, no L2 escape;
     (c) a control, one unit flipped (the largest |z64| of layer 3's c1,
     the combine's first hidden layer, on a node a valid edge touches),
     must fail both; (d) the backward
     with the mask buffer gives the training path's gradients bit for bit
     (it runs every row, so under a masked cotangent this holds the
     training path's skip of the tail), and the training path twice too;
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
     full-width depth-6 ``MultimodalGNN`` of seeded random weights
     (``init_params_``, as every model here); its scores are held against
     the plain version (``held_to_plain``, as every kernel-against-plain
     comparison of scores below: RTOL, ATOL, and past them the replaced
     function in float64 inside the same path decides); the kernel's
     launch counter must show that the path went through it; then a
     ``'noop'`` ``PoseGNN`` through ``make_scorer``/``score_windows`` over
     the same windows (the windows path, ``fused_logits_pose``): one launch
     per window batch, scores held against the plain version;
  3b. training path: the same scenes' encodings (``precompute_scene_encodings``)
     and one epoch of ``GNNTrainer.fit`` of a full-width depth-6
     ``MultimodalGNN`` with the ``configs/clr.yaml`` GNN settings from an
     ``EncodedGraphBatcher``; the training pair's launch counters must
     equal the steps, the frozen encoders must not move, the epoch
     checkpoint must load into a fresh model; on one fixed batch, 3 steps
     through the kernels and 3 through the plain version give the same
     losses, and 10 more steps lower the loss (at STEP_LR); 3 ``train_step``s on raw
     window batches (crops, points, radar; the frozen encoders inside the
     step) give the losses of the same steps from the encodings;
  3c. active inference: the same workload through ``score_scenes``,
     ``predict_scenes``, tracks and AMOTA with a full-width depth-6
     ``MultimodalGNN(knn_conv_mode='active')``, then an active ``PoseGNN``
     through ``make_scorer``; 18 segment-sum launches per forward; scores
     held against the same path with the plain segment sum where both
     picked the same kNN graphs (a window whose graphs differ must show a
     near-tie at the k-th neighbour; they are counted), and on every window
     with the kernel run's kNN graphs replayed in the plain run (the
     witness: segment sums in float64, the kNN graphs replayed);
  3d. active training: ``GNNTrainer`` steps for ``mm`` from encodings and
     ``pose`` from window batches; every gather's backward is a segment
     sum (``gather_rows``): launches per step exactly
     ``active_step_launches`` (mm 38, pose 36: 18 forward segment sums and
     one per gather in the backward); a second run of the 4 steps from the
     same state gives bit-identical parameters and Adam moments (the same
     two runs through ``torch.gather``'s atomic backward printed beside);
     frozen encoders unchanged, 3 steps through the kernel and 3 through
     the plain version agree, 10 more lower the loss;
  3e. device-resident training on the same 48 windows and encodings: one
     epoch of ``fit_device`` (each step a replay of one captured CUDA graph)
     against host ``train_step``s on the same index rows, loss by loss; the
     dedup form against the dense one (the gathered batches bit-identical);
     ``fused_steps=4`` against eager steps, with one host wait per group;
     the ``'noop'`` ``PoseGNN`` through ``fit`` and ``fit_device``; the
     active ``mm`` through ``fit_device`` (38 segment sums per step) against
     eager steps, a second epoch from the same start bit-identical, and an
     epoch under ``use_deterministic_algorithms(True, warn_only=True)``
     with no op that torch flags; for each graphed path an epoch of replays alone, traced
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
     uploads (``point_dtype``) against float32 ones; then the same
     comparisons (host path, plain version, grouped, predicted edges at
     near-ties) on ``responsive_model`` of the phase-3 model, whose scores
     move with the embeddings (their quantiles printed), with controls
     that must fail: camera and lidar features zeroed put averaged edges
     outside RTOL, ATOL; the radar features held at the encoding level
     (the pipeline's against the scorer's), zeroed ones outside; the
     active model's pipeline (18 segment sums per forward) against the
     plain segment sum with its kNN graphs replayed; scoring from 3b's
     precomputed encodings (float32 and float16 transport) against the
     raw encode;
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
     call, the active paths' edges/s, profile and train step (also beside
     the same step through ``torch.gather``'s atomic backward, in turns); (4d) the
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
     against the same runs without a mesh (losses and parameters at
     ``RTOL, ATOL``; two mesh-free runs bit-identical; the ops torch
     itself calls nondeterministic in an epoch listed; the kernels
     launched by the mesh run alone counted); (b) two gloo ranks sharing the card (``python -m
     batch3dmot_tpu_torch.parallel.dryrun 2 --device cuda``: a sharded
     ``mm`` train step in each kNN-conv mode, sharded ``PoseGNN`` and dedup
     ``fit_device`` epochs, grouped pipeline inference, cached-embedding
     scoring and a ResNet ``fit_device`` epoch): every kernel launched on
     each rank, parameters and one-step gradients bit-identical across the
     ranks, losses, trained states, one-step gradients and scores against
     the same paths in this process at ``RTOL, ATOL``; (4g) the
     ``fit_device`` dense epoch with and without ``make_mesh(1)`` in turns;
  3j. the CLI (``batch3dmot_tpu_torch.cli.main``, in this process, no
     ``--config``, ``--set`` overrides for the ``bench.py`` workload, the
     default ``Config``'s full-width depth-6 mm): ``build-graphs
     --synthetic 4``, ``train-gnn --model mm --encoded`` (the automatic
     device-resident dataset), ``predict --pipeline encoded`` (cached
     embeddings; raw encode at float32 points) and ``--pipeline device``,
     ``eval``, ``train-gnn --model pose --fused-steps 4``, ``demo``: each
     call's kernel launches at their exact expected counts, the encoded
     averages against ``predict_scenes`` on the same checkpoint and scenes
     at ``RTOL, ATOL`` (predicted edges, submission and AMOTA equal but at
     near-ties of the two paths' averages, counted), the device pipeline
     against the encoded predict the same way; then the same on
     ``responsive_model`` of the trained checkpoint, written as a port
     ``.pt`` checkpoint (predict encoded and device through ``cli.main``,
     launches counted; the score quantiles printed), with a lidar-zeroed
     control through the API that must fall outside; (4h) each call's wall time,
     predict's rate lines, and the train-gnn epoch beside a ``fit_device``
     epoch of the same dataset through the Python API, in turns;
  3k. the nuScenes data plane through the CLI (in this process, ``--set``
     overrides only) on a v1.0-trainval-shaped tree written from a seed
     without PIL (``write_nuscenes_tree``: 2 scenes of 40 keyframes, one
     train and one val by a splits JSON; about 25 annotated objects per
     keyframe in all 7 tracking classes plus non-tracking ones; six
     cameras with placeholder images; LIDAR_TOP at 34,720 points and five
     18-field radars, chained so that 10 and 6 sweeps are full; a
     Megvii-format detector at about 1.3x GT): ``validate-data --strict``,
     ``preprocess --modality all`` (a second run byte-identical,
     ``--skip-existing`` writing nothing, every lidar artifact inside its
     box), ``train-pointnet`` and ``train-radarnet --device-dataset``,
     ``build-graphs`` (train and val; GT matches and positive edges in every
     class present), ``train-gnn --model mm --encoded`` with both encoders
     grafted, ``predict --pipeline encoded`` and ``device`` on the val split
     (held to each other as in 3j), ``export-gt``, ``eval``, ``eval
     --devkit`` (exits with the devkit message); each call's kernel
     launches at their exact count; then (``nuscenes_model_checks``), for
     train-gnn's checkpoint and for a model whose scores move with the
     embeddings (``responsive_model``; lidar-zeroed features put edges
     outside the tolerance), the val store's windows through the kernel
     against the plain version, one train-store batch through the training
     pair against autograd of the plain version, the device pipeline on
     the scene it loaded from the tree (equal to the store's) against the
     encoded scorer, encodings and averages, and the ``bfloat16`` encode
     against its definition (point encoders in float32 on bf16-rounded
     weights and inputs; an unrounded control outside), scores within 0.06
     of float32; (4i) each call's wall time, preprocess annotations/s per
     modality, the lidar and radar preprocessors with and without the
     last-sample memo in turns, build-graphs detections/s by stage,
     predict's rate lines, the float32 and bfloat16 encodes in turns;
  3l. training from scratch (``flagship_phase``): seed 0 of
     ``scripts/torch_flagship_error_bar.py``'s defaults (the full-width
     depth-6 mm from ``init_params_``, 80 epochs of ``fit_device`` on 12
     synthetic scenes, 30 held-out scenes through the encode-once scorer)
     in this process, its kernel launches counted, AMOTA at least
     FLAGSHIP_MIN_AMOTA (printed beside the JAX package's 0.9865 +-
     0.0004); the inference kernel at its widened cover (2560, 102400) x1
     against its plain version (a dense nuScenes window: 500 boxes a frame,
     window 5, kNN 40), a shape past it refused; a dense synthetic scene
     (windows of more than 1,024 nodes) through the device pipeline with
     the trained model against its module loop (``fused=False``).

Prints an ``{"encoders": [...]}`` line (4f's timings and 3h's checks),
the card's name and power limit, a ``{"kernels": [...]}`` line (the
backward's entry with 2b's mask readings, the segment sum's with the
active training launches per step, reruns and step times) and, last,
``{"ok": true, "device": {...}}``. Exits non-zero, without the last
line, when there is no CUDA device or any phase fails. The AMOTA and AP it
prints come from random or barely trained weights.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
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
# Where a kernel's output falls outside RTOL, ATOL of its float32 plain
# version, the plain version in float64 decides (``held_to_plain``):
# float32 cannot hold RTOL, ATOL where sums of large terms cancel
# (init_params_'s draw preserves variance, and six layers of degree-40
# sums of random features reach 1e3-1e5). The kernel's distance from
# float64 may then exceed RTOL |f64| + ATOL by at most WITNESS_C times the
# float32 plain version's largest distance over the same feature row (a
# node's or an edge's state: its terms are of one size) or, for scores,
# over the tensor. WITNESS_C is the kernels' arithmetic against float32's:
# a 3xTF32 product is off by up to 3 x 2^-22 of itself (each operand's
# small part keeps 11 bits of its residual, and the small x small product
# is dropped), 12 times a float32 product's 2^-24; the sums round to
# nearest as float32's do (csrc/tc_gemm.cuh), so they add nothing to it
WITNESS_C = 12.0
# ROADMAP C.5's check (2b at F64_CASES): max |kernel - f64| within
# F64_RATIO times max |float32 plain - f64| over each of the logits (on
# valid edges) and the stashes x_t, e_t, agg_t: the kernels at float32's
# distance from float64. The plain version with TF32 matmuls allowed is
# held to it too and must fail it (the control)
F64_CASES = (("mm", (1024, 32768), 1), ("mm", (64, 512), 8))
F64_RATIO = 2.0
# 4i times the lidar and radar preprocessors with and without the port's
# last-sample memo on this many image annotations of the 3k tree
MEMO_TIME_ANNS = 100
# 3k's responsive model: its GNN weights at this many times init_params_'s
# draw (flax's: lecun-normal kernels, zero biases). The torch-style draw
# the port had before needed 1.75 at a third of this draw's variance (1.0
# gave nearly constant scores); this draw has that variance at 1.0, and
# 1.25 leaves a margin. 3k's lidar control prints how many edges it puts
# outside RTOL, ATOL
RESPONSIVE_GAIN = 1.25
# 3f's and 3j's: the bench.py workload's windows (40 tracks, kNN 40) pass
# each node's sensor features to more edges, whose averages dilute them.
# The old draw needed 3.0 there; this draw's gain of equal variance is 3.0
# / sqrt(3) ~ 1.75 (3f's camera and lidar controls and 3j's lidar control
# print the edges they put outside)
DENSE_RESPONSIVE_GAIN = 1.75
# the encoders a GNN holds (frozen in training), kept by responsive_model
FROZEN_NAMES = ("resnet", "pointnet", "radarnet")
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
# the one-batch training steps of 3b, 3d and 3e (the kernels against the
# plain version, then 10 more that must lower the loss) and 3e's 'noop'
# PoseGNN: configs/clr.yaml's GNN lr. The JAX package's descent tests take
# 1e-3 on kNN-8 windows; on the bench.py workload's kNN-40 windows flax's
# draw diverges there (one step took 3b's loss from 0.648 to 3.887, ten
# more left it at 0.905), as scripts/flagship_synthetic.py notes for
# trainval density
STEP_LR = 1e-4
MAX_REL_L2 = 1e-2
# 2b (a): how far from zero a ReLU unit's pre-activation z may lie when the
# training backward's mask for it differs from the float64 sign, as a share
# of the unit's scale sum_k |w_k a_k| + |b| (relu_preactivations_from_
# stashes; a recomputed hidden input's own scale in place of |a_k|). A bound
# of |z32 - z64| from the kernel's arithmetic, not a fit:
#  * operand split (tc_gemm.cuh): big = tf32(x) and small = tf32(x - big),
#    each rounded to nearest, leave |x - big - small| <= 2^-22 |x|; the
#    three TF32 products drop small*small and those residues: at most
#    3 * 2^-22 |w a| per product;
#  * a product of two TF32 values is exact in f32; the f32 sums (the
#    tensor cores' steps, each cut toward zero with 2 bits kept below the
#    result's unit, scripts/probe_tc_rounding.py, and rounded to nearest
#    through half a unit, then added to a register sum to nearest; the fp32
#    block_gemm of the classifier and of the node projections; the
#    epilogue's bias and projection adds) are bounded as if each of their
#    n addends were added with its own rounding of up to two units of
#    2^-23: at most n 2^-22 of the sum of the addends' magnitudes, which is
#    (1 + 2^-9) sum |w a| with the split parts; n <= 3 x 256 + 4 = 772 (K
#    at most 256: h2 and c1; three addends per TF32 product; the half unit
#    and the step's big*big sum it comes from add no addend);
#  * so one layer on stashed inputs: TAU_LAYER; a layer on a recomputed
#    hidden layer adds that layer's error through |w| (ReLU is 1-Lipschitz),
#    and the deepest chain is three layers (the classifier's a3), hence
#    3 TAU_LAYER (1 + TAU_LAYER).
TAU_LAYER = 772 * 2.0 ** -22 * (1 + 2.0 ** -9) + 3 * 2.0 ** -22
RELU_TAU = 3 * TAU_LAYER * (1 + TAU_LAYER)
# kNN graphs of two runs may differ only where the k-th and (k+1)-th
# neighbour distances lie within this relative gap (f32 summation orders)
NEAR_TIE = 1e-4
FP32_PEAK = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores
# H100 SXM TF32 tensor-core FLOP/s; a float32-accurate product needs the
# three TF32 products of 3xTF32, so its peak is TF32_PEAK / 3. The kernels
# run the big*big products once more per step to round the step's sum to
# nearest (csrc/tc_gemm.cuh): that is the design's cost, and it shows in
# their times, not in the bound
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


# 2b's cases: (model, (N, E), windows, all-padding windows at the end,
# cotangent masked as the masked loss gives it: zero on masked edges, so the
# backward skips each window's tail; unmasked, it is non-zero on every edge
# and the live extent covers every row)
TRAIN_CASES = [
    ("mm", (64, 512), 8, 0, False),
    ("mm", (256, 4096), 8, 0, True),  # the main path's bucket and batch
    ("mm", (512, 4096), 2, 0, True),
    ("pose", (128, 1024), 8, 0, True),
    ("mm", (1024, 32768), 1, 0, False),
    ("mm", (64, 512), 2, 1, True),  # the second window is all padding
]


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
    3xTF32 tensor-core rate, the least a float32-accurate product on the
    tensor cores needs, unless given) and bytes over the memory rate."""
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


def fused_mp_plain64(x0, e0, att, src, dst, edge_mask, flat, meta, depth, logits=False,
                     carries=False):
    """The plain message-passing version in float64 on float32 arguments
    (features and weights cast up): ``held_to_plain``'s witness."""
    from batch3dmot_tpu_torch.ops.fused_mp import fused_mp_scores_plain

    def up(t):
        return None if t is None else t.double()

    return fused_mp_scores_plain(up(x0), up(e0), up(att), src, dst, edge_mask,
                                 [w.double() for w in flat], meta, depth, logits=logits,
                                 carries=carries)


def as_f64(x):
    """A float64 tensor of a tensor, an array or a list of arrays (their
    elements in order)."""
    import torch

    if isinstance(x, (list, tuple)):
        x = np.concatenate([np.ravel(a) for a in x]) if len(x) else np.zeros(0)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.astype(np.float64))
    return x.detach().double()


def held_to_plain(got, ref, ref64_fn, what, rows=False, rtol=RTOL, atol=ATOL):
    """Holds a kernel's output ``got`` to its float32 plain version ``ref``
    (tensors, arrays or lists of arrays, alike) at ``rtol``, ``atol``
    element by element. Where elements fall outside, ``ref64_fn()`` (the
    plain version in float64 on the same inputs) decides: |got - f64| may
    exceed rtol |f64| + atol by at most WITNESS_C times the largest
    |ref - f64| over the element's row (the last axis, with ``rows``:
    feature rows) or over the tensor; the readings are printed. Returns
    max |got - ref| and None, or the reading (elements outside,
    max |got - f64|, max |ref - f64|, the kernel's largest excess in units
    of that float32 distance)."""
    got, ref = as_f64(got), as_f64(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    diff = (got - ref).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    outside = int((diff > rtol * ref.abs() + atol).sum())
    if outside == 0:
        return err, None
    r64 = as_f64(ref64_fn()).to(got.device)
    d_kernel, d_plain = (got - r64).abs(), (ref - r64).abs()
    scale = d_plain.amax(-1, keepdim=True) if rows else d_plain.max()
    excess = (d_kernel - rtol * r64.abs() - atol).clamp_min(0.0)
    units = float((excess / scale.clamp_min(1e-30)).max())
    beyond = int((excess > WITNESS_C * scale).sum())
    reading = (outside, float(d_kernel.max()), float(d_plain.max()), units)
    log(f"{what}: {outside} of {got.numel()} elements outside rtol {rtol:g}, atol {atol:g} "
        f"of the float32 plain version; against float64 max|kernel-f64| {reading[1]:.3e}, "
        f"max|plain-f64| {reading[2]:.3e}, the kernel's largest excess over the tolerance "
        f"{units:.3f}x "
        f"the float32 plain version's distance over its {'row' if rows else 'tensor'} "
        f"(held within {WITNESS_C:g}x)")
    assert beyond == 0, (what, "the kernel is further from float64 than the float32 plain "
                         "version allows", beyond, reading)
    return err, reading


def compare_grads(got, ref, ref64_fn, what, branches_fn=None):
    """Holds every gradient tensor at the gradient tolerance (see
    MAX_REL_L2). Past it float64 decides, as in held_to_plain: the
    kernel's RMS distance from float64 must be within WITNESS_C times the
    float32 plain version's; or else, with ``branches_fn`` (the plain
    version's gradients under the kernel's own ReLU masks), the tensor
    must be those element by element (the kernel took other ReLU branches
    than the float32 plain version, where its forward, held to float64,
    crossed zero). Returns max |got - ref| and, for the tensors with
    elements outside the tolerance, (name, outside, size, relative L2
    error, RMS of kernel - float64, RMS of f32 plain - float64)."""
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    worst, tied, ref64, branches = 0.0, [], None, None
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
        rk, rp = rms64(g, ref64[k]), rms64(r, ref64[k])
        tied.append((k, outside, r.numel(), rel_l2, rk, rp))
        if rel_l2 <= MAX_REL_L2 or rk <= WITNESS_C * rp:
            continue
        assert branches_fn is not None, (what, k, rel_l2, rk, rp)
        if branches is None:
            branches = branches_fn()
        b = branches[k]
        off = int(((g - b).abs() > GRAD_ATOL * float(b.abs().max()) + GRAD_RTOL * b.abs()).sum())
        log(f"{what} {k}: relative L2 {rel_l2:.3e} from the float32 plain version's own "
            f"branches, RMS from float64 kernel {rk:.3e}, f32 plain {rp:.3e}; under "
            f"the kernel's own ReLU masks {off} elements outside")
        assert off == 0, (what, k, rel_l2, rk, rp, off)
    return worst, tied


def f64_distances(got, ref, ref64):
    """max |got - f64|, max |ref - f64| and their ratio."""
    r64 = as_f64(ref64)
    d_k = float((as_f64(got) - r64).abs().max())
    d_p = float((as_f64(ref) - r64).abs().max())
    return d_k, d_p, d_k / d_p if d_p > 0 else (0.0 if d_k == 0 else float("inf"))


def f64_check(case, outs, plain, tf32, ref64, mask):
    """ROADMAP C.5's check on an F64_CASES case: for the logits (valid
    edges) and the stashes x_t, e_t, agg_t, the kernel's largest distance
    from float64 within F64_RATIO times the float32 plain version's; the
    plain version with TF32 matmuls allowed (``tf32``, the control) must
    fail it. Returns the readings."""
    rows = {}
    for i, what in enumerate(("logits", "x_t", "e_t", "agg_t")):
        sel = (lambda t: t[mask]) if i == 0 else (lambda t: t)  # noqa: E731
        d_k, d_p, ratio = f64_distances(sel(outs[i]), sel(plain[i]), sel(ref64[i]))
        d_c, _, c_ratio = f64_distances(sel(tf32[i]), sel(plain[i]), sel(ref64[i]))
        rows[what] = dict(kernel=d_k, plain=d_p, ratio=ratio, tf32=d_c, tf32_ratio=c_ratio)
        log(f"2b {case} {what} against float64: max|kernel-f64| {d_k:.3e}, max|plain32-f64| "
            f"{d_p:.3e}, ratio {ratio:.3f} (held to {F64_RATIO:g}); control, TF32 matmuls "
            f"allowed: {d_c:.3e}, ratio {c_ratio:.1f}")
    bad = {w: r["ratio"] for w, r in rows.items() if not r["ratio"] <= F64_RATIO}
    assert not bad, (case, "further from float64 than F64_RATIO x float32's distance", bad)
    assert any(r["tf32_ratio"] > F64_RATIO for r in rows.values()), (
        case, "the control (TF32 matmuls allowed) passes the float64 check", rows)
    return rows


def rms64(a, r64):
    """RMS of a tensor's distance from its float64 run."""
    return float(((a.double() - r64) ** 2).mean().sqrt())


def grad_rms64(got, ref, ref64):
    """Per gradient tensor: RMS of the kernel's and of the float32 plain
    version's distance from float64, and their ratio."""
    out = {}
    for k, r64 in ref64.items():
        rk, rp = rms64(got[k], r64), rms64(ref[k], r64)
        out[k] = (rk, rp, rk / rp if rp > 0 else (0.0 if rk == 0 else float("inf")))
    return out


def relu_mask_units(masks, pre64):
    """2b (a): the units where ``masks`` differ from the float64 signs of
    ``pre64`` (``relu_preactivations_from_stashes``), and of those the ones
    whose |z64| exceeds RELU_TAU times their scale."""
    differ = beyond = 0
    for m, (z, scale) in zip(masks, pre64):
        d = m != (z > 0)
        differ += int(d.sum())
        beyond += int((d & (z.abs() > RELU_TAU * scale)).sum())
    return differ, beyond


def grads_outside(got, ref):
    """2b (b): every gradient tensor element by element at GRAD_RTOL and
    GRAD_ATOL x max|ref| of the tensor, no relative-L2 escape. Returns
    (elements outside, max |got - ref|)."""
    assert set(got) == set(ref), set(got) ^ set(ref)
    outside, worst = 0, 0.0
    for k, r in ref.items():
        diff = (got[k] - r).abs()
        worst = max(worst, float(diff.max()))
        outside += int((diff > GRAD_ATOL * float(r.abs().max()) + GRAD_RTOL * r.abs()).sum())
    return outside, worst


def control_seen(case, beyond, outside, err, z64):
    """2b (c): checks (a) and (b) must both reject the flipped unit."""
    assert beyond > 0, (case, "check (a) accepts the flipped unit", z64)
    assert outside > 0, (case, "check (b) accepts the flipped unit", err, z64)


def training_pair_checks(models, rng):
    """Phase 2b: the training pair (B4-B7) against autograd of the plain
    version on random inputs through the logits (on init_params_'s draw
    such inputs saturate mm's sigmoid, every valid score at (1024, 32768),
    and a gradient through a saturated sigmoid is 0: the sigmoid's step is
    held by 3b's and 3k's batches), case by case (TRAIN_CASES): the logits
    and stashes (``held_to_plain``); the gradients against the plain version's own
    branches (compare_grads, with its relative-L2 escape: a reading) and
    against it replaying the float64 masks of the kernel's stashes (a
    reading); then under the backward kernel's own ReLU masks
    (``fused_mp_train_masks``): (a) every mask it took that differs from
    the float64 sign lies within RELU_TAU of zero, (b) every gradient
    tensor at GRAD_RTOL, GRAD_ATOL x max|ref| element by element, no
    escape, (c) one unit flipped (the largest |z64| of the middle layer's
    c1, the combine's first hidden layer, on a node a valid edge touches)
    is rejected by both, (d) the
    backward with the mask buffer gives the training path's gradients bit
    for bit, and a second run of the training path too. Returns the
    largest forward and gradient errors and the readings."""
    import torch

    from batch3dmot_tpu_torch.ops.fused_mp import (
        extract_mp_params,
        fused_mp_scores_plain,
        relu_preactivations_from_stashes,
    )
    from batch3dmot_tpu_torch.ops.fused_mp_train import (
        fused_mp_train_masks,
        fused_mp_train_scores,
    )

    fwd_err = bwd_err = 0.0
    rows = []
    for name, (n, e), windows, empty, masked in TRAIN_CASES:
        model = models[name]
        pose = name == "pose"
        nd, ed = model.node_dim, model.edge_dim
        inputs = random_inputs(rng, windows, n, e, nd, ed, not pose, empty)
        ct = torch.from_numpy(rng.uniform(-1.0, 1.0, (windows, e)).astype(np.float32)).cuda()
        if masked:
            ct = ct * inputs[5]
        flat, meta = extract_mp_params(model, not pose, nd, ed)
        scores, stashes, grads_m, kmasks = fused_mp_train_masks(*inputs, flat, meta, 6, ct, True)
        with torch.no_grad():
            ref = fused_mp_scores_plain(*inputs, flat, meta, 6, True, carries=True)
        torch.cuda.synchronize()
        f_err, ref64 = 0.0, []

        def plain64_out(i, inputs=inputs, flat=flat, meta=meta):
            if not ref64:
                ref64.extend(fused_mp_plain64(*inputs, flat, meta, 6, True, carries=True))
            return ref64[i]

        for i, (what, a, b) in enumerate(zip(("scores", "x_t", "e_t", "agg_t"),
                                             (scores, *stashes), ref)):
            err, _ = held_to_plain(a, b, functools.partial(plain64_out, i),
                                   f"2b {name} ({n},{e}) x{windows} {what}", rows=i > 0)
            f_err = max(f_err, err)
        fwd_err = max(fwd_err, f_err)
        witness = None
        if (name, (n, e), windows) in F64_CASES:
            allow = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                with torch.no_grad():
                    tf32 = fused_mp_scores_plain(*inputs, flat, meta, 6, True, carries=True)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = allow
            witness = f64_check(f"{name} ({n},{e}) x{windows}", (scores, *stashes), ref, tf32,
                                [plain64_out(i) for i in range(4)], inputs[-1])
            del tf32
        del ref, ref64
        _, g_k = train_grads(model, inputs, ct, 6, True, fused_mp_train_scores)
        _, g_p = train_grads(model, inputs, ct, 6, True, fused_mp_scores_plain)

        def plain64(model=model, inputs=inputs, ct=ct):
            m64 = copy.deepcopy(model).double()
            i64 = [t.double() if t is not None and t.is_floating_point() else t
                   for t in inputs]
            return train_grads(m64, i64, ct.double(), 6, True, fused_mp_scores_plain)[1]

        grads64 = None
        if witness is not None:
            g64 = plain64()
            plain64 = lambda g64=g64: g64  # noqa: E731
            grads64 = grad_rms64(g_k, g_p, g64)
            worst = sorted(grads64.items(), key=lambda kv: -kv[1][2])
            log(f"2b {name} ({n},{e}) x{windows} gradients against float64 (RMS over each "
                f"tensor, kernel / float32 plain): median ratio "
                f"{float(np.median([v[2] for v in grads64.values()])):.3f}, largest "
                + ", ".join(f"{k} {rk:.3e} / {rp:.3e} ({q:.2f})" for k, (rk, rp, q) in worst[:4]))
            del g64
        # the plain version's own branches (a reading: ReLU ties)
        err, tied = compare_grads(g_k, g_p, plain64, f"{name} ({n},{e}) x{windows}",
                                  lambda: train_grads(model, inputs, ct, 6, True, functools.partial(
                                      fused_mp_scores_plain, relu_masks=kmasks))[1])
        bwd_err = max(bwd_err, err)
        d64 = lambda t: None if t is None else t.double()  # noqa: E731
        pre64 = relu_preactivations_from_stashes(
            [t.double() for t in stashes], d64(inputs[2]), *inputs[3:],
            [w.double() for w in flat], meta, 6)
        masks64 = [z > 0 for z, _ in pre64]
        masks32 = [z > 0 for z, _ in relu_preactivations_from_stashes(
            stashes, inputs[2], *inputs[3:], flat, meta, 6)]
        near = sum(int((a != b).sum()) for a, b in zip(masks64, masks32))
        del masks32
        # the float64 masks of the kernel's stashes replayed (a reading)
        _, g_64 = train_grads(model, inputs, ct, 6, True, functools.partial(
            fused_mp_scores_plain, relu_masks=masks64))
        out64, err64 = grads_outside(g_k, g_64)
        l2_64 = max(float((g_k[k] - r).double().norm() / r.double().norm())
                    for k, r in g_64.items())
        assert l2_64 <= MAX_REL_L2, (name, n, e, l2_64)
        del g_64, masks64
        # (a) the kernel's masks against float64
        differ, beyond = relu_mask_units(kmasks, pre64)
        assert beyond == 0, (name, n, e, "a kernel mask beyond RELU_TAU of zero", differ, beyond)
        # (b) the gradients under the kernel's own masks, no escape
        _, g_r = train_grads(model, inputs, ct, 6, True, functools.partial(
            fused_mp_scores_plain, relu_masks=kmasks))
        out_r, err_r = grads_outside(g_k, g_r)
        assert out_r == 0, (name, n, e, "elements outside under the kernel's masks", out_r)
        del g_r
        # (c) one unit flipped: the largest |z64| of the middle layer's c1 (the
        # combine's first hidden layer at depth 3; a node's units reach
        # every edge it touches in the later layers) on a node a valid edge
        # touches
        li = 6 * 3 + 4
        src, dst, valid = inputs[3:]
        touched = torch.zeros(windows, n, dtype=torch.bool, device=valid.device)
        rows_b = torch.arange(windows, device=valid.device)[:, None].expand_as(valid)
        touched[rows_b[valid], src.long()[valid]] = True
        touched[rows_b[valid], dst.long()[valid]] = True
        z = pre64[li][0].abs() * touched[..., None]
        at = np.unravel_index(int(z.argmax()), tuple(z.shape))
        flipped = list(kmasks)
        flipped[li] = kmasks[li].clone()
        flipped[li][at] = ~flipped[li][at]
        c_differ, c_beyond = relu_mask_units(flipped, pre64)
        _, g_f = train_grads(model, inputs, ct, 6, True, functools.partial(
            fused_mp_scores_plain, relu_masks=flipped))
        c_out, c_err = grads_outside(g_k, g_f)
        control_seen(f"{name} ({n},{e}) x{windows}", c_beyond, c_out, c_err,
                     float(pre64[li][0][at]))
        del g_f, flipped, z, touched
        # (d) the mask buffer changes nothing: its gradients are the training
        # path's, and the training path's twice
        leaves = [None if t is None else t.detach().clone().requires_grad_()
                  for t in inputs[:3]]
        flat_l = [w.clone().requires_grad_() for w in flat]
        wanted = [t for t in (*leaves, *flat_l) if t is not None]
        g_train = torch.autograd.grad(
            fused_mp_train_scores(*leaves, *inputs[3:], flat_l, meta, 6, True), wanted, ct)
        g_mask = [g for g in grads_m if g is not None]
        assert len(g_mask) == len(g_train) and all(
            torch.equal(a, b) for a, b in zip(g_mask, g_train)), "the mask buffer moved a gradient"
        _, again = train_grads(model, inputs, ct, 6, True, fused_mp_train_scores)
        torch.cuda.synchronize()
        for k in g_k:
            assert torch.equal(g_k[k], again[k]), f"{k}: two backward runs differ"
        units = sum(m.numel() for m in kmasks)
        rows.append(dict(case=f"{name} ({n},{e}) x{windows}", units=units, differ=differ,
                         f32_f64_differ=near, outside=out_r, err=err_r,
                         control=dict(at=[int(i) for i in at], z64=float(pre64[li][0][at]),
                                      scale=float(pre64[li][1][at]), differ=c_differ,
                                      beyond=c_beyond, outside=c_out, err=c_err),
                         tied_tensors=len(tied), f64_masks_outside=out64,
                         f64_masks_rel_l2=l2_64,
                         **(dict(f64=witness, grads_rms64=grads64) if witness else {})))
        log(f"kernel fused_mp_train {name} ({n},{e}) x{windows} empty={empty} "
            f"masked cotangent={masked}: "
            f"max|kernel-plain| scores and stashes {f_err:.3e}, gradients {err:.3e} "
            f"over {len(g_k)} tensors ({len(tied)} held to the relative L2 bound); "
            f"float64 masks of the kernel's stashes ({near} units where a float32 recompute "
            f"differs) replayed: {out64} elements outside, max {err64:.3e} (relative L2 "
            f"{l2_64:.2e}, held to {MAX_REL_L2:g}); the backward's "
            f"own masks: (a) {differ} of {units} units differ from float64, none beyond "
            f"RELU_TAU {RELU_TAU:.3e} x scale; (b) replayed, {out_r} elements outside rtol "
            f"{GRAD_RTOL:g}, atol {GRAD_ATOL:g} x max|plain|, max {err_r:.3e}; (c) control "
            f"(c1 of layer 3 at {tuple(int(i) for i in at)}, z64 "
            f"{float(pre64[li][0][at]):.3e}, scale {float(pre64[li][1][at]):.3e}) "
            f"rejected: {c_beyond} unit beyond RELU_TAU, {c_out} elements outside (max "
            f"{c_err:.3e}); (d) gradients with the mask buffer bit-identical to the training "
            f"path's; backward bit-identical across two runs")
        for k, outside, size, rel_l2, rk, rp in tied:
            log(f"  {k}: {outside}/{size} elements outside the gradient tolerance against "
                f"the plain version's own branches, relative L2 error {rel_l2:.2e}; RMS from "
                f"a float64 plain run: kernel {rk:.3e}, f32 plain {rp:.3e}")
        model.zero_grad(set_to_none=True)
        del inputs, scores, stashes, grads_m, kmasks, pre64, g_k, g_p, again, g_train
    log("2b under the backward kernel's own ReLU masks (case: units differing from "
        "float64, elements outside): " + "; ".join(
            f"{r['case']}: {r['differ']}, {r['outside']}" for r in rows))
    return fwd_err, bwd_err, rows


def active_step_launches(depth, mm):
    """The segment-sum kernel's launches in one knn_conv_mode='active'
    training step: the forward's segment sums (2 per layer, 2 per kNN
    GATConv, which runs before layers 0, 2, 4, ...) and the backward's, one
    per ``gather_rows`` (per layer ``[x | initial_x]``; per GATConv both
    scores, the messages, the softmax's max and denominator; mm's two
    attention rows)."""
    convs = (depth + 1) // 2
    return 2 * depth + 2 * convs + depth + 4 * convs + (2 if mm else 0)


@contextlib.contextmanager
def atomic_gathers():
    """The models' gathers as before their backward became a segment sum:
    ``gather_rows`` replaced by a plain ``torch.gather`` (the same forward;
    its backward scatter-adds with atomics). For readings only."""
    from batch3dmot_tpu_torch.models import gnn, layers
    from batch3dmot_tpu_torch.ops import segment
    from batch3dmot_tpu_torch.ops.segment_kernel import gather_segments

    saved = [(m, m.gather_rows) for m in (gnn, layers, segment)]
    for m, _ in saved:
        m.gather_rows = gather_segments
    try:
        yield
    finally:
        for m, fn in saved:
            m.gather_rows = fn


def trainer_state(tr):
    """A trainer's parameters and Adam moments, by name, copied."""
    names = {id(p): k for k, p in tr.model.named_parameters()}
    out = {f"param {k}": p.detach().clone() for k, p in tr.model.named_parameters()}
    for p, st in tr.optimizer.state.items():
        for key in ("exp_avg", "exp_avg_sq"):
            out[f"{key} {names[id(p)]}"] = st[key].clone()
    return out


def state_diff(a, b):
    """(tensors that differ, the largest |difference|) of two trainer_states."""
    assert a.keys() == b.keys()
    differ = [k for k in a if not a[k].equal(b[k])]
    worst = max((float((a[k] - b[k]).abs().max()) for k in differ), default=0.0)
    return differ, worst


def plain_scorer(model, float64=False):
    """A SceneEncodedScorer of ``model`` whose window forwards run the plain
    message-passing version instead of the kernel (in float64 with
    ``float64``: ``held_to_plain``'s witness; the scores come back in
    float32)."""
    from batch3dmot_tpu_torch.infer.predict import SceneEncodedScorer
    from batch3dmot_tpu_torch.ops.fused_mp import extract_mp_params, fused_mp_scores_plain

    plain = fused_mp_plain64 if float64 else fused_mp_scores_plain

    class PlainScorer(SceneEncodedScorer):
        def _forward(self, batch, det_index, enc):
            x_img, pn, rn, lp, rp = (t[det_index] for t in enc)
            m = self.model
            x0, e0, att, _ = m.pre_message_passing(batch, x_img, pn, rn, lp, rp)
            flat, meta = extract_mp_params(m, True, m.node_dim, m.edge_dim)
            return plain(x0, e0, att, batch.edge_src, batch.edge_dst, batch.edge_mask,
                         flat, meta, m.depth).float()

    return PlainScorer(model)


@contextlib.contextmanager
def plain_training(float64=False):
    """Training scores through the plain version called directly (autograd
    differentiates it), instead of the kernel pair; with ``float64`` in
    float64, the scores rounded to float32 (``held_to_plain``'s witness)."""
    from batch3dmot_tpu_torch.ops import fused_mp_train as fmt

    def plain64(*args, **kwargs):
        return fused_mp_plain64(*args, **kwargs).float()

    kernels = fmt.fused_mp_train_scores
    fmt.fused_mp_train_scores = plain64 if float64 else fmt.fused_mp_scores_plain
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
def plain_segment_sum(float64=False):
    """The segment-sum dispatcher runs the plain version on the card
    (autograd still takes the dispatcher's backward); with ``float64`` it
    sums in float64 and rounds the sums to the data's dtype: the rest of
    the float32 path unchanged, ``held_to_plain``'s witness."""
    from batch3dmot_tpu_torch.ops import segment_kernel

    def plain64(data, ids, num_segments, mask=None):
        return segment_kernel.segment_sum_plain(data.double(), ids, num_segments,
                                                mask).to(data.dtype)

    kernel = segment_kernel.segment_sum_cuda
    segment_kernel.segment_sum_cuda = plain64 if float64 else segment_kernel.segment_sum_plain
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


def replayed_outs(run, caps, float64=False):
    """``run(outs)`` through the plain segment sum (in float64 with
    ``float64``) with the kNN graphs ``caps`` replayed."""
    import torch

    outs = []
    with replay_knn(caps), plain_segment_sum(float64):
        run(outs)
    torch.cuda.synchronize()
    return outs


def valid_scores(outs, windows=None):
    """The valid edges' scores of ``outs`` (per forward (edge_mask,
    scores)), window by window (``windows``: (forward, slot) pairs; all by
    default), concatenated."""
    import torch

    if windows is None:
        windows = [(f, slot) for f, (mask, _) in enumerate(outs) for slot in range(mask.shape[0])]
    if not windows:
        return torch.zeros(0)
    return torch.cat([outs[f][1][slot][outs[f][0][slot].to(outs[f][1].device)]
                      for f, slot in windows])


def replayed_err(run, kernel, what):
    """The plain segment sum's run with the kernel run's kNN graphs
    replayed, held to the kernel run's scores on every window's valid
    edges (``held_to_plain``: the witness sums in float64); returns
    max |kernel - plain|."""
    outs = replayed_outs(run, kernel[1])
    assert len(outs) == len(kernel[0])
    err, _ = held_to_plain(valid_scores(kernel[0]), valid_scores(outs), lambda: valid_scores(
        replayed_outs(run, kernel[1], float64=True)), what)
    return err


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


def compare_active(run, kernel, plain, convs, what):
    """Holds the kernel run's scores to the plain run's where both built
    the same kNN graphs at every conv (``held_to_plain`` over those
    windows; the witness sums in float64 on the kernel run's kNN graphs,
    replayed into ``run``); a window whose
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
    windows, flips, same = 0, [], []
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
                same.append((f, slot))
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
    worst, _ = held_to_plain(valid_scores(outs_k, same), valid_scores(outs_p, same),
                             lambda: valid_scores(replayed_outs(run, knn_k, float64=True), same),
                             what)
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


def held_avgs(got, want, want64_fn, what):
    """``held_to_plain`` over lists of {(src, dst): mean} dicts: the same
    keys, the means in the order of ``want``'s keys."""
    assert [g.keys() for g in got] == [w.keys() for w in want], what

    def flat(dicts):
        return [np.array([d[k] for k in w], np.float64) for d, w in zip(dicts, want)]

    return held_to_plain(flat(got), flat(want), lambda: flat(want64_fn()), what)


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
    # which ops of a training epoch PyTorch itself calls nondeterministic:
    # one dense fit_device epoch (its eager warm-up steps and the capture)
    # under use_deterministic_algorithms(warn_only=True)
    probe = GNNTrainer(make_model("mm"), clr_cfg, init_state_dict=start_sd)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            probe.fit_device(dense_ds, epochs=1, verbose=False, seed=7)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).split(" does not have a deterministic")[0][:160]
                      for w in caught if "determinis" in str(w.message)})
    log(f"3i (a) nondeterministic ops flagged by torch in a fit_device epoch: "
        f"{flagged or 'none'}")
    del probe
    for form, ds in (("dense", dense_ds), ("dedup", dedup_ds), ("fused_steps=4", None)):
        # ref2: the mesh-free run again: bit-identical (the attention rows'
        # gathers sum their cotangents in a fixed order,
        # models/layers.py::gather_rows; the kernels add without atomics)
        ref, ref2 = (GNNTrainer(make_model("mm"), clr_cfg, init_state_dict=start_sd)
                     for _ in range(2))
        dp = GNNTrainer(make_model("mm"), clr_cfg, init_state_dict=start_sd, mesh=mesh)
        ref_losses, ref2_losses, dp_losses = (record_losses(t) for t in (ref, ref2, dp))

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
        # the training pair's kernels; the 'noop' mm's backward sums the
        # attention rows' cotangents with the segment-sum kernel
        assert launched["fwd"] > 0 and launched["bwd"] > 0, (form, launched)
        assert launched["segment_sum"] == 2 * launched["bwd"], (form, launched)
        for k, v in launched.items():
            path_launches[k] += v
        steps = ref.step
        assert dp.graph_replays == ref.graph_replays == steps, (dp.graph_replays, steps)
        np.testing.assert_allclose(dp_losses, ref_losses, rtol=RTOL, atol=ATOL)
        rel = max_rel_diff(dp_losses, ref_losses)  # the replay epoch below adds to the lists
        (diff, at), (spread, _) = max_param_diff(dp, ref), max_param_diff(ref2, ref)
        # C.1: two mesh-free epochs from one start are bit-identical
        assert spread == 0.0 and ref2_losses == ref_losses, (form, spread)
        p_atol = ATOL
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
    # the active mm step of the dry run (depth 2)
    want_active = active_step_launches(2, True)
    assert check["active_step_launches"] == [want_active] * 2, (check["active_step_launches"],
                                                                want_active)
    log(f"3i (b) dryrun 2 --device cuda (gloo, both ranks on {card}) in {dryrun_s:.1f} s, "
        f"its one-process comparison included: every kernel launched on each rank "
        f"{check['counters']} (the active step's segment sums {check['active_step_launches']}, "
        f"{want_active} expected); ranks bit-identical; vs one process (at rtol {RTOL:.0e}, atol "
        f"{ATOL:.0e}) max |trained state diff| {check['param']:.2e}, one-step gradients "
        f"{check['grad']:.2e}, averaged edges {check['pipeline']:.2e}, cached-embedding scores "
        f"{check['cached']:.2e}; phase 3i and 4g {time.perf_counter() - t_phase:.1f} s")
    return dict(one_rank=dict(runs=runs, launches=path_launches, mesh_free=free_launches),
                timing=timing, ranks=check["counters"], dryrun_s=dryrun_s,
                active_step_launches=check["active_step_launches"])


# ---- the CLI (phase 3j, timing 4h) ---------------------------------------------

# bench.py's workload: 4 synthetic scenes of 16 frames and 40 tracks, window
# 5, 40 candidate predecessors; the default Config's mm at full width
# (configs/clr.yaml's widths, depth 6)
CLI_SIZES = ("graph_construction.synthetic_frames=16", "graph_construction.synthetic_tracks=40",
             "graph_construction.batch_size_graph=5", "graph_construction.top_knn_nodes=40")


def cli_submission(items, preds, cfg):
    """The submission the CLI's predict assembles from per-scene predicted
    edges: tracks by hierarchical_clusters with the join thresholds, scene
    results, track ids offset scene by scene."""
    from batch3dmot_tpu_torch.infer.tracks import (
        all_scene_sample_tokens,
        assemble_submission,
        hierarchical_clusters,
        scene_results,
    )

    results, tokens, offset = [], [], 0
    for scene, (pred_edges, _) in zip(items, preds):
        cats = {i: m["category_name"] for i, m in enumerate(scene.metadata)}
        tracks = hierarchical_clusters(pred_edges, cats, cfg.predict.join_score_thresholds)
        res = scene_results(tracks, scene, cfg.predict.interpolate_trailer_tracks)
        for boxes in res.values():
            for b in boxes:
                b["tracking_id"] = str(offset + int(b["tracking_id"]))
        offset += len(tracks)
        results.append(res)
        tokens += all_scene_sample_tokens(scene)
    return json.loads(json.dumps(assemble_submission(
        results, tokens, use_camera=cfg.main.sensors_used.get("img", True),
        use_lidar=cfg.main.sensors_used.get("lidar", True), use_radar=False)))


def submission_diff(a, b):
    """The largest difference of two submissions' numeric box fields, box
    by box; raises unless they hold the same sample tokens and, per token,
    the same boxes (tracking id, name, sample token) in the same order.
    Boxes interpolated along trailer tracks take the scene's yaw and
    velocity, which a scene rebuilt from a store's sidecars holds to
    float64 rounding of the source scene's."""
    assert a["meta"] == b["meta"] and a["results"].keys() == b["results"].keys()
    worst = 0.0
    for token, boxes in a["results"].items():
        key = lambda x: (int(x["tracking_id"]), x["tracking_name"])  # noqa: E731
        xs, ys = sorted(boxes, key=key), sorted(b["results"][token], key=key)
        assert [key(x) for x in xs] == [key(y) for y in ys], token
        for x, y in zip(xs, ys):
            assert x["sample_token"] == y["sample_token"]
            for f in ("translation", "size", "rotation", "velocity", "tracking_score"):
                worst = max(worst, float(np.abs(np.subtract(x[f], y[f])).max()))
    return worst


def cli_phase(card):
    """Phase 3j: the port's CLI (``batch3dmot_tpu_torch.cli.main``, no
    --config, --set overrides, on the card by default) through
    build-graphs, train-gnn (mm --encoded: the automatic device-resident
    dataset; pose --fused-steps 4), predict (encoded: the cached-embedding
    path and the raw encode; device), eval and demo, in a temporary
    directory. Holds (a) each run's kernel launches to their exact
    expected counts, (b) the encoded predict's per-scene averages against
    ``predict_scenes`` on the same checkpoint and scenes at RTOL, ATOL, and
    its predicted edges, submission and (d) eval AMOTA equal but for
    near-ties of the two paths' averages, (c) the device pipeline against
    the encoded predict the same way. 4h: each subcommand's wall time,
    predict's rate lines, and the train-gnn epoch beside a fit_device epoch
    of the same dataset through the Python API, in turns. Returns the
    launches per kernel and the timings."""
    import ast
    import glob
    import os
    import shutil

    import torch

    from batch3dmot_tpu_torch import cli
    from batch3dmot_tpu_torch.config import GNNConfig
    from batch3dmot_tpu_torch.eval.tracking_metrics import (
        evaluate_tracking,
        gt_boxes_from_scene,
        json_safe,
    )
    from batch3dmot_tpu_torch.graphs import build_scene_graphs
    from batch3dmot_tpu_torch.graphs.build_device import build_scene_graphs_device
    from batch3dmot_tpu_torch.infer import device_pipeline
    from batch3dmot_tpu_torch.infer.predict import (
        SceneEncodedScorer,
        greedy_round,
        predict_scenes,
        threshold_edges,
    )
    from batch3dmot_tpu_torch.io import GraphStoreReader
    from batch3dmot_tpu_torch.models import make_model
    from batch3dmot_tpu_torch.train.data import group_sizes_by_bucket
    from batch3dmot_tpu_torch.train.encoded import (
        materialize_encoded_datasets_dedup,
        probe_scene_encoding_cache,
        store_detection_count,
        _encoder_digest,
    )
    from batch3dmot_tpu_torch.train.trainer import WARMUP_STEPS, GNNTrainer
    from batch3dmot_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="b3d_cli_")
    sets = [f"paths.tmp={tmp}", *CLI_SIZES]
    argv_sets = [a for kv in sets for a in ("--set", kv)]
    cfg = cli.Config()
    cfg.apply_overrides(sets)
    times, launches, outputs = {}, {}, {}

    def run(tag, argv):
        """One CLI call: its result, wall time, printed lines and the
        kernels it launched (every count set to 0 just before)."""
        out = io.StringIO()
        torch.cuda.synchronize()
        counters(reset=True)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = cli.main([*argv, *argv_sets])
        torch.cuda.synchronize()
        times[tag] = time.perf_counter() - t0
        launches[tag] = counters()
        outputs[tag] = out.getvalue()
        for line in outputs[tag].splitlines():
            log(f"  [{tag}] {line}")
        return result

    def scores_of(tag):
        d = os.path.join(tmp, f"eval_{tag}", "predict")
        return {os.path.basename(p).split("_edge_scores")[0]: {
            ast.literal_eval(k): v for k, v in json.load(open(p)).items()}
            for p in glob.glob(os.path.join(d, "*_edge_scores.json"))}

    def submission_of(tag):
        return json.load(open(os.path.join(tmp, f"eval_{tag}", "submission.json")))

    try:
        # 1. stores
        run("build-graphs", ["build-graphs", "--synthetic", "4"])
        stores = sorted(glob.glob(os.path.join(cfg.paths.graphs_dir, "*.b3d")))
        assert len(stores) == 4, stores
        sizes = {p: [(n, e) for n, e in zip(*GraphStoreReader(p).window_sizes())
                     if n > 0 and e > 0] for p in stores}
        train_p, val_p = stores[:-1], stores[-1:]  # max(1, 4 // 10) validation scenes

        def n_groups(paths):
            return len(group_sizes_by_bucket([s for p in paths for s in sizes[p]]))

        # 2. train-gnn mm --encoded: the automatic device-resident dataset;
        # per group of the train and validation sets, the warm-up steps and
        # the capture run through the wrappers, the replays without them
        hist_mm = run("train-gnn mm", ["train-gnn", "--model", "mm", "--encoded",
                                       "--epochs", "1"])
        assert "auto device-resident dataset" in outputs["train-gnn mm"]
        gt_, gv = n_groups(train_p), n_groups(val_p)
        per = WARMUP_STEPS + 1
        want = dict(fused_mp=per * gv, fwd=per * gt_, bwd=per * gt_, segment_sum=2 * per * gt_)
        assert launches["train-gnn mm"] == want, (launches["train-gnn mm"], want)
        assert np.isfinite(hist_mm[0]["train/loss"]), hist_mm
        ck = sorted(glob.glob(os.path.join(cfg.paths.models, "gnn", "*.pt")),
                    key=os.path.getmtime)[-1]

        # 3. predict: encoded (the caches train-gnn wrote, float16
        # transport), encoded from the raw modalities at float32 points,
        # and the device pipeline at float32 points with the stores' window
        n_live = sum(len(v) for v in sizes.values())
        f32 = ["--set", "predict.point_dtype=float32"]
        run("predict encoded", ["predict", "--pipeline", "encoded", "--checkpoint", ck,
                                "--set", f"paths.eval={tmp}/eval_cached"])
        assert "cached-embedding path (float16 uploads, 4 scenes)" in outputs["predict encoded"]
        run("predict encoded raw", ["predict", "--pipeline", "encoded", "--checkpoint", ck,
                                    "--set", f"paths.eval={tmp}/eval_raw",
                                    "--set", "predict.embedding_cache=off", *f32])
        run("predict device", ["predict", "--pipeline", "device", "--synthetic", "4",
                               "--checkpoint", ck, "--set", f"paths.eval={tmp}/eval_device",
                               "--set", "predict.batch_size_graph=5", *f32])
        # one scene group of 4: the encoded path scores its windows in batches
        # of 8 at the run's one bucket; the device pipeline scores the group
        # in one launch, or scene by scene when one scene's work fills the
        # card (device_pipeline._GROUP_WORK_CEILING)
        scenes = cli._build_synthetic_scenes(cfg, 4, True)
        pipe = device_pipeline.DeviceScenePipeline(make_model("mm"), 5, 40)
        quanta = [pipe._quanta(s) for s in scenes]
        mn = max(q[2] for q in quanta)
        work = max(-(-q[1] // 8) * 8 for q in quanta) * mn * mn * min(40, mn)
        dev_launches = len(scenes) if work >= device_pipeline._GROUP_WORK_CEILING else 1
        for tag, n in (("predict encoded", -(-n_live // 8)),
                       ("predict encoded raw", -(-n_live // 8)),
                       ("predict device", dev_launches)):
            want = dict(fused_mp=n, fwd=0, bwd=0, segment_sum=0)
            assert launches[tag] == want, (tag, launches[tag], want)

        # (b) the Python API on the same checkpoint and the stores' scenes
        model = make_model("mm")
        model.load_state_dict(load_checkpoint(ck, map_location="cpu"))
        items = []
        for p in stores:
            windows = GraphStoreReader(p).windows()
            items.append((cli._scene_from_store(p, windows, with_modalities=True), windows))
        api = predict_scenes(SceneEncodedScorer(model), items, cfg.predict)
        raw, dev = scores_of("raw"), scores_of("device")
        api_err = max(max_avg_diff(raw[s.scene_token], a) for (s, _), (_, a) in zip(items, api))
        thresholds = cfg.predict.edge_score_thresholds
        cli_preds = [(greedy_round(threshold_edges(raw[s.scene_token], s, thresholds)),
                      raw[s.scene_token]) for s, _ in items]
        scene_list = [s for s, _ in items]
        api_flips, api_unexplained = rounding_flips(api, cli_preds, scene_list)
        assert api_unexplained == 0, api_unexplained
        api_sub = cli_submission(scene_list, api, cfg)
        if api_flips == 0:
            assert api_sub == submission_of("raw")

        # (c) the device pipeline against the encoded predict: averages at
        # RTOL, ATOL where the card built the host's windows; a scene with a
        # kNN flip (k-th and (k+1)-th candidates at a near-tie) is held by
        # compare_builds instead
        dev_err, knn_scenes, same = 0.0, 0, []
        for s, ws in items:
            if dev[s.scene_token].keys() == raw[s.scene_token].keys():
                dev_err = max(dev_err, max_avg_diff(dev[s.scene_token], raw[s.scene_token]))
                same.append(s)
                continue
            full = next(x for x in scenes if x.scene_token == s.scene_token)
            q = pipe._quanta(full)
            flips_b, _ = compare_builds(full, list(build_scene_graphs(full, 5, cfg.graph_construction)),
                                        build_scene_graphs_device(full, 5, cfg.graph_construction,
                                                                  max_nodes=q[2]), 5, 40)
            assert flips_b > 0, s.scene_token
            knn_scenes += 1
        dev_preds = [(greedy_round(threshold_edges(dev[s.scene_token], s, thresholds)),
                      dev[s.scene_token]) for s in same]
        raw_same = [p for p, (s, _) in zip(cli_preds, items) if s in same]
        dev_flips, dev_unexplained = rounding_flips(dev_preds, raw_same, same)
        assert dev_unexplained == 0, dev_unexplained
        dev_sub_diff = None
        if dev_flips == 0 and knn_scenes == 0:
            dev_sub_diff = submission_diff(submission_of("device"), submission_of("raw"))
            assert dev_sub_diff <= 1e-6, dev_sub_diff

        # (d) eval against the synthetic scenes' GT
        gt_path = os.path.join(tmp, "gt.json")
        gt_boxes = [b for s in cli._build_synthetic_scenes(cfg, 4, False)
                    for b in gt_boxes_from_scene(s)]
        with open(gt_path, "w") as f:
            json.dump({"boxes": gt_boxes}, f)
        res_cli = run("eval", ["eval", "--submission", os.path.join(tmp, "eval_raw",
                                                                     "submission.json"),
                               "--gt", gt_path])
        printed = json.loads(outputs["eval"].strip().splitlines()[-1])
        res_api = evaluate_tracking(gt_boxes, [b for v in api_sub["results"].values() for b in v],
                                    list(api_sub["results"].keys()))
        assert printed == json_safe({"amota": res_cli.amota, "amotp": res_cli.amotp})
        if api_flips == 0:
            assert res_api.amota == res_cli.amota, (res_api.amota, res_cli.amota)
        assert np.isfinite(res_cli.amota)

        # (e) (b)-(d) again on a model whose scores move with the embeddings:
        # responsive_model of the checkpoint, written as a port checkpoint,
        # through predict encoded (raw encode) and device, held to the API
        # on the same model; a lidar-zeroed control through the API outside
        resp = responsive_model(model, scene_list, [ws for _, ws in items],
                                gain=DENSE_RESPONSIVE_GAIN)
        ck_r = save_checkpoint(os.path.join(tmp, "responsive", "gnn_responsive.pt"),
                               {k: v.detach().cpu() for k, v in resp.state_dict().items()})
        run("predict encoded responsive", [
            "predict", "--pipeline", "encoded", "--checkpoint", ck_r,
            "--set", f"paths.eval={tmp}/eval_resp", "--set", "predict.embedding_cache=off",
            *f32])
        run("predict device responsive", [
            "predict", "--pipeline", "device", "--synthetic", "4", "--checkpoint", ck_r,
            "--set", f"paths.eval={tmp}/eval_resp_device", "--set",
            "predict.batch_size_graph=5", *f32])
        for tag, n in (("predict encoded responsive", -(-n_live // 8)),
                       ("predict device responsive", dev_launches)):
            want = dict(fused_mp=n, fwd=0, bwd=0, segment_sum=0)
            assert launches[tag] == want, (tag, launches[tag], want)
        raw_r, dev_r = scores_of("resp"), scores_of("resp_device")
        api_r = predict_scenes(SceneEncodedScorer(resp), items, cfg.predict)
        resp_err = max(max_avg_diff(raw_r[s.scene_token], a) for (s, _), (_, a) in zip(items, api_r))
        cli_r = [(greedy_round(threshold_edges(raw_r[s.scene_token], s, thresholds)),
                  raw_r[s.scene_token]) for s, _ in items]
        resp_flips, resp_unexplained = rounding_flips(api_r, cli_r, scene_list)
        assert resp_unexplained == 0, resp_unexplained
        sub_r = submission_of("resp")
        api_sub_r = cli_submission(scene_list, api_r, cfg)
        amota_r = [evaluate_tracking(gt_boxes, [b for v in sb["results"].values() for b in v],
                                     list(sb["results"].keys())).amota
                   for sb in (sub_r, api_sub_r)]
        if resp_flips == 0:
            assert api_sub_r == sub_r
            assert amota_r[0] == amota_r[1], amota_r
        dev_err_r = max((max_avg_diff(dev_r[s.scene_token], raw_r[s.scene_token]) for s in same),
                        default=0.0)
        dev_preds_r = [(greedy_round(threshold_edges(dev_r[s.scene_token], s, thresholds)),
                        dev_r[s.scene_token]) for s in same]
        dev_flips_r, dev_unexplained_r = rounding_flips(
            dev_preds_r, [p for p, (s, _) in zip(cli_r, items) if s in same], same)
        assert dev_unexplained_r == 0, dev_unexplained_r
        ctrl = predict_scenes(zeroed_scorer(resp, 1), items, cfg.predict)
        ctrl_out = sum(outside_avg(a, raw_r[s.scene_token]) for (s, _), (_, a) in zip(items, ctrl))
        assert ctrl_out > 0, "lidar-zeroed features stay within RTOL, ATOL"
        resp_quant = score_quantiles([v for a in raw_r.values() for v in a.values()])
        responsive_run = dict(scores=resp_quant, api_err=resp_err, near_tie_edges=resp_flips,
                              amota=amota_r, dev_err=dev_err_r, dev_near_tie_edges=dev_flips_r,
                              lidar_control_outside=ctrl_out)
        log(f"3j (e) the responsive model (averaged scores {resp_quant} at the 0/10/50/90/100% "
            f"quantiles): predict --pipeline encoded vs predict_scenes max|avg diff| "
            f"{resp_err:.3e}, predicted edges at a near-tie {resp_flips}, submission "
            f"{'equal' if resp_flips == 0 else 'differs at those'}, AMOTA {amota_r[0]!r} vs "
            f"{amota_r[1]!r}; --pipeline device vs encoded {dev_err_r:.3e} over {len(same)} "
            f"scenes, {dev_flips_r} near-tie edges; lidar features zeroed: {ctrl_out} averaged "
            f"edges outside RTOL, ATOL")
        del resp

        # 5. train-gnn pose, host batches from the stores, 4 steps per
        # group: one staging source (every batch has one shape), whose
        # warm-up steps and capture run the training pair; validation runs
        # the inference kernel once per batch
        hist_pose = run("train-gnn pose", ["train-gnn", "--model", "pose", "--epochs", "1",
                                           "--fused-steps", "4",
                                           "--set", f"paths.models={tmp}/pose"])
        val_batches = -(-len(sizes[val_p[0]]) // cfg.gnn.batch_size)
        want = dict(fused_mp=val_batches, fwd=per, bwd=per, segment_sum=0)
        assert launches["train-gnn pose"] == want, (launches["train-gnn pose"], want)
        assert np.isfinite(hist_pose[0]["train/loss"])

        # 6. demo (its own temporary directory)
        res_demo = run("demo", ["demo", "--synthetic", "2", "--epochs", "1"])
        assert np.isfinite(res_demo.amota) and launches["demo"]["fused_mp"] > 0
        shutil.rmtree(outputs["demo"].split("(artifacts in ")[-1].split(")")[0],
                      ignore_errors=True)

        log(f"3j CLI on {card}: kernels launched (every count reset before each call) "
            + "; ".join(f"{k} {v}" for k, v in launches.items()))
        log(f"3j (b) predict --pipeline encoded (raw encode, float32 points) vs predict_scenes "
            f"on the same checkpoint and scenes: max|avg diff| {api_err:.3e} (RTOL {RTOL:g}, "
            f"ATOL {ATOL:g}); predicted edges at a near-tie of the two paths' averages: "
            f"{api_flips}; submission {'equal' if api_flips == 0 else 'differs at those'}")
        log(f"3j (c) predict --pipeline device vs encoded: max|avg diff| {dev_err:.3e} over "
            f"{len(same)} scenes with the host's windows ({knn_scenes} with a kNN near-tie "
            f"flip); predicted edges at a near-tie: {dev_flips}; submission: the same "
            f"tracks, box fields within {dev_sub_diff} (the device path's scenes come from "
            f"the generator, the encoded path's from the stores' sidecars)")
        log(f"3j (d) eval AMOTA {res_cli.amota!r} (API path {res_api.amota!r}); demo AMOTA "
            f"{res_demo.amota!r}; train-gnn mm epoch loss {hist_mm[0]['train/loss']:.6f}, "
            f"pose {hist_pose[0]['train/loss']:.6f}")

        # 4h: wall times, rate lines, and the train-gnn epoch beside a
        # fit_device epoch of the same dataset through the API, in turns
        # (2 epochs each: the second is the steady epoch; the caches are warm)
        digest = _encoder_digest(model)

        def encoded(paths):
            out = []
            for p in paths:
                enc = probe_scene_encoding_cache(p, digest, store_detection_count(p))
                assert enc is not None, p
                out += [(w, enc) for w in GraphStoreReader(p).windows()
                        if w.num_nodes > 0 and w.num_edges > 0]
            return out

        api_train = materialize_encoded_datasets_dedup(encoded(train_p))
        api_val = materialize_encoded_datasets_dedup(encoded(val_p))

        def cli_epoch(i):
            h = run(f"train-gnn timing {i}", ["train-gnn", "--model", "mm", "--encoded",
                                              "--epochs", "2", "--init-checkpoint", ck,
                                              "--set", f"paths.models={tmp}/timing{i}"])
            return h[1]["epoch_time_s"] * 1e3

        def api_epoch():
            tr = GNNTrainer(make_model("mm"), GNNConfig(), init_state_dict=model.state_dict())
            h = tr.fit_device(api_train, epochs=2, val_dataset=api_val, verbose=False)
            return h[1]["epoch_time_s"] * 1e3

        turns = [cli_epoch(0), api_epoch(), api_epoch(), cli_epoch(1)]
        rates = [line for tag, out in outputs.items() if tag.startswith("predict")
                 for line in out.splitlines() if line.startswith("predict[")]
        steps = sum(-(-len(g) // cfg.gnn.batch_size)
                    for _, g in group_sizes_by_bucket([s for p in train_p for s in sizes[p]]))
        timing = dict(wall_s={k: v for k, v in times.items() if "timing" not in k},
                      train_epoch_ms=dict(cli=(turns[0] + turns[3]) / 2,
                                          fit_device=(turns[1] + turns[2]) / 2, turns=turns,
                                          steps=steps))
        log(f"4h CLI wall times on {card}: " + ", ".join(
            f"{k} {v:.2f} s" for k, v in timing["wall_s"].items()))
        for line in rates:
            log(f"4h  {line.split(' -> ')[0]}")
        log(f"4h train-gnn mm --encoded steady epoch ({steps} train steps + validation) "
            f"{timing['train_epoch_ms']['cli']:.2f} ms vs fit_device through the API "
            f"{timing['train_epoch_ms']['fit_device']:.2f} ms (turns cli/api/api/cli "
            + "/".join(f"{t:.2f}" for t in turns) + f" ms); phase 3j and 4h "
            f"{time.perf_counter() - t_phase:.1f} s")
        total = dict.fromkeys(counters(), 0)
        for tag, c in launches.items():
            if "timing" in tag:
                continue
            for k, v in c.items():
                total[k] += v
        return dict(launches=total, per_call={k: v for k, v in launches.items()
                                              if "timing" not in k},
                    timing=timing, api_err=api_err, dev_err=dev_err, responsive=responsive_run)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- the nuScenes data plane (phase 3k, timing 4i) -----------------------------

# sensor rigs as nuScenes' (channel, translation on the ego, yaw): the six
# cameras (optical axis yaw; focal length of the 1600 x 900 canvas), the
# five radars and LIDAR_TOP (mounted turned by -90 degrees)
NUSC_CAMERAS = (
    ("CAM_FRONT", (1.70, 0.02, 1.51), 0.0, 1266.4),
    ("CAM_FRONT_RIGHT", (1.55, -0.49, 1.50), -0.96, 1260.8),
    ("CAM_FRONT_LEFT", (1.52, 0.49, 1.51), 0.96, 1272.6),
    ("CAM_BACK", (0.03, 0.0, 1.57), np.pi, 809.2),
    ("CAM_BACK_LEFT", (1.04, 0.71, 1.56), 1.92, 1256.7),
    ("CAM_BACK_RIGHT", (1.03, -0.48, 1.57), -1.92, 1259.5),
)
NUSC_RADARS = (
    ("RADAR_FRONT", (3.41, 0.0, 0.50), 0.0),
    ("RADAR_FRONT_LEFT", (2.42, 0.80, 0.50), np.pi / 2),
    ("RADAR_FRONT_RIGHT", (2.42, -0.80, 0.50), -np.pi / 2),
    ("RADAR_BACK_LEFT", (-0.56, 0.61, 0.50), 3.05),
    ("RADAR_BACK_RIGHT", (-0.56, -0.63, 0.50), -3.05),
)
NUSC_LIDAR = ("LIDAR_TOP", (0.94, 0.0, 1.84), -np.pi / 2)
# the devkit's 18-field radar .pcd layout (name, size, type)
RADAR_FIELDS = (
    ("x", 4, "F"), ("y", 4, "F"), ("z", 4, "F"), ("dyn_prop", 1, "I"), ("id", 2, "I"),
    ("rcs", 4, "F"), ("vx", 4, "F"), ("vy", 4, "F"), ("vx_comp", 4, "F"),
    ("vy_comp", 4, "F"), ("is_quality_valid", 1, "I"), ("ambig_state", 1, "I"),
    ("x_rms", 1, "I"), ("y_rms", 1, "I"), ("invalid_state", 1, "I"), ("pdh0", 1, "I"),
    ("vx_rms", 1, "I"), ("vy_rms", 1, "I"),
)
# tracking classes (raw category, detection name, w/l/h, speed m/s, share
# of the objects)
# after nuScenes trainval's mix, and non-tracking categories the data plane
# must filter out
NUSC_CLASSES = (
    ("vehicle.car", "car", (1.95, 4.6, 1.7), 8.0, 0.44),
    ("human.pedestrian.adult", "pedestrian", (0.67, 0.73, 1.77), 1.3, 0.22),
    ("vehicle.truck", "truck", (2.5, 6.9, 2.8), 7.0, 0.08),
    ("vehicle.trailer", "trailer", (2.9, 12.0, 3.9), 6.0, 0.04),
    ("vehicle.bus.rigid", "bus", (2.9, 11.0, 3.5), 7.0, 0.04),
    ("vehicle.bicycle", "bicycle", (0.6, 1.7, 1.3), 4.0, 0.08),
    ("vehicle.motorcycle", "motorcycle", (0.8, 2.1, 1.5), 7.0, 0.10),
)
NUSC_OTHER = (("movable_object.barrier", (2.5, 0.5, 1.0)),
              ("movable_object.trafficcone", (0.4, 0.4, 1.1)),
              ("static_object.bicycle_rack", (2.0, 6.0, 1.2)))
NUSC_T0_US = 1_533_151_603_547_590  # a trainval-era timestamp


def write_nuscenes_tree(root, seed=0, scenes=2, keyframes=40, objects=50, others=8,
                        lidar_points=34720, radar_points=100, lidar_hz=20, radar_hz=12):
    """A nuScenes-shaped v1.0-trainval tree under ``root`` from a numpy
    seed, written without PIL: ``scenes`` scenes of ``keyframes`` samples at
    2 Hz (the first ``scenes // 2`` in the train split, the rest in val, by
    a splits JSON); ``objects`` tracked objects per scene along a gently
    curving road (about 25 annotated per keyframe within 55 m of the ego,
    all 7 tracking classes) and ``others`` of non-tracking categories; six
    cameras with nuScenes-like calibrations, 1600 x 900 canvases and small
    placeholder JPEG files; LIDAR_TOP ``.pcd.bin`` sweeps of
    ``lidar_points`` points at ``lidar_hz`` (object returns inside their
    boxes plus ground), five radars' 18-field binary ``.pcd`` sweeps of
    about ``radar_points`` returns at ``radar_hz``, each sensor's sweeps
    chained by ``prev`` from before the first keyframe, so that
    ``nsweeps_lidar=10`` and ``nsweeps_radar=6`` take full sweeps; and per
    split a Megvii-format detector JSON with about 1.3x the GT boxes (10%
    missed, false positives, non-tracking detections, noisy boxes and
    scores). Non-key sweeps reuse a pool of ground-only files per scene.
    Returns dict(root, version, splits_json, det_dir, the sizes, and the
    counts of annotations, tracking-class annotations and detections)."""
    import os

    from batch3dmot_tpu_torch import geometry as geo

    rng = np.random.default_rng(seed)
    version = "v1.0-trainval"
    tdir = os.path.join(root, version)
    os.makedirs(tdir, exist_ok=True)
    for d in ("samples", "sweeps"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    tables = {k: [] for k in ("scene", "sample", "sample_data", "ego_pose", "calibrated_sensor",
                              "sensor", "sample_annotation", "instance", "category", "attribute",
                              "visibility", "log", "map")}
    tables["visibility"] = [{"token": str(i), "level": lvl, "description": ""}
                            for i, lvl in enumerate(("v0-40", "v40-60", "v60-80", "v80-100"), 1)]
    cat_tok = {}
    det_name = {c[0]: c[1] for c in NUSC_CLASSES}
    share = [c[4] for c in NUSC_CLASSES]
    for name in [c[0] for c in NUSC_CLASSES] + [o[0] for o in NUSC_OTHER]:
        cat_tok[name] = f"cat_{len(cat_tok)}"
        tables["category"].append({"token": cat_tok[name], "name": name, "description": ""})
    base_q = np.array([0.5, -0.5, 0.5, -0.5])  # optical z along the ego's +x
    rigs = {}
    for ch, t, yaw, f in NUSC_CAMERAS:
        q = geo.quat_multiply(geo.yaw_to_quat(yaw), base_q)
        rigs[ch] = (np.array(t), q, [[f, 0.0, 800.0], [0.0, f, 450.0], [0.0, 0.0, 1.0]], "camera")
    for ch, t, yaw in NUSC_RADARS:
        rigs[ch] = (np.array(t), geo.yaw_to_quat(yaw), [], "radar")
    rigs[NUSC_LIDAR[0]] = (np.array(NUSC_LIDAR[1]), geo.yaw_to_quat(NUSC_LIDAR[2]), [], "lidar")
    for ch, (t, q, k, modality) in rigs.items():
        tables["sensor"].append({"token": f"sen_{ch}", "channel": ch, "modality": modality})
        tables["calibrated_sensor"].append({
            "token": f"cs_{ch}", "sensor_token": f"sen_{ch}", "translation": t.tolist(),
            "rotation": q.tolist(), "camera_intrinsic": k})

    kappa, speed = 0.002, 5.0  # the road's curvature (1/m); the ego's speed (m/s)

    def road(s, h0, p0):
        h = h0 + kappa * s
        p = p0 + np.stack([np.sin(h) - np.sin(h0), -(np.cos(h) - np.cos(h0))], -1) / kappa
        return p, h

    def to_frame(pts, t, q):
        """Global (or parent-frame) points [n, 3] into a frame at (t, q)."""
        return (pts - t) @ geo.quat_rotation_matrix(q)

    n_ann = n_track = n_det = 0
    splits = {"train": [], "val": []}
    det_results = {"train": {}, "val": {}}
    for sc in range(scenes):
        name = f"scene-{sc + 1:04d}"
        split = "train" if sc < max(1, scenes // 2) else "val"
        splits[split].append(name)
        p0, h0 = np.array([600.0 + 300 * sc, 1600.0]), 0.3 + 0.5 * sc
        # objects: (category, w/l/h, arc-length start, speed, lateral offset,
        # against the road direction)
        objs = []
        for o in range(objects + others):
            if o < objects:
                k = o if o < len(NUSC_CLASSES) else rng.choice(len(NUSC_CLASSES), p=share)
                cat, _, size, v, _ = NUSC_CLASSES[k]
                ped = cat.startswith("human")
                lane = rng.choice([-8.0, 8.0]) if ped else rng.choice([-5.4, -1.8, 1.8, 5.4])
                flip = lane > 0 if not ped else bool(rng.random() < 0.5)
                v = 0.0 if (not ped and rng.random() < 0.2) else v * rng.uniform(0.6, 1.2)
                if not ped and v == 0.0:
                    lane = rng.choice([-9.0, 9.0])  # parked
            else:
                cat, size = NUSC_OTHER[o % len(NUSC_OTHER)]
                v, lane, flip = 0.0, rng.choice([-10.5, 10.5]), False
            wlh = np.array(size) * rng.uniform(0.9, 1.1, 3)
            objs.append((cat, wlh, rng.uniform(-60, speed * keyframes / 2 + 60), v, lane, flip))

        def obj_state(o, t):
            cat, wlh, s0, v, lane, flip = objs[o]
            s = s0 + (-v if flip else v) * t
            p, h = road(np.array(s), h0, p0)
            n = np.array([-np.sin(h), np.cos(h)])
            center = np.array([*(p + lane * n), wlh[2] / 2])
            yaw = h + (np.pi if flip else 0.0)
            vel = np.array([np.cos(h), np.sin(h), 0.0]) * (-v if flip else v)
            return center, wlh, yaw, vel

        def ego_state(t):
            p, h = road(np.array(speed * t), h0, p0)
            return np.array([*p, 0.0]), geo.yaw_to_quat(h), h

        inst_toks = [f"sc{sc}_inst{o}" for o in range(len(objs))]
        sample_toks = [f"sc{sc}_s{i}" for i in range(keyframes)]
        chain_last = {}  # channel -> last sample_data token (for prev/next)

        def add_sd(ch, t, sample_tok, key, filename, width=0, height=0):
            tok = f"sc{sc}_sd_{ch}_{len(tables['sample_data'])}"
            ep = f"sc{sc}_ep{len(tables['ego_pose'])}"
            et, eq, _ = ego_state(t)
            ts = NUSC_T0_US + sc * 10**8 + int(round(t * 1e6))
            tables["ego_pose"].append({"token": ep, "timestamp": ts, "rotation": eq.tolist(),
                                       "translation": et.tolist()})
            prev = chain_last.get(ch, "")
            if prev:
                sds_by_tok[prev]["next"] = tok
            rec = {"token": tok, "sample_token": sample_tok, "ego_pose_token": ep,
                   "calibrated_sensor_token": f"cs_{ch}", "timestamp": ts,
                   "fileformat": filename.rsplit(".", 1)[-1], "is_key_frame": key,
                   "height": height, "width": width, "filename": filename,
                   "prev": prev, "next": ""}
            tables["sample_data"].append(rec)
            sds_by_tok[tok] = rec
            chain_last[ch] = tok
            return tok

        sds_by_tok, anns_by_tok = {}, {}

        def ground(n):
            r = 3.0 + 67.0 * rng.random(n) ** 1.5
            a = rng.uniform(-np.pi, np.pi, n)
            return np.stack([r * np.cos(a), r * np.sin(a), rng.normal(-0.15, 0.03, n)], 1)

        def lidar_rows(ego_pts):
            """Ego-frame points -> LIDAR_TOP .pcd.bin rows (x, y, z,
            intensity, ring) in the sensor frame."""
            t_l, q_l = rigs["LIDAR_TOP"][:2]
            xyz = to_frame(ego_pts, t_l, q_l)
            return np.hstack([xyz, rng.uniform(0, 100, (len(xyz), 1)),
                              rng.integers(0, 32, (len(xyz), 1))]).astype(np.float32)

        def radar_bytes(rows):
            n = len(rows)
            dtype = np.dtype([(f, {("F", 4): "<f4", ("I", 1): "i1", ("I", 2): "<i2"}[(t, s)])
                              for f, s, t in RADAR_FIELDS])
            arr = np.zeros(n, dtype)
            for i, (f, _, _) in enumerate(RADAR_FIELDS):
                arr[f] = rows[:, i]
            head = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
                    f"FIELDS {' '.join(f for f, _, _ in RADAR_FIELDS)}\n"
                    f"SIZE {' '.join(str(s) for _, s, _ in RADAR_FIELDS)}\n"
                    f"TYPE {' '.join(t for _, _, t in RADAR_FIELDS)}\n"
                    f"COUNT {' '.join('1' for _ in RADAR_FIELDS)}\n"
                    f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n")
            return head.encode() + arr.tobytes()

        def radar_clutter(n):
            rows = np.zeros((n, 18))
            r, a = rng.uniform(5, 80, n), rng.uniform(-1.2, 1.2, n)
            rows[:, 0], rows[:, 1] = r * np.cos(a), r * np.sin(a)
            rows[:, 2] = rng.normal(0, 0.5, n)
            rows[:, 3] = rng.integers(0, 8, n)  # 7: filtered by the devkit's defaults
            rows[:, 4] = rng.integers(0, 120, n)
            rows[:, 5] = rng.normal(5, 5, n)
            rows[:, 6:10] = rng.normal(0, 1, (n, 4))
            rows[:, 10] = 1
            rows[:, 11] = np.where(rng.random(n) < 0.8, 3, rng.integers(0, 3, n))
            rows[:, 12:14] = rng.integers(0, 20, (n, 2))
            rows[:, 14] = np.where(rng.random(n) < 0.85, 0, rng.integers(1, 18, n))
            rows[:, 15:18] = rng.integers(0, 8, (n, 3))
            return rows

        # pools of ground-only files for the non-key sweeps
        pool_lidar = []
        for j in range(lidar_hz // 2 - 1):
            fn = f"sweeps/LIDAR_TOP/sc{sc}_pool{j}.pcd.bin"
            os.makedirs(os.path.join(root, os.path.dirname(fn)), exist_ok=True)
            lidar_rows(ground(lidar_points)).tofile(os.path.join(root, fn))
            pool_lidar.append(fn)
        pool_radar = {}
        for ch, _, _ in NUSC_RADARS:
            os.makedirs(os.path.join(root, "sweeps", ch), exist_ok=True)
            pool_radar[ch] = []
            for j in range(radar_hz // 2 - 1):
                fn = f"sweeps/{ch}/sc{sc}_pool{j}.pcd"
                with open(os.path.join(root, fn), "wb") as fh:
                    fh.write(radar_bytes(radar_clutter(radar_points)))
                pool_radar[ch].append(fn)
        for ch, _, _, _ in NUSC_CAMERAS:
            os.makedirs(os.path.join(root, "samples", ch), exist_ok=True)
            with open(os.path.join(root, "samples", ch, f"sc{sc}.jpg"), "wb") as fh:
                fh.write(b"\xff\xd8\xff\xe0" + bytes(60) + b"\xff\xd9")  # no decode happens
        for ch in ("LIDAR_TOP",) + tuple(r[0] for r in NUSC_RADARS):
            os.makedirs(os.path.join(root, "samples", ch), exist_ok=True)

        last_ann = {}
        ann_count = {}
        for i, stok in enumerate(sample_toks):
            t = 0.5 * i
            # the non-key sweeps since the previous keyframe (or lead-in)
            for j in range(lidar_hz // 2 - 1, 0, -1):
                add_sd("LIDAR_TOP", t - j / lidar_hz, stok, False, pool_lidar[j - 1])
            for ch, _, _ in NUSC_RADARS:
                for j in range(radar_hz // 2 - 1, 0, -1):
                    add_sd(ch, t - j / radar_hz, stok, False, pool_radar[ch][j - 1])
            et, eq, eh = ego_state(t)
            tables["sample"].append({
                "token": stok, "timestamp": NUSC_T0_US + sc * 10**8 + int(round(t * 1e6)),
                "prev": sample_toks[i - 1] if i else "",
                "next": sample_toks[i + 1] if i + 1 < keyframes else "", "scene_token": f"sc{sc}"})
            # objects in range at this keyframe
            lidar_obj, radar_obj = [], {ch: [] for ch, _, _ in NUSC_RADARS}
            frame_anns = []
            for o in range(len(objs)):
                center, wlh, yaw, vel = obj_state(o, t)
                d = float(np.linalg.norm(center[:2] - et[:2]))
                if d > 55.0:
                    continue
                c_ego = to_frame(center[None], et, eq)[0]
                n_l = 0 if rng.random() < 0.1 else int(min(600, 6000 / max(d, 4.0) ** 1.5))
                if n_l:
                    local = (rng.random((n_l, 3)) - 0.5) * wlh[[1, 0, 2]] * 0.95
                    rot = geo.quat_rotation_matrix(geo.yaw_to_quat(yaw - eh))
                    lidar_obj.append(local @ rot.T + c_ego)
                n_r = 0
                for ch, rt, ryaw in NUSC_RADARS:
                    c_r = to_frame(c_ego[None], np.array(rt), geo.yaw_to_quat(ryaw))[0]
                    if not (0 < c_r[0] < 70 and abs(np.arctan2(c_r[1], c_r[0])) < 1.2):
                        continue
                    k = int(rng.integers(1, 4))
                    local = (rng.random((k, 3)) - 0.5) * wlh[[1, 0, 2]] * 0.9
                    rot = geo.quat_rotation_matrix(geo.yaw_to_quat(yaw - eh - ryaw))
                    rows = np.zeros((k, 18))
                    rows[:, 0:3] = local @ rot.T + c_r
                    v_r = geo.quat_rotation_matrix(geo.yaw_to_quat(-(eh + ryaw)))[:2, :2] @ vel[:2]
                    rows[:, 3] = 0 if np.linalg.norm(vel) > 0.5 else 1
                    rows[:, 4] = rng.integers(0, 120, k)
                    rows[:, 5] = rng.normal(10, 4, k)
                    rows[:, 6:8] = v_r - [speed, 0.0]
                    rows[:, 8:10] = v_r
                    rows[:, 10] = 1
                    rows[:, 11] = 3
                    rows[:, 12:14] = rng.integers(0, 20, (k, 2))
                    rows[:, 15:18] = rng.integers(0, 8, (k, 3))
                    radar_obj[ch].append(rows)
                    n_r += k
                inst = inst_toks[o]
                atok = f"sc{sc}_ann{o}_{i}"
                prev = last_ann.get(inst, "")
                ann = {"token": atok, "sample_token": stok, "instance_token": inst,
                       "visibility_token": str(int(rng.integers(1, 5))), "attribute_tokens": [],
                       "translation": center.tolist(), "size": wlh.tolist(),
                       "rotation": geo.yaw_to_quat(yaw).tolist(),
                       "prev": prev, "next": "",
                       "num_lidar_pts": n_l, "num_radar_pts": n_r}
                if prev:
                    anns_by_tok[prev]["next"] = atok
                anns_by_tok[atok] = ann
                last_ann[inst] = atok
                ann_count[inst] = ann_count.get(inst, 0) + 1
                tables["sample_annotation"].append(ann)
                frame_anns.append((o, center, wlh, yaw, vel, d))
                n_ann += 1
                n_track += objs[o][0] in det_name
            # keyframe files: LIDAR_TOP, the radars, the cameras
            pts = np.vstack(lidar_obj + [np.zeros((0, 3))])
            pts = np.vstack([pts, ground(max(0, lidar_points - len(pts)))])[:lidar_points]
            fn = f"samples/LIDAR_TOP/sc{sc}_s{i}.pcd.bin"
            lidar_rows(pts).tofile(os.path.join(root, fn))
            add_sd("LIDAR_TOP", t, stok, True, fn)
            for ch, _, _ in NUSC_RADARS:
                rows = np.vstack(radar_obj[ch] + [np.zeros((0, 18))])
                rows = np.vstack([rows, radar_clutter(max(0, radar_points - len(rows)))])
                fn = f"samples/{ch}/sc{sc}_s{i}.pcd"
                with open(os.path.join(root, fn), "wb") as fh:
                    fh.write(radar_bytes(rows))
                add_sd(ch, t, stok, True, fn)
            for ch, _, _, _ in NUSC_CAMERAS:
                add_sd(ch, t, stok, True, f"samples/{ch}/sc{sc}.jpg", 1600, 900)
            # the detector: tracking-class GT boxes, 10% missed, noisy; false
            # positives; non-tracking detections the loader drops
            dets = []
            for o, center, wlh, yaw, vel, d in frame_anns:
                cat = objs[o][0]
                if cat not in det_name or rng.random() < 0.1:
                    continue
                sig = 0.15 * (1 + d / 40)
                dets.append({
                    "sample_token": stok,
                    "translation": (center + rng.normal(0, sig, 3) * [1, 1, 0.3]).tolist(),
                    "size": (wlh * rng.normal(1, 0.05, 3)).tolist(),
                    "rotation": geo.yaw_to_quat(yaw + rng.normal(0, 0.08)).tolist(),
                    "velocity": (vel[:2] + rng.normal(0, 0.4, 2)).tolist(),
                    "detection_name": det_name[cat],
                    "detection_score": float(rng.uniform(0.3, 0.95)),
                    "attribute_name": ""})
            n_gt = len(dets)
            for _ in range(int(round(0.4 * n_gt))):
                cat, name_, size, _, _ = NUSC_CLASSES[rng.choice(len(NUSC_CLASSES), p=share)]
                r, a = rng.uniform(3, 50), rng.uniform(-np.pi, np.pi)
                c = et + [r * np.cos(a), r * np.sin(a), size[2] / 2]
                dets.append({
                    "sample_token": stok, "translation": c.tolist(), "size": list(size),
                    "rotation": geo.yaw_to_quat(rng.uniform(-np.pi, np.pi)).tolist(),
                    "velocity": rng.normal(0, 1, 2).tolist(), "detection_name": name_,
                    "detection_score": float(rng.uniform(0.05, 0.5)), "attribute_name": ""})
            for _ in range(3):
                dets.append({
                    "sample_token": stok, "translation": (et + [8.0, 11.0, 0.5]).tolist(),
                    "size": [0.5, 2.5, 1.0], "rotation": [1.0, 0.0, 0.0, 0.0],
                    "velocity": [0.0, 0.0], "detection_name": "barrier",
                    "detection_score": float(rng.uniform(0.1, 0.9)), "attribute_name": ""})
            det_results[split][stok] = dets
            n_det += n_gt + int(round(0.4 * n_gt))
        for o, inst in enumerate(inst_toks):
            if inst not in ann_count:
                continue
            first = next(a for a in tables["sample_annotation"] if a["instance_token"] == inst)
            last = last_ann[inst]
            tables["instance"].append({
                "token": inst, "category_token": cat_tok[objs[o][0]],
                "nbr_annotations": ann_count[inst], "first_annotation_token": first["token"],
                "last_annotation_token": last})
        tables["log"].append({"token": f"log{sc}", "logfile": "", "vehicle": "n015",
                              "date_captured": "2018-07-24", "location": "singapore-onenorth"})
        tables["scene"].append({
            "token": f"sc{sc}", "log_token": f"log{sc}", "nbr_samples": keyframes,
            "first_sample_token": sample_toks[0], "last_sample_token": sample_toks[-1],
            "name": name, "description": "fabricated"})
    for name, rows in tables.items():
        with open(os.path.join(tdir, f"{name}.json"), "w") as fh:
            json.dump(rows, fh)
    splits_json = os.path.join(root, "splits.json")
    with open(splits_json, "w") as fh:
        json.dump(splits, fh)
    det_dir = os.path.join(root, "detections")
    os.makedirs(os.path.join(det_dir, "megvii"), exist_ok=True)
    meta = {"use_camera": False, "use_lidar": True, "use_radar": False, "use_map": False,
            "use_external": False}
    for split, results in det_results.items():
        with open(os.path.join(det_dir, "megvii", f"megvii_{split}.json"), "w") as fh:
            json.dump({"meta": meta, "results": results}, fh)
    return dict(root=root, version=version, splits_json=splits_json, det_dir=det_dir,
                scenes=scenes, keyframes=keyframes, lidar_points=lidar_points,
                annotations=n_ann, tracking_annotations=n_track, detections=n_det)



def time_sample_memo(tables, cfg, splits_json, pre, tmp, count=MEMO_TIME_ANNS):
    """4i: the lidar and radar preprocessors on the first ``count`` image
    annotations of ``pre``'s ``processed_img_anns.json``, with the port's
    memo of the last sample's clouds (``data/preprocess.py::_LastSample``)
    and without it (every annotation aggregates its sample's sweeps, as
    the JAX package does), in turns; the two write the same bytes. Returns
    seconds per turn and annotations per modality."""
    import hashlib
    import os

    from batch3dmot_tpu_torch.data import preprocess as tpre

    img = json.load(open(os.path.join(pre, "processed_img_anns.json")))
    split = next(k for k, v in img.items() if v)
    sub = {split: img[split][:count]}
    memo = tpre._LastSample

    class NoMemo(memo):
        def get(self, sample_token, key, make):
            return make()

    fns = {"lidar": tpre.preprocess_lidar_annotations, "radar": tpre.preprocess_radar_annotations}
    out = {}
    for kind, fn in fns.items():
        secs, digests, n = [], [], 0
        for turn, cls in enumerate((memo, NoMemo, NoMemo, memo)):
            d = os.path.join(tmp, f"memo_{kind}_{turn}")
            tpre._LastSample = cls
            try:
                t0 = time.perf_counter()
                anns = fn(tables, d, sub, cfg, splits_json=splits_json)
                secs.append(time.perf_counter() - t0)
            finally:
                tpre._LastSample = memo
            n = sum(map(len, anns.values()))
            digests.append({f: hashlib.sha1(open(os.path.join(d, f), "rb").read()).hexdigest()
                            for f in sorted(os.listdir(d))})
        assert all(dg == digests[0] for dg in digests), f"{kind}: the memo changed the bytes"
        out[kind] = dict(annotations=n, turns=secs, memo_s=(secs[0] + secs[3]) / 2,
                         no_memo_s=(secs[1] + secs[2]) / 2)
    return out


def responsive_model(model, scenes, windows_list, gain=RESPONSIVE_GAIN, seed=11,
                     buckets=None):
    """A copy of ``model`` whose scores move with the embeddings: its GNN
    weights drawn from ``seed`` at ``gain`` times ``init_params_``'s draw
    (a briefly trained model gives nearly constant scores: the sensor
    features fade through the attention encoder's five layers), its
    encoders kept, and the edge classifier's last layer set so
    that the logits over ``scenes``' windows (the module loop's) have mean
    0 and standard deviation 2 (``buckets``: the batcher's, for windows
    past the default buckets). 3f, 3j, 3k and 3l hold their comparisons on
    it."""
    import torch

    from batch3dmot_tpu_torch.models import init_params_
    from batch3dmot_tpu_torch.train.encoded import EncodedGraphBatcher, precompute_scene_encodings

    out = copy.deepcopy(model)
    init_params_(out, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in out.named_parameters():
            if p.dim() >= 2 and not name.startswith(FROZEN_NAMES):
                p.mul_(gain)
    for name in FROZEN_NAMES:
        if hasattr(model, name):
            getattr(out, name).load_state_dict(getattr(model, name).state_dict())
    out = out.cuda().eval()
    pairs = [(w, precompute_scene_encodings(out, scene))
             for scene, windows in zip(scenes, windows_list) for w in windows]
    last, logits = out.edge_classifier[-1], []
    hook = last.register_forward_hook(lambda mod, args, z: logits.append(z))
    try:
        with torch.no_grad():
            batcher = EncodedGraphBatcher(pairs, 8, **({} if buckets is None
                                                        else dict(buckets=buckets)))
            for graph, encs in batcher.epoch(shuffle=False):
                graph = graph.to("cuda")
                out.forward_from_encodings(graph, *(t.cuda() for t in encs))
                logits[-1] = logits[-1].reshape(graph.edge_mask.shape)[graph.edge_mask]
    finally:
        hook.remove()
    z = torch.cat(logits)
    mean, std = z.mean(), z.std()
    with torch.no_grad():
        last.weight.mul_(2.0 / std)
        last.bias.sub_(mean).mul_(2.0 / std)
    return out


def zeroed_scorer(model, slot):
    """A SceneEncodedScorer of ``model`` with one sensor's features zeroed,
    the controls of 3f, 3j and 3k (slot 0: camera, 1: lidar, 2: radar)."""
    from batch3dmot_tpu_torch.infer.predict import SceneEncodedScorer

    class Zeroed(SceneEncodedScorer):
        def _encode(self, *args):
            enc = list(super()._encode(*args))
            enc[slot] = enc[slot].new_zeros(enc[slot].shape)
            return tuple(enc)

    return Zeroed(model)


def score_quantiles(values):
    """The 0, 10, 50, 90 and 100% quantiles of scores, to show their spread."""
    return [float(x) for x in np.quantile(np.asarray(values), (0.0, 0.1, 0.5, 0.9, 1.0))]


def outside_avg(got, want):
    """Averaged edges of ``want`` whose ``got`` lies outside RTOL, ATOL."""
    return sum(abs(got[k] - v) > RTOL * abs(v) + ATOL for k, v in want.items())


def nuscenes_model_checks(cfg, model, scene, windows, full, train_store, enc_avg):
    """3k's checks of the kernels on the tree's own data, for train-gnn's
    checkpoint (``trained``) and for ``responsive_model`` of it (whose
    scores move with the embeddings: the trained ones barely do, and the
    readings print how little). Holds (a) the scene the device predict
    loaded from the tree to the val store's (detections and modality arrays
    equal); (b) for both models, the val store's windows through the kernel
    against the plain version window by window (RTOL, ATOL), and the CLI's
    encoded averages against the plain ones; (c) controls, lidar or radar
    features zeroed: the lidar one outside that tolerance for
    ``responsive`` (the radar features move its scores less, the readings
    print how much); (d) ``responsive`` through the device pipeline on the
    loaded scene against the encoded scorer on the store: the pipeline's
    lidar and radar encodings and presence flags (RTOL, ATOL), and its
    averaged scores (RTOL, ATOL; the lidar control outside); (e) one
    batch of the train store (the trainer's batcher and batch size) through
    the training pair against autograd of the plain version, for both
    models; (f) the bfloat16 encode on ``responsive``: the embeddings at
    RTOL, ATOL of its definition written out here (the point encoders in
    float32 on bf16-rounded weights, statistics and inputs), a control
    (unrounded weights) outside it, presence flags equal, scores within
    0.06 of float32; the two encodes timed in turns. Returns the readings."""
    import torch

    from batch3dmot_tpu_torch import cli
    from batch3dmot_tpu_torch.graph import IMG_SHAPE
    from batch3dmot_tpu_torch.infer.device_pipeline import DeviceScenePipeline
    from batch3dmot_tpu_torch.infer.predict import SceneEncodedScorer, average_scene_edges
    from batch3dmot_tpu_torch.io import GraphStoreReader
    from batch3dmot_tpu_torch.ops.fused_mp import extract_mp_params, fused_mp_scores_plain
    from batch3dmot_tpu_torch.ops.fused_mp_train import fused_mp_train_scores, train_forward_cuda
    from batch3dmot_tpu_torch.train.encoded import EncodedGraphBatcher, precompute_scene_encodings

    out = {}
    # (a) the device predict's input, extracted from the tree, is the store's
    assert full.num_detections == scene.num_detections, (full.num_detections,
                                                          scene.num_detections)
    for name in ("frame_idx", "class_id", "lidar", "radar"):
        a, b = getattr(full, name), getattr(scene, name)
        assert a.shape == b.shape and np.array_equal(a, b), name
    model = model.cuda().eval()
    responsive = responsive_model(model, [scene], [windows])

    def outside(a, b):
        return int((np.abs(a - b) > RTOL * np.abs(b) + ATOL).sum())

    win_scores = {}
    for tag, m in (("trained", model), ("responsive", responsive)):
        # (b), (c)
        k = SceneEncodedScorer(m).score_scene(scene, windows)
        p = plain_scorer(m).score_scene(scene, windows)
        assert [a.shape for a in k] == [b.shape for b in p]
        plain_err, witness = held_to_plain(k, p, lambda m=m: plain_scorer(
            m, float64=True).score_scene(scene, windows), f"3k {tag} window scores")
        flat = np.concatenate(k)
        r = dict(plain_err=plain_err, plain_witness=witness, scores=score_quantiles(flat),
                 edges=int(flat.size))
        for slot, sensor in ((1, "lidar"), (2, "radar")):
            c = zeroed_scorer(m, slot).score_scene(scene, windows)
            r[f"{sensor}_control_err"] = max(float(np.abs(a - b).max())
                                             for a, b in zip(k, c) if a.size)
            r[f"{sensor}_control_outside"] = sum(outside(b, a) for a, b in zip(k, c))
            if slot == 1:
                win_scores[tag] = (k, c)
        if tag == "trained":
            r["cli_vs_plain"] = max_avg_diff(enc_avg, average_scene_edges(windows, p))
        out[tag] = r
    assert out["responsive"]["lidar_control_outside"] > 0, out["responsive"]

    # (d) the device pipeline on the tree's scene against the encoded scorer:
    # its encodings (kept from its encode_frozen call) and its averages
    k, c = win_scores["responsive"]
    enc_s, ctrl_s = average_scene_edges(windows, k), average_scene_edges(windows, c)
    kept, encode = [], responsive.encode_frozen

    def keep(img, lidar, radar):
        enc = encode(img, lidar, radar)
        kept.append((lidar, radar, *enc))
        return enc

    responsive.encode_frozen = keep
    try:
        dev_s = DeviceScenePipeline(responsive, 5, cfg.graph_construction.top_knn_nodes
                                    ).score_scenes([full])[0]
    finally:
        del responsive.encode_frozen
    assert len(kept) == 1, len(kept)
    m_det = scene.num_detections
    img = torch.zeros((m_det, *IMG_SHAPE), device="cuda")
    lidar, radar = torch.from_numpy(scene.lidar).cuda(), torch.from_numpy(scene.radar).cuda()
    with torch.inference_mode():
        want = SceneEncodedScorer(responsive)._encode(img, lidar, radar)
    d_lidar, d_radar, _, d_pn, d_rn = (t[:m_det] for t in kept[0])
    assert torch.equal(d_lidar.sum(dim=(1, 2)) != 0, want[3])
    assert torch.equal(d_radar.sum(dim=(1, 2)) != 0, want[4])
    torch.testing.assert_close(d_pn, want[1], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(d_rn, want[2], rtol=RTOL, atol=ATOL)
    out["responsive"]["device_encodings_err"] = max(float((d_pn - want[1]).abs().max()),
                                                    float((d_rn - want[2]).abs().max()))
    if dev_s.keys() == enc_s.keys():
        out["responsive"]["device_vs_encoded"] = max_avg_diff(dev_s, enc_s)
        ctrl = sum(abs(dev_s[e] - v) > RTOL * abs(v) + ATOL for e, v in ctrl_s.items())
        out["responsive"]["device_control_outside"] = int(ctrl)
        assert ctrl > 0, "the device comparison does not see zeroed lidar features"
    else:
        out["responsive"]["device_vs_encoded"] = None  # a kNN near-tie (the trained run counts it)

    # (e) one train-store batch through the training pair and the plain version
    rng = np.random.default_rng(12)
    train_windows = GraphStoreReader(train_store).windows()
    tscene = cli._scene_from_store(train_store, train_windows, with_modalities=True)
    for tag, m in (("trained", model), ("responsive", responsive)):
        enc = precompute_scene_encodings(m, tscene)
        graph, encs = next(EncodedGraphBatcher([(w, enc) for w in train_windows],
                                               cfg.gnn.batch_size, seed=1).epoch())
        graph, encs = graph.to("cuda"), [t.cuda() for t in encs]
        with torch.no_grad():
            x0, e0, att, _ = m.pre_message_passing(graph, *encs)
        inputs = (x0, e0, att, graph.edge_src, graph.edge_dst, graph.edge_mask)
        flat_w, meta = extract_mp_params(m, True, m.node_dim, m.edge_dim)
        with torch.no_grad():
            got = train_forward_cuda(*inputs, flat_w, meta, m.depth, False)[:4]
            ref = fused_mp_scores_plain(*inputs, flat_w, meta, m.depth, False, carries=True)
        # scores at RTOL, ATOL (held_to_plain); the stashes at RTOL and ATOL
        # x max|plain| of the tensor (the tree's raw pose features scale the
        # node and edge features far past 1); the readings print each
        # tensor's scale and how many of its elements fall outside the
        # unscaled ATOL
        f_err, stash = 0.0, {}
        for what, a, b in zip(("scores", "x_t", "e_t", "agg_t"), got, ref):
            scale = float(b.abs().max())
            diff = (a - b).abs()
            stash[what] = dict(max_plain=scale, max_diff=float(diff.max()),
                               outside_atol=int((diff > RTOL * b.abs() + ATOL).sum()))
            if what == "scores":
                held_to_plain(a, b, lambda m=m, inputs=inputs, flat_w=flat_w, meta=meta:
                              fused_mp_plain64(*inputs, flat_w, meta, m.depth),
                              f"3k train store batch ({tag}) scores")
            else:
                torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL * max(1.0, scale),
                                           msg=lambda e, w=what: f"{tag} {w} {stash[w]}: {e}")
            f_err = max(f_err, float(diff.max()))
        ct = torch.from_numpy(rng.uniform(-1.0, 1.0, tuple(x0.shape[:1]) + tuple(e0.shape[1:2]))
                              .astype(np.float32)).cuda()
        _, g_k = train_grads(m, inputs, ct, m.depth, False, fused_mp_train_scores)
        _, g_p = train_grads(m, inputs, ct, m.depth, False, fused_mp_scores_plain)

        def plain64(m=m, inputs=inputs, ct=ct):
            m64 = copy.deepcopy(m).double()
            i64 = [t.double() if t is not None and t.is_floating_point() else t for t in inputs]
            return train_grads(m64, i64, ct.double(), m.depth, False, fused_mp_scores_plain)[1]

        err, tied = compare_grads(g_k, g_p, plain64, f"3k train store batch ({tag})")
        out[tag].update(train_batch=[int(x) for x in graph.edge_mask.shape],
                        train_edges=int(graph.edge_mask.sum()), train_fwd_err=f_err,
                        train_stashes=stash,
                        train_grad_err=err, train_grad_tied=len(tied),
                        train_grad_max=max(float(g.abs().max()) for g in g_p.values()))
        m.zero_grad(set_to_none=True)

    # (f) encode_dtype on the responsive model
    f32 = SceneEncodedScorer(responsive)
    bf16 = SceneEncodedScorer(responsive, encode_dtype="bfloat16")
    s32 = np.concatenate(f32.score_scene(scene, windows))
    s16 = np.concatenate(bf16.score_scene(scene, windows))
    bf16_err = float(np.abs(s32 - s16).max())
    assert bf16_err <= 0.06, bf16_err
    rounded = [t.bfloat16().float() for t in (lidar, radar)]
    definition = copy.deepcopy(f32.model)
    for name in ("pointnet", "radarnet"):
        for t in (*getattr(definition, name).parameters(), *getattr(definition, name).buffers()):
            if t.is_floating_point():
                t.data = t.data.bfloat16().float()
    with torch.inference_mode():
        e32, e16 = f32._encode(img, lidar, radar), bf16._encode(img, lidar, radar)
        assert torch.equal(e32[3], e16[3]) and torch.equal(e32[4], e16[4])
        want = definition.encode_frozen(img, *rounded)
        unrounded = f32.model.encode_frozen(img, *rounded)
        def_err = ctrl_err = emb_err = 0.0
        ctrl_out = 0
        for i in (1, 2):  # pn, rn (no images on the card)
            torch.testing.assert_close(e16[i], want[i], rtol=RTOL, atol=ATOL)
            def_err = max(def_err, float((e16[i] - want[i]).abs().max()))
            ctrl_err = max(ctrl_err, float((unrounded[i] - want[i]).abs().max()))
            ctrl_out += int(((unrounded[i] - want[i]).abs()
                             > RTOL * want[i].abs() + ATOL).sum())
            emb_err = max(emb_err, float((e32[i] - e16[i]).abs().max()))
        assert ctrl_out > 0, "the unrounded-weights control met the bfloat16 definition"
        enc_turns = [cuda_ms(lambda s=s: s._encode(img, lidar, radar), 10)
                     for s in (f32, bf16, bf16, f32)]
    out["bf16"] = dict(score_err=bf16_err, embedding_err=emb_err, definition_err=def_err,
                       control_err=ctrl_err, control_outside=ctrl_out, turns=enc_turns,
                       detections=m_det)
    return out


def nuscenes_phase(card):
    """Phase 3k: the port's CLI (``cli.main`` in this process, ``--set``
    overrides only, the card by default) on a nuScenes-shaped tree that
    ``write_nuscenes_tree`` writes from a seed (2 scenes of 40 keyframes,
    one train and one val; lidar and radar, no images: the card's machine
    has no PIL): ``validate-data --strict``, ``preprocess --modality all``
    (twice, then ``--skip-existing``), ``train-pointnet`` and
    ``train-radarnet --device-dataset``, ``build-graphs`` (train, and val
    for predict), ``train-gnn --model mm --encoded`` with both encoders
    grafted, ``predict --pipeline encoded`` and ``--pipeline device`` on
    the val split, ``export-gt``, ``eval`` and ``eval --devkit``. Holds the
    second preprocess byte-identical and the skipped one writing nothing,
    every lidar artifact inside its box, GT matches and positive edges in
    every class of the stores, each call's kernel launches to their exact
    count, the device predict against the encoded one (RTOL, ATOL; the
    same predicted edges, submission and AMOTA but at counted near-ties),
    and ``nuscenes_model_checks``. 4i: each call's wall time, preprocess
    annotations/s per modality, the last-sample memo's gain
    (``time_sample_memo``), build-graphs detections/s by stage, predict's
    rate lines, and the float32 and bfloat16 encodes in turns. Returns the
    launches per kernel, the timings and the checked readings."""
    import ast
    import glob
    import hashlib
    import os
    import shutil

    import torch

    from batch3dmot_tpu_torch import cli
    from batch3dmot_tpu_torch import geometry as geo
    from batch3dmot_tpu_torch.config import TRACKING_CLASS_NAMES
    from batch3dmot_tpu_torch.data.nuscenes_tables import NuScenesTables
    from batch3dmot_tpu_torch.eval.tracking_metrics import json_safe
    from batch3dmot_tpu_torch.graphs import build_scene_graphs
    from batch3dmot_tpu_torch.graphs.build_device import build_scene_graphs_device
    from batch3dmot_tpu_torch.graphs.statistics import edge_class_histogram
    from batch3dmot_tpu_torch.infer import device_pipeline
    from batch3dmot_tpu_torch.infer.predict import greedy_round, threshold_edges
    from batch3dmot_tpu_torch.io import GraphStoreReader
    from batch3dmot_tpu_torch.train.data import group_sizes_by_bucket
    from batch3dmot_tpu_torch.train.trainer import WARMUP_STEPS
    from batch3dmot_tpu_torch.utils.checkpoint import load_checkpoint

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="b3d_nusc_")
    t0 = time.perf_counter()
    tree = write_nuscenes_tree(os.path.join(tmp, "nuscenes"), seed=0)
    t_write = time.perf_counter() - t0
    sets = [f"paths.tmp={tmp}/run", f"paths.data={tree['root']}",
            f"paths.splits_json={tree['splits_json']}", f"paths.detections_dir={tree['det_dir']}",
            "main.version=v1.0-trainval", "detections.megvii.train=megvii/megvii_train.json",
            "detections.megvii.val=megvii/megvii_val.json", "main.sensors_used.img=false"]
    argv_sets = [a for kv in sets for a in ("--set", kv)]
    cfg = cli.Config()
    cfg.apply_overrides(sets)
    val_graphs = os.path.join(tmp, "graphs_val")
    times, launches, outputs = {}, {}, {}

    def run(tag, argv):
        """One CLI call: its result, wall time, printed lines and the
        kernels it launched (every count set to 0 just before)."""
        out = io.StringIO()
        torch.cuda.synchronize()
        counters(reset=True)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = cli.main([*argv, *argv_sets])
        torch.cuda.synchronize()
        times[tag] = time.perf_counter() - t0
        launches[tag] = counters()
        outputs[tag] = out.getvalue()
        for line in outputs[tag].splitlines()[-6:]:
            log(f"  [{tag}] {line}")
        return result

    def digests(d):
        return {os.path.relpath(p, d): hashlib.sha1(Path(p).read_bytes()).hexdigest()
                for p in sorted(glob.glob(os.path.join(d, "**", "*"), recursive=True))
                if os.path.isfile(p)}

    def mtimes(d):
        return {p: os.stat(p).st_mtime_ns
                for p in glob.glob(os.path.join(d, "**", "*"), recursive=True)}

    def latest(pattern):
        return sorted(glob.glob(pattern), key=os.path.getmtime)[-1]

    zero = dict(fused_mp=0, fwd=0, bwd=0, segment_sum=0)
    try:
        # 1. the doctor, strict
        run("validate-data", ["validate-data", "--strict"])
        assert "validate-data: 0 error(s), 0 warning(s)" in outputs["validate-data"]

        # 2. preprocess: twice byte-identical, then --skip-existing writes nothing
        pre = cfg.paths.preprocessed
        said = run("preprocess", ["preprocess", "--modality", "all"])
        first = digests(pre)
        run("preprocess again", ["preprocess", "--modality", "all"])
        assert digests(pre) == first, "a second preprocess wrote other bytes"
        before = mtimes(pre)
        assert run("preprocess --skip-existing", ["preprocess", "--skip-existing"]) == {}
        assert mtimes(pre) == before, "preprocess --skip-existing wrote files"
        # every lidar artifact inside its box (1.001: the float32 rounding of
        # the saved ego-frame points)
        tables = NuScenesTables(tree["root"], tree["version"])
        lidar_anns = json.load(open(os.path.join(pre, "processed_lidar_anns.json")))
        n_clouds = n_points = 0
        for e in {e["sample_annotation_token"]: e for v in lidar_anns.values() for e in v}.values():
            ann = tables.get("sample_annotation", e["sample_annotation_token"])
            ego_t, ego_q = tables.ego_pose_of_sample(ann["sample_token"])
            c_e, q_e, _ = geo.boxes_global_to_ego(
                np.array([ann["translation"]]), np.array([ann["rotation"]]), np.zeros((1, 3)),
                ego_t, ego_q)
            pts = np.load(os.path.join(pre, "lidar", f"{ann['token']}.npy"))
            assert geo.points_in_box(c_e[0], np.array(ann["size"]), q_e[0], pts[0:3].astype(float),
                                     wlh_factor=1.001).all(), ann["token"]
            n_clouds += 1
            n_points += pts.shape[1]
        assert n_clouds > 500 and n_points > 20 * n_clouds, (n_clouds, n_points)
        for tag in ("validate-data", "preprocess", "preprocess again", "preprocess --skip-existing"):
            assert launches[tag] == zero, (tag, launches[tag])
        memo = time_sample_memo(tables, cfg, tree["splits_json"], pre, tmp)

        # 3. the point encoders on the artifacts, one epoch each
        for enc in ("pointnet", "radarnet"):
            hist = run(f"train-{enc}", [f"train-{enc}", "--device-dataset", "--epochs", "1"])
            assert np.isfinite(hist[0]["train/nll"]) and launches[f"train-{enc}"] == zero
        enc_ck = {enc: latest(os.path.join(cfg.paths.models, enc, "*.pt"))
                  for enc in ("pointnet", "radarnet")}

        # 4. stores: the train split (for train-gnn) and the val split (for
        # the encoded predict)
        build = run("build-graphs", ["build-graphs"])
        build_val = run("build-graphs val", ["build-graphs", "--set", "graph_construction.split=val",
                                             "--set", f"paths.graphs_dir={val_graphs}"])
        train_p = sorted(glob.glob(os.path.join(cfg.paths.graphs_dir, "*.b3d")))
        val_p = sorted(glob.glob(os.path.join(val_graphs, "*.b3d")))
        assert len(train_p) == 1 and len(val_p) == 1, (train_p, val_p)
        hist = edge_class_histogram(train_p + val_p)
        pos, matched = {}, {}
        for p in train_p + val_p:
            reader = GraphStoreReader(p)
            for i in range(reader.num_windows):
                cls, src = reader.array(i, "node_class"), reader.array(i, "edge_src")
                lab = reader.array(i, "edge_label")
                for c in np.unique(cls):
                    name = TRACKING_CLASS_NAMES[int(c)]
                    pos[name] = pos.get(name, 0) + int(lab[cls[src] == c].sum())
            for md in json.load(open(p.replace(".b3d", "_metadata.json"))):
                matched[md["category_name"]] = matched.get(md["category_name"], 0) + bool(md["token"])
        # the classes present: GT in at least 3 keyframes of a scene
        present = set()
        for scene_rec in tables.scenes:
            frames = {}
            for tok in tables.scene_sample_tokens(scene_rec["token"]):
                for c in set(tables.gt_frame_boxes(tok).class_id.tolist()):
                    frames[c] = frames.get(c, 0) + 1
            present |= {TRACKING_CLASS_NAMES[c] for c, n in frames.items() if n >= 3}
        assert len(present) >= 5, present
        assert all(pos.get(c, 0) > 0 and matched.get(c, 0) > 0 and hist[c] > 0
                   for c in present), (present, pos, matched)
        for tag in ("build-graphs", "build-graphs val"):
            assert launches[tag] == zero, (tag, launches[tag])

        # 5. train-gnn mm --encoded with both encoders grafted: one store, so
        # train and validation sets are that store's windows
        sizes = {p: [(n, e) for n, e in zip(*GraphStoreReader(p).window_sizes())
                     if n > 0 and e > 0] for p in train_p + val_p}
        hist_mm = run("train-gnn mm", ["train-gnn", "--model", "mm", "--encoded", "--epochs", "1",
                                       "--pointnet-checkpoint", enc_ck["pointnet"],
                                       "--radarnet-checkpoint", enc_ck["radarnet"]])
        out = outputs["train-gnn mm"]
        assert "grafted frozen pointnet" in out and "grafted frozen radarnet" in out, out
        groups = len(group_sizes_by_bucket(sizes[train_p[0]]))
        per = WARMUP_STEPS + 1
        want = dict(fused_mp=per * groups, fwd=per * groups, bwd=per * groups,
                    segment_sum=2 * per * groups)
        assert launches["train-gnn mm"] == want, (launches["train-gnn mm"], want)
        assert np.isfinite(hist_mm[0]["train/loss"]), hist_mm
        ck = latest(os.path.join(cfg.paths.models, "gnn", "*.pt"))

        # 6. predict on the val split: encoded over its stores (no caches:
        # the raw encode), the device pipeline straight from the tree at the
        # stores' window; one scene: one launch of the device pipeline
        run("predict encoded", ["predict", "--pipeline", "encoded", "--checkpoint", ck,
                                "--set", f"paths.graphs_dir={val_graphs}",
                                "--set", f"paths.eval={tmp}/eval_encoded"])
        loaded, load = [], cli._load_nuscenes_scenes

        def recording(*args, **kw):
            for sc in load(*args, **kw):
                loaded.append(sc)
                yield sc

        cli._load_nuscenes_scenes = recording
        try:
            run("predict device", ["predict", "--pipeline", "device", "--checkpoint", ck,
                                   "--set", "predict.batch_size_graph=5",
                                   "--set", f"paths.eval={tmp}/eval_device"])
        finally:
            cli._load_nuscenes_scenes = load
        assert len(loaded) == 1, len(loaded)
        n_live = len(sizes[val_p[0]])
        for tag, n in (("predict encoded", -(-n_live // 8)), ("predict device", 1)):
            assert launches[tag] == dict(zero, fused_mp=n), (tag, launches[tag], n)

        def scores_of(tag):
            p = glob.glob(os.path.join(tmp, f"eval_{tag}", "predict", "*_edge_scores.json"))
            assert len(p) == 1, p
            return {ast.literal_eval(k): v for k, v in json.load(open(p[0])).items()}

        enc_avg, dev_avg = scores_of("encoded"), scores_of("device")
        model = cli._make_cli_model(cfg, "mm")
        model.load_state_dict(load_checkpoint(ck, map_location="cpu"))
        windows = GraphStoreReader(val_p[0]).windows()
        scene = cli._scene_from_store(val_p[0], windows, with_modalities=True)
        thresholds = cfg.predict.edge_score_thresholds
        dev_err, knn_flips, dev_flips, sub_diff = 0.0, 0, 0, None
        if dev_avg.keys() == enc_avg.keys():
            dev_err = max_avg_diff(dev_avg, enc_avg)
            preds = [(greedy_round(threshold_edges(a, scene, thresholds)), a)
                     for a in (dev_avg, enc_avg)]
            dev_flips, unexplained = rounding_flips(preds[:1], preds[1:], [scene])
            assert unexplained == 0, unexplained
        else:
            # a kNN near-tie: the card's windows hold the host builder's but at it
            full = loaded[0]
            q = device_pipeline.DeviceScenePipeline(model, 5, 40)._quanta(full)
            knn_flips, _ = compare_builds(
                full, list(build_scene_graphs(full, 5, cfg.graph_construction)),
                build_scene_graphs_device(full, 5, cfg.graph_construction, max_nodes=q[2]), 5, 40)
            assert knn_flips > 0
        gt_path = os.path.join(tmp, "gt.json")
        run("export-gt", ["export-gt", "--out", gt_path])
        gt = json.load(open(gt_path))
        assert gt["frames"] and all(t.startswith("sc1_") for t in gt["frames"])
        res = {tag: run(f"eval {tag}", ["eval", "--submission",
                                        os.path.join(tmp, f"eval_{tag}", "submission.json"),
                                        "--gt", gt_path])
               for tag in ("encoded", "device")}
        if dev_flips == 0 and knn_flips == 0:
            sub_diff = submission_diff(
                json.load(open(os.path.join(tmp, "eval_device", "submission.json"))),
                json.load(open(os.path.join(tmp, "eval_encoded", "submission.json"))))
            assert sub_diff <= 1e-6, sub_diff
            assert res["device"].amota == res["encoded"].amota, (res["device"].amota,
                                                                 res["encoded"].amota)
        assert np.isfinite(res["encoded"].amota)
        try:
            run("eval --devkit", ["eval", "--submission",
                                  os.path.join(tmp, "eval_encoded", "submission.json"), "--devkit"])
        except SystemExit as e:
            assert str(e.code).startswith("nuscenes-devkit is not installed"), e.code
        else:
            raise AssertionError("eval --devkit ran without the devkit")
        for tag in ("export-gt", "eval encoded", "eval device"):
            assert launches[tag] == zero, (tag, launches[tag])

        # 7. the kernels on the tree's windows against the plain version, the
        # comparisons on a model whose scores move with the embeddings, and
        # encode_dtype (nuscenes_model_checks)
        mc = nuscenes_model_checks(cfg, model, scene, windows, loaded[0], train_p[0], enc_avg)
        total = dict(zero)
        for c in launches.values():
            for k, v in c.items():
                total[k] += v

        log(f"3k nuScenes tree written in {t_write:.2f} s: {tree['scenes']} scenes x "
            f"{tree['keyframes']} keyframes, {tree['annotations']} annotations "
            f"({tree['tracking_annotations']} in tracking classes), {tree['detections']} "
            f"tracking-class detections; LIDAR_TOP {tree['lidar_points']} points x "
            f"{cfg.preprocessing.nsweeps_lidar} sweeps, 5 radars x "
            f"{cfg.preprocessing.nsweeps_radar} sweeps")
        log(f"3k CLI on {card}: kernels launched (every count reset before each call) "
            + "; ".join(f"{k} {v}" for k, v in launches.items() if v != zero))
        log(f"3k preprocess: a second run byte-identical ({len(first)} files), --skip-existing "
            f"wrote nothing; {n_clouds} lidar clouds ({n_points} points) inside their boxes")
        log(f"3k stores: classes with GT in 3+ keyframes {sorted(present)}; positive edges "
            f"{pos}; GT-matched detections {matched}; edge class histogram {hist}")
        log(f"3k predict --pipeline device vs encoded (val scene): max|avg diff| {dev_err:.3e} "
            f"(RTOL {RTOL:g}, ATOL {ATOL:g}); kNN near-tie windows {knn_flips}; predicted edges "
            f"at a near-tie {dev_flips}; submission box fields within {sub_diff}; AMOTA "
            f"encoded {res['encoded'].amota!r} device {res['device'].amota!r}")
        for tag in ("trained", "responsive"):
            r = mc[tag]
            log(f"3k {tag} model on the val store's {len(windows)} windows ({r['edges']} edges; "
                f"scores min/10%/median/90%/max "
                + "/".join(f"{x:.6f}" for x in r["scores"])
                + f"): max|kernel-plain| {r['plain_err']:.3e} window by window (RTOL {RTOL:g}, "
                f"ATOL {ATOL:g})"
                + (f", the CLI's encoded averages vs the plain ones {r['cli_vs_plain']:.3e}"
                   if "cli_vs_plain" in r else "")
                + "; controls, features zeroed: " + ", ".join(
                    f"{x} max|diff| {r[f'{x}_control_err']:.3e}, "
                    f"{r[f'{x}_control_outside']} edges outside" for x in ("lidar", "radar")))
            log(f"3k {tag} model, one train-store batch {tuple(r['train_batch'])} "
                f"({r['train_edges']} valid edges) through the training pair: max|kernel-plain| "
                f"scores and stashes {r['train_fwd_err']:.3e} ("
                + ", ".join(f"{w} max|plain| {v['max_plain']:.3e} max|diff| {v['max_diff']:.3e} "
                            f"{v['outside_atol']} outside ATOL {ATOL:g}"
                            for w, v in r["train_stashes"].items())
                + f"), gradients {r['train_grad_err']:.3e} "
                f"(max|plain| {r['train_grad_max']:.3e}; {r['train_grad_tied']} tensors held to "
                f"the relative L2 bound)")
        r = mc["responsive"]
        log(f"3k responsive model, device pipeline on the tree-loaded val scene vs the encoded "
            f"scorer on the store: lidar and radar encodings max|diff| "
            f"{r['device_encodings_err']:.3e}, presence flags equal; max|avg diff| "
            f"{r['device_vs_encoded']} (RTOL {RTOL:g}, ATOL {ATOL:g}); the lidar-zeroed control puts "
            f"{r.get('device_control_outside')} edges outside; the loaded scene's detections "
            f"and lidar and radar arrays equal the store's")
        b = mc["bf16"]
        log(f"3k encode_dtype=bfloat16, responsive model, val scene ({b['detections']} detections): "
            f"max|score - float32| {b['score_err']:.3e} (<= 0.06); embeddings "
            f"{b['embedding_err']:.3e} from float32, {b['definition_err']:.3e} from the "
            f"definition (RTOL {RTOL:g}, ATOL {ATOL:g}); control, unrounded weights: "
            f"{b['control_err']:.3e}, {b['control_outside']} elements outside; presence flags "
            f"equal")
        wall = {k: v for k, v in times.items()}
        rates = {k: dict(annotations=v["annotations"], seconds=v["seconds"],
                         per_s=v["annotations"] / v["seconds"]) for k, v in said.items()}
        builds = {tag: dict(b, per_s=b["detections"] / b["seconds"])
                  for tag, b in (("train", build), ("val", build_val))}
        log(f"4i CLI wall times on {card}: " + ", ".join(f"{k} {v:.2f} s" for k, v in wall.items()))
        log(f"4i preprocess on {card}'s host: " + ", ".join(
            f"{k} {v['annotations']} annotations in {v['seconds']:.2f} s "
            f"({v['per_s']:.1f}/s)" for k, v in rates.items()))
        for tag, b in builds.items():
            log(f"4i build-graphs {tag} on {card}'s host: {b['detections']} detections in "
                f"{b['seconds']:.2f} s ({b['per_s']:.1f}/s): tables and matching "
                f"{b['tables']:.2f} s, modality extraction {b['modalities']:.2f} s, graph build "
                f"{b['graphs']:.2f} s, store write {b['write']:.2f} s")
        for kind, r in memo.items():
            log(f"4i preprocess {kind} on {card}'s host, {r['annotations']} annotations: with "
                f"the last-sample memo {r['memo_s']:.2f} s "
                f"({r['annotations'] / r['memo_s']:.1f}/s), without {r['no_memo_s']:.2f} s "
                f"({r['annotations'] / r['no_memo_s']:.1f}/s), "
                f"{r['no_memo_s'] / r['memo_s']:.2f}x; turns with/without/without/with "
                + "/".join(f"{t:.2f}" for t in r["turns"]) + " s; the same bytes")
        for tag in ("predict encoded", "predict device"):
            log(f"4i  {[ln for ln in outputs[tag].splitlines() if ln.startswith('predict[')][-1].split(' -> ')[0]}")
        enc_turns = mc["bf16"]["turns"]
        log(f"4i encode of the val scene's {scene.num_detections} detections on {card}: float32 "
            f"{(enc_turns[0] + enc_turns[3]) / 2:.3f} ms, bfloat16 "
            f"{(enc_turns[1] + enc_turns[2]) / 2:.3f} ms (turns f32/bf16/bf16/f32 "
            + "/".join(f"{t:.3f}" for t in enc_turns) + f" ms); phase 3k and 4i "
            f"{time.perf_counter() - t_phase:.1f} s")
        timing = dict(wall_s=wall, tree_write_s=t_write, preprocess=rates, sample_memo=memo,
                      build_graphs=builds,
                      encode_ms=dict(float32=(enc_turns[0] + enc_turns[3]) / 2,
                                     bfloat16=(enc_turns[1] + enc_turns[2]) / 2, turns=enc_turns))
        checks = dict(device_vs_encoded=dev_err, knn_flip_windows=knn_flips,
                      near_tie_edges=dev_flips, submission_diff=sub_diff,
                      amota=json_safe(dict(encoded=res["encoded"].amota,
                                           device=res["device"].amota)),
                      models=mc,
                      lidar_clouds_in_box=n_clouds, phase_s=time.perf_counter() - t_phase)
        return dict(launches=total, per_call={k: v for k, v in launches.items() if v != zero},
                    timing=timing, checks=checks)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- the flagship and the widened cover (phase 3l) ------------------------------

# 3l: seed 0 of scripts/torch_flagship_error_bar.py at its defaults must
# reach this AMOTA; the JAX package's five seeds gave 0.9865 +- 0.0004
# (docs/flagship_sweep_r05.json)
FLAGSHIP_MIN_AMOTA = 0.980
JAX_FLAGSHIP_AMOTA = (0.9865, 0.0004)
# a dense scene for the device pipeline: 2,766 detections over 6 frames,
# whose 5-frame windows pad to the cover's 2,560 nodes (a nuScenes sample
# holds up to 500 boxes), at kNN 40
DENSE_SCENE = dict(seed=21, num_frames=6, num_tracks=640, with_modalities=True,
                   modality_dropout=0.2)


def flagship_phase():
    """Phase 3l: (a) seed 0 of the flagship error bar's defaults
    (``scripts/torch_flagship_error_bar.py``: 80 epochs of the full-width
    depth-6 mm trained from scratch on 12 scenes through ``fit_device``,
    then 30 held-out scenes through the encode-once scorer and AMOTA) in
    this process, its kernel launches counted (every count set to 0 just
    before); AMOTA at least FLAGSHIP_MIN_AMOTA; (b) B1-B3 at the widened
    cover, (2560, 102400) x1 (the flax draw, its random inputs scaled and
    the classifier's last bias set so that the logits have mean 0 and
    standard deviation 2), against the plain version at RTOL, ATOL,
    bit-identical across two runs, and a shape past it refused; (c) a
    dense scene (windows of more than 1,024 nodes) through the device
    pipeline with ``responsive_model`` of (a)'s trained model against the
    pipeline's module loop (``fused=False``) at RTOL, ATOL, one fused
    launch, its scores spread. Returns what it measured."""
    import os
    import re

    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import torch_flagship_error_bar as error_bar
    import torch_flagship_synthetic as flagship

    from batch3dmot_tpu_torch.config import GraphConstructionConfig
    from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
    from batch3dmot_tpu_torch.graphs import build_scene_graphs
    from batch3dmot_tpu_torch.infer.device_pipeline import DeviceScenePipeline
    from batch3dmot_tpu_torch.models import MultimodalGNN, init_params_, make_model
    from batch3dmot_tpu_torch.ops.fused_mp import (
        COVER,
        extract_mp_params,
        fused_mp_plan,
        fused_mp_scores_cuda,
        fused_mp_scores_plain,
        pack_mp_weights,
    )
    from batch3dmot_tpu_torch.utils.checkpoint import load_checkpoint

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="b3d_flagship_")
    ckpt = os.path.join(tmp, "seed0.pt")
    # (a)
    args = flagship.build_parser().parse_args(error_bar.seed_argv(0, 80, 30, ckpt))
    counters(reset=True)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        summary = flagship.run(args)
    t_flagship = time.perf_counter() - t0
    launches = counters()
    printed = json.loads(re.search(r"^kernels (\{.*\})$", out.getvalue(), re.M).group(1))
    training = re.search(r"^training: .*$", out.getvalue(), re.M).group(0)
    assert printed["launches"] == launches, (printed, launches)
    assert all(v > 0 for v in launches.values()), f"a kernel of the flagship never ran: {launches}"
    log(f"3l (a) flagship seed 0 (error-bar defaults: 80 epochs, 12 scenes, 30 held-out): "
        f"AMOTA {summary['amota']!r} (the JAX package's five seeds "
        f"{JAX_FLAGSHIP_AMOTA[0]} +- {JAX_FLAGSHIP_AMOTA[1]}), AMOTP {summary['amotp']!r}, "
        f"final train AP {summary['final_train_ap']!r}, {training}, held-out "
        f"{summary['inference_edges']} edges in {summary['inference_s']:.2f} s; launches "
        f"{launches} (the warm-up steps and captures; {printed['graph_replays']} replays, "
        f"{printed['graph_captures']} captures), {t_flagship:.1f} s")
    assert summary["amota"] >= FLAGSHIP_MIN_AMOTA, (summary, FLAGSHIP_MIN_AMOTA)

    # (b) on the flax draw (init_params_), inputs scaled as said below
    model = init_params_(make_model("mm"), torch.Generator().manual_seed(0)).cuda().eval()
    nd, ed = model.node_dim, model.edge_dim
    n, e = COVER
    flat, meta = extract_mp_params(model, True, nd, ed)
    _, _, widths = pack_mp_weights(flat, meta, nd, ed, True)
    for past in ((n + 1, e), (n, e + 1)):
        try:
            fused_mp_plan(1, *past, widths, True)
        except ValueError as err:
            assert str(COVER) in str(err), err
        else:
            raise AssertionError(f"{past} past the cover was not refused")
    with torch.inference_mode():
        # random edges give nodes of degree ~40, and six layers of such sums
        # put the logits of unit inputs in the hundreds (the sigmoid
        # saturates: a blind comparison); the draw's biases are zero, so its
        # ReLU network is positively homogeneous: inputs scaled by c scale
        # the logits by c, here to a standard deviation of 2, and the
        # classifier's last bias (zero) then moves their mean to 0
        inputs = random_inputs(np.random.default_rng(15), 1, n, e, nd, ed, True)
        mask = inputs[-1]
        unit = fused_mp_scores_plain(*inputs, flat, meta, 6, logits=True)[mask]
        input_scale = 2.0 / float(unit.std())
        inputs = tuple(t * input_scale if t.is_floating_point() else t for t in inputs)
        model.edge_classifier[-1].bias.fill_(-input_scale * float(unit.mean()))
        flat, meta = extract_mp_params(model, True, nd, ed)
        got = fused_mp_scores_cuda(*inputs, flat, meta, 6)
        again = fused_mp_scores_cuda(*inputs, flat, meta, 6)
        ref = fused_mp_scores_plain(*inputs, flat, meta, 6)
        torch.cuda.synchronize()
        assert torch.equal(got, again), "two fused_mp runs at the cover differ"
        torch.testing.assert_close(got[mask], ref[mask], rtol=RTOL, atol=ATOL)
        cover_err = float((got[mask] - ref[mask]).abs().max())
        cover_quant = score_quantiles(got[mask].cpu().numpy())
        assert cover_quant[3] - cover_quant[1] > 0.1, f"saturated scores: {cover_quant}"
        k_ms = cuda_ms(lambda: fused_mp_scores_cuda(*inputs, flat, meta, 6), 5)
        p_ms = cuda_ms(lambda: fused_mp_scores_plain(*inputs, flat, meta, 6), 2)
        flops, nbytes = mp_work(inputs, widths, 6)
        b_ms, b_by = bound(flops, nbytes)
    log(f"3l (b) kernel fused_mp at the cover {COVER} x1: max|kernel-plain| {cover_err:.3e} "
        f"(scores {cover_quant} at the 0/10/50/90/100% quantiles; unit inputs' logits "
        f"{score_quantiles(unit.cpu().numpy())}, inputs scaled by {input_scale:.3e}) over "
        f"{int(mask.sum())} "
        f"valid edges; bit-identical across two runs; kernel "
        f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
        f"({n + 1}, {e}) and ({n}, {e + 1}) refused")
    del inputs, got, again, ref, mask

    # (c) on responsive_model of (a)'s trained model (whose scores on such
    # a scene, far from its training data, are all near 0)
    trained = MultimodalGNN(depth=6)
    trained.load_state_dict(load_checkpoint(ckpt))
    scene = make_synthetic_scene(**DENSE_SCENE, classes=list(TRAINVAL_CLASS_MIX))
    host_windows = [w for w in build_scene_graphs(scene, 5, GraphConstructionConfig(
        top_knn_nodes=40)) if w.num_edges > 0]
    resp = responsive_model(trained, [scene], [host_windows], gain=DENSE_RESPONSIVE_GAIN,
                            buckets=(COVER,))
    pipe = DeviceScenePipeline(resp, 5, 40)
    _, windows, max_nodes = pipe._quanta(scene)
    assert 1024 < max_nodes <= COVER[0], max_nodes
    counters(reset=True)
    dense = pipe.score_scene(scene)
    dense_launches = counters()["fused_mp"]
    assert dense_launches == 1, dense_launches
    loop = DeviceScenePipeline(resp, 5, 40, fused=False).score_scene(scene)
    dense_err = max_avg_diff(dense, loop)
    quant = score_quantiles(list(dense.values()))
    assert quant[3] - quant[1] > 0.1, f"the dense scene's scores do not move: {quant}"
    log(f"3l (c) device pipeline on a dense scene ({scene.num_detections} detections, "
        f"{windows} windows of ({max_nodes}, {max_nodes * 40})): {len(dense)} averaged edges "
        f"(scores {quant} at the 0/10/50/90/100% quantiles), fused vs module loop max|avg "
        f"diff| {dense_err:.3e}, {dense_launches} fused launch")
    t_total = time.perf_counter() - t_phase
    log(f"3l: {t_total:.1f} s")
    return dict(
        flagship=dict(amota=summary["amota"], amotp=summary["amotp"],
                      final_train_ap=summary["final_train_ap"],
                      steps_per_s=summary["steps_per_s"],
                      inference_edges=summary["inference_edges"],
                      inference_s=summary["inference_s"], graph_replays=printed["graph_replays"],
                      seconds=t_flagship, jax_amota=JAX_FLAGSHIP_AMOTA),
        launches=launches,
        cover=dict(shape=list(COVER), max_abs_err=cover_err, scores=cover_quant,
                   input_scale=input_scale, ms=k_ms, plain_ms=p_ms,
                   bound_ms=b_ms, bound_by=b_by),
        dense_scene=dict(detections=scene.num_detections, windows=windows,
                         max_nodes=max_nodes, edges=len(dense), max_abs_err=dense_err,
                         scores=quant, launches=dense_launches),
        seconds=t_total,
    )


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
    report = cuda_build.build(["fused_mp", "fused_mp_train", "segment_sum", "tc_probe"])
    for name, r in report.items():
        log(f"build {name}: {r['seconds']:.1f} s ({nvcc})")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    # ---- 1b. how the tensor cores round, one product per route ----------
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import probe_tc_rounding

    tc_rounding = probe_tc_rounding.rounding_probe()
    for line in probe_tc_rounding.summary(tc_rounding):
        log(f"tc probe {line}")
    # the kernels' half_ulp rounds a step's sum to nearest only on an adder
    # that cuts toward zero; on one that rounds to nearest it is a bias
    for name, r in tc_rounding.items():
        assert probe_tc_rounding.rounds(r["models"]) == "toward zero", (
            name, "the tensor cores' sums do not cut toward zero, which half_ulp "
            "(csrc/tc_gemm.cuh) assumes", r["models"][:4])
    tc_products = probe_tc_rounding.product_probe()
    for route, r in tc_products["routes"].items():
        log(f"tc probe {route}, {tc_products['shape']} on {tc_products['activations']}: "
            f"max|x-f64| {r['product']['max']:.3e} ({r['ratio']:.3f}x float32's), lean "
            f"{r['product']['lean']:+.3f}; sums of {tc_products['rows_summed']} rows "
            f"{r['sums']['max']:.3e} ({r['sums_ratio']:.3f}x), lean {r['sums']['lean']:+.3f}")
        if route in probe_tc_rounding.KERNEL_ROUTES:
            assert max(r["ratio"], r["sums_ratio"]) <= F64_RATIO, (route, r)
        elif route == probe_tc_rounding.CONTROL:
            assert r["ratio"] > F64_RATIO, ("the TF32 control is within float32's distance", r)

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
            case = f"kernel fused_mp {name} ({n},{e}) x{windows} empty={empty}"
            if mask.any():
                err, _ = held_to_plain(got[mask], ref[mask], lambda: fused_mp_plain64(
                    *inputs, flat, meta, 6, logits=pose)[mask], case)
                max_err = max(max_err, err)
            else:
                err = float((got - ref).abs().max())
            # the logits too: on init_params_'s draw random inputs saturate
            # many scores, whose comparison then sees nothing
            logit_err = err if pose else 0.0
            if not pose and mask.any():
                got_l = fused_mp_scores_cuda(*inputs, flat, meta, 6, logits=True)
                ref_l = fused_mp_scores_plain(*inputs, flat, meta, 6, logits=True)
                logit_err, _ = held_to_plain(got_l[mask], ref_l[mask], lambda: fused_mp_plain64(
                    *inputs, flat, meta, 6, logits=True)[mask], f"{case} logits")
                if (name, (n, e), windows) in F64_CASES:
                    # ROADMAP C.5's check on the inference kernel's logits
                    l64 = fused_mp_plain64(*inputs, flat, meta, 6, logits=True)[mask]
                    d_k, d_p, ratio = f64_distances(got_l[mask], ref_l[mask], l64)
                    s_k, s_p, s_ratio = f64_distances(got[mask], ref[mask], torch.sigmoid(l64))
                    log(f"{case} against float64: logits max|kernel-f64| {d_k:.3e}, "
                        f"max|plain32-f64| {d_p:.3e}, ratio {ratio:.3f} (held to "
                        f"{F64_RATIO:g}); scores {s_k:.3e}, {s_p:.3e}, ratio {s_ratio:.3f} "
                        f"({int(((ref[mask] == 0) | (ref[mask] == 1)).sum())} of "
                        f"{int(mask.sum())} valid scores at 0 or 1 in float32)")
                    assert ratio <= F64_RATIO, (case, "logits further from float64", d_k, d_p)
            log(f"{case}: max|kernel-plain| {err:.3e} over {int(mask.sum())} valid edges "
                f"(logits {logit_err:.3e}); bit-identical across two runs")
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
    fwd_err, bwd_err, relu_readings = training_pair_checks(models, rng)

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

    plain_scores = plain_scorer(model).score_scenes(scenes, windows_list)
    for ss, ps in zip(scores, plain_scores):
        assert [a.shape for a in ss] == [b.shape for b in ps]
    path_err, _ = held_to_plain(
        [a for ss in scores for a in ss], [a for ps in plain_scores for a in ps],
        lambda: [a for ss in plain_scorer(model, float64=True).score_scenes(
            scenes, windows_list) for a in ss], "main path scores")
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
    def pose_plain_scores(plain):
        fused_mp.fused_mp_scores_cuda = plain
        try:
            return score_windows(noop_scorer, all_windows)
        finally:
            fused_mp.fused_mp_scores_cuda = fused_mp_scores_cuda

    pose_plain = pose_plain_scores(fused_mp_scores_plain)
    for w, a, b in zip(all_windows, pose_scores, pose_plain):
        assert a.shape == b.shape == (w.num_edges,) and np.isfinite(a).all()
        assert ((a >= 0) & (a <= 1)).all()
    noop_pose_err, _ = held_to_plain(pose_scores, pose_plain, lambda: pose_plain_scores(
        lambda *args, **kw: fused_mp_plain64(*args, **kw).float()), "'noop' PoseGNN windows")
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
    # version from the same start, then 10 more kernel steps (STEP_LR, no
    # decay)
    batch = next(EncodedGraphBatcher(pairs, 2, seed=1, uniform=True).epoch())
    step_cfg = GNNConfig(batch_size=2, lr=STEP_LR, weight_decay=0.0)
    tk = GNNTrainer(make_model("mm"), step_cfg, init_state_dict=start_sd)
    tp = GNNTrainer(make_model("mm"), step_cfg, init_state_dict=start_sd)
    lk = [float(tk.train_step(batch)[0]) for _ in range(3)]
    with plain_training():
        lp = [float(tp.train_step(batch)[0]) for _ in range(3)]

    def plain64_steps():
        t64 = GNNTrainer(make_model("mm"), step_cfg, init_state_dict=start_sd)
        with plain_training(float64=True):
            return [float(t64.train_step(batch)[0]) for _ in range(3)]

    held_to_plain(np.array(lk), np.array(lp), plain64_steps, "3 mm steps' losses",
                  rtol=1e-4, atol=0.0)
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
    act_err, act_windows, flips = compare_active(mm_run, run_k, run_p, convs,
                                                 "active path scores")
    seg_err = max(seg_err, act_err)
    log(f"active path: score_scenes {active_ms:.2f} ms (CUDA events), host "
        f"{active_host_ms:.2f} ms, {n_edges / (active_ms / 1e3):.0f} edges/s; "
        f"{sum(len(p) for p, _ in preds_a)} predicted edges, {n_tracks_a} tracks, "
        f"{len(boxes_a)} boxes; AMOTA {res_a.amota:.4f} (untrained random weights)")
    log(f"active path scores vs the plain segment sum: max|kernel-plain| {act_err:.3e} "
        f"over {act_windows - len(flips)} of {act_windows} windows with the same kNN "
        f"graphs; kNN flips at near-ties: {len(flips)} windows ({flip_summary(flips)})")
    replay_err = replayed_err(mm_run, run_k, "active path, kNN graphs replayed")
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
    pose_err, pose_windows, pose_flips = compare_active(pose_run, run_k, run_p, convs,
                                                        "active PoseGNN windows")
    seg_err = max(seg_err, pose_err)
    pose_replay = replayed_err(pose_run, run_k, "active PoseGNN, kNN graphs replayed")
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
    # ((128, 1024) x2); the segment sum's backward is a gather, every
    # gather's (gather_rows) a segment sum, so two runs of the same steps
    # are bit-identical (the torch.gather formulation's spread is printed)
    active_sd = {k: v.clone() for k, v in active_mm.state_dict().items()}
    pose_sd = {k: v.clone() for k, v in active_pose.state_dict().items()}
    encs_a = [precompute_scene_encodings(active_mm, sc) for sc in scenes]
    pairs_a = [(w, enc) for ws, enc in zip(windows_list, encs_a) for w in ws]
    small = [w for w in all_windows if pick_bucket(w.num_nodes, w.num_edges) == (128, 1024)]
    pose_b = GraphBatcher(small, 2, buckets=((128, 1024),), seed=0)
    active_train, repro = {}, {}
    for name, sd, batcher in (
        ("mm", active_sd, EncodedGraphBatcher(pairs_a, 2, seed=0, uniform=True)),
        ("pose", pose_sd, pose_b),
    ):
        # 4 steps (pose's bucket has 3 batches: its first comes again)
        batches = list(itertools.islice(itertools.cycle(list(batcher.epoch())), 4))
        tr = GNNTrainer(make_model(name, knn_conv_mode="active"), GNNConfig(**clr),
                        init_state_dict=sd)
        frozen_a = {k: v.clone() for k, v in tr.model.state_dict().items()
                    if k.split(".")[0] in FROZEN_ENCODERS}
        segment_sum.launches = 0
        losses = [float(tr.train_step(b)[0]) for b in batches]
        torch.cuda.synchronize()
        steps_launches = segment_sum.launches
        per_step = active_step_launches(6, name == "mm")
        assert steps_launches == per_step * len(batches), (name, steps_launches, per_step)
        assert np.isfinite(losses).all(), losses
        # the same 4 steps again from the same state: bit-identical
        # parameters and Adam moments; then twice through torch.gather
        # (a reading)
        tr2 = GNNTrainer(make_model(name, knn_conv_mode="active"), GNNConfig(**clr),
                         init_state_dict=sd)
        for b in batches:
            tr2.train_step(b)
        differ, _ = state_diff(trainer_state(tr), trainer_state(tr2))
        assert not differ, (name, "two runs of the same active steps differ", differ[:5])
        with atomic_gathers():
            old = []
            for _ in range(2):
                t_old = GNNTrainer(make_model(name, knn_conv_mode="active"), GNNConfig(**clr),
                                   init_state_dict=sd)
                for b in batches:
                    t_old.train_step(b)
                old.append(trainer_state(t_old))
        old_differ, old_diff = state_diff(*old)
        repro[name] = dict(steps=len(batches), launches=steps_launches, per_step=per_step,
                           torch_gather_tensors_differ=len(old_differ),
                           torch_gather_max_diff=old_diff)
        del tr2, t_old, old
        state = tr.model.state_dict()
        for k, v in frozen_a.items():
            assert torch.equal(state[k], v), f"frozen {k} moved"
        batch = batches[0]
        tk = GNNTrainer(make_model(name, knn_conv_mode="active"), step_cfg, init_state_dict=sd)
        tp = GNNTrainer(make_model(name, knn_conv_mode="active"), step_cfg, init_state_dict=sd)
        lk = [float(tk.train_step(batch)[0]) for _ in range(3)]
        with plain_segment_sum():
            lp = [float(tp.train_step(batch)[0]) for _ in range(3)]

        def plain64_steps(name=name, sd=sd, batch=batch):
            t64 = GNNTrainer(make_model(name, knn_conv_mode="active"), step_cfg,
                             init_state_dict=sd)
            with plain_segment_sum(float64=True):
                return [float(t64.train_step(batch)[0]) for _ in range(3)]

        held_to_plain(np.array(lk), np.array(lp), plain64_steps,
                      f"3 active {name} steps' losses", rtol=1e-4, atol=0.0)
        more = [float(tk.train_step(batch)[0]) for _ in range(10)]
        assert more[-1] < lk[0], (name, lk, more)
        shape = tuple(batch[0].edge_src.shape if isinstance(batch, tuple)
                      else batch.edge_src.shape)
        active_train[name] = (tk, batch)
        log(f"active training {name}: {len(batches)} steps of {shape}, segment_sum "
            f"launches {steps_launches} ({per_step} per step), losses "
            f"{[f'{v:.6f}' for v in losses]}; a second run of the steps bit-identical "
            f"(parameters and Adam moments); two runs through torch.gather: "
            f"{len(old_differ)} tensors differ, max {old_diff:.3e}"
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
    pose_cfg = GNNConfig(batch_size=2, lr=STEP_LR, weight_decay=0.0)
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
    # per forward and 20 in the backward (active_step_launches), through
    # fit_device on 8 windows of the active encodings, against eager
    # train_steps on the same rows; a second epoch from the same start
    # bit-identical; an epoch under use_deterministic_algorithms(warn_only)
    # must have no op that torch flags
    act_ds = materialize_encoded_dataset(pairs_a[:8])
    act_batches = epoch_batches(act_ds, 2, 7)
    t_act, h_act, act_dev_losses = resident("mm", active_sd, act_ds, mode="active")
    t_ref = GNNTrainer(make_model("mm", knn_conv_mode="active"), clr_cfg,
                       init_state_dict=active_sd)
    act_losses, act_step, c_act = eager_steps(t_ref, act_batches)
    act_per_step = active_step_launches(6, True)
    assert c_act["segment_sum"] == act_step.get("segment_sum_kernel") == act_per_step, (
        c_act, act_step, act_per_step)
    np.testing.assert_allclose(act_dev_losses, act_losses, rtol=1e-4)
    act_rel = max_rel_diff(act_dev_losses, act_losses)
    act_diff, act_at = max_param_diff(t_act, t_ref)
    assert act_diff <= 2 * lr * len(act_batches), act_diff
    t_act2, _, act_dev_losses2 = resident("mm", active_sd, act_ds, mode="active")
    act_state = trainer_state(t_act)
    differ, _ = state_diff(act_state, trainer_state(t_act2))
    assert not differ and act_dev_losses2 == act_dev_losses, ("two active fit_device epochs "
                                                              "differ", differ[:5])
    with atomic_gathers():
        t_old = [resident("mm", active_sd, act_ds, mode="active")[0] for _ in range(2)]
    old_differ, old_diff = state_diff(*(trainer_state(t) for t in t_old))
    probe = GNNTrainer(make_model("mm", knn_conv_mode="active"), clr_cfg,
                       init_state_dict=active_sd)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            probe.fit_device(act_ds, epochs=1, verbose=False, seed=7)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    act_flagged = sorted({str(w.message).split(" does not have a deterministic")[0][:160]
                          for w in caught if "determinis" in str(w.message)})
    log(f"fit_device active mm: ops torch flags nondeterministic in an epoch: {act_flagged}")
    assert not act_flagged, act_flagged
    repro["fit_device"] = dict(steps=len(act_batches), per_step=act_per_step, flagged=act_flagged,
                               torch_gather_tensors_differ=len(old_differ),
                               torch_gather_max_diff=old_diff)
    del t_act2, t_old, probe
    rep_act = replayed(t_act, lambda: t_act.fit_device(act_ds, epochs=1, verbose=False),
                       len(act_batches), act_step)
    log(f"fit_device active mm: {len(act_batches)} steps ({act_per_step} segment sums per "
        f"step); a second epoch from the same start bit-identical (parameters, Adam moments, "
        f"losses); two epochs through torch.gather: {len(old_differ)} tensors differ, max "
        f"{old_diff:.3e}; losses step by step vs eager: max "
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

    # the same checks on a model whose scores move with the embeddings
    # (responsive_model; the seeded phase-3 model's scores barely do), with
    # float32 point uploads as the scorer's: the pipeline's averages against
    # the encoded scorer on the same graphs and against the kernel's plain
    # version, grouped against per scene, its predicted edges against the
    # encoded path's; camera- and lidar-zeroed controls must put averaged
    # edges outside RTOL, ATOL; the radar features (which move these scores
    # less) are held at the encoding level, a zeroed control outside
    resp = responsive_model(model, scenes, windows_list, gain=DENSE_RESPONSIVE_GAIN)
    pipe_r = DeviceScenePipeline(resp, 5, 40, point_dtype="float32")
    pipe_r.score_scene(scenes[0])  # warm-up
    kept, encode = [], resp.encode_frozen

    def keep(img, lidar, radar):
        enc = encode(img, lidar, radar)
        kept.append((lidar, radar, *enc))
        return enc

    resp.encode_frozen = keep
    try:
        r_singles = [pipe_r.score_scene(sc) for sc in scenes]
    finally:
        del resp.encode_frozen
    assert len(kept) == len(scenes), len(kept)

    class RecordingEncoder(SceneEncodedScorer):
        """The encoded scorer, keeping each scene's encodings."""

        kept = None

        def _encode(self, *args):
            enc = super()._encode(*args)
            self.kept.append(enc)
            return enc

    rec = RecordingEncoder(resp)
    rec.kept = []
    r_host = [average_scene_edges(ws, rec.score_scene(sc, ws))
              for sc, ws in zip(scenes, dev_windows)]
    r_host_err = max(max_avg_diff(a, h) for a, h in zip(r_singles, r_host))
    fused_mp.fused_mp_scores_cuda = fused_mp_scores_plain
    try:
        r_plain = [pipe_r.score_scene(sc) for sc in scenes]
    finally:
        fused_mp.fused_mp_scores_cuda = fused_mp_scores_cuda
    r_plain_err = max(max_avg_diff(a, b) for a, b in zip(r_singles, r_plain))
    with grouping_forced():
        r_grouped = pipe_r.score_scenes(scenes)
    r_group_err = max(max_avg_diff(g, a) for g, a in zip(r_grouped, r_singles))
    r_ctrl = {}
    for slot, sensor in ((0, "camera"), (1, "lidar"), (2, "radar")):
        zeroed = zeroed_scorer(resp, slot)
        r_ctrl[sensor] = sum(outside_avg(average_scene_edges(ws, zeroed.score_scene(sc, ws)), a)
                             for sc, ws, a in zip(scenes, dev_windows, r_singles))
    log(f"device pipeline on the responsive model: averaged edges outside RTOL, ATOL with "
        f"one sensor's features zeroed: {r_ctrl}")
    assert r_ctrl["camera"] > 0 and r_ctrl["lidar"] > 0, (r_ctrl, "zeroed features stay "
                                                          "within RTOL, ATOL")
    r_enc_err, r_radar_ctrl = 0.0, 0
    for sc, (lidar, radar, x_img, pn, rn), want in zip(scenes, kept, rec.kept):
        m_det = sc.num_detections
        assert torch.equal(lidar[:m_det].sum(dim=(1, 2)) != 0, want[3][:m_det])
        assert torch.equal(radar[:m_det].sum(dim=(1, 2)) != 0, want[4][:m_det])
        for got, ref in ((x_img, want[0]), (pn, want[1]), (rn, want[2])):
            torch.testing.assert_close(got[:m_det], ref[:m_det], rtol=RTOL, atol=ATOL)
            r_enc_err = max(r_enc_err, float((got[:m_det] - ref[:m_det]).abs().max()))
        r_radar_ctrl += int((want[2][:m_det].abs() > RTOL * want[2][:m_det].abs() + ATOL).sum())
    assert r_radar_ctrl > 0, "zeroed radar encodings stay within RTOL, ATOL"
    r_preds = predict_scenes(SceneEncodedScorer(resp), items)
    r_preds_dev = [predict_scene_device(resp, sc, cfg_dev) for sc in scenes]
    r_flips, r_unexplained = rounding_flips(r_preds_dev, r_preds, scenes)
    assert r_unexplained == 0, r_unexplained
    r_amota = [submission_and_amota(items, pr)[3].amota for pr in (r_preds_dev, r_preds)]
    r_quant = score_quantiles([v for a in r_singles for v in a.values()])
    log(f"device pipeline on the responsive model (averaged scores {r_quant} at the 0/10/50/"
        f"90/100% quantiles): max|pipeline - host path| {r_host_err:.3e}, max|kernel - plain| "
        f"{r_plain_err:.3e}, max|grouped - singles| {r_group_err:.3e}; averaged edges outside "
        f"RTOL, ATOL with camera features zeroed {r_ctrl['camera']}, lidar {r_ctrl['lidar']} "
        f"(radar, a reading: {r_ctrl['radar']}); "
        f"encodings vs the scorer's max|diff| {r_enc_err:.3e} (presence flags equal), zeroed "
        f"radar encodings {r_radar_ctrl} elements outside; predicted edges vs predict_scenes: "
        f"{r_flips} at a near-tie of the two paths' averages; AMOTA {r_amota[0]:.4f} vs "
        f"{r_amota[1]:.4f}")
    pipe_responsive = dict(scores=r_quant, host_err=r_host_err, plain_err=r_plain_err,
                           group_err=r_group_err, controls=r_ctrl, radar_control=r_radar_ctrl,
                           encodings_err=r_enc_err, near_tie_edges=r_flips, amota=r_amota)
    max_err = max(max_err, r_plain_err)
    del resp, pipe_r, kept, rec, r_plain, r_grouped

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
    def act_pipe_plain(float64=False):
        with replay_knn(knn_caps), plain_segment_sum(float64):
            return [pipe_a.score_scene(sc) for sc in scenes]

    act_plain = act_pipe_plain()
    act_pipe_err, _ = held_avgs(act_singles, act_plain, lambda: act_pipe_plain(float64=True),
                                "active device pipeline, kNN graphs replayed")
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

    # ---- 3j. the CLI (and its timing, 4h) ------------------------------------
    cli_run = cli_phase(card)

    # ---- 3k. the nuScenes data plane through the CLI (and its timing, 4i) -------
    nusc_run = nuscenes_phase(card)

    # ---- 3l. the flagship from scratch and the widened cover ------------------
    flag_run = flagship_phase()

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
    per_call = f"{dev_ms / seg_seen:.4f} ms" if seg_seen else "not measured"
    log(f"  device time per call: segment_sum {per_call} ({seg_seen} of 20 "
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

        def gather_step(tk=tk, batch=batch):
            with atomic_gathers():
                tk.train_step(batch)

        turns_s = [cuda_ms(plain_step, 3), cuda_ms(lambda: tk.train_step(batch), 5),
                   cuda_ms(lambda: tk.train_step(batch), 5), cuda_ms(plain_step, 3)]
        # the cost of the reproducible gathers: the same step with
        # torch.gather's atomic backward (before) and with gather_rows (after)
        turns_g = [cuda_ms(gather_step, 20), cuda_ms(lambda: tk.train_step(batch), 20),
                   cuda_ms(lambda: tk.train_step(batch), 20), cuda_ms(gather_step, 20)]
        graph = batch[0] if isinstance(batch, tuple) else batch
        after, before = (turns_g[1] + turns_g[2]) / 2, (turns_g[0] + turns_g[3]) / 2
        repro[name].update(step_ms=after, torch_gather_step_ms=before, turns=turns_g)
        log(f"timing active train step {name} (Adam included) at "
            f"{tuple(graph.edge_src.shape)} ({int(graph.edge_mask.sum())} valid edges): "
            f"kernel {(turns_s[1] + turns_s[2]) / 2:.3f} ms, plain segment sum "
            f"{(turns_s[0] + turns_s[3]) / 2:.3f} ms (turns plain/kernel/kernel/plain "
            + "/".join(f"{t:.3f}" for t in turns_s) + " ms); the reproducible gathers "
            f"{after:.3f} ms vs torch.gather's atomic backward {before:.3f} ms, "
            f"{after / before:.3f}x (turns gather/rows/rows/gather "
            + "/".join(f"{t:.3f}" for t in turns_g) + " ms)")
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

    # the streaming epoch on a trainer of its own (3g's, whose replays 3g
    # traced, crashed the process when traced again on an H100)
    t_s4 = GNNTrainer(make_model("mm"), clr_cfg, init_state_dict=start_sd)
    stream4 = StreamingEncodedBatcher(paths, t_s4.model, loader, clr["batch_size"], seed=4,
                                      uniform=True)
    t_form = GNNTrainer(make_model("mm"), clr_cfg, init_state_dict=start_sd)
    enc_b = EncodedGraphBatcher(pairs, 2, seed=0, uniform=True)
    warm_run = lambda: t_s4.fit(stream4, epochs=1, verbose=False, fused_steps=4)  # noqa: E731
    enc_run = lambda: t_form.fit(enc_b, epochs=1, verbose=False, fused_steps=4)  # noqa: E731
    warm_run()  # capture
    enc_run()
    for p in paths:
        Path(p + ".enc.npz").unlink()
    cold_calls = count_calls(t_s4.model, "encode_frozen")
    cold_ms = wall_epoch_ms(warm_run)
    del t_s4.model.encode_frozen
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
    del t_s, t_s4, t_form, t_ps, t_pm
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
        # 1b: how the tensor cores round their sums, one product per route
        tc_probe=dict(rounding={k: v["models"] for k, v in tc_rounding.items()},
                      products=tc_products),
        # the device pipeline (3f, 4d): launches of its per-scene and grouped
        # runs, and the kernel at the group's window grid
        device_pipeline=dict(
            launches=single_launches, grouped_launches=group_launches,
            responsive=pipe_responsive,
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
            # 2b: the backward's own ReLU masks (its debug mask output, off
            # on the training path) against float64, and the gradients
            # replaying them, case by case
            **(dict(relu_masks=dict(tau=RELU_TAU, cases=relu_readings))
               if tag == "bwd" else {}),
        ))
    kernels.append(dict(
        name="segment_sum", route="cuda", source="batch3dmot_tpu_torch/csrc/segment_sum.cu",
        replaces="batch3dmot_tpu/ops/pallas_segment.py:29 (via :56)",
        launches=active_launches, max_abs_err=seg_err, ms=seg_ms, plain_ms=seg_plain_ms,
        bound_ms=seg_bound_ms, bound_by=seg_bound_by, library_ms=seg_lib_ms,
        device_pipeline=dict(launches=act_single_launches,
                             grouped_launches=act_group_launches),
        # the store paths' 'noop' mm steps: the attention rows' gathers in
        # the backward
        store_path=dict(launches=c_store["segment_sum"] + c_raw["segment_sum"]),
        # 3d, 3e, 4c: active training, every gather's backward a segment
        # sum: launches per step, bit-identical reruns, the step's time
        active_training=repro,
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
    # 3j: each kernel's launches by the CLI's calls (each wrapper's count
    # from its reset just before a call to just after it); 4h's timing once
    for k, key in zip(kernels, ("fused_mp", "fwd", "bwd", "segment_sum")):
        k["cli"] = dict(launches=cli_run["launches"][key],
                        **(dict(per_call={t: c[key] for t, c in cli_run["per_call"].items()},
                                timing=cli_run["timing"]) if key == "fwd" else {}),
                        **(dict(responsive=cli_run["responsive"]) if key == "fused_mp" else {}))
    # 3k: each kernel's launches by the nuScenes-tree CLI calls (counted as
    # 3j counts them); 4i's timing and 3k's checked values once
    for k, key in zip(kernels, ("fused_mp", "fwd", "bwd", "segment_sum")):
        k["nuscenes"] = dict(launches=nusc_run["launches"][key],
                             **(dict(per_call={t: c[key] for t, c in nusc_run["per_call"].items()},
                                     timing=nusc_run["timing"], checks=nusc_run["checks"])
                                if key == "fwd" else {}))
    # 3l: each kernel's launches by the flagship run (the warm-up steps and
    # the captures; the replays run without the wrappers); the widened
    # cover's check, the dense scene's and the flagship's numbers once
    for k, key in zip(kernels, ("fused_mp", "fwd", "bwd", "segment_sum")):
        k["flagship"] = dict(launches=flag_run["launches"][key],
                             **({kk: v for kk, v in flag_run.items() if kk != "launches"}
                                if key == "fused_mp" else {}))
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
