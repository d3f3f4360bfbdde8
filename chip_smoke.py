#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``batch3dmot_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build: every CUDA source of the port from ``batch3dmot_tpu_torch/csrc``
     (one ``nvcc`` per source, started together);
  2. kernels: the inference kernel against its plain PyTorch version on the
     card, on inputs made from a numpy seed, at the shapes the main path
     gives it and beyond (up to the largest bucket), compared on valid
     edges; then the training pair (the stashing forward and the
     hand-written backward) against autograd of the plain version: scores
     and stashes, and dx0, de0, datt and every weight gradient under a
     random cotangent that is non-zero on every edge, masked ones too; the
     backward run twice must give bit-identical gradients;
  3. inference path: the ``bench.py`` workload (4 synthetic scenes, 16
     frames, 40 tracks, trainval class mix, window 5, kNN 40) rebuilt from
     the port's modules and driven through ``SceneEncodedScorer.score_scenes``,
     ``predict_scenes``, track assembly and ``evaluate_tracking`` with a
     full-width depth-6 ``MultimodalGNN`` of seeded random weights; its
     scores are held against the plain version; the kernel's launch counter
     must show that the path went through it;
  3b. training path: the same scenes' encodings (``precompute_scene_encodings``)
     and one epoch of ``GNNTrainer.fit`` of a full-width depth-6
     ``MultimodalGNN`` with the ``configs/clr.yaml`` GNN settings from an
     ``EncodedGraphBatcher``; the training pair's launch counters must
     equal the steps, the frozen encoders must not move, the epoch
     checkpoint must load into a fresh model; on one fixed batch, 3 steps
     through the kernels and 3 through the plain version give the same
     losses, and 10 more steps lower the loss;
  4. timing: each kernel and its plain version with CUDA events on real
     main-path batches (inference, and the training pair at (256, 4096) x8),
     the train step, the paths' edges/s, and device-time profiles.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero, without the last
line, when there is no CUDA device or any phase fails. The AMOTA and AP it
prints come from random or barely trained weights.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import tempfile
import time
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
FP32_PEAK = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores
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


def mp_work(inputs, widths, depth):
    """(FLOP, bytes) that one fused MP forward needs on these inputs: the
    per-node-projected formulation over the valid edges and the nodes they
    touch; each input read once and the scores written once."""
    x0, e0, att, src, dst, mask = inputs
    b, n, nd = x0.shape
    ed = e0.shape[-1]
    w = widths
    n_edges = int(mask.sum())
    touched = touched_nodes(src, dst, mask)
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


def bound(flops, nbytes):
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


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


def profile_device(run):
    """Wall ms, device-busy ms and the device rows (ms, name, count) of one
    call of ``run`` under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the operator rows repeat their kernels' time
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA),
                  reverse=True)
    return wall_ms, sum(r[0] for r in rows) / 1e3, rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from batch3dmot_tpu_torch.config import GNNConfig
    from batch3dmot_tpu_torch.graph import pick_bucket
    from batch3dmot_tpu_torch.infer.predict import SceneEncodedScorer, predict_scenes
    from batch3dmot_tpu_torch.models import init_params_, make_model
    from batch3dmot_tpu_torch.ops import cuda_build, fused_mp
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
    from batch3dmot_tpu_torch.train.encoded import (
        EncodedGraphBatcher,
        precompute_scene_encodings,
    )
    from batch3dmot_tpu_torch.train.trainer import FROZEN_ENCODERS, GNNTrainer
    from batch3dmot_tpu_torch.utils.checkpoint import load_checkpoint

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
    report = cuda_build.build(["fused_mp", "fused_mp_train"])
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
            ref = fused_mp_scores_plain(*inputs, flat, meta, 6, logits=pose)
            torch.cuda.synchronize()
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
                f"max|kernel-plain| {err:.3e} over {int(mask.sum())} valid edges")
            if (n, e) == (1024, 32768):
                k_ms = cuda_ms(lambda: fused_mp_scores_cuda(*inputs, flat, meta, 6), 5)
                p_ms = cuda_ms(lambda: fused_mp_scores_plain(*inputs, flat, meta, 6), 3)
                _, _, w = pack_mp_weights(flat, meta, nd, ed, True)
                flops, nbytes = mp_work(inputs, w, 6)
                log(f"timing fused_mp at ({n},{e}) x1: kernel {k_ms:.3f} ms, plain "
                    f"{p_ms:.3f} ms, bound {flops / FP32_PEAK * 1e3:.3f} ms "
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
        bound_ms = max(flops / FP32_PEAK, nbytes / HBM_RATE) * 1e3
        bound_by = "operations" if flops / FP32_PEAK >= nbytes / HBM_RATE else "bytes"
        timed[bucket] = (kernel_ms, plain_ms, bound_ms, bound_by)
        log(f"timing fused_mp at {bucket} x{inputs[0].shape[0]} ({int(inputs[-1].sum())} "
            f"valid edges): kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms (turns "
            "plain/kernel/kernel/plain " + "/".join(f"{t:.3f}" for t in turns) + " ms), "
            f"bound {bound_ms:.3f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 2**20:.1f} MiB; "
            f"{bound_by}), {flops / (kernel_ms * 1e-3) / 1e12:.2f} TFLOP/s")
    kernel_ms, plain_ms, bound_ms, bound_by = timed[(256, 4096)]
    del captured, args, inputs

    wall_ms, device_ms, rows = profile_device(lambda: scorer.score_scenes(scenes, windows_list))
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
            f"({flops / 1e9:.2f} GFLOP, {nbytes / 2**20:.1f} MiB; {b_by}), "
            f"{flops / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s")
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

    kernels = [dict(
        name="fused_mp", route="cuda",
        source="batch3dmot_tpu_torch/csrc/fused_mp.cu",
        replaces="batch3dmot_tpu/ops/pallas_mp.py:228 (+:313 tiled, :433 hbm)",
        launches=launches["fused_mp"], max_abs_err=max_err,
        ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None,
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
        ))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
