#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``batch3dmot_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build: every CUDA kernel of the port from ``batch3dmot_tpu_torch/csrc``
     (one ``nvcc`` per source, started together);
  2. kernels: each kernel against its plain PyTorch version on the card, on
     inputs made from a numpy seed, at the shapes the main path gives it
     and beyond (up to the largest bucket), compared on valid edges;
  3. main path: the ``bench.py`` workload (4 synthetic scenes, 16 frames,
     40 tracks, trainval class mix, window 5, kNN 40) rebuilt from the
     port's modules and driven through ``SceneEncodedScorer.score_scenes``,
     ``predict_scenes``, track assembly and ``evaluate_tracking`` with a
     full-width depth-6 ``MultimodalGNN`` of seeded random weights; its
     scores are held against the plain version; the kernels' launch
     counters must show that the path went through them;
  4. timing: each kernel and its plain version with CUDA events on a real
     main-path batch, the main path's edges/s, and a device-time profile.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero, without the last
line, when there is no CUDA device or any phase fails. The AMOTA it prints
comes from untrained weights.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# relative tolerance and absolute floor for kernel vs plain version: both
# are float32; sums run in another order (per-node projections, CSR order)
RTOL, ATOL = 2e-4, 2e-5
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

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
    report = cuda_build.build(["fused_mp"])
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

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scorer.score_scenes(scenes, windows_list)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the operator rows repeat their kernels' time
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA),
                  reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    log(f"profile score_scenes: wall {wall_ms:.2f} ms, device busy {device_ms:.2f} ms "
        f"({100 * device_ms / wall_ms:.1f}%)")
    for us, key, count in rows[:10]:
        log(f"  {us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")

    kernels = [dict(
        name="fused_mp", route="cuda",
        source="batch3dmot_tpu_torch/csrc/fused_mp.cu",
        replaces="batch3dmot_tpu/ops/pallas_mp.py:228 (+:313 tiled, :433 hbm)",
        launches=launches["fused_mp"], max_abs_err=max_err,
        ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None,
    )]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
