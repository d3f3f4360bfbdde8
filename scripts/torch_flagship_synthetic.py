"""Flagship synthetic run of the PyTorch port: the whole multimodal pipeline
at moderate scale, as ``scripts/flagship_synthetic.py`` runs the JAX
package. Trains the MultimodalGNN from scratch on precomputed encodings
(device-resident, dedup form, one CUDA-graph replay per step), predicts
held-out scenes with the encode-once scorer (or the device pipeline) and
scores AMOTA with the port's evaluator. The options, defaults, stages and
the ``FLAGSHIP {...}`` summary line are the JAX script's; ``--device``
picks the card (the default, which must exist) or the CPU.

Usage: python scripts/torch_flagship_synthetic.py [--epochs 8] [--scenes 12]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))



def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=12)
    ap.add_argument("--val-scenes", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--tracks", type=int, default=12)
    ap.add_argument("--fused-steps", type=int, default=8)
    ap.add_argument("--no-fused", action="store_true",
                    help="the JAX script's XLA-autodiff A/B; the port trains "
                    "'noop' models through its kernels only and refuses it")
    ap.add_argument("--host-batches", action="store_true",
                    help="per-batch host->device transfer (the default is "
                    "the device-resident dataset: upload once, one replayed "
                    "CUDA graph per step)")
    # at trainval density (kNN 40, L=5) the demo-scale lr 1e-3 diverges:
    # use the reference's GNN lr (1e-4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device-pipeline", action="store_true")
    # the reference's production shape trains at kNN 40 with L=5 windows
    ap.add_argument("--window-len", type=int, default=3)
    ap.add_argument("--knn", type=int, default=8)
    # error bars: vary the training seed (init + epoch shuffling; the scene
    # data stays fixed), keep the trained weights, and re-score a saved
    # checkpoint on another held-out set size without retraining
    ap.add_argument("--train-seed", type=int, default=0)
    ap.add_argument("--save-checkpoint", default="")
    ap.add_argument("--load-checkpoint", default="",
                    help="skip training; score this checkpoint (a port .pt or "
                    "a JAX .msgpack) on the held-out scenes")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where to compute (default: the GPU, which must exist)")
    return ap


def kernel_launches() -> dict:
    """The port's kernel wrappers' launch counters: B1-B3 (one kernel), the
    training forward B4/B6 and backward B5/B7, the segment sum B8. A
    replayed CUDA graph runs no Python: these count eager launches, the
    warm-up steps' and the captures'."""
    from batch3dmot_tpu_torch.ops.fused_mp import fused_mp_scores
    from batch3dmot_tpu_torch.ops.fused_mp_train import fused_mp_train_scores
    from batch3dmot_tpu_torch.ops.segment_kernel import segment_sum

    return {"fused_mp": fused_mp_scores.launches,
            "fwd": fused_mp_train_scores.fwd_launches,
            "bwd": fused_mp_train_scores.bwd_launches,
            "segment_sum": segment_sum.launches}


def prepare(args, init_state_dict=None):
    """The flagship's set-up for parsed ``args``: (device, the kernels
    built, the trainer, the training windows with their scenes'
    encodings, the held-out (scene, windows), the run's one bucket as a
    tuple of buckets). ``init_state_dict`` (the port's state-dict keys)
    replaces the seeded initial weights."""
    from batch3dmot_tpu_torch import resolve_device
    from batch3dmot_tpu_torch.config import GNNConfig, GraphConstructionConfig
    from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
    from batch3dmot_tpu_torch.graph import pick_bucket
    from batch3dmot_tpu_torch.graphs import build_scene_graphs
    from batch3dmot_tpu_torch.models import MultimodalGNN
    from batch3dmot_tpu_torch.ops import cuda_build
    from batch3dmot_tpu_torch.train.encoded import precompute_scene_encodings
    from batch3dmot_tpu_torch.train.trainer import GNNTrainer

    if args.no_fused:
        raise SystemExit("--no-fused: the port trains 'noop' models through its kernels "
                         "only (no autodiff path to compare them with)")
    device = resolve_device(args.device)
    builds = []
    if device.type == "cuda":
        # build the kernels up front (one nvcc per source, in parallel)
        report = cuda_build.build(["fused_mp", "fused_mp_train", "segment_sum"])
        builds = [name for name, r in report.items() if r["compiled"]]
    gc = GraphConstructionConfig(top_knn_nodes=args.knn, batch_size_graph=args.window_len)
    L = args.window_len

    print(f"building {args.scenes}+{args.val_scenes} scenes ...", flush=True)
    t0 = time.time()
    model = MultimodalGNN(depth=args.depth)
    scene_windows = []
    for seed in range(args.scenes + args.val_scenes):
        scene = make_synthetic_scene(
            seed=seed, num_frames=args.frames, num_tracks=args.tracks,
            with_modalities=True, modality_dropout=0.25,
        )
        windows = [w for w in build_scene_graphs(scene, L, gc) if w.num_edges > 0]
        scene_windows.append((scene, windows))
    # one bucket for the whole run, sized to the densest window (the JAX
    # script's choice, kept so that both train on the same batches)
    bucket = pick_bucket(
        max(w.num_nodes for _, ws in scene_windows for w in ws),
        max(w.num_edges for _, ws in scene_windows for w in ws),
    )
    buckets = (bucket,)
    print(f"  bucket {bucket} (L={L}, knn={args.knn})", flush=True)

    trainer = GNNTrainer(
        model,
        GNNConfig(lr=args.lr, weight_decay=1e-4, batch_size=args.batch_size, loss="cb"),
        device=device, seed=args.train_seed, init_state_dict=init_state_dict,
    )
    train_items, val_scenes = [], []
    for seed, (scene, windows) in enumerate(scene_windows):
        if seed < args.scenes:
            if not args.load_checkpoint:
                enc = precompute_scene_encodings(trainer.model, scene, device=device)
                train_items.extend((w, enc) for w in windows)
        else:
            val_scenes.append((scene, windows))
    print(f"  data ready in {time.time() - t0:.1f}s: {len(train_items)} train windows",
          flush=True)
    return device, builds, trainer, train_items, val_scenes, buckets


def run(args, init_state_dict=None) -> dict:
    """The flagship run for parsed ``args``; returns the summary it prints
    on its ``FLAGSHIP`` line. ``init_state_dict`` (the port's state-dict
    keys) replaces the seeded initial weights."""
    import torch

    from batch3dmot_tpu_torch.cli import _load_gnn_weights
    from batch3dmot_tpu_torch.config import PredictConfig
    from batch3dmot_tpu_torch.eval.tracking_metrics import evaluate_tracking, gt_boxes_from_scene
    from batch3dmot_tpu_torch.graph import pick_bucket
    from batch3dmot_tpu_torch.infer.predict import (
        _pad_detection_count,
        make_scene_encoded_scorer,
        predict_scene,
    )
    from batch3dmot_tpu_torch.infer.tracks import (
        all_scene_sample_tokens,
        hierarchical_clusters,
        scene_results,
    )
    from batch3dmot_tpu_torch.train.encoded import (
        EncodedGraphBatcher,
        materialize_encoded_dataset_dedup,
    )
    from batch3dmot_tpu_torch.utils.checkpoint import save_checkpoint

    device, builds, trainer, train_items, val_scenes, buckets = prepare(args, init_state_dict)
    L = args.window_len
    steps, train_time = 0, float("nan")
    t0 = time.time()
    if args.load_checkpoint:
        _load_gnn_weights(trainer.model, args.load_checkpoint)
        history = [{"train/avgprec": float("nan")}]
        print(f"loaded checkpoint {args.load_checkpoint}", flush=True)
    elif args.host_batches:
        batcher = EncodedGraphBatcher(train_items, batch_size=args.batch_size,
                                      buckets=buckets, uniform=True)
        history = trainer.fit(batcher, epochs=args.epochs, verbose=True,
                              fused_steps=args.fused_steps)
        steps = len(batcher) * args.epochs
    else:
        # dedup form (one embedding table, gathered on the device): the
        # dense per-window buffers' numbers at ~1/L the memory
        ds = materialize_encoded_dataset_dedup(train_items, buckets=buckets)
        history = trainer.fit_device(ds, epochs=args.epochs, verbose=True,
                                     seed=args.train_seed)
        n_items = ds[0].pose.shape[0] - 1
        steps = (-(-n_items // args.batch_size)) * args.epochs
    if not args.load_checkpoint:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_time = time.time() - t0
        print(f"training: {train_time:.1f}s for {steps} steps "
              f"({steps / train_time:.1f} steps/s)", flush=True)
    if args.save_checkpoint:
        save_checkpoint(args.save_checkpoint,
                        {k: v.cpu() for k, v in trainer.model.state_dict().items()})
        print(f"saved checkpoint -> {args.save_checkpoint}", flush=True)

    if args.device_pipeline:
        from batch3dmot_tpu_torch.infer.device_pipeline import predict_scene_device
    else:
        scorer = make_scene_encoded_scorer(trainer.model, device=device)
    # run-global shapes: one bucket and one m_pad across the held-out scenes
    sized = [(w.num_nodes, w.num_edges) for _, ws in val_scenes for w in ws if w.num_edges]
    run_bucket = (pick_bucket(max(n for n, _ in sized), max(e for _, e in sized)),)
    run_m_pad = max(_pad_detection_count(s.num_detections) for s, _ in val_scenes)
    gt_boxes, pred_boxes, frames = [], [], []
    t0 = time.time()
    n_edges = 0
    for scene, windows in val_scenes:
        if args.device_pipeline:
            pred_edges, _ = predict_scene_device(trainer.model, scene, window_len=L,
                                                 device=device)
        else:
            pred_edges, _ = predict_scene(
                scorer, scene, windows, PredictConfig(windows_per_batch=8),
                buckets=run_bucket, m_pad=run_m_pad,
            )
        cats = {i: m["category_name"] for i, m in enumerate(scene.metadata)}
        tracks = hierarchical_clusters(pred_edges, cats)
        results = scene_results(tracks, scene)
        pred_boxes.extend(b for boxes in results.values() for b in boxes)
        gt_boxes.extend(gt_boxes_from_scene(scene))
        frames.extend(all_scene_sample_tokens(scene))
        n_edges += sum(w.num_edges for w in windows)
    infer_time = time.time() - t0

    res = evaluate_tracking(gt_boxes, pred_boxes, frames)
    print(res.summary())
    summary = {
        "train_windows": len(train_items),
        "epochs": args.epochs,
        "train_seed": args.train_seed,
        "val_scenes": args.val_scenes,
        "final_train_ap": history[-1]["train/avgprec"],
        "steps_per_s": steps / train_time if steps else 0.0,
        "inference_edges": n_edges,
        "inference_s": infer_time,
        "amota": res.amota,
        "amotp": res.amotp,
    }
    if device.type == "cuda":
        print("kernels " + json.dumps({
            "launches": kernel_launches(), "graph_replays": trainer.graph_replays,
            "graph_captures": trainer.graph_captures,
            "kernel_builds": builds}), flush=True)
    print("FLAGSHIP " + json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> dict:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
