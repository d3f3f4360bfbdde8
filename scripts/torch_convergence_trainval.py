"""Reference-scale convergence run of the PyTorch port: 100 epochs on the
550-scene trainval-shaped synthetic set, as
``scripts/convergence_trainval.py`` runs the JAX package.

The reference trains its GNN for 100 epochs with AP-stamped per-epoch
checkpoints and picks the best by validation AP. This script runs that
workload end to end on one card through ``python -m
batch3dmot_tpu_torch.cli`` (in process):

  1. build 550 train stores (L=5) + 150 held-out val stores (L=2,
     disjoint seeds) at trainval density (40 frames x 40 tracks);
  2. ``train-gnn --model mm --encoded --epochs 100``: the dedup
     device-resident dataset (the whole train set fits one card); the CLI
     holds out the last 10% of stores, so every epoch logs train and val
     AP and every epoch checkpoint is AP-stamped;
  3. best-checkpoint selection by ValAP from the stamped file names;
  4. grouped ``predict --pipeline encoded`` over the 150 val scenes with
     the best checkpoint;
  5. AMOTA (the port's evaluator) and the per-class table.

Reports per-stage wall, the convergence curve (from metrics.jsonl), the
CUDA graphs captured and kernel libraries compiled (where the JAX script
counts compiled programs), and peak RSS, on the JAX script's
``CONVERGENCE SUMMARY {...}`` line. ``--device`` (default: the GPU, which
must exist) goes to every CLI call.

Run (one GPU; resumable: stores and encoding caches are reused through
--skip-existing and the digest-keyed .enc.npz files):
    python scripts/torch_convergence_trainval.py
    python scripts/torch_convergence_trainval.py --scenes 12 --val 4 --epochs 3  # smoke
"""

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from batch3dmot_tpu_torch.cli import main as cli
from torch_soak_trainval_scale import (
    CAPTURES,
    Stage,
    build_kernels,
    rss_gb,
    synthetic_amota,
)


def best_checkpoint(gnn_dir):
    """The highest-ValAP stamped checkpoint (the reference picks by the AP
    in the file name); ties go to the later epoch."""
    best, best_ap = None, -1.0
    for p in glob.glob(os.path.join(gnn_dir, "*.pt")):
        m = re.search(r"ValAP([0-9.]+)\.pt$", p)
        if not m:
            continue
        ap = float(m.group(1))
        em = re.search(r"_epoch(\d+)_", p)
        ep = int(em.group(1)) if em else -1
        if (ap, ep) > (best_ap, -1 if best is None else best[1]):
            best, best_ap = (p, ep), ap
    return (best[0], best[1], best_ap) if best else (None, -1, float("nan"))


def run(a):
    from batch3dmot_tpu_torch import resolve_device
    from batch3dmot_tpu_torch.eval.tracking_metrics import json_safe

    builds = build_kernels(resolve_device(a.device))
    CAPTURES.track()
    dev = ["--device", resolve_device(a.device).type]
    tmp = a.workdir
    os.makedirs(tmp, exist_ok=True)
    train_dir = os.path.join(tmp, "graphs_train")
    val_dir = os.path.join(tmp, "graphs_val")
    gnn_dir = os.path.join(tmp, "nuscenes", "models", "gnn")
    density = [
        "--set", f"graph_construction.synthetic_frames={a.frames}",
        "--set", f"graph_construction.synthetic_tracks={a.tracks}",
    ]
    common = ["--set", f"paths.tmp={tmp}", *density, *dev]
    walls = {}

    with Stage(f"build train stores ({a.scenes} scenes, L=5)", walls):
        cli([
            "build-graphs", "--synthetic", str(a.scenes), *common,
            "--set", f"paths.graphs_dir={train_dir}",
            "--set", "graph_construction.batch_size_graph=5",
            "--skip-existing",
        ])

    with Stage(f"build val stores ({a.val} scenes, L=2)", walls):
        cli([
            "build-graphs", "--synthetic", str(a.val), *common,
            "--set", f"paths.graphs_dir={val_dir}",
            "--set", "graph_construction.batch_size_graph=2",
            "--set", "graph_construction.synthetic_seed_base=100000",
            "--skip-existing",
        ])

    metrics_path = os.path.join(gnn_dir, "metrics.jsonl")
    if os.path.exists(metrics_path):
        os.rename(metrics_path, metrics_path + f".pre{int(time.time())}")

    with Stage(f"train-gnn --encoded device-resident ({a.epochs} epochs)", walls):
        # the whole 550-scene train set on the card (dedup form, with the
        # CLI's 10% store holdout as a device-resident val set)
        os.environ.setdefault("B3D_DEVICE_DATASET_GB", "12")
        cli([
            "train-gnn", "--model", "mm", "--encoded",
            "--epochs", str(a.epochs), *common,
            "--set", f"paths.graphs_dir={train_dir}",
            "--set", "gnn.batch_size=8",
            "--set", f"gnn.lr={a.lr}",
        ])

    ckpt, epoch, val_ap = best_checkpoint(gnn_dir)
    assert ckpt, f"no AP-stamped checkpoints in {gnn_dir}"
    print(f"best checkpoint: epoch {epoch}, ValAP {val_ap:.6f}: {ckpt}", flush=True)

    with Stage(f"grouped predict over {a.val} val scenes (best ckpt)", walls):
        cli([
            "predict", "--model", "mm", "--pipeline", "encoded", *common,
            "--checkpoint", ckpt,
            "--set", f"paths.graphs_dir={val_dir}",
            "--set", "graph_construction.batch_size_graph=2",
            "--set", "predict.scenes_per_batch=4",
        ])

    with Stage("AMOTA vs synthetic GT", walls):
        res = synthetic_amota(os.path.join(tmp, "nuscenes", "eval", "submission.json"),
                              a.val, a.frames, a.tracks)

    curve = []
    with open(metrics_path) as f:
        for line in f:
            r = json.loads(line)
            curve.append({
                "epoch": r["step"],
                "train_ap": round(r.get("train/avgprec", float("nan")), 6),
                "val_ap": round(r.get("val/avgprec", float("nan")), 6),
                "loss": round(r.get("train/loss", float("nan")), 6),
                "epoch_s": round(r.get("epoch_time_s", float("nan")), 2),
            })
    out = json_safe({
        "walls_s": walls,
        "best_epoch": epoch,
        "best_val_ap": val_ap,
        "amota": res.amota,
        "amotp": res.amotp,
        "per_class_amota": {c: m["amota"] for c, m in res.per_class.items()},
        "graph_captures": CAPTURES.total(),
        "kernel_builds": len(builds),
        "peak_rss_gb": round(rss_gb(), 2),
        "curve": curve,
    })
    with open(os.path.join(tmp, "convergence_summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    print("CONVERGENCE SUMMARY " + json.dumps(
        {k: v for k, v in out.items() if k != "curve"}
    ), flush=True)
    epochs_s = [c["epoch_s"] for c in curve[2:]]
    if epochs_s:
        print(f"warm epoch median {sorted(epochs_s)[len(epochs_s) // 2]:.1f}s "
              f"over {len(epochs_s)} epochs", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=550)
    ap.add_argument("--val", type=int, default=150)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--tracks", type=int, default=40)
    ap.add_argument("--epochs", type=int, default=100)
    # the reference's GNN lr at trainval density
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "b3d_torch_convergence"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where to compute (default: the GPU, which must exist)")
    run(ap.parse_args())
