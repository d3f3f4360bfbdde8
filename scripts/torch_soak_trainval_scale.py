"""Trainval-scale synthetic soak of the PyTorch port: the real dataset's
shape end to end through the port's CLI, as
``scripts/soak_trainval_scale.py`` drives the JAX package's.

The reference's working set is ~700 scenes; this soak drives
``python -m batch3dmot_tpu_torch.cli`` (in process) through the whole
pipeline at that scene count and trainval density (40 frames x ~40
concurrent tracks), reporting per stage:

  * wall time,
  * peak RSS so far (``ru_maxrss``: an unbounded buffer of encoded items
    would show here),
  * the CUDA graphs captured (where the JAX script counts its compiled
    programs; the kernel libraries are compiled once, up front, and
    counted there).

Stages: build train stores (550 scenes, L=5) -> build val stores (150
scenes, L=2, disjoint seeds) -> ``train-gnn --model mm --encoded --stream``
(1 epoch) -> ``train-gnn --encoded --device-dataset`` (2 epochs, the whole
train set on the card in the dedup encoding form) -> grouped ``predict
--pipeline encoded`` over the val split -> AMOTA vs the synthetic GT. The
options, defaults and stages are the JAX script's; ``--device`` (default:
the GPU, which must exist) goes to every CLI call.

Run (one GPU):
    python scripts/torch_soak_trainval_scale.py [--scenes 550] [--val 150]
    python scripts/torch_soak_trainval_scale.py --scenes 40 --val 12   # smoke
"""

import argparse
import functools
import glob
import json
import os
import resource
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from batch3dmot_tpu_torch.cli import main as cli


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


class TrainerCaptures:
    """The CUDA-graph captures of the GNNTrainers the CLI makes in this
    process, summed from each trainer's own count. The CLI keeps its
    trainers to itself: ``track`` holds each one from its creation until
    ``release`` (the end of the Stage that made it) adds its count in."""

    def __init__(self):
        self.live, self.released = [], 0

    def track(self):
        from batch3dmot_tpu_torch.train.trainer import GNNTrainer

        init, live = GNNTrainer.__init__, self.live

        @functools.wraps(init)
        def tracked(trainer, *args, **kwargs):
            init(trainer, *args, **kwargs)
            live.append(trainer)

        GNNTrainer.__init__ = tracked

    def total(self):
        return self.released + sum(t.graph_captures for t in self.live)

    def release(self):
        self.released = self.total()
        self.live.clear()


CAPTURES = TrainerCaptures()


def build_kernels(device):
    """Builds the port's kernels up front on the card (one nvcc per source,
    in parallel); returns the names this call compiled (none where they
    were built already)."""
    if device.type != "cuda":
        return []
    from batch3dmot_tpu_torch.ops import cuda_build

    report = cuda_build.build(sorted(p.stem for p in cuda_build.CSRC.glob("*.cu")))
    builds = [name for name, r in report.items() if r["compiled"]]
    print(f"kernel builds: {builds}", flush=True)
    return builds


class Stage:
    def __init__(self, name, walls=None):
        self.name, self.walls = name, walls

    def __enter__(self):
        self.t0, self.c0 = time.time(), CAPTURES.total()
        print(f"=== {self.name} ===", flush=True)
        return self

    def __exit__(self, *exc):
        dt = time.time() - self.t0
        if self.walls is not None:
            self.walls[self.name] = round(dt, 1)
        print(
            f"=== {self.name}: {dt:.1f}s wall, peak RSS {rss_gb():.2f} GiB, "
            f"+{CAPTURES.total() - self.c0} CUDA graph capture(s) ===",
            flush=True,
        )
        CAPTURES.release()


def du_gb(path):
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    return total / 2**30


def synthetic_amota(submission_path, n_val, frames, tracks):
    """AMOTA of a submission against the val scenes' synthetic GT (seeds
    100000 + s, the val stores' generator)."""
    from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
    from batch3dmot_tpu_torch.eval.tracking_metrics import evaluate_tracking, gt_boxes_from_scene

    with open(submission_path) as f:
        submission = json.load(f)
    gt_boxes = []
    for s in range(n_val):
        scene = make_synthetic_scene(seed=100000 + s, num_frames=frames, num_tracks=tracks,
                                     with_modalities=False)
        gt_boxes += gt_boxes_from_scene(scene)
    pred = [b for boxes in submission["results"].values() for b in boxes]
    res = evaluate_tracking(gt_boxes, pred, list(submission["results"].keys()))
    print(res.summary(), flush=True)
    return res


def run(n_train, n_val, frames, tracks, epochs, keep, device):
    from batch3dmot_tpu_torch import resolve_device

    builds = build_kernels(resolve_device(device))
    CAPTURES.track()
    dev = ["--device", resolve_device(device).type]
    tmp = tempfile.mkdtemp(prefix="b3d_torch_soak_")
    train_dir = os.path.join(tmp, "graphs_train")
    val_dir = os.path.join(tmp, "graphs_val")
    density = [
        "--set", f"graph_construction.synthetic_frames={frames}",
        "--set", f"graph_construction.synthetic_tracks={tracks}",
    ]
    common = ["--set", f"paths.tmp={tmp}", *density, *dev]

    try:
        with Stage(f"build train stores ({n_train} scenes, L=5)"):
            cli([
                "build-graphs", "--synthetic", str(n_train), *common,
                "--set", f"paths.graphs_dir={train_dir}",
                "--set", "graph_construction.batch_size_graph=5",
                "--skip-existing",
            ])
            print(f"train store dir: {du_gb(train_dir):.2f} GiB")

        with Stage(f"build val stores ({n_val} scenes, L=2)"):
            cli([
                "build-graphs", "--synthetic", str(n_val), *common,
                "--set", f"paths.graphs_dir={val_dir}",
                "--set", "graph_construction.batch_size_graph=2",
                "--set", "graph_construction.synthetic_seed_base=100000",
                "--skip-existing",
            ])
            print(f"val store dir: {du_gb(val_dir):.2f} GiB")

        with Stage("train-gnn --encoded streaming (1 epoch)"):
            # --stream pins the scene-streaming path (without it the CLI
            # takes the device-resident dataset whenever it fits)
            cli([
                "train-gnn", "--model", "mm", "--encoded", "--stream",
                "--epochs", "1", *common,
                "--set", f"paths.graphs_dir={train_dir}",
                "--set", "gnn.batch_size=8",
            ])

        with Stage(f"train-gnn --encoded --device-dataset ({epochs} epochs)"):
            # the whole train set on one card in the dedup encoding form
            # (one per-detection table instead of ~L per-window copies);
            # the streaming stage's encoding caches are reused, so this
            # stage pays the upload and the training only
            os.environ.setdefault("B3D_DEVICE_DATASET_GB", "12")
            cli([
                "train-gnn", "--model", "mm", "--encoded",
                "--device-dataset", "--epochs", str(epochs), *common,
                "--set", f"paths.graphs_dir={train_dir}",
                "--set", "gnn.batch_size=8",
            ])

        ckpts = sorted(
            glob.glob(os.path.join(tmp, "nuscenes", "models", "gnn", "*.pt")),
            key=os.path.getmtime,
        )
        with Stage(f"grouped predict over {n_val} val scenes (encoded)"):
            cli([
                "predict", "--model", "mm", "--pipeline", "encoded", *common,
                *(["--checkpoint", ckpts[-1]] if ckpts else []),
                "--set", f"paths.graphs_dir={val_dir}",
                "--set", "graph_construction.batch_size_graph=2",
                "--set", "predict.scenes_per_batch=4",
            ])

        with Stage("AMOTA vs synthetic GT"):
            res = synthetic_amota(os.path.join(tmp, "nuscenes", "eval", "submission.json"),
                                  n_val, frames, tracks)
            print(f"soak AMOTA={res.amota:.3f} ({res.amota!r})")
        print(
            f"SOAK COMPLETE: peak RSS {rss_gb():.2f} GiB, {CAPTURES.total()} CUDA graph "
            f"captures, {len(builds)} kernel builds total, artifacts in {tmp}"
        )
        return res
    finally:
        if not keep:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=550)
    ap.add_argument("--val", type=int, default=150)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--tracks", type=int, default=40)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where to compute (default: the GPU, which must exist)")
    a = ap.parse_args()
    run(a.scenes, a.val, a.frames, a.tracks, a.epochs, a.keep, a.device)
