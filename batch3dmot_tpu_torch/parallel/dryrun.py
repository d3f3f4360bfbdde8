"""Dry run of the data-parallel paths on N ranks (counterpart of
``__graft_entry__.dryrun_multichip``), at its tiny shapes:

    python -m batch3dmot_tpu_torch.parallel.dryrun N [--device cuda|cpu] [--out DIR]

spawns N ranks (by default on the GPU: over NCCL, or over gloo when there
are more ranks than GPUs; with ``--device cpu`` on the CPU over gloo) and
runs on each:

  1. one sharded ``mm`` train step, in each kNN-conv mode ('noop', then
     'active', whose segment sums go through the segment-sum kernel);
  2. a sharded ``PoseGNN`` ``fit_device`` epoch;
  3. a sharded dedup-encoded ``MultimodalGNN`` ``fit_device`` epoch;
  4. grouped device-pipeline inference over N scenes;
  5. cached-embedding ``SceneEncodedScorer.score_scenes``;
  6. a sharded ``EncoderTrainer.fit_device`` epoch (the ResNet-AE).

Rank 0 prints one line per path; over NCCL with more than one rank it
also traces an epoch of replayed ``fit_device`` steps and prints the NCCL
kernels they ran. Then this process runs the same paths alone
(:func:`run_paths` without a mesh) and holds every rank to it
(:func:`compare`); a rank's failure or a mismatch fails the run. With
``--out`` every rank saves its results (losses, scores, the trained states,
the summed gradients of the one-step paths, the kernel wrappers' launch
counts, and the active step's segment-sum launches) to ``DIR/rank{r}.pt``,
and the comparison goes to ``DIR/check.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

# one process against N ranks: the same math up to the order of the
# reductions (and, on the card, of autograd's atomic sums)
LOSS_RTOL = 1e-4
RTOL, ATOL = 2e-4, 2e-5


def _example_graph(max_nodes: int = 32, max_edges: int = 64, seed: int = 0):
    from batch3dmot_tpu_torch.config import GraphConstructionConfig
    from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
    from batch3dmot_tpu_torch.graphs.build import build_window_graph
    from batch3dmot_tpu_torch.train.data import to_padded

    scene = make_synthetic_scene(seed=seed, num_frames=4, num_tracks=5, with_modalities=True)
    g = build_window_graph(scene, 0, 3, GraphConstructionConfig(top_knn_nodes=5))
    return to_padded(g, max_nodes, max_edges)


def _windows(scene, knn: int):
    from batch3dmot_tpu_torch.config import GraphConstructionConfig
    from batch3dmot_tpu_torch.graphs import build_scene_graphs

    return [w for w in build_scene_graphs(scene, 3, GraphConstructionConfig(top_knn_nodes=knn))
            if w.num_edges > 0]


def launch_counts() -> dict:
    """The kernel wrappers' launch counters of this process."""
    from batch3dmot_tpu_torch.ops.fused_mp import fused_mp_scores
    from batch3dmot_tpu_torch.ops.fused_mp_train import fused_mp_train_scores
    from batch3dmot_tpu_torch.ops.segment_kernel import segment_sum

    return dict(fused_mp=fused_mp_scores.launches, fwd=fused_mp_train_scores.fwd_launches,
                bwd=fused_mp_train_scores.bwd_launches, segment_sum=segment_sum.launches)


def run_paths(mesh, n: int, device=None, say=print) -> dict:
    """The six paths at global batch width ``n`` on ``mesh`` (None: one
    process on ``device``, None meaning the GPU). Returns their results,
    equal, up to the order of the reductions, on every rank and in one
    process."""
    from batch3dmot_tpu_torch.config import EncoderTrainConfig, GNNConfig
    from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
    from batch3dmot_tpu_torch.graph import batch_graphs
    from batch3dmot_tpu_torch.infer.device_pipeline import DeviceScenePipeline
    from batch3dmot_tpu_torch.infer.predict import SceneEncodedScorer
    from batch3dmot_tpu_torch.models import init_params_, make_model
    from batch3dmot_tpu_torch.train.data import materialize_graph_dataset
    from batch3dmot_tpu_torch.train.encoded import (
        materialize_encoded_dataset_dedup,
        precompute_scene_encodings,
    )
    from batch3dmot_tpu_torch.train.encoders import image_transform, make_resnet_trainer
    from batch3dmot_tpu_torch.train.trainer import GNNTrainer

    kw = dict(mesh=mesh) if mesh is not None else dict(device=device)
    cfg = GNNConfig(batch_size=n)
    bucket = ((32, 64),)
    out = dict(losses={}, states={}, grads={})

    def finite(name, value):
        if not np.isfinite(value):
            raise RuntimeError(f"dryrun {name}: non-finite loss {value}")
        out["losses"][name] = value

    def keep_state(name, trainer):
        # what training moves: the trained parameters and the statistics
        out["states"][name] = {
            k: v.detach().cpu() for k, v in trainer.model.state_dict(keep_vars=True).items()
            if not isinstance(v, torch.nn.Parameter) or v.requires_grad}

    def keep_grads(name, trainer):
        # a one-step path's loss is taken before its update: the step's
        # gradients (summed over the ranks) are what it computed
        out["grads"][name] = {k: p.grad.detach().cpu()
                              for k, p in trainer.model.named_parameters() if p.grad is not None}

    # 1. one sharded train step of the mm model, in each kNN-conv mode
    batch = batch_graphs([_example_graph()] * n)
    trainer = GNNTrainer(make_model("mm", depth=2), cfg, **kw)
    finite("mm_step", float(trainer.train_step(batch)[0]))
    active = GNNTrainer(make_model("mm", depth=2, knn_conv_mode="active"), cfg, **kw)
    before = launch_counts()["segment_sum"]
    finite("active_step", float(active.train_step(batch)[0]))
    # the segment-sum kernel's launches of that step (0 on the CPU)
    out["active_step_launches"] = launch_counts()["segment_sum"] - before
    for name, tr in (("mm_step", trainer), ("active_step", active)):
        keep_state(name, tr)
        keep_grads(name, tr)
    say(f"one sharded train step OK, loss={out['losses']['mm_step']:.4f} "
        f"(active {out['losses']['active_step']:.4f})")

    # 2. a PoseGNN fit_device epoch, the dataset split along its window axis
    windows = _windows(make_synthetic_scene(seed=1, num_frames=6, num_tracks=5), 5)
    pose = GNNTrainer(make_model("pose", depth=2), cfg, **kw)
    finite("pose_fit_device",
           pose.fit_device(materialize_graph_dataset(windows, buckets=bucket), epochs=1,
                           verbose=False)[0]["train/loss"])
    keep_state("pose_fit_device", pose)
    say(f"sharded device-dataset epoch OK, loss={out['losses']['pose_fit_device']:.4f}")

    # 3. a dedup-encoded fit_device epoch: graphs and det_index split, the
    # table replicated
    mm_scene = make_synthetic_scene(seed=2, num_frames=6, num_tracks=5, with_modalities=True)
    mm = GNNTrainer(make_model("mm", depth=2), cfg, **kw)
    enc = precompute_scene_encodings(mm.model, mm_scene, chunk=32, device=mm.device)
    ds = materialize_encoded_dataset_dedup([(w, enc) for w in _windows(mm_scene, 5)],
                                           buckets=bucket)
    finite("dedup_fit_device", mm.fit_device(ds, epochs=1, verbose=False)[0]["train/loss"])
    keep_state("dedup_fit_device", mm)
    say(f"sharded dedup-encoded epoch OK, loss={out['losses']['dedup_fit_device']:.4f}")

    # 4. grouped device-pipeline inference over n scenes, with seeded
    # weights (a trained model's would carry the steps' rounding noise)
    model = init_params_(make_model("mm", depth=2), torch.Generator().manual_seed(0))
    scenes = [make_synthetic_scene(seed=10 + i, num_frames=5, num_tracks=4,
                                   with_modalities=True) for i in range(n)]
    avgs = DeviceScenePipeline(model, 3, 4, **kw).score_scenes(scenes)
    total = sum(len(a) for a in avgs)
    if not total or not all(np.isfinite(v) for a in avgs for v in a.values()):
        raise RuntimeError("dryrun: non-finite or empty sharded inference scores")
    out["pipeline"] = avgs
    say(f"sharded grouped inference OK, {total} averaged edges over {len(scenes)} scenes")

    # 5. scoring from precomputed encodings
    windows_list = [_windows(s, 4) for s in scenes]
    encs = [precompute_scene_encodings(model, s, device=trainer.device) for s in scenes]
    cached = SceneEncodedScorer(model, **kw).score_scenes(
        scenes, windows_list, windows_per_batch=n, m_pad=64, encodings_list=encs)
    n_cached = sum(len(x) for per in cached for x in per)
    if not n_cached or not all(np.isfinite(x).all() for per in cached for x in per):
        raise RuntimeError("dryrun: non-finite or empty cached-embedding scores")
    out["cached"] = cached
    say(f"sharded cached-embedding inference OK, {n_cached} window-edge scores")

    # 6. an encoder fit_device epoch (the item axis split)
    rng = np.random.default_rng(0)
    imgs = (rng.random((8 * n, 32, 32, 3)) * 255).astype(np.uint8)
    labels = rng.integers(0, 7, 8 * n).astype(np.int32)
    resnet = make_resnet_trainer(EncoderTrainConfig(batch_size=2 * n, lr=1e-3), **kw)
    finite("encoder_fit_device", resnet.fit_device(
        (imgs, labels), transform=image_transform(), epochs=1, verbose=False)[0]["train/loss"])
    keep_state("encoder_fit_device", resnet)
    say(f"sharded encoder epoch OK, loss={out['losses']['encoder_fit_device']:.4f}")
    out["counters"] = launch_counts()
    return out


def compare(ranks: list, single: dict) -> dict:
    """Hold the ranks' ``run_paths`` results against one process's: every
    rank's trained states, one-step gradients, averaged edges and scores
    bit-identical to rank 0's; the losses at rel 1e-4; the states, the
    gradients, the averaged edges and the cached-embedding scores at RTOL,
    ATOL. Returns the largest differences; raises AssertionError at the
    first mismatch."""
    first = ranks[0]
    for r, rank in enumerate(ranks[1:], 1):
        for part in ("states", "grads"):
            for name, tensors in first[part].items():
                for k, v in tensors.items():
                    if not torch.equal(rank[part][name][k], v):
                        raise AssertionError(f"rank {r} differs from rank 0: {name} {k}")
        if rank["pipeline"] != first["pipeline"] or not all(
                np.array_equal(a, b) for pa, pb in zip(rank["cached"], first["cached"])
                for a, b in zip(pa, pb)):
            raise AssertionError(f"rank {r}'s scores differ from rank 0's")
    np.testing.assert_allclose([first["losses"][k] for k in single["losses"]],
                               list(single["losses"].values()), rtol=LOSS_RTOL)
    worst = dict(param=0.0, grad=0.0, pipeline=0.0, cached=0.0)
    for part, key in (("states", "param"), ("grads", "grad")):
        if single[part].keys() != first[part].keys():
            raise AssertionError(f"the {part} differ in their paths from one process's")
        for name, tensors in single[part].items():
            if tensors.keys() != first[part][name].keys():
                raise AssertionError(f"{name}: the {part} differ in their tensors")
            for k, want in tensors.items():
                got = first[part][name][k]
                if not want.is_floating_point():
                    if not torch.equal(got, want):
                        raise AssertionError(f"{name} {k} differs from one process")
                    continue
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                           msg=lambda m, n=name, k=k: f"{n} {k}: {m}")
                worst[key] = max(worst[key], float((got - want).abs().max()))
    for got, want in zip(first["pipeline"], single["pipeline"], strict=True):
        if got.keys() != want.keys():
            raise AssertionError("the averaged edges differ from one process's")
        for key, v in want.items():
            diff = abs(got[key] - v)
            if diff > RTOL * abs(v) + ATOL:
                raise AssertionError(f"averaged edge {key}: {got[key]} vs {v}")
            worst["pipeline"] = max(worst["pipeline"], diff)
    for got, want in zip(first["cached"], single["cached"], strict=True):
        for g, w in zip(got, want, strict=True):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
            worst["cached"] = max(worst["cached"], float(np.abs(g - w).max(initial=0.0)))
    return worst


def _traced_nccl_kernels(mesh) -> dict:
    """A PoseGNN ``fit_device`` epoch on the mesh (its steps captured),
    then a second, of replays alone, under the profiler: the NCCL kernels
    that epoch's replays ran, by name, and its replays."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from batch3dmot_tpu_torch.config import GNNConfig
    from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene
    from batch3dmot_tpu_torch.models import make_model
    from batch3dmot_tpu_torch.ops.cuda_build import TRACE_LEAD_S
    from batch3dmot_tpu_torch.train.data import materialize_graph_dataset
    from batch3dmot_tpu_torch.train.trainer import GNNTrainer

    windows = _windows(make_synthetic_scene(seed=1, num_frames=6, num_tracks=5), 5)
    ds = materialize_graph_dataset(windows, buckets=((32, 64),))
    trainer = GNNTrainer(make_model("pose", depth=2), GNNConfig(batch_size=mesh.size), mesh=mesh)
    trainer.fit_device(ds, epochs=1, verbose=False)
    issued, replays = mesh.collectives, trainer.graph_replays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_LEAD_S)  # the profiler may drop a trace's first records
        trainer.fit_device(ds, epochs=1, verbose=False)
        torch.cuda.synchronize()
    if mesh.collectives != issued:
        raise AssertionError("a replayed epoch issued collectives from Python")
    kernels = {ev.key: ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and "nccl" in ev.key.lower()}
    return dict(nccl_kernels=kernels, replays=trainer.graph_replays - replays)


def _rank(mesh, out_dir: Optional[str]) -> None:
    def say(line):
        if mesh.rank == 0:
            print(f"dryrun({mesh.size}, {mesh.backend}, {mesh.device.type}): {line}", flush=True)

    out = run_paths(mesh, mesh.size, say=say)
    out["collectives"] = mesh.collectives
    if mesh.capturable and mesh.size > 1:
        out["captured"] = _traced_nccl_kernels(mesh)
        say(f"captured NCCL collectives: an epoch of {out['captured']['replays']} replays ran "
            f"{sum(out['captured']['nccl_kernels'].values())} NCCL kernels "
            f"({', '.join(out['captured']['nccl_kernels'])})")
    if out_dir is not None:
        torch.save(out, f"{out_dir}/rank{mesh.rank}.pt")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", type=int, nargs="?", default=2, help="number of ranks")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--out", default=None, help="directory for each rank's results")
    args = parser.parse_args(argv)
    from batch3dmot_tpu_torch.parallel.mesh import spawn

    backend = None
    device = "cpu" if args.device == "cpu" else None
    if args.device == "cuda":
        from batch3dmot_tpu_torch.ops import cuda_build

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")

        # build once here: the ranks load the libraries from the build cache
        cuda_build.build(["fused_mp", "fused_mp_train", "segment_sum"])
        if args.n > torch.cuda.device_count():
            backend = "gloo"  # NCCL refuses two ranks on one GPU
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.out or tmp
        spawn(_rank, args.n, out_dir, device=device, backend=backend)
        ranks = [torch.load(f"{out_dir}/rank{r}.pt", weights_only=False)
                 for r in range(args.n)]
    worst = compare(ranks, run_paths(None, args.n, device=device, say=lambda line: None))
    print(f"dryrun({args.n}): every rank matches one process: trained states within "
          f"{worst['param']:.2e}, one-step gradients {worst['grad']:.2e}, averaged edges "
          f"{worst['pipeline']:.2e}, cached-embedding scores {worst['cached']:.2e}; "
          f"launches per rank {[r['counters'] for r in ranks]}", flush=True)
    if args.out is not None:
        with open(f"{args.out}/check.json", "w") as f:
            json.dump(dict(worst, counters=[r["counters"] for r in ranks],
                           active_step_launches=[r["active_step_launches"] for r in ranks],
                           collectives=[r["collectives"] for r in ranks],
                           captured=[r.get("captured") for r in ranks]), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
