"""Command-line interface of the port (counterpart of ``batch3dmot_tpu/cli.py``).

The JAX CLI's subcommands with its option strings and defaults, running
the port's paths on the card:

    python -m batch3dmot_tpu_torch.cli build-graphs --synthetic N
    python -m batch3dmot_tpu_torch.cli train-gnn    [--model pose|mm] [--encoded] [--devices N]
    python -m batch3dmot_tpu_torch.cli train-resnet | train-pointnet | train-radarnet
    python -m batch3dmot_tpu_torch.cli predict      --checkpoint ck [--pipeline encoded]
    python -m batch3dmot_tpu_torch.cli eval         --submission sub.json --gt gt.json
    python -m batch3dmot_tpu_torch.cli concat-jsons --file1 a.json --file2 b.json --outfile out.json
    python -m batch3dmot_tpu_torch.cli import-checkpoint --torch ref.pth --arch mm --out ck.pt
    python -m batch3dmot_tpu_torch.cli demo         # build -> train -> predict -> eval

Every command takes ``--config cfg.yaml`` (PyYAML is imported only then)
and ``--set section.key=value`` overrides. One flag is the port's own:
``--device {cuda,cpu}`` on the subcommands that compute. It defaults to the
GPU, and without one they exit with "no CUDA device" instead of running on
the CPU.

Checkpoints are the port's ``.pt`` files. ``--init-checkpoint``,
``predict --checkpoint`` and the encoder grafts also read the JAX package's
flax msgpack files. ``--init-checkpoint`` loads the weights only, as the
JAX CLI does: the optimizer starts fresh.

``--devices N`` runs the subcommand's body on N ranks, one process each
(``parallel.mesh.spawn``): NCCL with one card per rank where the machine has
N cards, gloo where ranks share a card or with ``--device cpu``. Every rank
reads every scene and store; rank 0 alone prints and writes checkpoints,
logs, per-scene JSONs and the submission. Under ``torchrun`` the ranks come
from the environment and nothing is spawned.

The nuScenes data plane runs as in the JAX CLI: ``validate-data``,
``preprocess``, ``build-graphs`` and ``predict --pipeline device`` from a
nuScenes tree, and ``export-gt``. It is host numpy; on the card's machine,
which has no PIL and no PyYAML, run it with ``--set`` overrides and the
lidar and radar sensors (an image request there raises where PIL is
imported). ``eval --devkit`` needs the nuscenes-devkit, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from batch3dmot_tpu_torch.config import Config


def _load_config(args) -> Config:
    cfg = Config.from_yaml(args.config) if args.config else Config()
    if args.set:
        cfg.apply_overrides(args.set)
    return cfg


def _store_dir(cfg: Config) -> str:
    return cfg.paths.graphs_dir


def _active_modalities(cfg: Config):
    """Sensor subset from main.sensors_used (poses only / +camera / +lidar /
    full multimodal)."""
    mods = tuple(
        m for m in ("img", "lidar", "radar") if cfg.main.sensors_used.get(m)
    )
    return mods or ("img", "lidar", "radar")


def _device(args):
    """The torch device of a computing subcommand: a rank's mesh device, or
    ``--device`` (default: the GPU, which must exist)."""
    from batch3dmot_tpu_torch import resolve_device

    mesh = _mesh_from_args(args)
    if mesh is not None:
        return mesh.device
    try:
        return resolve_device(getattr(args, "device", None))
    except RuntimeError:
        raise SystemExit(
            "no CUDA device: torch sees no GPU; pass --device cpu to run on the CPU"
        ) from None


def _mesh_from_args(args):
    """The data-parallel mesh this command runs on (None: one process)."""
    return getattr(args, "mesh", None)


def _build_synthetic_scenes(cfg: Config, num_scenes: int, with_mods: bool):
    from batch3dmot_tpu_torch.data.synthetic import make_synthetic_scene

    gc = cfg.graph_construction
    base = gc.synthetic_seed_base
    return [
        make_synthetic_scene(
            seed=base + s,
            num_frames=gc.synthetic_frames,
            num_tracks=gc.synthetic_tracks,
            with_modalities=with_mods,
        )
        for s in range(num_scenes)
    ]


def cmd_build_graphs(args) -> dict:
    cfg = _load_config(args)
    _device(args)
    from batch3dmot_tpu_torch.graphs import build_scene_graphs
    from batch3dmot_tpu_torch.io import save_scene_graphs

    out_dir = _store_dir(cfg)
    window_len = cfg.graph_construction.batch_size_graph
    t0 = time.time()
    total_windows = total_edges = total_dets = n_scenes = 0
    n_skipped = [0]
    # host seconds per stage: tables and matching, modality extraction
    # (filled by the scene loader), graph build, store write
    stages = {"tables": 0.0, "modalities": 0.0, "graphs": 0.0, "write": 0.0}

    def already_built(scene_token: str) -> bool:
        # restartable per scene: the skip is decided before any modality
        # extraction
        if args.skip_existing and os.path.exists(
            os.path.join(out_dir, f"{scene_token}_len{window_len}.b3d")
        ):
            n_skipped[0] += 1
            return True
        return False

    if args.synthetic:
        scenes = iter(
            _build_synthetic_scenes(
                cfg, args.synthetic, cfg.main.sensors_used.get("img", False)
            )
        )
    else:
        # streamed: one scene's detections and modality arrays at a time
        scenes = _load_nuscenes_scenes(cfg, skip=already_built, stages=stages)

    for scene in scenes:
        if args.synthetic and already_built(scene.scene_token):
            continue
        n_scenes += 1
        total_dets += scene.num_detections
        t = time.perf_counter()
        windows = list(build_scene_graphs(scene, window_len, cfg.graph_construction))
        stages["graphs"] += time.perf_counter() - t
        if not windows:
            continue
        t = time.perf_counter()
        save_scene_graphs(
            windows, out_dir, metadata=scene.metadata,
            frame_tokens=scene.frame_tokens,
        )
        stages["write"] += time.perf_counter() - t
        total_windows += len(windows)
        total_edges += sum(w.num_edges for w in windows)
    dt = time.time() - t0
    print(
        f"build-graphs: {n_scenes} scenes ({n_skipped[0]} skipped), "
        f"{total_windows} windows, {total_edges} edges -> {out_dir} in {dt:.1f}s"
    )
    print(
        f"build-graphs: {total_dets} detections; host seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
    )
    return {"detections": total_dets, "seconds": dt, **stages}


def _load_nuscenes_scenes(cfg: Config, skip=None, split: Optional[str] = None,
                          stages: Optional[Dict[str, float]] = None):
    """Generator over the SceneDetections of ONE split built from the tables
    and the detector JSON (build-graphs: ``graph_construction.split``;
    predict passes the eval split). The detection-JSON key comes from the
    same split, so scenes are never matched against another split's file.

    Streams one scene at a time and applies ``skip(scene_token)`` before the
    per-detection modality extraction, so that a resume is cheap. With
    ``stages``, the host seconds of the tables and matching and of the
    modality extraction are added to its ``"tables"`` and ``"modalities"``
    entries."""
    from batch3dmot_tpu_torch.data.detections import (
        load_detection_results,
        scene_from_frames,
    )
    from batch3dmot_tpu_torch.data.nuscenes_tables import NuScenesTables

    stages = stages if stages is not None else {"tables": 0.0, "modalities": 0.0}
    t = time.perf_counter()
    tables = NuScenesTables(cfg.paths.data, cfg.main.version)
    split = split or cfg.graph_construction.split
    split_key = "mini" if cfg.main.version == "v1.0-mini" else split
    det_path = (
        cfg.detections.get(cfg.main.detections, {}).get(split_key)
        if cfg.detections
        else None
    )
    if det_path is None:
        raise SystemExit(
            f"No detection JSON configured for detector={cfg.main.detections} "
            f"split={split_key}; set detections.{cfg.main.detections}.{split_key}"
        )
    dets = load_detection_results(os.path.join(cfg.paths.detections_dir, det_path))
    # raw modality features per detection, for the sensors the config
    # enables only (poses-only configs skip the stage)
    want = tuple(
        m for m in ("img", "lidar", "radar") if cfg.main.sensors_used.get(m)
    )
    try:
        metas = tables.scene_metas_for_split(split, cfg.paths.splits_json or None)
    except KeyError as e:
        raise SystemExit(str(e))
    stages["tables"] += time.perf_counter() - t
    for meta in metas:
        if skip is not None and skip(meta["token"]):
            continue
        t = time.perf_counter()
        toks, ego_t, ego_q = tables.scene_ego_poses(meta["token"])
        gt = tables.scene_gt(meta["token"])
        img = lidar = radar = cam_ok = None
        if want:
            from batch3dmot_tpu_torch.data.preprocess import extract_detection_modalities

            t_mod = time.perf_counter()
            img, lidar, radar, cam_ok = extract_detection_modalities(
                tables, toks, dets, cfg, modalities=want
            )
            stages["modalities"] += time.perf_counter() - t_mod
            t += time.perf_counter() - t_mod
        scene = scene_from_frames(
            meta["token"], toks, dets, gt, ego_t, ego_q,
            cfg.graph_construction,
            ego_rad_min=cfg.pointnet.ego_rad_min,
            ego_rad_max=cfg.pointnet.ego_rad_max,
            img=img, lidar=lidar, radar=radar,
            camera_keep=cam_ok if "img" in want else None,
        )
        stages["tables"] += time.perf_counter() - t
        yield scene


def _load_stores(cfg: Config):
    paths = sorted(glob.glob(os.path.join(_store_dir(cfg), "*.b3d")))
    if not paths:
        raise SystemExit(
            f"No .b3d graph stores under {_store_dir(cfg)}; run build-graphs first"
        )
    return paths


def _load_gnn_weights(model, path: str) -> None:
    """GNN weights from a port ``.pt`` (an epoch checkpoint's state dict or
    a ``GNNTrainer.save_state`` file, whose weights are taken) or a JAX
    flax msgpack file (an epoch checkpoint or a trainer state), strictly."""
    from batch3dmot_tpu_torch.utils.checkpoint import load_checkpoint, load_flax_checkpoint

    if path.endswith(".pt"):
        state = load_checkpoint(path, map_location="cpu")
        model.load_state_dict(state["model"] if "model" in state else state)
    else:
        load_flax_checkpoint(path, model)


def _graft_encoder_checkpoints(args, model) -> None:
    """Load separately trained encoder checkpoints (port ``.pt`` or JAX
    msgpack) into the tracker's frozen encoders; only the leaves the GNN
    has are taken (standalone encoders also carry their heads or decoder)."""
    from batch3dmot_tpu_torch.utils.checkpoint import merge_encoder_params

    wanted = {
        name: getattr(args, f"{name}_checkpoint", None)
        for name in ("resnet", "pointnet", "radarnet")
    }
    if not any(wanted.values()):
        return
    try:
        merge_encoder_params(model, **wanted)
    except (ValueError, KeyError) as e:
        names = ", ".join(name for name, path in wanted.items() if path)
        raise SystemExit(f"train-gnn: cannot graft the {names} encoder checkpoint(s): "
                         f"{type(e).__name__}: {e}") from None
    for name, path in wanted.items():
        if path:
            print(f"train-gnn: grafted frozen {name} encoder from {path}")


def _estimate_dedup_device_bytes(*path_sets) -> int:
    """Estimate of the device-resident dedup dataset's bytes (the padded
    window graphs at their materialization buckets, ``det_index`` and one
    encoding-table row per detection) from store headers and metadata
    sidecars alone: no array data is read and nothing is encoded. Each
    positional argument is one path set materialized as its own dataset
    (train, val), grouped as ``train.data.group_sizes_by_bucket`` groups
    them, plus the empty pad window of each group. It gates the automatic
    ``--encoded`` device-resident upgrade; the exact guard after
    materialization still runs. The port's ``PaddedGraph`` has the JAX
    package's leaves and dtypes, so the per-node and per-edge bytes are the
    JAX package's."""
    from batch3dmot_tpu_torch.io import GraphStoreReader
    from batch3dmot_tpu_torch.train.data import group_sizes_by_bucket

    total = 0
    dets = 0
    total_nodes = 0
    window_len = 2
    for paths in path_sets:
        sizes = []
        for p in paths:
            r = GraphStoreReader(p)
            window_len = max(window_len, getattr(r, "window_len", 2))
            nodes, edges = r.window_sizes()
            sizes.extend(
                (n, e) for n, e in zip(nodes, edges) if n > 0 and e > 0
            )
            total_nodes += sum(n for n, e in zip(nodes, edges) if n > 0 and e > 0)
            meta_path = p.replace(".b3d", "_metadata.json")
            if os.path.exists(meta_path) and dets >= 0:
                with open(meta_path) as f:
                    dets += len(json.load(f))
            else:
                dets = -1  # the estimate below
        if not sizes:
            continue
        for (mn, me), idxs in group_sizes_by_bucket(sizes):
            # pose 76 B/node + time/class i32 + mask ~85 B/node + det_index
            # 4 B/node; src/dst/attr/mask/label/weight ~33 B/edge
            total += (len(idxs) + 1) * (mn * 89 + me * 33)
    if dets < 0:
        # no sidecars: each detection appears in about window_len windows
        dets = total_nodes // max(window_len, 1) + 1
    # table rows: x_img [D+1, 96] + pointnet/radarnet [D+1, 256] f32 + 2 bools
    total += (dets + 1) * (96 * 4 + 256 * 4 + 256 * 4 + 2)
    return total


def _dataset_nbytes(groups) -> int:
    """Bytes of device-resident dataset groups ``(graphs, enc, bucket)``;
    a tensor shared by several groups (the dedup table) counts once."""
    import torch

    seen = set()
    total = 0

    def visit(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                total += x.numel() * x.element_size()
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                visit(getattr(x, f.name))
        elif isinstance(x, (tuple, list)):
            for y in x:
                visit(y)

    for g in groups:
        visit(g[:2])
    return total


def _device_budget_check(ds_bytes: int, mesh) -> None:
    n_chips = mesh.size if mesh is not None else 1
    limit_gb = float(os.environ.get("B3D_DEVICE_DATASET_GB", "6"))
    if ds_bytes > limit_gb * 2**30 * n_chips:
        raise SystemExit(
            f"--device-dataset: dataset is {ds_bytes / 2**30:.1f} GiB "
            f"(> {limit_gb} GiB/chip x {n_chips}; override with "
            "B3D_DEVICE_DATASET_GB or add --devices) — drop the flag "
            "to stream"
        )


def cmd_train_gnn(args):
    cfg = _load_config(args)
    device = _device(args)
    from batch3dmot_tpu_torch.io import GraphStoreReader
    from batch3dmot_tpu_torch.train.store_data import make_batcher
    from batch3dmot_tpu_torch.train.trainer import GNNTrainer
    from batch3dmot_tpu_torch.utils.metric_logging import MetricWriter

    store_paths = _load_stores(cfg)
    n_val_scenes = max(1, len(store_paths) // 10)
    train_paths = store_paths[:-n_val_scenes] or store_paths
    val_paths = store_paths[-n_val_scenes:]

    model = _make_cli_model(cfg, args.model)

    mesh = _mesh_from_args(args)
    if mesh is not None and cfg.gnn.batch_size % mesh.size:
        new_bs = -(-cfg.gnn.batch_size // mesh.size) * mesh.size
        print(
            f"train-gnn: rounding gnn.batch_size {cfg.gnn.batch_size} -> "
            f"{new_bs} (divisible by {mesh.size} devices)"
        )
        cfg.gnn.batch_size = new_bs

    trainer = GNNTrainer(model, cfg.gnn, device=device, mesh=mesh)
    if args.init_checkpoint:
        _load_gnn_weights(trainer.model, args.init_checkpoint)
    _graft_encoder_checkpoints(args, trainer.model)
    log_dir = os.path.join(cfg.paths.models, "gnn")
    version = f"{cfg.main.version}-{args.model}"

    def writer():
        # JSONL only: TensorBoard's writer imports TensorFlow where it is
        # installed, and TensorFlow imports JAX
        rank0 = mesh is None or mesh.rank == 0
        return MetricWriter(log_dir, tensorboard=False) if rank0 else None

    def _fit_device_dataset(train_ds, val_ds):
        """The --device-dataset tail: the budget guard (per card, times the
        mesh the dataset splits across), then ``fit_device`` with the
        validation set device-resident too."""
        tgroups = train_ds if isinstance(train_ds, list) else [train_ds]
        vgroups = [] if val_ds is None else (val_ds if isinstance(val_ds, list) else [val_ds])
        ds_bytes = _dataset_nbytes(tgroups + vgroups)
        _device_budget_check(ds_bytes, mesh)
        n_windows = sum(g[0].pose.shape[0] - 1 for g in tgroups)
        print(
            f"train-gnn: device-resident dataset "
            f"({n_windows} train windows, {ds_bytes / 2**20:.0f} MiB "
            f"incl. val, buckets {[g[2] for g in tgroups]})"
        )
        with _maybe_profile(getattr(args, "profile", None)):
            history = trainer.fit_device(
                train_ds,
                epochs=args.epochs or cfg.gnn.num_epochs,
                val_dataset=val_ds,
                log_dir=log_dir,
                version=version,
                writer=writer(),
            )
        print(f"train-gnn: done, checkpoints in {log_dir}")
        return history

    is_pose = type(trainer.model).__name__ == "PoseGNN"
    if args.device_dataset and not args.encoded:
        # the plain (modality-free) dataset: the pose model's counterpart of
        # the encoded device-resident path
        if not is_pose:
            raise SystemExit(
                "--device-dataset needs --encoded for multimodal models "
                "(the raw-modality dataset would re-run the frozen "
                "encoders in every step)"
            )
        from batch3dmot_tpu_torch.train.data import materialize_graph_datasets

        windows = [w for p in train_paths for w in GraphStoreReader(p).windows()]
        val_windows = [
            w for p in val_paths for w in GraphStoreReader(p).windows()
            if w.num_nodes > 0 and w.num_edges > 0
        ]
        return _fit_device_dataset(
            materialize_graph_datasets(windows),
            materialize_graph_datasets(val_windows) if val_windows else None,
        )
    if args.encoded:
        # the frozen encoders run once per scene; the GNN trains on
        # gathered embeddings
        if is_pose:
            raise SystemExit("--encoded applies to the multimodal models only")
        from batch3dmot_tpu_torch.train.encoded import (
            StreamingEncodedBatcher,
            _encoder_digest,
            materialize_encoded_datasets_dedup,
            scene_encodings_cached,
        )

        def scene_loader(path):
            windows = GraphStoreReader(path).windows()
            scene = _scene_from_store(path, windows, with_modalities=True)
            if scene.img is None and scene.lidar is None and scene.radar is None:
                raise SystemExit(
                    f"--encoded: {path} carries no modality arrays; "
                    "build graphs with sensors enabled"
                )
            return scene

        device_flag = args.device_dataset
        auto_upgrade = False
        if not device_flag and not args.stream:
            # automatic: device-resident whenever the dedup dataset fits
            # the budget; --stream pins the path bounded by one scene
            n_chips = mesh.size if mesh is not None else 1
            budget = (
                float(os.environ.get("B3D_DEVICE_DATASET_GB", "6"))
                * 2**30 * n_chips
            )
            est = _estimate_dedup_device_bytes(train_paths, val_paths)
            if est <= 0.8 * budget:
                print(
                    f"train-gnn: auto device-resident dataset (est. "
                    f"{est / 2**30:.2f} GiB fits the {budget / 2**30:.0f} "
                    f"GiB budget; --stream to disable)"
                )
                device_flag = auto_upgrade = True
            else:
                print(
                    f"train-gnn: streaming (est. device-resident size "
                    f"{est / 2**30:.2f} GiB exceeds 0.8 x {budget / 2**30:.0f}"
                    f" GiB; raise B3D_DEVICE_DATASET_GB or add --devices to "
                    f"go device-resident)"
                )
        if device_flag:
            # one table of every detection's embeddings, gathered by row
            # inside each step (train/encoded.py::DedupEncodings)
            digest = _encoder_digest(trainer.model)

            def encoded_items(paths):
                items = []
                for p in paths:
                    enc = scene_encodings_cached(
                        trainer.model, p, scene_loader, digest=digest, device=device,
                    )
                    items.extend(
                        (w, enc)
                        for w in GraphStoreReader(p).windows()
                        if w.num_nodes > 0 and w.num_edges > 0
                    )
                return items

            try:
                val_items = encoded_items(val_paths)
                return _fit_device_dataset(
                    materialize_encoded_datasets_dedup(encoded_items(train_paths)),
                    materialize_encoded_datasets_dedup(val_items) if val_items else None,
                )
            except SystemExit as e:
                if not auto_upgrade:
                    raise
                # the exact guard disagreed with the estimate: stream (the
                # encoding caches written above are reused)
                print(f"train-gnn: {e} — falling back to streaming")
        train_batcher = StreamingEncodedBatcher(
            train_paths, trainer.model, scene_loader, cfg.gnn.batch_size,
            uniform=True, device=device,
        )
        val_batcher = (
            StreamingEncodedBatcher(
                val_paths, trainer.model, scene_loader, cfg.gnn.batch_size,
                uniform=True, device=device,
            )
            if val_paths
            else None
        )
    else:
        train_batcher = make_batcher(train_paths, cfg.gnn.batch_size, uniform=True)
        val_batcher = (
            make_batcher(val_paths, cfg.gnn.batch_size, uniform=True)
            if val_paths
            else None
        )
    print(
        f"train-gnn: {len(store_paths)} scene stores, "
        f"{len(train_batcher)} train batches/epoch"
    )
    with _maybe_profile(getattr(args, "profile", None)):
        history = trainer.fit(
            train_batcher,
            val_batcher,
            epochs=args.epochs or cfg.gnn.num_epochs,
            log_dir=log_dir,
            # the model family goes into the checkpoint name
            version=version,
            writer=writer(),
            fused_steps=args.fused_steps,
        )
    print(f"train-gnn: done, checkpoints in {log_dir}")
    return history


def _maybe_profile(log_dir: Optional[str]):
    """A ``torch.profiler`` trace written to ``log_dir`` (--profile DIR)."""
    if not log_dir:
        return contextlib.nullcontext()
    from batch3dmot_tpu_torch.utils.profiling import profile_trace

    return profile_trace(log_dir)


def _split_entries(anns: dict):
    """(train_entries, val_entries) from a split-keyed processed-anns dict
    (keys like train/val or mini_train/mini_val; fallback: everything)."""
    train, val = [], []
    for key, entries in anns.items():
        if "train" in key:
            train.extend(entries)
        elif "val" in key:
            val.extend(entries)
    if not train:
        train = [e for entries in anns.values() for e in entries]
    return train, val


def _synthetic_encoder_batches(prefix: str, batch_size: int = 8, n: int = 16):
    """Shape-compatible random batches (explicit --synthetic only)."""
    rng = np.random.default_rng(0)
    if prefix == "resnet":
        return [
            rng.random((batch_size, 32, 32, 3), dtype=np.float32) for _ in range(n)
        ]
    pts_shape = (
        (batch_size, 128, 3) if prefix == "pointnet" else (batch_size, 64, 4)
    )
    return [
        (
            rng.standard_normal(pts_shape).astype(np.float32),
            rng.integers(0, 7, batch_size).astype(np.int32),
        )
        for _ in range(n)
    ]


def _encoder_device_dataset(
    cfg, args, make_trainer, prefix, pre, bs, train_entries, val_entries, mesh,
):
    """The --device-dataset tail of the encoder commands: every item decoded
    or loaded once (``data/preprocess.materialize_*``), uploaded once, and
    trained by ``EncoderTrainer.fit_device`` with the loaders' per-epoch
    randomness on the device (``train/encoders.{image,lidar,radar}_transform``)."""
    from batch3dmot_tpu_torch.train import encoders as enc_mod

    enc_cfg = getattr(cfg, prefix)
    if prefix == "resnet":
        from batch3dmot_tpu_torch.data.preprocess import materialize_image_dataset

        mat = lambda entries: materialize_image_dataset(  # noqa: E731
            cfg.paths.data, entries, res_size=cfg.resnet.res_size
        )
        transform = enc_mod.image_transform(cfg.resnet.res_size)
    elif prefix == "pointnet":
        from batch3dmot_tpu_torch.data.preprocess import materialize_lidar_dataset

        mat = lambda entries: materialize_lidar_dataset(  # noqa: E731
            os.path.join(pre, "lidar"), entries,
            min_pts=cfg.pointnet.min_lidar_pts,
            ego_rad=(cfg.pointnet.ego_rad_min, cfg.pointnet.ego_rad_max),
            num_points=cfg.pointnet.num_points,
            rng=np.random.default_rng(enc_cfg.manual_seed),
        )
        transform = enc_mod.lidar_transform(cfg.pointnet.num_points)
    else:
        from batch3dmot_tpu_torch.data.preprocess import materialize_radar_dataset

        mat = lambda entries: materialize_radar_dataset(  # noqa: E731
            os.path.join(pre, "radar"), entries,
            min_pts=cfg.radarnet.min_radar_pts,
            ego_rad=(cfg.radarnet.ego_rad_min, cfg.radarnet.ego_rad_max),
            num_points=cfg.radarnet.num_points,
            rng=np.random.default_rng(enc_cfg.manual_seed),
        )
        transform = enc_mod.radar_transform(cfg.radarnet.num_points)

    train_ds = mat(train_entries)
    val_ds = mat(val_entries) if len(val_entries) >= bs else None
    ds_bytes = sum(
        a.nbytes for ds in [train_ds] + ([val_ds] if val_ds is not None else [])
        for a in ds
    )
    _device_budget_check(ds_bytes, mesh)
    n_train = train_ds[0].shape[0]
    print(
        f"train-{prefix}: device-resident dataset ({n_train} train items, "
        f"{ds_bytes / 2**20:.0f} MiB incl. val, batch {bs})"
    )
    trainer = make_trainer(steps_per_epoch=max(1, n_train // bs), mesh=mesh)
    return trainer.fit_device(
        train_ds,
        transform=transform,
        val_dataset=val_ds,
        epochs=args.epochs or enc_cfg.num_epochs,
        log_dir=os.path.join(cfg.paths.models, prefix),
        prefix=prefix,
        seed=enc_cfg.manual_seed,
    )


def _encoder_cmd(args, prefix: str):
    """Shared body of train-resnet / train-pointnet / train-radarnet: the L2
    preprocessing artifacts under ``paths.preprocessed`` (the
    ``processed_*_anns.json`` lists and their crops or ``.npy`` clouds), or
    random shape-compatible batches with ``--synthetic``."""
    from batch3dmot_tpu_torch.train import encoders as enc_mod

    cfg = _load_config(args)
    device = _device(args)
    mesh = _mesh_from_args(args)
    enc_cfg = getattr(cfg, prefix)
    bs = enc_cfg.batch_size
    if mesh is not None and bs % mesh.size:
        bs = -(-bs // mesh.size) * mesh.size
        print(f"train-{prefix}: rounding batch_size to {bs} for {mesh.size} devices")
    # the trainer on a mesh needs the rounded size
    enc_cfg.batch_size = bs
    maker = getattr(enc_mod, f"make_{prefix}_trainer")

    def make_trainer(**kw):
        return maker(enc_cfg, device=device, **kw)

    if args.synthetic:
        batches = _synthetic_encoder_batches(prefix, batch_size=bs)
        train_iter = lambda: iter(batches)  # noqa: E731
        val_iter = None
        steps_per_epoch = len(batches)
    else:
        from batch3dmot_tpu_torch.data.preprocess import (
            image_batches,
            lidar_batches,
            radar_batches,
        )

        pre = cfg.paths.preprocessed
        kind = {"resnet": "img", "pointnet": "lidar", "radarnet": "radar"}[prefix]
        anns_path = os.path.join(pre, f"processed_{kind}_anns.json")
        if not os.path.exists(anns_path):
            raise SystemExit(
                f"{anns_path} not found; run `preprocess` first "
                f"(or pass --synthetic for random batches)"
            )
        with open(anns_path) as f:
            anns = json.load(f)
        train_entries, val_entries = _split_entries(anns)
        if prefix == "pointnet":
            pred = lambda e: (  # noqa: E731 (as lidar_batches filters)
                e["num_lidar_pts"] > cfg.pointnet.min_lidar_pts
                and cfg.pointnet.ego_rad_min < e["ann_ego_radius"] < cfg.pointnet.ego_rad_max
            )
        elif prefix == "radarnet":
            pred = lambda e: (  # noqa: E731 (as radar_batches filters)
                e["num_radar_pts"] >= cfg.radarnet.min_radar_pts
                and cfg.radarnet.ego_rad_min < e["ann_ego_radius"] < cfg.radarnet.ego_rad_max
            )
        else:
            pred = lambda e: True  # noqa: E731
        train_entries = [e for e in train_entries if pred(e)]
        val_entries = [e for e in val_entries if pred(e)]
        if len(train_entries) < bs:
            raise SystemExit(
                f"train-{prefix}: only {len(train_entries)} usable annotations "
                f"< batch_size {bs}; lower {prefix}.batch_size"
            )
        if args.device_dataset:
            return _encoder_device_dataset(
                cfg, args, make_trainer, prefix, pre, bs,
                train_entries, val_entries, mesh,
            )
        rng = np.random.default_rng(enc_cfg.manual_seed)
        if prefix == "resnet":
            mk = lambda entries, shuffle: lambda: image_batches(  # noqa: E731
                cfg.paths.data, entries, bs,
                res_size=cfg.resnet.res_size, rng=rng, shuffle=shuffle,
            )
        elif prefix == "pointnet":
            mk = lambda entries, shuffle: lambda: lidar_batches(  # noqa: E731
                os.path.join(pre, "lidar"), entries, bs,
                min_pts=cfg.pointnet.min_lidar_pts,
                ego_rad=(cfg.pointnet.ego_rad_min, cfg.pointnet.ego_rad_max),
                num_points=cfg.pointnet.num_points,
                augment=shuffle,  # augmentation on the train split only
                rng=rng, shuffle=shuffle,
            )
        else:
            mk = lambda entries, shuffle: lambda: radar_batches(  # noqa: E731
                os.path.join(pre, "radar"), entries, bs,
                min_pts=cfg.radarnet.min_radar_pts,
                ego_rad=(cfg.radarnet.ego_rad_min, cfg.radarnet.ego_rad_max),
                num_points=cfg.radarnet.num_points,
                rng=rng, shuffle=shuffle,
            )
        train_iter = mk(train_entries, True)
        val_iter = mk(val_entries, False) if len(val_entries) >= bs else None
        steps_per_epoch = max(1, len(train_entries) // bs)
        print(
            f"train-{prefix}: {len(train_entries)} train / "
            f"{len(val_entries)} val annotations, batch {bs}"
        )

    trainer = make_trainer(steps_per_epoch=steps_per_epoch, mesh=mesh)
    return trainer.fit(
        train_iter,
        val_iter,
        epochs=args.epochs or enc_cfg.num_epochs,
        log_dir=os.path.join(cfg.paths.models, prefix),
        prefix=prefix,
    )


def cmd_train_resnet(args):
    return _encoder_cmd(args, "resnet")


def cmd_train_pointnet(args):
    return _encoder_cmd(args, "pointnet")


def cmd_train_radarnet(args):
    return _encoder_cmd(args, "radarnet")


def cmd_predict(args):
    cfg = _load_config(args)
    if args.aot_cache:
        # the port's cold start is the nvcc build, cached by source hash
        from pathlib import Path

        from batch3dmot_tpu_torch.ops import cuda_build

        cuda_build.BUILD_DIR = Path(args.aot_cache)
    return _run_predict(
        cfg,
        args.checkpoint,
        args.model,
        pipeline=args.pipeline,
        mesh=_mesh_from_args(args),
        synthetic=args.synthetic,
        skip_existing=args.skip_existing,
        device=_device(args),
    )


def _make_cli_model(cfg: Config, name: str):
    """Model from a family name: 'mm'/'pose' take modalities and attention
    from the config; the reference family names (clr_att_gnn, cl_att_gnn,
    cl_gnn_trad, gnn_baseline, gnn_transfer_cl, ...) fix them
    (models/registry.py)."""
    from batch3dmot_tpu_torch.models import MultimodalGNN, PoseGNN, make_model

    if name == "mm":
        return MultimodalGNN(
            depth=cfg.gnn.gnn_depth,
            use_attention=cfg.gnn.attention,
            knn_conv_mode=cfg.gnn.knn_conv_mode,
            modalities=_active_modalities(cfg),
        )
    if name == "pose":
        return PoseGNN(depth=cfg.gnn.gnn_depth, knn_conv_mode=cfg.gnn.knn_conv_mode)
    return make_model(
        name, depth=cfg.gnn.gnn_depth, knn_conv_mode=cfg.gnn.knn_conv_mode
    )


def _half(obj):
    """``obj`` (a scene or a window) with float32 lidar and radar points in
    float16."""
    if obj is None:
        return None
    rep = {
        f: getattr(obj, f).astype(np.float16)
        for f in ("lidar", "radar")
        if getattr(obj, f) is not None and getattr(obj, f).dtype == np.float32
    }
    return dataclasses.replace(obj, **rep) if rep else obj


def _run_predict(
    cfg: Config,
    checkpoint: Optional[str],
    model_kind: str,
    pipeline: str = "auto",
    mesh=None,
    synthetic: int = 0,
    skip_existing: bool = False,
    device=None,
):
    """Batched inference over graph stores, or, for the device pipeline,
    over scenes built on the card from source data.

    Pipelines:
      * ``windows``: per-window scoring; mm re-encodes every node of every
        window (the reference's behaviour);
      * ``encoded``: every detection of a scene group encoded once,
        embeddings gathered per window (the mm default), or the per-scene
        encoding caches (``predict.embedding_cache``);
      * ``device``: graph construction, encoding and scoring of a scene
        group on the card (mm only).
    The next group is dispatched before this one is fetched.
    """
    import torch

    from batch3dmot_tpu_torch.graph import DEFAULT_BUCKETS, pick_bucket
    from batch3dmot_tpu_torch.infer.predict import (
        SceneEncodedScorer,
        _pad_detection_count,
        dispatch_predict_scenes,
        finalize_predict_scenes,
        greedy_round,
        make_scorer,
        predict_scene,
        threshold_edges,
    )
    from batch3dmot_tpu_torch.infer.tracks import (
        all_scene_sample_tokens,
        assemble_submission,
        hierarchical_clusters,
        scene_results,
    )
    from batch3dmot_tpu_torch.io import GraphStoreReader
    from batch3dmot_tpu_torch.models import init_params_

    model = _make_cli_model(cfg, model_kind)
    is_pose = type(model).__name__ == "PoseGNN"
    rank0 = mesh is None or mesh.rank == 0
    if mesh is not None and cfg.predict.windows_per_batch % mesh.size:
        cfg.predict.windows_per_batch = (
            -(-cfg.predict.windows_per_batch // mesh.size) * mesh.size
        )
    if pipeline == "auto":
        pipeline = "windows" if is_pose else "encoded"
    if is_pose and pipeline in ("encoded", "device"):
        raise SystemExit(
            f"--pipeline {pipeline} applies to the multimodal models; "
            f"'{model_kind}' has no frozen encoders (use --pipeline windows)"
        )
    init_params_(model, torch.Generator().manual_seed(0))
    if checkpoint:
        _load_gnn_weights(model, checkpoint)

    enc_by_token: Dict[str, dict] = {}
    use_enc_cache = False
    if pipeline == "device":
        # no stores: the scenes come straight from source data; a nuScenes
        # tree's eval split is streamed, one scene's modalities at a time
        scenes = (
            _build_synthetic_scenes(cfg, synthetic, True)
            if synthetic
            else _load_nuscenes_scenes(cfg, split=cfg.eval.eval_set)
        )
        scene_items = ((s, None) for s in scenes)
    else:
        paths = _load_stores(cfg)
        cached: Dict[str, dict] = {}
        if pipeline == "encoded" and cfg.predict.embedding_cache != "off":
            mode = cfg.predict.embedding_cache
            if mode not in ("auto", "write"):
                raise SystemExit(
                    f"predict.embedding_cache must be auto|write|off, got "
                    f"'{mode}'"
                )
            from batch3dmot_tpu_torch.train.encoded import (
                _encoder_digest,
                probe_scene_encoding_cache,
                store_detection_count,
            )

            digest = _encoder_digest(model)
            # a digest mismatch (another checkpoint's encoders) is not
            # recomputed in auto mode: the run encodes the raw modalities;
            # stale and unreadable caches are reported by the probe
            for p in paths:
                enc = probe_scene_encoding_cache(p, digest, store_detection_count(p))
                if enc is not None:
                    cached[p] = enc
            use_enc_cache = mode == "write" or len(cached) == len(paths)
            if not use_enc_cache and cached:
                print(
                    f"predict: valid embedding caches cover "
                    f"{len(cached)}/{len(paths)} stores — using "
                    "raw-modality encode (predict.embedding_cache=write "
                    "builds the rest)"
                )
        scene_items = []
        for path in paths:
            windows = GraphStoreReader(path).windows()
            need_mods = pipeline == "encoded" and (
                not use_enc_cache or path not in cached
            )
            scene = _scene_from_store(path, windows, with_modalities=need_mods)
            if use_enc_cache:
                enc = cached.get(path)
                if enc is None:  # write mode: compute and persist
                    from batch3dmot_tpu_torch.train.encoded import scene_encodings_cached

                    enc = scene_encodings_cached(
                        model, path, lambda p, s=scene: s, digest=digest,
                        expected_rows=scene.num_detections, device=device,
                    )
                enc_by_token[scene.scene_token] = enc
            scene_items.append((scene, windows))
        if use_enc_cache:
            print(
                f"predict: cached-embedding path "
                f"({cfg.predict.embedding_dtype} uploads, "
                f"{len(paths)} scenes)"
            )

    # lidar and radar in predict.point_dtype, cast once at load so that
    # every pipeline sees the same values (the windows path pads them back
    # to float32 on the host)
    if not is_pose and cfg.predict.point_dtype == "float16":
        scene_items = (
            (_half(s), None if ws is None else [_half(w) for w in ws])
            for s, ws in scene_items
        )
    if pipeline != "device":
        scene_items = list(scene_items)

    if pipeline == "windows":
        scorer = make_scorer(model, device=device, mesh=mesh)
    elif pipeline == "encoded":
        scorer = SceneEncodedScorer(
            model, device=device, mesh=mesh,
            embedding_dtype=cfg.predict.embedding_dtype,
        )
    elif pipeline == "device":
        from batch3dmot_tpu_torch.infer.device_pipeline import DeviceScenePipeline

        device_pipe = DeviceScenePipeline(
            model,
            cfg.predict.batch_size_graph,
            cfg.graph_construction.top_knn_nodes,
            device=device,
            mesh=mesh,
        )
    else:
        raise SystemExit(f"Unknown pipeline '{pipeline}'")

    # one bucket and one detection padding for the whole run, as the JAX
    # CLI pins them
    run_buckets, run_m_pad = DEFAULT_BUCKETS, None
    if pipeline != "device" and scene_items:
        sized = [
            (w.num_nodes, w.num_edges)
            for _, ws in scene_items
            for w in ws
            if w.num_nodes and w.num_edges
        ]
        if sized:
            run_buckets = (
                pick_bucket(
                    max(n for n, _ in sized), max(e for _, e in sized), DEFAULT_BUCKETS
                ),
            )
        if pipeline == "encoded":
            run_m_pad = max(
                _pad_detection_count(s.num_detections) for s, _ in scene_items
            )

    edge_scores_dir = os.path.join(cfg.paths.eval, "predict")
    if rank0:
        os.makedirs(edge_scores_dir, exist_ok=True)
    group_size = (
        max(1, cfg.predict.scenes_per_batch)
        if pipeline in ("device", "encoded")
        else 1
    )

    def _results_path(scene):
        return os.path.join(edge_scores_dir, f"{scene.scene_token}_results.json")

    def _resumed(scene) -> bool:
        # checked as the scene is staged, before its own results can exist
        return skip_existing and os.path.exists(_results_path(scene))

    def _items():
        """('cached', scene) singles and ('group', [(scene, windows), ...])
        batches in scene order (the buffer flushes before a cached scene so
        that a resumed run keeps its numbering)."""
        buf = []
        for scene, windows in scene_items:
            if _resumed(scene):
                if buf:
                    yield ("group", buf)
                    buf = []
                yield ("cached", scene)
                continue
            buf.append((scene, windows))
            if len(buf) >= group_size:
                yield ("group", buf)
                buf = []
        if buf:
            yield ("group", buf)

    def _stage(item):
        """Dispatch a group's device work; returns a function that fetches
        it as [(pred_edges, avg_scores, scored), ...]."""
        if item is None or item[0] == "cached":
            return item
        items = item[1]
        if pipeline == "device":
            pending = device_pipe.dispatch_scenes([s for s, _ in items])

            def fin():
                out = []
                for (scene, _), avg in zip(items, device_pipe.finalize_scenes(pending)):
                    kept = threshold_edges(avg, scene, cfg.predict.edge_score_thresholds)
                    # averaged unique edges (the other pipelines count the
                    # per-window observations)
                    out.append((greedy_round(kept), avg, len(avg)))
                return out

            return ("fut", items, fin)
        if pipeline == "encoded" and group_size > 1:
            staged = dispatch_predict_scenes(
                scorer, items, cfg.predict,
                buckets=run_buckets, m_pad=run_m_pad,
                encodings_list=[
                    enc_by_token[s.scene_token] for s, _ in items
                ] if use_enc_cache else None,
            )

            def fin():
                return [
                    (pe, avg, sum(w.num_edges for w in ws))
                    for (pe, avg), (_, ws) in zip(finalize_predict_scenes(scorer, staged), items)
                ]

            return ("fut", items, fin)

        def fin():
            out = []
            for scene, windows in items:
                pred_edges, avg_scores = predict_scene(
                    scorer, scene, windows, cfg.predict,
                    buckets=run_buckets, m_pad=run_m_pad,
                    encodings=enc_by_token[scene.scene_token] if use_enc_cache else None,
                )
                out.append((pred_edges, avg_scores, sum(w.num_edges for w in windows)))
            return out

        return ("fut", items, fin)

    all_results = []
    scene_track_counts: List[int] = []
    all_tokens: List[str] = []
    n_edges = n_scenes = n_resumed = n_resumed_edges = 0
    t0 = time.time()

    def _assemble(scene, pred_edges, avg_scores, scored):
        nonlocal n_edges
        n_edges += scored
        cats = {i: m["category_name"] for i, m in enumerate(scene.metadata)}
        tracks = hierarchical_clusters(
            pred_edges, cats, cfg.predict.join_score_thresholds
        )
        results = scene_results(tracks, scene, cfg.predict.interpolate_trailer_tracks)
        if rank0:
            with open(os.path.join(
                    edge_scores_dir, f"{scene.scene_token}_edge_scores.json"), "w") as f:
                json.dump({str(k): v for k, v in avg_scores.items()}, f)
            # for --skip-existing (atomic, so a kill mid-write leaves no
            # readable half file)
            tmp = f"{_results_path(scene)}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(
                    {"results": results, "num_tracks": len(tracks), "scored": scored}, f
                )
            os.replace(tmp, _results_path(scene))
        all_results.append(results)
        scene_track_counts.append(len(tracks))

    it = _items()
    staged = _stage(next(it, None))
    while staged is not None:
        staged_next = _stage(next(it, None))  # enqueued before this one is fetched
        if staged[0] == "cached":
            # a previous run's per-scene results; track ids are scene-local
            # and offset below. Counted apart from the scored scenes.
            scene = staged[1]
            with open(_results_path(scene)) as f:
                payload = json.load(f)
            n_scenes += 1
            n_resumed += 1
            n_resumed_edges += int(payload["scored"])
            all_results.append(payload["results"])
            scene_track_counts.append(int(payload["num_tracks"]))
            all_tokens.extend(all_scene_sample_tokens(scene))
        else:
            _, items, fin = staged
            for (scene, _), out in zip(items, fin()):
                n_scenes += 1
                _assemble(scene, *out)
                all_tokens.extend(all_scene_sample_tokens(scene))
        staged = staged_next

    # scene-local track ids -> globally unique (after the loop, so that
    # resumed scenes keep a consistent numbering)
    track_offset = 0
    for results, ntracks in zip(all_results, scene_track_counts):
        if track_offset:
            for boxes in results.values():
                for b in boxes:
                    b["tracking_id"] = str(track_offset + int(b["tracking_id"]))
        track_offset += ntracks
    dt = time.time() - t0

    submission = assemble_submission(
        all_results,
        all_tokens,
        use_camera=cfg.main.sensors_used.get("img", True),
        use_lidar=cfg.main.sensors_used.get("lidar", True),
        use_radar=False,
    )
    sub_path = os.path.join(cfg.paths.eval, "submission.json")
    if rank0:
        os.makedirs(cfg.paths.eval, exist_ok=True)
        with open(sub_path, "w") as f:
            json.dump(submission, f)
    unit = "unique edges" if pipeline == "device" else "edges"
    resumed_msg = (
        f" + {n_resumed} resumed ({n_resumed_edges} {unit})" if n_resumed else ""
    )
    print(
        f"predict[{pipeline}]: {n_scenes - n_resumed} scenes, {n_edges} {unit} "
        f"scored in {dt:.1f}s ({n_edges / max(dt, 1e-9):.0f} {unit}/s)"
        f"{resumed_msg} -> {sub_path}"
    )
    return submission


def _scene_from_store(path: str, windows, with_modalities: bool = False):
    """The SceneDetections view prediction needs, rebuilt from a store and
    its sidecars: global yaw and velocity from the metadata's rotation and
    velocity, ego-frame fields from its ``ego`` entries (a store without
    them is refused with a rebuild hint), the real frame tokens from the
    frames sidecar; with ``with_modalities`` the per-detection modality
    arrays re-assembled from the windows' node features through
    ``det_index``."""
    from batch3dmot_tpu_torch import geometry as geo
    from batch3dmot_tpu_torch.config import TRACKING_CLASSES
    from batch3dmot_tpu_torch.data.types import SceneDetections

    meta_path = path.replace(".b3d", "_metadata.json")
    with open(meta_path, "r") as f:
        metadata = json.load(f)
    m = len(metadata)
    scene_token = os.path.basename(path).split("_len")[0]
    frame_idx = np.array([md["time"] for md in metadata], np.int32)
    class_id = np.array(
        [TRACKING_CLASSES[md["category_name"]] for md in metadata], np.int32
    )
    center_g = np.array([md["translation"] for md in metadata], float).reshape(m, 3)
    quats = np.array(
        [md.get("rotation", [1.0, 0.0, 0.0, 0.0]) for md in metadata], float
    ).reshape(m, 4)
    yaw_g = geo.quaternion_yaw(quats) if m else np.zeros((0,))
    vel_g = np.zeros((m, 3))
    for i, md in enumerate(metadata):
        v = md.get("velocity")
        if v:
            vel_g[i, : len(v[:2])] = v[:2]
    # the frames sidecar: every frame's sample token, trailing empty frames
    # included; without it, the detection-derived frame count
    frame_tokens = None
    frames_path = path.replace(".b3d", "_frames.json")
    if os.path.exists(frames_path):
        with open(frames_path) as f:
            frame_tokens = json.load(f)
    num_frames = (
        len(frame_tokens) if frame_tokens is not None
        else (int(frame_idx.max()) + 1 if m else 0)
    )
    if any("ego" not in md for md in metadata):
        raise SystemExit(
            f"{meta_path} predates the ego-pose sidecar fields; re-run "
            "build-graphs for this scene (stores are rebuilt per scene, "
            "--skip-existing leaves the others untouched)"
        )
    center_e = np.array([md["ego"]["center"] for md in metadata], float)
    yaw_e = np.array([md["ego"]["yaw"] for md in metadata], float)
    vel_e = np.array([md["ego"]["vel"] for md in metadata], float)
    token_map: Dict[str, int] = {}
    token_id = np.full(m, -1, np.int32)
    for i, md in enumerate(metadata):
        tok = md.get("token")
        if tok:
            token_id[i] = token_map.setdefault(tok, len(token_map))

    img = lidar = radar = None
    if with_modalities:
        from batch3dmot_tpu_torch.graph import IMG_SHAPE, LIDAR_SHAPE, RADAR_SHAPE

        has = {
            name: any(
                getattr(w, name) is not None and getattr(w, name).size
                for w in windows
            )
            for name in ("img", "lidar", "radar")
        }
        img_dt = next(
            (w.img.dtype for w in windows if w.img is not None and w.img.size),
            np.float32,
        )
        img = np.zeros((m, *IMG_SHAPE), img_dt) if has["img"] else None
        lidar = np.zeros((m, *LIDAR_SHAPE), np.float32) if has["lidar"] else None
        radar = np.zeros((m, *RADAR_SHAPE), np.float32) if has["radar"] else None
        for w in windows:
            for name, buf in (("img", img), ("lidar", lidar), ("radar", radar)):
                arr = getattr(w, name)
                if buf is not None and arr is not None and arr.size:
                    buf[w.det_index] = arr

    return SceneDetections(
        scene_token=scene_token,
        num_frames=num_frames,
        frame_idx=frame_idx,
        center_g=center_g,
        yaw_g=np.asarray(yaw_g, float).reshape(m),
        vel_g=vel_g,
        center_e=center_e.reshape(m, 3),
        yaw_e=yaw_e.reshape(m),
        vel_e=vel_e.reshape(m, 3),
        wlh=np.array([md["size"] for md in metadata], float).reshape(m, 3),
        class_id=class_id,
        score=np.array([md["score"] for md in metadata], float),
        token_id=token_id,
        metadata=metadata,
        frame_tokens=frame_tokens,
        img=img,
        lidar=lidar,
        radar=radar,
    )


def cmd_preprocess(args) -> dict:
    """The L2 modality preprocessing: per-annotation artifacts for encoder
    training, per modality, skipped with ``--skip-existing`` where its anns
    JSON exists. Returns the annotation count and seconds per modality
    written."""
    cfg = _load_config(args)
    from batch3dmot_tpu_torch.data.nuscenes_tables import NuScenesTables
    from batch3dmot_tpu_torch.data.preprocess import (
        generate_image_annotations,
        preprocess_lidar_annotations,
        preprocess_radar_annotations,
    )

    tables = NuScenesTables(cfg.paths.data, cfg.main.version)
    pre = cfg.paths.preprocessed
    os.makedirs(pre, exist_ok=True)
    wanted = ("img", "lidar", "radar") if args.modality == "all" else (args.modality,)

    def done(kind):
        return os.path.join(pre, f"processed_{kind}_anns.json")

    def need_img_anns(kind):
        # lidar and radar membership follows the image-annotation records
        if not os.path.exists(done("img")):
            raise SystemExit(
                f"{kind} preprocessing needs processed_img_anns.json "
                "(dataset membership + camera->radar channels); run "
                "`preprocess --modality img` first"
            )
        with open(done("img")) as f:
            return json.load(f)

    sj = cfg.paths.splits_json or None
    makers = {
        "img": lambda: generate_image_annotations(tables, cfg, splits_json=sj),
        "lidar": lambda: preprocess_lidar_annotations(
            tables, os.path.join(pre, "lidar"), need_img_anns("lidar"), cfg,
            splits_json=sj,
        ),
        "radar": lambda: preprocess_radar_annotations(
            tables, os.path.join(pre, "radar"), need_img_anns("radar"), cfg,
            splits_json=sj,
        ),
    }
    written = {}
    t0 = time.time()
    for kind in ("img", "lidar", "radar"):
        if kind not in wanted or (args.skip_existing and os.path.exists(done(kind))):
            continue
        t = time.perf_counter()
        anns = makers[kind]()
        with open(done(kind), "w") as f:
            json.dump(anns, f)
        n = sum(len(v) for v in anns.values())
        written[kind] = {"annotations": n, "seconds": time.perf_counter() - t}
        print(f"preprocess {kind}: {n} annotations -> {done(kind)}")
    print(f"preprocess: done in {time.time() - t0:.1f}s -> {pre}")
    return written


def cmd_concat_jsons(args) -> None:
    """Merge two split-keyed annotation JSONs: file1's split lists extended
    by file2's."""
    with open(args.file1) as f:
        a = json.load(f)
    with open(args.file2) as f:
        b = json.load(f)
    for split, entries in b.items():
        if split in a and isinstance(a[split], list):
            a[split].extend(entries)
        else:
            a[split] = entries
    with open(args.outfile, "w") as f:
        json.dump(a, f)
    print(
        f"concat-jsons: {list(a.keys())} -> {args.outfile} "
        f"({sum(len(v) for v in a.values() if isinstance(v, list))} entries)"
    )


def cmd_validate_data(args) -> None:
    """The data doctor over the configured data plane (tables, splits JSON,
    detection JSON) before any expensive stage. Exit code 1 on errors, and
    on warnings with ``--strict``."""
    cfg = _load_config(args)
    from batch3dmot_tpu_torch.data.validate import validate_config_data

    findings = validate_config_data(cfg, split=args.split)
    for f in findings:
        print(f)
    n_err = sum(1 for f in findings if f.level == "error")
    n_warn = sum(1 for f in findings if f.level == "warn")
    print(
        f"validate-data: {n_err} error(s), {n_warn} warning(s) for "
        f"dataroot={cfg.paths.data} version={cfg.main.version} "
        f"detector={cfg.main.detections}"
    )
    if n_err or (args.strict and n_warn):
        raise SystemExit(1)


def cmd_export_gt(args) -> None:
    """GT tracking boxes of the eval split from the nuScenes tables, as the
    JSON ``eval --gt`` reads ({"boxes": [...], "frames": [...]}): exporting
    every scene would make the scorer count the other splits' frames as
    missed tracks."""
    cfg = _load_config(args)
    from batch3dmot_tpu_torch.config import TRACKING_CLASS_NAMES
    from batch3dmot_tpu_torch.data.nuscenes_tables import NuScenesTables

    tables = NuScenesTables(cfg.paths.data, cfg.main.version)
    boxes, frames = [], []
    try:
        metas = tables.scene_metas_for_split(cfg.eval.eval_set, cfg.paths.splits_json or None)
    except KeyError as e:
        raise SystemExit(str(e))
    for scene in metas:
        for tok in tables.scene_sample_tokens(scene["token"]):
            frames.append(tok)
            gt = tables.gt_frame_boxes(tok)
            for i in range(len(gt)):
                boxes.append(
                    {
                        "sample_token": tok,
                        "translation": gt.center[i].tolist(),
                        "tracking_name": TRACKING_CLASS_NAMES[int(gt.class_id[i])],
                        "instance": gt.instance[i],
                    }
                )
    with open(args.out, "w") as f:
        json.dump({"boxes": boxes, "frames": frames}, f)
    print(f"export-gt: {len(boxes)} boxes over {len(frames)} frames -> {args.out}")


def cmd_import_checkpoint(args) -> None:
    """A reference torch ``.pth`` checkpoint as a port ``.pt``: the port's
    modules carry the reference's state-dict names, so this is a strict
    load by name and a save."""
    import torch

    from batch3dmot_tpu_torch.models import (
        MultimodalGNN,
        PointNetClassifier,
        PoseGNN,
        RadarNetClassifier,
        ResNetAE,
    )
    from batch3dmot_tpu_torch.utils.checkpoint import save_checkpoint

    modules = {
        "resnet": ResNetAE,
        "pointnet": PointNetClassifier,
        "radarnet": RadarNetClassifier,
        "mm": MultimodalGNN,
        "pose": PoseGNN,
    }
    sd = torch.load(args.torch, map_location="cpu", weights_only=True)
    module = modules[args.arch]()
    if args.arch == "mm":
        # the reference tracker holds whole encoders; the GNN's have no
        # decoder and no classification head, whose entries are dropped
        heads = {
            f"{name}.{k}"
            for name, enc in (("resnet", ResNetAE), ("pointnet", PointNetClassifier),
                              ("radarnet", RadarNetClassifier))
            for k in enc().state_dict()
        } - set(module.state_dict())
        sd = {k: v for k, v in sd.items() if k not in heads}
    try:
        module.load_state_dict(sd, strict=True)
    except RuntimeError as e:
        raise SystemExit(f"import-checkpoint[{args.arch}]: {args.torch}: {e}") from None
    state = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    path = save_checkpoint(args.out, state, metadata={"source": args.torch})
    n = sum(v.numel() for k, v in state.items() if not k.endswith("num_batches_tracked"))
    print(f"import-checkpoint[{args.arch}]: {n} params {args.torch} -> {path}")


def cmd_eval(args) -> None:
    with open(args.submission) as f:
        submission = json.load(f)

    if not args.devkit and not args.gt:
        raise SystemExit("eval: --gt is required (or pass --devkit)")
    if args.devkit:
        # the official nuScenes TrackingEval (nuscenes-devkit and the tree)
        from batch3dmot_tpu_torch.eval.nuscenes_eval import devkit_available, run_official_eval

        if not devkit_available():
            raise SystemExit(
                "nuscenes-devkit is not installed; re-run without --devkit "
                "to use the native AMOTA scorer"
            )
        metrics = run_official_eval(submission, _load_config(args))
        print(json.dumps(metrics))
        return metrics

    from batch3dmot_tpu_torch.eval.tracking_metrics import evaluate_tracking, json_safe

    with open(args.gt) as f:
        gt = json.load(f)
    pred_boxes = [b for boxes in submission["results"].values() for b in boxes]
    frames = list(submission["results"].keys())
    res = evaluate_tracking(gt["boxes"], pred_boxes, frames)
    print(res.summary())
    # a run where no class matched reports NaN: strict JSON null instead
    print(json.dumps(json_safe({"amota": res.amota, "amotp": res.amotp})))
    return res


def cmd_demo(args) -> None:
    """The full synthetic pipeline: build -> train -> predict -> eval."""
    import tempfile

    from batch3dmot_tpu_torch.eval.tracking_metrics import (
        evaluate_tracking,
        gt_boxes_from_scene,
    )

    device = _device(args)
    tmp = tempfile.mkdtemp(prefix="b3d_demo_")
    args.config = None
    args.set = (args.set or []) + [
        f"paths.tmp={tmp}",
        "graph_construction.batch_size_graph=3",
        "graph_construction.top_knn_nodes=5",
        "gnn.gnn_depth=2",
        "gnn.lr=1e-3",
        "gnn.weight_decay=0.0",
    ]
    args.synthetic = args.synthetic or 3
    args.skip_existing = False
    cmd_build_graphs(args)

    args.model = "pose"
    args.epochs = args.epochs or 6
    args.init_checkpoint = None
    args.fused_steps = 8
    args.profile = None
    args.encoded = args.device_dataset = args.stream = False
    for name in ("resnet", "pointnet", "radarnet"):
        setattr(args, f"{name}_checkpoint", None)
    cmd_train_gnn(args)

    cfg = _load_config(args)
    ckpts = sorted(
        glob.glob(os.path.join(cfg.paths.models, "gnn", "*.pt")),
        key=os.path.getmtime,
    )
    submission = _run_predict(cfg, ckpts[-1] if ckpts else None, "pose", device=device)

    # evaluated against the synthetic GT
    scenes = _build_synthetic_scenes(cfg, args.synthetic, False)
    gt_boxes = [b for s in scenes for b in gt_boxes_from_scene(s)]
    pred_boxes = [b for boxes in submission["results"].values() for b in boxes]
    frames = list(submission["results"].keys())
    res = evaluate_tracking(gt_boxes, pred_boxes, frames)
    print(res.summary())
    print(f"demo complete: AMOTA={res.amota:.3f} (artifacts in {tmp})")
    return res


# ---- the parser -------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    from batch3dmot_tpu_torch.models.registry import MODEL_REGISTRY

    parser = argparse.ArgumentParser(prog="batch3dmot_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p):
        p.add_argument("--config", type=str, default=None)
        p.add_argument("--set", action="append", default=[],
                       help="override section.key=value")
        return p

    def devices_arg(p):
        p.add_argument("--devices", type=int, default=None,
                       help="data-parallel ranks, one process each (default: 1)")
        return p

    def device_arg(p):
        p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                       help="where to compute (default: the GPU, which must exist)")
        return p

    p = common(sub.add_parser("preprocess"))
    p.add_argument("--modality", choices=["img", "lidar", "radar", "all"],
                   default="all")
    p.add_argument("--skip-existing", action="store_true",
                   help="skip modalities whose anns JSON already exists")
    p.set_defaults(fn=cmd_preprocess)

    p = device_arg(common(sub.add_parser("build-graphs")))
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic scenes instead of nuScenes")
    p.add_argument("--skip-existing", action="store_true",
                   help="skip scenes whose store already exists (resume)")
    p.set_defaults(fn=cmd_build_graphs)

    model_names = sorted(MODEL_REGISTRY)

    p = device_arg(devices_arg(common(sub.add_parser("train-gnn"))))
    p.add_argument("--model", choices=model_names, default="mm",
                   help="model family: short aliases (pose/mm) follow the "
                        "config's sensors; reference family names "
                        "(clr_att_gnn, cl_att_gnn, cl_gnn_trad, "
                        "gnn_baseline, ...) fix their modalities")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--init-checkpoint", type=str, default=None,
                   help="start from these weights (.pt, or a JAX .msgpack); "
                        "the optimizer starts fresh")
    p.add_argument("--fused-steps", type=int, default=8,
                   help="same-shape optimizer steps run per upload and fetch")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler trace to this directory "
                        "(trace_<pid>.json) and, beside it, the training "
                        "loop's counters (loop_<pid>.json: calls, steps, "
                        "valid edges and edge slots, the device's step and "
                        "wait seconds); a device-resident run names its "
                        "stages train.sources, train.rows, train.steps, "
                        "train.fetch and train.metrics")
    p.add_argument("--encoded", action="store_true",
                   help="precompute the frozen encoders once per scene and "
                        "train on gathered embeddings")
    p.add_argument("--device-dataset", action="store_true",
                   help="upload the whole padded dataset once and gather "
                        "each step's batch on the device; multimodal "
                        "models need --encoded; must fit the "
                        "B3D_DEVICE_DATASET_GB budget per card (default 6). "
                        "With --encoded this is automatic whenever the "
                        "estimated dedup dataset fits the budget")
    p.add_argument("--stream", action="store_true",
                   help="with --encoded: force scene-streaming training "
                        "(memory bounded by one scene) instead of the "
                        "automatic device-resident upgrade")
    for enc in ("resnet", "pointnet", "radarnet"):
        p.add_argument(f"--{enc}-checkpoint", type=str, default=None,
                       help=f"graft a pretrained {enc} encoder checkpoint "
                            "into the tracker's frozen submodule")
    p.set_defaults(fn=cmd_train_gnn)

    for name, fn in [
        ("train-resnet", cmd_train_resnet),
        ("train-pointnet", cmd_train_pointnet),
        ("train-radarnet", cmd_train_radarnet),
    ]:
        p = device_arg(devices_arg(common(sub.add_parser(name))))
        p.add_argument("--epochs", type=int, default=None)
        p.add_argument("--synthetic", action="store_true",
                       help="train on random shape-compatible batches")
        p.add_argument("--device-dataset", action="store_true",
                       help="decode or load every item once, upload the "
                            "stacked dataset, and run the loaders' per-epoch "
                            "randomness on the device "
                            "(B3D_DEVICE_DATASET_GB budget per card)")
        p.set_defaults(fn=fn)

    p = device_arg(devices_arg(common(sub.add_parser("predict"))))
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--model", choices=model_names, default="mm")
    p.add_argument("--pipeline",
                   choices=["auto", "windows", "encoded", "device"],
                   default="auto",
                   help="windows: per-window scoring; encoded: encode-once "
                        "(mm default); device: graph build and scoring on "
                        "the card straight from source data")
    p.add_argument("--synthetic", type=int, default=0,
                   help="(--pipeline device) predict N synthetic scenes")
    p.add_argument("--aot-cache", type=str, default=None,
                   help="directory of the built CUDA kernels (kept across "
                        "runs: the cold start is their nvcc build)")
    p.add_argument("--skip-existing", action="store_true",
                   help="resume an interrupted run: scenes with a per-scene "
                        "results JSON under <eval>/predict/ are loaded, not "
                        "re-scored (the submission still covers every scene)")
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("concat-jsons")
    p.add_argument("--file1", required=True)
    p.add_argument("--file2", required=True)
    p.add_argument("--outfile", required=True)
    p.set_defaults(fn=cmd_concat_jsons)

    p = common(sub.add_parser("validate-data"))
    p.add_argument("--strict", action="store_true",
                   help="exit nonzero on warnings too")
    p.add_argument("--split", default=None,
                   help="split to validate (default: graph_construction.split)")
    p.set_defaults(fn=cmd_validate_data)

    p = common(sub.add_parser("export-gt"))
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_export_gt)

    p = common(sub.add_parser("eval"))
    p.add_argument("--submission", required=True)
    p.add_argument("--gt", default=None,
                   help="GT boxes JSON (export-gt output); required unless --devkit")
    p.add_argument("--devkit", action="store_true",
                   help="score with the official nuScenes TrackingEval "
                        "(needs nuscenes-devkit + dataset) instead of the "
                        "native scorer")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("import-checkpoint")
    p.add_argument("--torch", required=True, help="reference .pth checkpoint")
    p.add_argument("--arch", required=True,
                   choices=["resnet", "pointnet", "radarnet", "mm", "pose"])
    p.add_argument("--out", required=True, help="output .pt path")
    p.set_defaults(fn=cmd_import_checkpoint)

    p = device_arg(common(sub.add_parser("demo")))
    p.add_argument("--synthetic", type=int, default=3)
    p.add_argument("--epochs", type=int, default=None)
    p.set_defaults(fn=cmd_demo)
    return parser


# ---- ranks --------------------------------------------------------------------


def _run_as_rank(args, mesh):
    """The subcommand on ``mesh``; the ranks but 0 print nothing."""
    args.mesh = mesh
    with open(os.devnull, "w") as devnull, contextlib.redirect_stdout(
            sys.stdout if mesh.rank == 0 else devnull):
        return args.fn(args)


def _rank_command(mesh, argv: List[str], result_path: str) -> None:
    """One rank of ``--devices N``: the subcommand on ``mesh``; rank 0
    writes its result (a history or a submission) to ``result_path``."""
    result = _run_as_rank(build_parser().parse_args(argv), mesh)
    if mesh.rank == 0:
        with open(result_path, "w") as f:
            json.dump(result, f)


def _run_on_ranks(args, argv: List[str]):
    """``--devices N``: the subcommand on N ranks (see the module
    docstring). Returns rank 0's result."""
    import tempfile

    import torch

    from batch3dmot_tpu_torch.parallel.mesh import spawn

    n = args.devices
    device = args.device or "cuda"
    if device == "cuda":
        if not torch.cuda.is_available():
            _device(args)
        from batch3dmot_tpu_torch.ops import cuda_build

        # the kernels are built once, here, before the ranks load them
        cuda_build.build(sorted(p.stem for p in cuda_build.CSRC.glob("*.cu")))
        backend = "nccl" if torch.cuda.device_count() >= n else "gloo"
        print(f"{args.command}: {n} ranks over {backend} on "
              f"{min(n, torch.cuda.device_count())} GPU(s)")
    else:
        backend = "gloo"
    with tempfile.TemporaryDirectory(prefix="b3d_ranks_") as tmp:
        result_path = os.path.join(tmp, "result.json")
        spawn(_rank_command, n, list(argv), result_path, device=device, backend=backend)
        with open(result_path) as f:
            return json.load(f)


def main(argv: Optional[List[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    n = getattr(args, "devices", None)
    if n and n > 1 and "WORLD_SIZE" not in os.environ:
        return _run_on_ranks(args, argv)
    if n and "WORLD_SIZE" in os.environ:
        # under torchrun: the ranks come from the environment
        from batch3dmot_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(n, device=args.device)
        try:
            return _run_as_rank(args, mesh)
        finally:
            mesh.close()
    return args.fn(args)


def script_main() -> int:
    """Console entry point: ``main()`` returns command results for
    in-process callers; this returns an exit status."""
    main()
    return 0


if __name__ == "__main__":
    main()
