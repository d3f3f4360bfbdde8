"""Driver of the training mixes: ``GNNTrainer.fit_device`` of the port over
the configuration's training scenes, dense form, whole epochs back to back.

Set-up builds the scenes and weights from the seed, the windows, the
frozen encodings (multimodal model) and the device-resident dataset, then
runs ``fit_device``'s first epoch, which captures every step the window
replays. Its first steps are the checked ones: the index rows that
``fit_device`` feeds to ``GNNTrainer._run_steps`` are watched (``Steps``),
and after its first and its third step the first gradient (Adam's first
moment after one step) and the parameters are kept for the check, with
the windows those rows name. The window runs ``fit_device`` one epoch at a
time until the seconds are spent. Every index row that ``fit_device``
stepped is counted: the rate is the valid training edges of the windows
it stepped over the window's time, whole epochs only, and the check holds
each epoch to every window once.
"""

from __future__ import annotations

import sys
import time
import types

import numpy as np
import torch
from torch.profiler import record_function

from harness import work
from harness.port import port_model, port_scene
from harness.scenes import make_scenes
from harness.weights import draw_state
from reference import compare
from reference import graphs as G
from reference import model as R


def inputs(ctx) -> types.SimpleNamespace:
    """What both sides get: the scenes and the initial weights."""
    cfg = ctx.cfg
    mm = cfg["model"] != "PoseGNN"
    pts = (cfg["lidar_points"], cfg["radar_points"]) if mm else None
    scenes = make_scenes(ctx.mix, range(cfg["train_scenes"]), ctx.seed, pts)
    init = draw_state(R.param_spec(cfg), ctx.seed, ctx.device,
                      cfg["assumed"]["weight_gains"]["train"], cfg["assumed"]["bias_scale"])
    return types.SimpleNamespace(ctx=ctx, cfg=cfg, mm=mm, scenes=scenes, init=init,
                                 device=ctx.device, seed=ctx.seed, checked=None)


def reference_windows(st) -> None:
    """The reference's own windows, in the order the dataset holds them:
    ``origin`` (scene, first frame) of every window with an edge, and
    ``counts`` (valid edges, sources, destinations, touched nodes, nodes)
    of each. Built after the window (they serve the work counts and the
    check); without the program's rows, the checked steps' windows are
    drawn from all of them."""
    if getattr(st, "origin", None) is not None:
        return
    cfg = st.cfg
    origin, counts = [], []
    for si, sc in enumerate(st.scenes):
        for start, w in G.scene_windows(sc, cfg["window_len_train"], cfg["top_knn_nodes"]):
            origin.append((si, start))
            counts.append((len(w["src"]), len(np.unique(w["src"])), len(np.unique(w["dst"])),
                           len(np.unique(np.r_[w["src"], w["dst"]])), len(w["pose"])))
    st.origin, st.counts = origin, np.array(counts, np.int64)
    if st.checked is None:
        steps, b = st.ctx.mix["check_steps"], cfg["batch_size"]
        rng = np.random.default_rng([st.seed % 2 ** 63, 11])
        st.checked = rng.permutation(len(origin))[: steps * b].reshape(steps, b).tolist()


def setup(ctx):
    from batch3dmot_tpu_torch.config import GNNConfig, GraphConstructionConfig
    from batch3dmot_tpu_torch.graphs import build_scene_graphs
    from batch3dmot_tpu_torch.train.trainer import GNNTrainer

    ctx.stages.mark("imports")
    st = inputs(ctx)
    ctx.stages.mark("scenes, weights")
    cfg, dev = st.cfg, st.device
    if dev.type == "cuda":
        from batch3dmot_tpu_torch.ops import cuda_build

        cuda_build.build(["fused_mp", "fused_mp_train", "segment_sum"])
        ctx.stages.mark("kernels built or found")
    gc = GraphConstructionConfig(top_knn_nodes=cfg["top_knn_nodes"],
                                 batch_size_graph=cfg["window_len_train"])
    b1, b2 = cfg["betas"]
    st.trainer = GNNTrainer(port_model(cfg), GNNConfig(
        lr=cfg["lr"], weight_decay=cfg["weight_decay"], batch_size=cfg["batch_size"],
        loss=cfg["loss"], beta_lo=b1, beta_hi=b2), device=dev, init_state_dict=st.init)
    windows, items = [], []
    for si, sc in enumerate(st.scenes):
        ps = port_scene(sc, f"train_{si}")
        if st.mm:
            from batch3dmot_tpu_torch.train.encoded import precompute_scene_encodings

            enc = precompute_scene_encodings(st.trainer.model, ps, device=dev)
        for w in build_scene_graphs(ps, cfg["window_len_train"], gc):
            if w.num_edges:
                windows.append(w)
                items.append((w, enc) if st.mm else w)
    st.n_windows = len(windows)
    if st.mm:
        from batch3dmot_tpu_torch.train.encoded import materialize_encoded_datasets as mat
    else:
        from batch3dmot_tpu_torch.train.data import materialize_graph_datasets as mat
    ctx.stages.mark("trainer, windows, encodings")
    st.groups = mat(items)
    st.trainer.fit_device(st.groups, epochs=0, verbose=False)  # the one upload
    ctx.stages.mark("dataset stacked and uploaded")

    # each group row's window, by its node features
    where = {w.pose.tobytes(): i for i, w in enumerate(windows)}
    st.rows = []
    for g in st.groups:
        nv = g[0].node_mask.sum(dim=1).tolist()
        st.rows.append([where[g[0].pose[r, :nv[r]].numpy().tobytes()]
                        for r in range(len(nv) - 1)])
    st.steps_per_epoch = sum(-(-len(r) // cfg["batch_size"]) for r in st.rows)
    st.rng = np.random.default_rng([st.seed % 2 ** 63, 13])
    st.watch = Steps(st, ctx.mix["check_steps"])
    st.trainer.fit_device(st.groups, epochs=1, verbose=False, seed=int(st.rng.integers(2 ** 31)))
    if st.watch.checked is None:
        raise RuntimeError("fit_device stepped no index rows through GNNTrainer._run_steps")
    st.prog, st.checked = st.watch.prog, st.watch.checked
    ctx.stages.mark("first epoch: checked steps and captures")
    return st


class Steps:
    """Watches the index rows that ``fit_device`` feeds to the trainer's
    ``_run_steps``: its first training call is run in three parts, after
    the first step and after ``steps`` steps the state is read for the
    check; every later training call's rows are kept (on the device until
    ``take``)."""

    def __init__(self, st, steps: int):
        self.st, self.steps, self.checked, self.prog = st, steps, None, None
        self.calls = []
        trainer = st.trainer
        self.run = trainer._run_steps
        trainer._run_steps = self

    def group(self, res) -> int:
        return next(i for i, g in enumerate(self.st.groups) if g is res.source)

    def __call__(self, res, idx, train: bool):
        if not train:
            return self.run(res, idx, train)
        if self.checked is not None:
            self.calls.append((self.group(res), idx))
            return self.run(res, idx, train)
        return self.first(res, idx)

    def first(self, res, idx):
        trainer, st, k = self.st.trainer, self.st, self.steps
        if idx.shape[0] < k:
            raise RuntimeError(f"fit_device's first call has {idx.shape[0]} steps, "
                               f"fewer than the {k} checked")
        b1 = st.cfg["betas"][0]
        trained = [(n, p) for n, p in trainer.model.named_parameters() if p.requires_grad]
        out = [self.run(res, idx[:1], True)]
        # Adam's first moment after one step is (1 - beta1) g
        grad = {n: (trainer.optimizer.state[p].get("exp_avg", torch.zeros_like(p))
                    / (1 - b1)).detach().cpu() for n, p in trained}
        out.append(self.run(res, idx[1:k], True))
        self.prog = {"losses": [float(x) for x in np.concatenate(out)[:, 0]], "grad": grad,
                     "change": {n: (p.detach().double() - st.init[n].double()).cpu()
                                for n, p in trained}}
        gi = self.group(res)
        # the empty window that pads a group's last batch has no edges
        self.checked = [[st.rows[gi][i] for i in row if i < res.n_items]
                        for row in idx[:k].cpu().tolist()]
        if idx.shape[0] > k:
            out.append(self.run(res, idx[k:], True))
        return np.concatenate(out)

    def take(self) -> list:
        """[(group, rows [steps, B])] of the training calls since the last
        ``take``, on the host."""
        calls, self.calls = self.calls, []
        return [(gi, idx.cpu().numpy()) for gi, idx in calls]


def stepped_work(st, visits: np.ndarray) -> dict:
    """The work of the windows stepped, each as many times as it was."""
    cfg = st.cfg
    w = work.mp_widths(cfg)
    depth = cfg["gnn_depth"]
    mp = np.zeros(4)
    for v, (e, _, _, t, _) in zip(visits, st.counts):
        mp += v * np.array(work.train_work(int(e), int(t), w, depth), np.float64)
    edges, nodes = int(visits @ st.counts[:, 0]), int(visits @ st.counts[:, 4])
    out = {"train_mp": (mp[0] + mp[1], mp[2] + mp[3]),
           "model_flops": 3 * work.pre_mp_flops(cfg, edges, nodes) + mp[0] + mp[1]}
    if st.mm:
        # the attention rows' two gathers differentiate into segment sums
        width = cfg["img_dim"] + cfg["lidar_dim"] + cfg["radar_dim"]
        segs = int(visits @ (st.counts[:, 1] + st.counts[:, 2]))
        out["segment_sum"] = work.segment_work(2 * edges, width, segs)
    return out


def window(st, seconds: float) -> dict:
    st.watch.take()
    t0 = time.perf_counter()
    epochs = bad = 0
    ends = []
    while True:
        with record_function("b3dbench.epoch"):
            hist = st.trainer.fit_device(st.groups, epochs=1, verbose=False,
                                         seed=int(st.rng.integers(2 ** 31)))
        epochs += 1
        ends.append(time.perf_counter() - t0)
        bad += not np.isfinite(hist[0]["train/loss"])
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    return {"epochs": epochs, "elapsed": elapsed, "bad": bad, "ends": ends,
            "stepped": st.watch.take()}


def summarize(st, raw: dict) -> dict:
    """The window's rate over the windows ``fit_device`` stepped, the steps
    attempted and failed (every step of an epoch whose mean loss is not
    finite), and its work. ``st.visits_off``: by how many visits the
    stepped windows miss every window once an epoch, and the steps the
    epochs' count."""
    print("window: epochs ended at " + ", ".join(f"{t:.3f}" for t in raw["ends"]) + " s",
          file=sys.stderr)
    reference_windows(st)
    if len(st.origin) != st.n_windows:
        raise RuntimeError(f"the program trained on {st.n_windows} windows with edges, the "
                           f"reference builds {len(st.origin)}")
    n = raw["epochs"]
    visits = np.zeros(len(st.origin), np.int64)
    steps = 0
    for gi, idx in raw["stepped"]:
        steps += idx.shape[0]
        rows = idx[idx < len(st.rows[gi])]
        np.add.at(visits, np.asarray(st.rows[gi], np.int64)[rows], 1)
    st.visits_off = float(np.abs(visits - n).sum() + abs(steps - n * st.steps_per_epoch))
    edges = int(visits @ st.counts[:, 0])
    return {"e2e": {"train_edges_per_s": edges / raw["elapsed"]},
            "attempted": steps, "failed": raw["bad"] * st.steps_per_epoch,
            "work": stepped_work(st, visits)}


def release(st) -> None:
    # the watch's hook on the trainer holds the trainer: drop both
    vars(st.trainer).pop("_run_steps", None)
    st.trainer = st.groups = st.watch = None
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_outputs(st, prec: str = "f64", fault=None) -> dict:
    """The reference's three steps on the checked windows, rebuilt from the
    scenes and the initial weights."""
    reference_windows(st)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = st.cfg
    ar = R.Arith(prec)
    P = {k: v.to(st.device, ar.dtype) if v.is_floating_point() else v for k, v in st.init.items()}
    batches = []
    for row in st.checked:
        batch = []
        for item in row:
            si, start = st.origin[item]
            sc = st.scenes[si]
            w = G.build_window(sc, start, cfg["window_len_train"], cfg["top_knn_nodes"])
            enc = None
            if st.mm:
                rows = [sc[m][w["det_index"]] for m in ("img", "lidar", "radar")]
                enc = R.encode_detections(P, *rows, ar)
            batch.append((w, enc))
        batches.append(batch)
    losses, grad, params = R.adam_steps(P, cfg, batches, ar, fault)
    return {"losses": losses, "grad": {k: v.cpu() for k, v in grad.items()},
            "change": {k: (params[k].double() - P[k].double()).cpu() for k in params}}


def check(st) -> dict:
    return {**compare.train_gaps(st.prog, reference_outputs(st)), "visits_off": st.visits_off}
