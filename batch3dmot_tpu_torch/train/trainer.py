"""Tracker-GNN trainer (counterpart of ``batch3dmot_tpu/train/trainer.py``,
its host-batched path).

  * optimizer: ``torch.optim.Adam(lr, betas, eps=1e-8, weight_decay)``, the
    reference's optimizer: the decay is added to the gradient before the
    moments (not AdamW), as the JAX package's ``torch_style_adam``;
  * the encoders (``resnet``, ``pointnet``, ``radarnet``) of a model with
    ``freeze_encoders`` (the default) get no update at all: they leave the
    optimizer and need no gradient, so weight decay cannot shrink them;
    with ``freeze_encoders=False`` they train with the rest (the JAX
    trainer's unmasked optimizer). Their batch-norm statistics are the
    running ones either way;
  * loss: (class-balanced unless ``cfg.loss == 'bce'``) BCE over the real
    edges divided by the window batch size, as the reference divides its
    mean BCE by ``gnn.batch_size``;
  * scores: the fused message-passing kernels and their hand-written
    backward on the GPU, autograd through their plain version on the CPU
    (``ops/fused_mp_train.py``); a model in ``knn_conv_mode='active'``
    runs its module loop under autograd instead (the kNN GATConv has no
    fused kernel; its segment sums and the message passing's go through
    the segment-sum kernel on the GPU), as the JAX trainer does;
  * metrics: per-batch loss, overall and per-class edge AP,
    nanmean-aggregated per epoch; checkpoints per epoch with AP-stamped
    names.

Window batches come from :class:`batch3dmot_tpu_torch.train.data.GraphBatcher`
or :class:`~batch3dmot_tpu_torch.train.store_data.StoreGraphBatcher`
(PaddedGraph), or from
:class:`~batch3dmot_tpu_torch.train.encoded.EncodedGraphBatcher` or
:class:`~batch3dmot_tpu_torch.train.encoded.StreamingEncodedBatcher`
((PaddedGraph, encodings)); ``fit`` takes a step per batch and fetches its
scores for the metrics on the host. Two paths keep the host out of the
steps:
  * ``fit_device`` trains on a dataset stacked once
    (``materialize_*_dataset(s)``) and uploaded once; every step gathers
    its batch on the device by index and computes its loss and APs there,
    and each group of steps ends in one fetch of those numbers;
  * ``fit(..., fused_steps=K)`` uploads K same-shape batches at once and
    runs them as K steps with one fetch.
On the card both replay one CUDA graph per (source, step kind): the whole
step (gather, forward, the kernels, backward, fused Adam, the metrics) is
captured once, after warm-up steps whose effect on the weights and the
optimizer is undone; per step the host copies the index row on the device,
replays the graph and copies its outputs into the group's buffer. A step
that cannot be captured raises. On the CPU the same steps run eagerly.

``mesh=`` (``parallel.make_mesh``) trains data-parallel, one process per
rank, with the JAX mesh's global-batch math (JAX ``:73-93``, ``:509-582``):
every rank takes its rows of each host batch; the loss is each rank's sum
over the global count of valid edges divided by the batch size, and one
flat all-reduce per step sums the gradients and the reported loss; the
APs are those of the all-gathered scores. ``fit_device`` splits each
group's windowed arrays (graphs, dense encodings, the dedup ``det_index``)
along the window axis, padded with copies of the empty window, and a step
fetches its rows from the ranks holding them (``parallel.mesh.fetch_rows``);
the dedup table is replicated. Under NCCL each step is still one replay,
its collectives inside the graph; gloo's collectives cannot be captured, so
under gloo the steps run eagerly. Rank 0 alone writes checkpoints and logs.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from batch3dmot_tpu_torch import prepare_model, upload
from batch3dmot_tpu_torch.config import TRACKING_CLASSES, GNNConfig
from batch3dmot_tpu_torch.graph import PaddedGraph
from batch3dmot_tpu_torch.models.gnn import PoseGNN
from batch3dmot_tpu_torch.models.layers import init_params_
from batch3dmot_tpu_torch.ops.fused_mp_train import fused_training_scores
from batch3dmot_tpu_torch.parallel.mesh import (
    RowTable,
    all_gather_rows,
    all_reduce_grads,
    all_reduce_sum,
    pad_rows,
    replicate,
    shard_batch_fn,
)
from batch3dmot_tpu_torch.train.encoded import FROZEN_ENCODERS, DedupEncodings
from batch3dmot_tpu_torch.train.metrics import average_precision_multi, masked_bce_terms
from batch3dmot_tpu_torch.utils import profiling
from batch3dmot_tpu_torch.utils.checkpoint import (
    epoch_checkpoint_name,
    load_checkpoint,
    save_checkpoint,
)

# eager steps before a capture (lazy state: optimizer moments, cuBLAS
# workspaces, the kernels' libraries and cached layouts); undone after
WARMUP_STEPS = 2


class GNNTrainer:
    """Trains a ``MultimodalGNN`` or ``PoseGNN`` on window batches.

    ``device`` None means the GPU (which must exist); pass ``"cpu"`` to run
    on the CPU. The weights come from ``init_state_dict`` when given, else
    from ``seed`` (default ``cfg.manual_seed``) through ``init_params_``.
    A captured step holds the learning rate and the optimizer's state
    tensors it was captured with: ``load_state`` drops the captured steps.
    With ``mesh`` the device is the mesh's, the batch size must divide by
    its size and rank 0's weights are broadcast."""

    def __init__(
        self,
        model: torch.nn.Module,
        cfg: Optional[GNNConfig] = None,
        device=None,
        seed: Optional[int] = None,
        init_state_dict: Optional[Dict[str, torch.Tensor]] = None,
        mesh=None,
    ):
        self.cfg = cfg or GNNConfig()
        self.mesh = mesh
        if mesh is not None:
            if self.cfg.batch_size % mesh.size:
                raise ValueError(f"batch size {self.cfg.batch_size} does not divide by the "
                                 f"mesh size {mesh.size}")
            device = mesh.device if device is None else device
        self.model, self.device = prepare_model(model, device)
        if init_state_dict is None:
            seed = self.cfg.manual_seed if seed is None else seed
            init_params_(self.model, torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(init_state_dict)
        if mesh is not None:
            replicate(self.model, mesh)
        self._shard = shard_batch_fn(mesh) if mesh is not None else (lambda batch: batch)
        self._told_eager = False
        # PoseGNN emits logits (no sigmoid head); MultimodalGNN emits scores
        self.from_logits = isinstance(self.model, PoseGNN)
        if getattr(self.model, "freeze_encoders", False):
            for name in FROZEN_ENCODERS:
                if hasattr(self.model, name):
                    getattr(self.model, name).requires_grad_(False)
        # on the card: the fused multi-tensor Adam, capturable (its step
        # counts live on the device) so that a CUDA graph can hold it; the
        # CPU refuses capturable and keeps the default implementation
        on_card = self.device.type == "cuda"
        self.optimizer = torch.optim.Adam(
            [p for p in self.model.parameters() if p.requires_grad],
            lr=float(self.cfg.lr),
            betas=(self.cfg.beta_lo, self.cfg.beta_hi),
            eps=1e-8,
            weight_decay=float(self.cfg.weight_decay),
            **(dict(fused=True, capturable=True) if on_card else {}),
        )
        self.step = 0
        self.graph_replays = 0
        self.graph_captures = 0
        self._class_ids = torch.tensor(list(TRACKING_CLASSES.values()), dtype=torch.int32,
                                       device=self.device)
        # the sources of steps on the device (with their captured steps) of
        # the latest fit_device or train_epoch call: dataset groups by the
        # identity of their host group, fused_steps' staging buffers by
        # (K, batch shape); a call keeps those it uses and drops the rest
        self._sources: Dict[object, _Resident] = {}

    # ---- core steps ------------------------------------------------------

    def _to_device(self, batch):
        if isinstance(batch, tuple):
            graph, enc = batch
            return graph.to(self.device), tuple(t.to(self.device) for t in enc)
        return batch.to(self.device)

    def _loss(self, batch):
        """(loss, scores [B, E]) of a batch on the device: a PaddedGraph, or
        (PaddedGraph, encodings) from EncodedGraphBatcher. On a mesh, this
        rank's rows and its term of the global loss (its sum over the
        global count)."""
        graph, enc = batch if isinstance(batch, tuple) else (batch, None)
        if self.model.knn_conv_mode == "active":
            scores = self._module_scores(graph, enc)
        else:
            scores = fused_training_scores(self.model, graph, enc)
        weights = (
            graph.edge_weight if self.cfg.loss == "cb"
            else torch.ones_like(graph.edge_weight)
        )
        total, count = masked_bce_terms(
            scores.reshape(-1),
            graph.edge_label.reshape(-1),
            graph.edge_mask.reshape(-1),
            weights.reshape(-1),
            from_logits=self.from_logits,
        )
        if self.mesh is not None:
            count = all_reduce_sum(count, self.mesh)
        return total / torch.clamp(count, min=1.0) / self.cfg.batch_size, scores

    def _module_scores(self, graph, enc):
        """Scores [B, E] of the module loop (LOGITS for PoseGNN); the frozen
        encoders run without a graph when no encodings are given."""
        if enc is None or self.from_logits:
            return self.model(graph)[0]
        return self.model.forward_from_encodings(graph, *enc)[0]

    def _step(self, batch):
        """One optimizer step on a batch on the device; returns (loss,
        scores), detached (on a mesh: the global loss, this rank's
        scores)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, scores = self._loss(batch)
        loss.backward()
        if self.mesh is not None:
            loss = all_reduce_grads(self._trained(), self.mesh, loss.detach().reshape(1))[0]
        self.optimizer.step()
        return loss.detach(), scores.detach()

    def _trained(self) -> List[torch.Tensor]:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def _global(self, loss, scores):
        """On a mesh, (this rank's term, its scores) -> (the global loss,
        every rank's scores)."""
        if self.mesh is None:
            return loss, scores
        return all_reduce_sum(loss, self.mesh), all_gather_rows(scores, self.mesh)

    def train_step(self, batch):
        """One optimizer step on a host batch (on a mesh the global batch,
        of which this rank takes its rows); returns (loss, scores) on the
        device, detached (the global batch's). The gradients stay in
        ``.grad`` until the next step."""
        loss, scores = self._step(self._to_device(self._shard(batch)))
        self.step += 1
        return loss, scores if self.mesh is None else all_gather_rows(scores, self.mesh)

    # ---- epoch loops -----------------------------------------------------

    def _batch_metrics(self, metrics: Dict[str, List[float]], prefix: str,
                       loss, scores, batch) -> None:
        if isinstance(batch, tuple):
            batch = batch[0]
        scores = scores.cpu().numpy().reshape(-1)
        if self.from_logits:
            # |x| = 30 already saturates the f32 sigmoid; clamping keeps exp
            # from overflowing
            scores = 1.0 / (1.0 + np.exp(-np.clip(scores, -30.0, 30.0)))
        labels = batch.edge_label.numpy().reshape(-1)
        mask = batch.edge_mask.numpy().reshape(-1)
        # per-edge class = class of the source node
        node_class = batch.node_class.numpy()
        src = batch.edge_src.numpy().astype(np.int64)
        edge_class = np.take_along_axis(node_class, src, axis=-1).reshape(-1)
        metrics[f"{prefix}/loss"].append(float(loss))
        metrics[f"{prefix}/avgprec"].append(average_precision_np(scores[mask], labels[mask]))
        for cname, cid in TRACKING_CLASSES.items():
            sel = mask & (edge_class == cid)
            if sel.any():
                metrics[f"{prefix}/avgprec/{cname}"].append(
                    average_precision_np(scores[sel], labels[sel])
                )

    def train_epoch(self, batcher, fused_steps: int = 1) -> Dict[str, float]:
        """One epoch. With ``fused_steps=K`` same-shape batches are grouped K
        at a time in batcher order and each group runs as K steps with one
        upload and one fetch (:meth:`_run_fused`); what is left of a shape
        at the end runs as one smaller group."""
        metrics: Dict[str, List[float]] = defaultdict(list)
        if fused_steps <= 1:
            for batch in batcher.epoch(shuffle=True):
                loss, scores = self.train_step(batch)
                self._batch_metrics(metrics, "train", loss, scores, batch)
            return _nanmean_metrics(metrics)
        previous, self._sources = self._sources, {}
        pending: Dict[tuple, list] = defaultdict(list)
        # the batcher's generator (which may run the encoders: the streaming
        # batcher) advances only here, between groups, never inside a capture
        for batch in batcher.epoch(shuffle=True):
            batch = self._shard(batch)
            key = _signature(batch)
            pending[key].append(batch)
            if len(pending[key]) == fused_steps:
                self._run_fused(metrics, pending.pop(key), fused_steps, previous)
        for group in pending.values():
            self._run_fused(metrics, group, fused_steps, previous)
        return _nanmean_metrics(metrics)

    def _run_fused(self, metrics, group, fused_steps: int, previous=None) -> None:
        """The steps of a group of same-shape host batches: stacked into one
        [n * B, ...] source (on the card one upload into this shape's
        staging buffers, which keep their captured step; ``previous``
        holds the last call's sources) and run as n steps gathered by
        index, ending in one fetch of their losses and APs."""
        stacked = _map_batches(lambda *ts: torch.cat(ts), *group)
        width = _tensors(group[0])[0].shape[0]
        rows = width * len(group)
        if self.device.type == "cuda":
            def staging():
                return _Resident(*_graph_enc(_map_batches(
                    lambda t: t.new_zeros((fused_steps * width, *t.shape[1:]), device=self.device),
                    stacked)), fused_steps * width)

            res = self._source((fused_steps, _signature(group[0])), previous or {}, staging)
            staged = res.graphs if res.enc is None else (res.graphs, res.enc)
            _map_batches(lambda dst, src: dst[:rows].copy_(src.pin_memory(), non_blocking=True),
                         staged, stacked)
        else:
            res = _Resident(*_graph_enc(stacked), rows)
        idx = self._upload_rows(index_rows(np.arange(rows), rows, width))
        self._accumulate_device_metrics(metrics, "train", self._run_steps(res, idx, train=True))

    def eval_epoch(self, batcher) -> Dict[str, float]:
        metrics: Dict[str, List[float]] = defaultdict(list)
        with torch.no_grad():
            for batch in batcher.epoch(shuffle=False):
                loss, scores = self._global(*self._loss(self._to_device(self._shard(batch))))
                self._batch_metrics(metrics, "val", loss, scores, batch)
        return _nanmean_metrics(metrics)

    def fit(self, train_batcher, val_batcher=None, epochs: Optional[int] = None,
            log_dir: Optional[str] = None, version: str = "synthetic",
            verbose: bool = True, fused_steps: int = 1, writer=None) -> List[Dict[str, float]]:
        """``epochs`` (default ``cfg.num_epochs``) of training, each followed
        by validation when a ``val_batcher`` is given, a checkpoint under
        ``log_dir`` when one is given and one record of the epoch's metrics
        through ``writer`` (``utils.metric_logging.MetricWriter``) when one
        is given; ``fused_steps`` as in :meth:`train_epoch`."""
        history: List[Dict[str, float]] = []
        for epoch in range(self.cfg.num_epochs if epochs is None else epochs):
            t0 = time.time()
            m = self.train_epoch(train_batcher, fused_steps=fused_steps)
            self._finish_epoch(epoch, m, t0, history, val_batcher=val_batcher,
                               log_dir=log_dir, version=version, verbose=verbose,
                               writer=writer)
        return history

    def _finish_epoch(self, epoch, m, t0, history, *, val_batcher=None,
                      log_dir=None, version="synthetic", verbose=True, writer=None):
        """Shared epoch tail: val metrics, logging, checkpointing (rank 0
        alone on a mesh)."""
        if val_batcher is not None:
            m.update(self.eval_epoch(val_batcher))
        m["epoch_time_s"] = time.time() - t0
        history.append(m)
        if self.mesh is not None and self.mesh.rank != 0:
            return
        if writer is not None:
            writer.log(epoch, m)
        if verbose:
            val_ap = m.get("val/avgprec", float("nan"))
            print(
                f"epoch {epoch}: loss={m['train/loss']:.4f} "
                f"AP={m['train/avgprec']:.4f} valAP={val_ap:.4f} "
                f"({m['epoch_time_s']:.1f}s)"
            )
        if log_dir is not None:
            path = epoch_checkpoint_name(
                log_dir, "gnn", epoch, version,
                m.get("train/avgprec", float("nan")),
                m.get("val/avgprec", float("nan")),
            )
            save_checkpoint(path, self._cpu_state(), metadata=dict(m))

    # ---- device-resident steps -------------------------------------------

    @staticmethod
    def _gather_device_batch(graphs, enc, ib):
        """The batch at index row ``ib`` of a device-resident group (or of a
        stacked group on the host); the dedup form gathers its batch's table
        rows through ``det_index``."""
        batch = _map_batches(lambda a: a.index_select(0, ib), graphs)
        if enc is None:
            return batch
        if isinstance(enc, DedupEncodings):
            return batch, _table_rows(enc.table, enc.det_index.index_select(0, ib))
        return batch, tuple(a.index_select(0, ib) for a in enc)

    def _fetch_device_batch(self, res, ib):
        """This rank's rows of the batch at the global index row ``ib`` of
        a group split over the mesh (``res.rows``): one fetch of every
        windowed array, then the dedup table's rows, gathered locally."""
        parts = res.rows.fetch(ib, self.mesh)
        n = len(_GRAPH_FIELDS)
        batch = PaddedGraph(**dict(zip(_GRAPH_FIELDS, parts[:n])))
        if isinstance(res.enc, DedupEncodings):
            return batch, _table_rows(res.enc.table, parts[n])
        return (batch, tuple(parts[n:])) if len(parts) > n else batch

    def _device_batch_metrics(self, scores, batch):
        """``_batch_metrics`` on the device: the overall and per-class
        tie-corrected APs of the batch's masked edges from one shared sort
        (``average_precision_multi``). Returns (AP, per-class APs [C],
        per-class presence [C] bool). No sigmoid: it is monotone, so the
        ranking, tie groups included, and hence the AP are the same."""
        graph = batch[0] if isinstance(batch, tuple) else batch
        y = graph.edge_label.to(scores.dtype)
        mask = graph.edge_mask
        # per-edge class = class of the source node (as _batch_metrics)
        edge_class = torch.gather(graph.node_class, -1, graph.edge_src.long())
        if self.mesh is not None:
            # the global batch's: every rank's rows, in one gather (classes
            # and labels are small integers, exact in float32)
            rows = all_gather_rows(torch.stack(
                [scores, y, mask.to(scores.dtype), edge_class.to(scores.dtype)], dim=1), self.mesh)
            scores, y, mask = rows[:, 0], rows[:, 1], rows[:, 2] != 0
            edge_class = rows[:, 3].to(edge_class.dtype)
        s, y, mask, edge_class = scores.reshape(-1), y.reshape(-1), mask.reshape(-1), \
            edge_class.reshape(-1)
        sel = mask[None, :] & (edge_class[None, :] == self._class_ids[:, None])  # [C, n]
        aps = average_precision_multi(s, y, torch.cat([mask[None, :], sel]))
        return aps[0], aps[1:], sel.any(dim=1)

    def _accumulate_device_metrics(self, metrics, prefix, rows) -> None:
        """Fold a group's fetched [n_steps, 2 + 2C] rows (loss, AP, per-class
        APs, per-class presence) into ``metrics`` with ``_batch_metrics``'
        keys: a class counts only in the steps where it has masked edges."""
        c = len(TRACKING_CLASSES)
        for row in rows:
            metrics[f"{prefix}/loss"].append(float(row[0]))
            metrics[f"{prefix}/avgprec"].append(float(row[1]))
            for i, cname in enumerate(TRACKING_CLASSES):
                if row[2 + c + i]:
                    metrics[f"{prefix}/avgprec/{cname}"].append(float(row[2 + i]))

    def _device_step(self, res, ib, train: bool):
        """One step on the batch of ``res`` at index row ``ib`` (an update
        when ``train``, else a forward), with its metrics as one [2 + 2C]
        row."""
        batch = (self._fetch_device_batch(res, ib) if res.rows is not None
                 else self._gather_device_batch(res.graphs, res.enc, ib))
        if train:
            loss, scores = self._step(batch)
        else:
            with torch.no_grad():
                loss, scores = self._loss(batch)
                if self.mesh is not None:
                    loss = all_reduce_sum(loss, self.mesh)
        ap, ap_cls, present = self._device_batch_metrics(scores, batch)
        return torch.cat([loss.reshape(1), ap.reshape(1), ap_cls, present.to(ap_cls.dtype)])

    def _upload_rows(self, idx: np.ndarray) -> torch.Tensor:
        """Index rows on the device: one upload."""
        return upload(idx, self.device)

    def _run_steps(self, res, idx, train: bool) -> np.ndarray:
        """The steps of the index rows ``idx`` [n_steps, B] over the source
        ``res``; returns their fetched metrics rows, the group's one wait for
        the device. On the card each step is one replay of the captured
        step (captured on first use), between two copies on the device;
        under gloo, whose collectives cannot be captured, an eager step.
        While a profiler records, the enqueueing and the fetch are the
        spans ``train.steps`` and ``train.fetch``, and on the card two
        events time the steps on the device (``utils.profiling``)."""
        n = idx.shape[0]
        capture = self.device.type == "cuda" and (self.mesh is None or self.mesh.capturable)
        if self.device.type == "cuda" and not capture and not self._told_eager:
            if self.mesh.rank == 0:
                print(f"GNNTrainer: {self.mesh.backend} collectives cannot be captured in a "
                      "CUDA graph; device-resident steps run eagerly")
            self._told_eager = True
        on = profiling.tracing()
        span = profiling.annotate("train.steps", on)
        span.__enter__()
        if capture:
            step = res.steps.get(train)
            if step is None:
                step = res.steps[train] = self._capture(res, idx[0], train)
            out = torch.empty(n, step.out.numel(), device=self.device)
            start = profiling.device_event(self.device) if on else None
            for k in range(n):
                step.index.copy_(idx[k])
                step.graph.replay()
                out[k].copy_(step.out)
            profiling.add_call(start, self.device)
            self.graph_replays += n
        else:
            out = torch.stack([self._device_step(res, ib, train) for ib in idx])
        if train:
            self.step += n
        span.__exit__(None, None, None)
        with profiling.annotate("train.fetch", on):
            return out.cpu().numpy()

    def _capture(self, res, first_row, train: bool) -> "_CapturedStep":
        """One step over ``res`` captured as a CUDA graph, whose replays run
        it for the index row copied into ``.index``. Warm-up steps on a side
        stream come first; their updates (weights, Adam's moments and step
        counts) are undone, so that replays continue from the state eager
        steps would."""
        index = first_row.clone()
        saved = self._optimizer_snapshot() if train else None
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._device_step(res, index, train)
        torch.cuda.current_stream(self.device).wait_stream(side)
        if train:
            self._optimizer_restore(saved)
            self.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._device_step(res, index, train)
        self.graph_captures += 1
        return _CapturedStep(graph, index, out)

    def _optimizer_snapshot(self):
        """(parameter, its value, its Adam state) of every trained parameter."""
        return [(p, p.detach().clone(), {k: v.clone() for k, v in self.optimizer.state[p].items()})
                for group in self.optimizer.param_groups for p in group["params"]]

    @torch.no_grad()
    def _optimizer_restore(self, saved) -> None:
        """Back to a snapshot, in place (a capture reads these tensors): a
        state that was empty returns to Adam's fresh one, all zeros."""
        for p, value, state in saved:
            p.copy_(value)
            for k, v in self.optimizer.state[p].items():
                if k in state:
                    v.copy_(state[k])
                else:
                    v.zero_()

    def _source(self, key, previous, make) -> "_Resident":
        """The source of steps under ``key``: this call's, else the previous
        call's (``previous``, with its captured steps), else ``make()``."""
        res = self._sources.get(key) or previous.pop(key, None) or make()
        self._sources[key] = res
        return res

    def _upload_dataset_groups(self, groups) -> List["_Resident"]:
        """The device-resident form of each dataset group (``(graphs, enc,
        bucket)``, enc None, a tuple or :class:`DedupEncodings`), uploaded
        once; dedup groups that share a table object share its upload. A
        group passed again (the same object) keeps its upload and captured
        steps. The sources this call does not use are dropped first."""
        keep = {id(g) for g in groups}
        previous = {k: v for k, v in self._sources.items() if k in keep}
        self._sources = {}
        # the tables of the groups already up (a kept source holds its host
        # group, so its id names no other object)
        tables = {id(g[1].table): previous[id(g)].enc.table for g in groups
                  if id(g) in previous and isinstance(g[1], DedupEncodings)}
        return [self._source(id(g), previous, lambda g=g: self._upload_group(g, tables))
                for g in groups]

    def _upload_group(self, group, tables) -> "_Resident":
        """One group on the device. On a mesh its windowed arrays are split
        over the ranks (a :class:`RowTable` of this rank's windows, padded
        with copies of the empty window so that the mesh divides them; the
        index ``n_items`` stays the empty window) and a dedup table is
        replicated."""
        graphs, enc, _ = group
        dev = self.device
        n_items = graphs.pose.shape[0] - 1
        edges = dict(edge_valid=graphs.edge_mask.sum(1).numpy(),
                     edge_slots=graphs.edge_mask.shape[1])
        dedup = isinstance(enc, DedupEncodings)
        if dedup and id(enc.table) not in tables:
            tables[id(enc.table)] = tuple(t.to(dev) for t in enc.table)
        if self.mesh is not None:
            windowed = [getattr(graphs, f) for f in _GRAPH_FIELDS]
            windowed += [enc.det_index] if dedup else list(enc or ())
            rows = RowTable.split([pad_rows(a, self.mesh.size) for a in windowed],
                                  self.mesh, dev)
            enc = DedupEncodings(None, tables[id(enc.table)]) if dedup else None
            return _Resident(None, enc, n_items, source=group, rows=rows, **edges)
        if dedup:
            enc = DedupEncodings(enc.det_index.to(dev), tables[id(enc.table)])
        elif enc is not None:
            enc = tuple(t.to(dev) for t in enc)
        return _Resident(graphs.to(dev), enc, n_items, source=group, **edges)

    def fit_device(self, dataset, epochs: int = 1, val_batcher=None, val_dataset=None,
                   log_dir: Optional[str] = None, version: str = "synthetic",
                   verbose: bool = True, seed: int = 0, writer=None) -> List[Dict[str, float]]:
        """``fit`` over a device-resident dataset: one group
        (``materialize_encoded_dataset``, ``..._dedup`` or
        ``train.data.materialize_graph_dataset``) or a list of per-bucket
        groups (the plural forms), uploaded once. Every epoch runs the
        groups in an order drawn from ``default_rng(seed)`` (no draw for one
        group) and shuffles each group's windows with the same generator,
        as the JAX package draws them, so the batches are the JAX package's;
        a group's last batch is padded with its empty window (index
        n_items). A group's index rows go up once per epoch and its losses
        and APs come back once. ``val_dataset`` (the same forms) is run
        every epoch over fixed sequential rows, as ``eval_epoch`` on an
        unshuffled batcher; pass it or ``val_batcher`` (the host path), not
        both. ``writer`` as in :meth:`fit`. While a profiler records, the
        stages are spans (``train.sources``, ``train.rows``, ``train.steps``,
        ``train.fetch``, ``train.metrics``) and the training calls are
        counted (``utils.profiling.loop_stats``)."""
        if val_dataset is not None and val_batcher is not None:
            raise ValueError("fit_device: pass val_dataset or val_batcher, not both")
        groups = dataset if isinstance(dataset, list) else [dataset]
        vgroups = [] if val_dataset is None else (
            val_dataset if isinstance(val_dataset, list) else [val_dataset])
        b = self.cfg.batch_size
        with profiling.annotate("train.sources"):
            resident = self._upload_dataset_groups(groups + vgroups)
            val_idx = [self._upload_rows(index_rows(np.arange(r.n_items), r.n_items, b))
                       for r in resident[len(groups):]]
        train_res, val_res = resident[:len(groups)], resident[len(groups):]
        rng = np.random.default_rng(seed)
        history: List[Dict[str, float]] = []
        for epoch in range(epochs):
            t0 = time.time()
            fetched = []
            order = rng.permutation(len(train_res)) if len(train_res) > 1 else [0]
            for gi in order:
                res = train_res[gi]
                on = profiling.tracing()
                with profiling.annotate("train.rows", on):
                    rows = index_rows(rng.permutation(res.n_items), res.n_items, b)
                    idx = self._upload_rows(rows)
                if on:
                    profiling.count_rows(rows, res.edge_valid, res.edge_slots)
                fetched.append(("train", self._run_steps(res, idx, train=True)))
            for res, idx in zip(val_res, val_idx):
                fetched.append(("val", self._run_steps(res, idx, train=False)))
            with profiling.annotate("train.metrics"):
                metrics: Dict[str, List[float]] = defaultdict(list)
                for prefix, out in fetched:
                    self._accumulate_device_metrics(metrics, prefix, out)
                self._finish_epoch(epoch, _nanmean_metrics(metrics), t0, history,
                                   val_batcher=val_batcher, log_dir=log_dir,
                                   version=version, verbose=verbose, writer=writer)
        return history

    def _cpu_state(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().cpu() for k, v in self.model.state_dict().items()}

    # ---- full-state checkpointing (resume with optimizer moments) --------

    def save_state(self, path: str) -> str:
        """Checkpoint the model, the optimizer's moments and the step count,
        so that training resumes exactly."""
        return save_checkpoint(path, {
            "model": self._cpu_state(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
        })

    def load_state(self, path: str) -> None:
        state = load_checkpoint(path, map_location=self.device)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = state["step"]
        # the captured steps hold the optimizer state tensors just replaced
        self._sources = {}


@dataclasses.dataclass
class _Resident:
    """A source of steps on the device: graphs [rows, ...], encodings (None,
    a tuple or :class:`DedupEncodings`), the number of windows before the
    empty one, its captured steps by kind (True: training), the host
    dataset group it was uploaded from (None for staging buffers) and, for
    a group split over a mesh, this rank's windows (``rows``; then
    ``graphs`` is None and ``enc`` holds only a dedup table). A dataset
    group's ``edge_valid`` [rows] counts each window's valid edges, of its
    ``edge_slots``, for the loop's counters."""

    graphs: Optional[PaddedGraph]
    enc: object
    n_items: int
    steps: dict = dataclasses.field(default_factory=dict)
    source: object = None
    rows: Optional[RowTable] = None
    edge_valid: Optional[np.ndarray] = None
    edge_slots: int = 0


@dataclasses.dataclass
class _CapturedStep:
    graph: object  # torch.cuda.CUDAGraph
    index: torch.Tensor  # the static index row [B]
    out: torch.Tensor  # the static metrics row [2 + 2C]


def index_rows(order, n_items: int, width: int) -> np.ndarray:
    """[n_steps, width] int32 rows of the window order ``order``, the last
    one padded with the empty window ``n_items``."""
    n_steps = -(-len(order) // width)
    return np.concatenate(
        [order, np.full(n_steps * width - len(order), n_items, np.int64)]
    ).reshape(n_steps, width).astype(np.int32)


def epoch_batches(group, batch_size: int, seed: int) -> list:
    """The batches, on the host, that ``fit_device(group, seed=seed)``
    gathers in its first epoch from the one dataset group ``group``
    (graphs, encodings, bucket): the rows of a ``default_rng(seed)``
    permutation, the last batch padded with the empty window."""
    graphs, enc = group[0], group[1]
    n_items = graphs.pose.shape[0] - 1
    idx = index_rows(np.random.default_rng(seed).permutation(n_items), n_items, batch_size)
    return [GNNTrainer._gather_device_batch(graphs, enc, row) for row in torch.from_numpy(idx)]


_GRAPH_FIELDS = tuple(f.name for f in dataclasses.fields(PaddedGraph))


def _table_rows(table, rows):
    """The dedup table's rows at ``rows`` [B, mn]: (x_img, pn, rn, lp, rp)
    each [B, mn, ...]."""
    return tuple(t.index_select(0, rows.reshape(-1)).reshape(*rows.shape, *t.shape[1:])
                 for t in table)


def _tensors(batch) -> List[torch.Tensor]:
    graph, enc = batch if isinstance(batch, tuple) else (batch, ())
    return [getattr(graph, f.name) for f in dataclasses.fields(graph)] + list(enc)


def _signature(batch) -> tuple:
    """The form and every tensor's shape and dtype of a host batch."""
    return isinstance(batch, tuple), tuple((tuple(t.shape), t.dtype) for t in _tensors(batch))


def _graph_enc(batch):
    return batch if isinstance(batch, tuple) else (batch, None)


def _map_batches(fn, *batches):
    """``fn`` over the corresponding tensors of batches of one form (a
    PaddedGraph, or (PaddedGraph, tuple of tensors)), in the same form."""
    if isinstance(batches[0], tuple):
        return (_map_batches(fn, *(b[0] for b in batches)),
                tuple(fn(*ts) for ts in zip(*(b[1] for b in batches))))
    return PaddedGraph(**{f.name: fn(*(getattr(b, f.name) for b in batches))
                          for f in dataclasses.fields(PaddedGraph)})


def _nanmean_metrics(metrics: Dict[str, List[float]]) -> Dict[str, float]:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN class APs
        return {k: float(np.nanmean(v)) for k, v in metrics.items()}


def average_precision_np(scores: np.ndarray, labels: np.ndarray) -> float:
    """Host-side binary AP: the sum over score thresholds of
    ``(recall_n - recall_{n-1}) * precision_n``; tied scores form ONE
    threshold (every member of a tie group shares the precision at the
    group's end), as the reference's torchmetrics AP and sklearn."""
    if len(scores) == 0 or labels.sum() == 0:
        return float("nan")
    order = np.argsort(-scores, kind="stable")
    s = scores[order]
    y = labels[order]
    n = len(y)
    tp = np.cumsum(y)
    is_last = np.empty(n, bool)
    is_last[-1] = True
    is_last[:-1] = s[1:] != s[:-1]
    end = np.where(is_last, np.arange(n), n)
    end = np.minimum.accumulate(end[::-1])[::-1]
    precision_at_end = tp[end] / (end + 1)
    return float((precision_at_end * y).sum() / tp[-1])
