"""Tracker-GNN trainer (counterpart of ``batch3dmot_tpu/train/trainer.py``,
its host-batched path).

  * optimizer: ``torch.optim.Adam(lr, betas, eps=1e-8, weight_decay)``, the
    reference's optimizer: the decay is added to the gradient before the
    moments (not AdamW), as the JAX package's ``torch_style_adam``;
  * frozen encoders (``resnet``, ``pointnet``, ``radarnet``) get no update
    at all: they leave the optimizer and need no gradient, so weight decay
    cannot shrink them; their batch-norm statistics are the running ones;
  * loss: (class-balanced unless ``cfg.loss == 'bce'``) BCE over the real
    edges divided by the window batch size, as the reference divides its
    mean BCE by ``gnn.batch_size``;
  * scores: the fused message-passing kernels and their hand-written
    backward on the GPU, autograd through their plain version on the CPU
    (``ops/fused_mp_train.py``); a model in ``knn_conv_mode='active'``
    runs its module loop under autograd instead (the kNN GATConv has no
    fused kernel; its segment sums and the message passing's go through
    the segment-sum kernel on the GPU), as the JAX trainer does;
  * metrics: per-batch loss, overall and per-class edge AP on the host,
    nanmean-aggregated per epoch; checkpoints per epoch with AP-stamped
    names.

Window batches come from :class:`batch3dmot_tpu_torch.train.data.GraphBatcher`
(PaddedGraph) or :class:`~batch3dmot_tpu_torch.train.encoded.EncodedGraphBatcher`
((PaddedGraph, encodings)).
"""

from __future__ import annotations

import time
import warnings
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from batch3dmot_tpu_torch import prepare_model
from batch3dmot_tpu_torch.config import TRACKING_CLASSES, GNNConfig
from batch3dmot_tpu_torch.models.gnn import PoseGNN
from batch3dmot_tpu_torch.models.layers import init_params_
from batch3dmot_tpu_torch.ops.fused_mp_train import fused_training_scores
from batch3dmot_tpu_torch.train.metrics import masked_bce
from batch3dmot_tpu_torch.utils.checkpoint import (
    epoch_checkpoint_name,
    load_checkpoint,
    save_checkpoint,
)

FROZEN_ENCODERS = ("resnet", "pointnet", "radarnet")


class GNNTrainer:
    """Trains a ``MultimodalGNN`` or ``PoseGNN`` on window batches.

    ``device`` None means the GPU (which must exist); pass ``"cpu"`` to run
    on the CPU. The weights come from ``init_state_dict`` when given, else
    from ``seed`` (default ``cfg.manual_seed``) through ``init_params_``."""

    def __init__(
        self,
        model: torch.nn.Module,
        cfg: Optional[GNNConfig] = None,
        device=None,
        seed: Optional[int] = None,
        init_state_dict: Optional[Dict[str, torch.Tensor]] = None,
    ):
        self.cfg = cfg or GNNConfig()
        self.model, self.device = prepare_model(model, device)
        if init_state_dict is None:
            seed = self.cfg.manual_seed if seed is None else seed
            init_params_(self.model, torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(init_state_dict)
        # PoseGNN emits logits (no sigmoid head); MultimodalGNN emits scores
        self.from_logits = isinstance(self.model, PoseGNN)
        for name in FROZEN_ENCODERS:
            if hasattr(self.model, name):
                getattr(self.model, name).requires_grad_(False)
        self.optimizer = torch.optim.Adam(
            [p for p in self.model.parameters() if p.requires_grad],
            lr=float(self.cfg.lr),
            betas=(self.cfg.beta_lo, self.cfg.beta_hi),
            eps=1e-8,
            weight_decay=float(self.cfg.weight_decay),
        )
        self.step = 0

    # ---- core steps ------------------------------------------------------

    def _to_device(self, batch):
        if isinstance(batch, tuple):
            graph, enc = batch
            return graph.to(self.device), tuple(t.to(self.device) for t in enc)
        return batch.to(self.device)

    def _loss(self, batch):
        """(loss, scores [B, E]) of a batch on the device: a PaddedGraph, or
        (PaddedGraph, encodings) from EncodedGraphBatcher."""
        graph, enc = batch if isinstance(batch, tuple) else (batch, None)
        if self.model.knn_conv_mode == "active":
            scores = self._module_scores(graph, enc)
        else:
            scores = fused_training_scores(self.model, graph, enc)
        weights = (
            graph.edge_weight if self.cfg.loss == "cb"
            else torch.ones_like(graph.edge_weight)
        )
        bce = masked_bce(
            scores.reshape(-1),
            graph.edge_label.reshape(-1),
            graph.edge_mask.reshape(-1),
            weights.reshape(-1),
            from_logits=self.from_logits,
        )
        return bce / self.cfg.batch_size, scores

    def _module_scores(self, graph, enc):
        """Scores [B, E] of the module loop (LOGITS for PoseGNN); the frozen
        encoders run without a graph when no encodings are given."""
        if enc is None or self.from_logits:
            return self.model(graph)[0]
        return self.model.forward_from_encodings(graph, *enc)[0]

    def train_step(self, batch):
        """One optimizer step on a host batch; returns (loss, scores) on the
        device, detached. The gradients stay in ``.grad`` until the next
        step."""
        dev = self._to_device(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss, scores = self._loss(dev)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return loss.detach(), scores.detach()

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

    def train_epoch(self, batcher) -> Dict[str, float]:
        metrics: Dict[str, List[float]] = defaultdict(list)
        for batch in batcher.epoch(shuffle=True):
            loss, scores = self.train_step(batch)
            self._batch_metrics(metrics, "train", loss, scores, batch)
        return _nanmean_metrics(metrics)

    def eval_epoch(self, batcher) -> Dict[str, float]:
        metrics: Dict[str, List[float]] = defaultdict(list)
        with torch.no_grad():
            for batch in batcher.epoch(shuffle=False):
                loss, scores = self._loss(self._to_device(batch))
                self._batch_metrics(metrics, "val", loss, scores, batch)
        return _nanmean_metrics(metrics)

    def fit(self, train_batcher, val_batcher=None, epochs: Optional[int] = None,
            log_dir: Optional[str] = None, version: str = "synthetic",
            verbose: bool = True) -> List[Dict[str, float]]:
        """``epochs`` (default ``cfg.num_epochs``) of training, each followed
        by validation when a ``val_batcher`` is given and a checkpoint under
        ``log_dir`` when one is given."""
        history: List[Dict[str, float]] = []
        for epoch in range(self.cfg.num_epochs if epochs is None else epochs):
            t0 = time.time()
            m = self.train_epoch(train_batcher)
            self._finish_epoch(epoch, m, t0, history, val_batcher=val_batcher,
                               log_dir=log_dir, version=version, verbose=verbose)
        return history

    def _finish_epoch(self, epoch, m, t0, history, *, val_batcher=None,
                      log_dir=None, version="synthetic", verbose=True):
        """Shared epoch tail: val metrics, logging, checkpointing."""
        if val_batcher is not None:
            m.update(self.eval_epoch(val_batcher))
        m["epoch_time_s"] = time.time() - t0
        history.append(m)
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
