"""Encoder trainers: ResNet-AE (MSE reconstruction), PointNet and RadarNet
(NLL classification) (counterpart of ``batch3dmot_tpu/train/encoders.py``,
on one device).

  * losses: the mean squared reconstruction error for the autoencoder; the
    mean NLL of the log-softmax for the classifiers, plus 0.001 x the
    feature-transform orthogonality regularizer when the PointNet has
    ``fstn``; accuracy beside it;
  * optimizer: ``torch.optim.Adam`` (eps 1e-8) with coupled weight decay
    (the decay added to the gradient before the moments, as optax's
    ``add_decayed_weights`` before ``scale_by_adam``) and StepLR: before
    every step the learning rate is set to ``lr * gamma ** (step //
    (steps_per_epoch * scheduler_step_size))``, ``step`` counting the
    optimizer's steps from 0 as optax's schedule does; the fused
    implementation on the card;
  * batch norm in training mode updates the running statistics with the
    biased batch variance (``models/layers.py::batch_norm``); dropout and
    the data transforms draw from the trainer's ``torch.Generator`` on its
    device;
  * ``fit`` steps over host batches, ``fit_device`` over a dataset uploaded
    once, gathered by index on the device and transformed there (the host
    loaders' per-epoch randomness: the LiDAR yaw augmentation, the fixed-size
    subsample); both keep every loss and metric on the device until the
    epoch ends and fetch them once; per-epoch checkpoints
    ``{prefix}_epoch{e}_loss{loss:.6f}.pt`` hold the model's state dict;
  * ``mesh=`` (``parallel.make_mesh``) trains data-parallel, one process per
    rank, with the math of one process on the global batch: each rank
    takes its rows of every batch (``fit_device``: each rank holds its
    share of the dataset's items, padded with the last item, and fetches a
    batch's rows from the others), the losses and metrics are global means
    (``parallel.mesh.batch_mean``), batch norm normalises with the global
    batch's statistics, every random draw takes the global tensor and keeps
    this rank's rows, and one all-reduce per step sums the gradients and
    the step's numbers. Rank 0 alone writes checkpoints and logs.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from batch3dmot_tpu_torch import prepare_model, upload
from batch3dmot_tpu_torch.config import EncoderTrainConfig
from batch3dmot_tpu_torch.models.encoders import (
    PointNetClassifier,
    RadarNetClassifier,
    ResNetAE,
    feature_transform_regularizer,
    image_input_f32,
)
from batch3dmot_tpu_torch.models.layers import init_params_
from batch3dmot_tpu_torch.parallel.mesh import (
    RowTable,
    all_reduce_grads,
    all_reduce_sum,
    batch_mean,
    data_parallel,
    pad_rows,
    rand_rows,
    replicate,
    shard_batch_fn,
)
from batch3dmot_tpu_torch.utils.checkpoint import save_checkpoint
from batch3dmot_tpu_torch.utils.weights import encoder_variables, load_encoder_variables

# the feature-transform regularizer's weight in the PointNet loss
REG_WEIGHT = 0.001


def steplr(cfg: EncoderTrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """Learning rate of optimizer step ``step`` (from 0): ``cfg.lr`` times
    ``scheduler_gamma`` every ``scheduler_step_size`` epochs (torch's
    StepLR, optax's staircase ``exponential_decay``)."""
    period = max(1, steps_per_epoch * cfg.scheduler_step_size)
    return lambda step: float(cfg.lr) * cfg.scheduler_gamma ** (step // period)


def steplr_adam(cfg: EncoderTrainConfig, params, device: torch.device) -> torch.optim.Adam:
    """Adam with coupled weight decay; the learning rate is set per step
    from :func:`steplr`. Fused on the card."""
    return torch.optim.Adam(
        params, lr=float(cfg.lr), betas=(cfg.beta_lo, cfg.beta_hi), eps=1e-8,
        weight_decay=float(cfg.weight_decay),
        **(dict(fused=True) if device.type == "cuda" else {}),
    )


def _as_tuple(batch):
    return tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)


class EncoderTrainer:
    """Trains one encoder; ``loss_fn(model, batch, train, generator) ->
    (loss, metrics)`` defines the family.

    ``device`` None means the GPU (which must exist); pass ``"cpu"`` to run
    on the CPU. The weights come from ``init_variables`` (a JAX encoder
    tree, ``{"params", "batch_stats"}`` with numpy leaves, as the JAX
    trainer's ``variables``) when given, else from ``cfg.manual_seed +
    seed`` through ``init_params_``; the trainer's generator (for
    dropout and the transforms) starts from the same seed. With ``mesh``
    the device is the mesh's, the batch size must divide by its size and
    rank 0's weights are broadcast."""

    def __init__(
        self,
        model: torch.nn.Module,
        loss_fn: Callable,
        cfg: Optional[EncoderTrainConfig] = None,
        steps_per_epoch: int = 100,
        seed: int = 0,
        device=None,
        init_variables: Optional[Dict[str, Any]] = None,
        mesh=None,
    ):
        self.cfg = cfg or EncoderTrainConfig()
        self.loss_fn = loss_fn
        self.mesh = mesh
        if mesh is not None:
            if self.cfg.batch_size % mesh.size:
                raise ValueError(f"batch size {self.cfg.batch_size} does not divide by the "
                                 f"mesh size {mesh.size}")
            device = mesh.device if device is None else device
        self.model, self.device = prepare_model(model, device)
        seed = self.cfg.manual_seed + seed
        if init_variables is None:
            init_params_(self.model, torch.Generator().manual_seed(seed))
        else:
            load_encoder_variables(self.model, init_variables)
        self.lr_at = steplr(self.cfg, steps_per_epoch)
        self.optimizer = steplr_adam(self.cfg, self.model.parameters(), self.device)
        if mesh is not None:
            replicate(self.model, mesh)
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._shard = shard_batch_fn(mesh) if mesh is not None else (lambda batch: batch)

    # ---- core steps ------------------------------------------------------

    def _to_device(self, batch):
        return tuple(upload(np.ascontiguousarray(a), self.device) if isinstance(a, np.ndarray)
                     else a.to(self.device, non_blocking=True) for a in _as_tuple(batch))

    def _train_step(self, batch):
        """One optimizer step on a batch on the device: (loss, metrics),
        detached, on the device."""
        lr = self.lr_at(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        with data_parallel(self.mesh):
            loss, aux = self.loss_fn(self.model, batch, True, self.generator)
        loss.backward()
        if self.mesh is not None:
            # this rank's terms of the global means -> their sums
            loss, aux = self._unstack(aux, all_reduce_grads(
                self.model.parameters(), self.mesh, self._stack(loss, aux)))
        self.optimizer.step()
        self.step += 1
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    @staticmethod
    def _stack(loss, aux) -> torch.Tensor:
        return torch.stack([loss.detach(), *(v.detach().float() for v in aux.values())])

    @staticmethod
    def _unstack(aux, row):
        return row[0], dict(zip(aux, row[1:]))

    @torch.no_grad()
    def _eval(self, batch):
        """(loss, metrics) with the running statistics, no update."""
        with data_parallel(self.mesh):
            loss, aux = self.loss_fn(self.model, batch, False, None)
        if self.mesh is not None:
            loss, aux = self._unstack(aux, all_reduce_sum(self._stack(loss, aux), self.mesh))
        return loss, aux

    def train_step(self, batch):
        """One optimizer step on a host batch (numpy arrays or tensors; on a
        mesh the global batch, of which this rank takes its rows); returns
        (loss, metrics) on the device."""
        return self._train_step(self._to_device(self._shard(batch)))

    # ---- epochs ------------------------------------------------------------

    @staticmethod
    def _epoch_metrics(parts) -> Dict[str, float]:
        """Per-epoch means of (prefix, [(loss, metrics), ...]) parts, from
        one fetch of every number."""
        rows = [torch.stack([loss, *aux.values()]) for _, steps in parts for loss, aux in steps]
        table = torch.stack(rows).cpu().numpy() if rows else np.zeros((0, 0), np.float32)
        m: Dict[str, float] = {}
        lo = 0
        for prefix, steps in parts:
            if not steps:
                continue
            block = table[lo: lo + len(steps)]
            lo += len(steps)
            for j, k in enumerate(("loss", *steps[0][1])):
                m[f"{prefix}/{k}"] = float(np.mean(np.ascontiguousarray(block[:, j])))
        return m

    def fit(
        self,
        train_batches: Callable[[], Iterable],
        val_batches: Optional[Callable[[], Iterable]] = None,
        epochs: int = 1,
        log_dir: Optional[str] = None,
        prefix: str = "encoder",
        verbose: bool = True,
        writer=None,
    ) -> List[Dict[str, float]]:
        """Epochs over host batches (``train_batches()`` gives an epoch's
        iterable of ``(inputs, labels)`` tuples of numpy arrays or tensors,
        or image arrays for the autoencoder); losses and metrics are
        fetched once per epoch."""
        history: List[Dict[str, float]] = []
        for epoch in range(epochs):
            t0 = time.time()
            train = [self.train_step(b) for b in train_batches()]
            if not train:
                raise RuntimeError(
                    "encoder training epoch produced no batches — too few "
                    "annotations survive the min-points/ego-radius filters "
                    "for this batch size"
                )
            val = ([self._eval(self._to_device(self._shard(b))) for b in val_batches()]
                   if val_batches is not None else [])
            m = self._epoch_metrics([("train", train), ("val", val)])
            self._epoch_tail(epoch, m, t0, history, log_dir, prefix, verbose, writer)
        return history

    def _epoch_tail(self, epoch, m, t0, history, log_dir, prefix, verbose, writer):
        """Timing, logging and the epoch's checkpoint (rank 0 alone on a
        mesh)."""
        m["epoch_time_s"] = time.time() - t0
        history.append(m)
        if self.mesh is not None and self.mesh.rank != 0:
            return
        if writer is not None:
            writer.log(epoch, m)
        if verbose:
            print(f"{prefix} epoch {epoch}: {m}")
        if log_dir:
            save_checkpoint(
                f"{log_dir}/{prefix}_epoch{epoch}_loss{m['train/loss']:.6f}.pt",
                {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
                metadata=m,
            )

    def _upload_dataset(self, dataset):
        """(the dataset's arrays on the device, item count); on a mesh this
        rank's share of the items (padded with copies of the last one so
        that the mesh divides them, never gathered) as a :class:`RowTable`."""
        arrays = tuple(np.ascontiguousarray(a) for a in _as_tuple(dataset))
        n_items = int(arrays[0].shape[0])
        if self.mesh is None:
            return tuple(upload(a, self.device) for a in arrays), n_items
        return RowTable.split([pad_rows(torch.from_numpy(a), self.mesh.size) for a in arrays],
                              self.mesh, self.device), n_items

    def fit_device(
        self,
        dataset,
        transform: Optional[Callable] = None,
        val_dataset=None,
        epochs: int = 1,
        log_dir: Optional[str] = None,
        prefix: str = "encoder",
        verbose: bool = True,
        writer=None,
        seed: int = 0,
    ) -> List[Dict[str, float]]:
        """``fit`` over a dataset on the device: the stacked item arrays
        (numpy, leading dim N; from ``data/preprocess.materialize_*``)
        upload once. Each epoch's order is ``np.random.default_rng(seed)``'s
        permutation, as the JAX trainer draws it; the remainder is dropped.
        Every step gathers its batch by index on the device and runs
        ``transform(generator, batch, train)`` there (``image_transform``,
        ``lidar_transform``, ``radar_transform``). Validation takes the
        validation set's rows in order, in full batches, with a generator
        seeded ``seed * 100003 + epoch``. After the upload only the
        epoch's index rows cross to the card, and the host waits for the
        card once per epoch, to fetch the metrics. On a mesh each rank
        holds its share of the items and every step fetches its rows of
        the batch from the ranks that hold them."""
        transform = transform or (lambda gen, batch, train: batch)
        bsz = self.cfg.batch_size
        data, n_items = self._upload_dataset(dataset)
        if n_items < bsz:
            raise RuntimeError(f"fit_device: {n_items} items < batch_size {bsz}")
        val = None
        if val_dataset is not None:
            vdata, vn = self._upload_dataset(val_dataset)
            if vn >= bsz:
                val = (vdata, torch.arange((vn // bsz) * bsz, device=self.device).reshape(-1, bsz))
        rng = np.random.default_rng(seed)

        def gather(arrays, rows):
            batch = (tuple(arrays.fetch(rows, self.mesh)) if self.mesh is not None
                     else tuple(a[rows] for a in arrays))
            return batch if isinstance(dataset, (tuple, list)) else batch[0]

        def transformed(gen, batch, train):
            with data_parallel(self.mesh):
                return transform(gen, batch, train)

        history: List[Dict[str, float]] = []
        for epoch in range(epochs):
            t0 = time.time()
            order = rng.permutation(n_items)[: (n_items // bsz) * bsz]
            idx = upload(order.reshape(-1, bsz).astype(np.int64), self.device)
            train = [self._train_step(transformed(self.generator, gather(data, idx[i]), True))
                     for i in range(idx.shape[0])]
            evals = []
            if val is not None:
                vdata, vidx = val
                gen = torch.Generator(device=self.device).manual_seed(seed * 100003 + epoch)
                evals = [self._eval(transformed(gen, gather(vdata, vidx[i]), False))
                         for i in range(vidx.shape[0])]
            m = self._epoch_metrics([("train", train), ("val", evals)])
            self._epoch_tail(epoch, m, t0, history, log_dir, prefix, verbose, writer)
        return history

    @property
    def variables(self) -> Dict[str, Any]:
        """The model's ``{"params", "batch_stats"}`` in the JAX layout
        (numpy), as the JAX trainer's ``variables``."""
        return encoder_variables(self.model)


# ---------------------------------------------------------------------------
# Loss functions per encoder family: (model, batch, train, generator) ->
# (loss, metrics)
# ---------------------------------------------------------------------------


def resnet_ae_loss(model: ResNetAE, batch, train: bool, generator=None):
    """Mean squared reconstruction error over every pixel and channel (the
    JAX package computes this mean; its docstring and the upstream call it
    MSE / batch_size). uint8 crops are divided by 255 for the target as for
    the input."""
    imgs = _as_tuple(batch)[0]
    loss = batch_mean((model(imgs, train) - image_input_f32(imgs)) ** 2)
    return loss, {"mse": loss}


def _classifier_loss(model, batch, train, generator, feature_transform):
    points, labels = batch
    result = model(points, train, generator)
    logp, trans_feat = (result[0], result[2]) if isinstance(result, tuple) else (result, None)
    labels = labels.long()
    nll = -batch_mean(torch.gather(logp, 1, labels[:, None]))
    loss = nll
    if feature_transform and trans_feat is not None:
        loss = loss + REG_WEIGHT * feature_transform_regularizer(trans_feat)
    acc = batch_mean((torch.argmax(logp, dim=1) == labels).float())
    return loss, {"nll": nll, "accuracy": acc}


def pointnet_loss(model: PointNetClassifier, batch, train: bool, generator=None):
    """NLL plus, when the model has the feature transform, the T-Net
    orthogonality regularizer."""
    return _classifier_loss(model, batch, train, generator, model.feature_transform)


def radarnet_loss(model: RadarNetClassifier, batch, train: bool, generator=None):
    return _classifier_loss(model, batch, train, generator, False)


# convenience constructors ---------------------------------------------------


def make_resnet_trainer(cfg=None, **kw) -> EncoderTrainer:
    return EncoderTrainer(ResNetAE(), resnet_ae_loss, cfg, **kw)


def make_pointnet_trainer(cfg=None, num_classes: int = 7, **kw) -> EncoderTrainer:
    """A PointNet trainer. As in the JAX package, ``cfg.feature_transform``
    (``PointNetConfig``) is not passed to the model: the classifier is built
    without ``fstn`` whatever the config says."""
    return EncoderTrainer(PointNetClassifier(num_classes), pointnet_loss, cfg, **kw)


def make_radarnet_trainer(cfg=None, num_classes: int = 7, **kw) -> EncoderTrainer:
    return EncoderTrainer(RadarNetClassifier(num_classes), radarnet_loss, cfg, **kw)


# ---------------------------------------------------------------------------
# Device transforms of device-resident training: the host loaders'
# per-epoch randomness as batched tensor ops on the padded dataset rows
# (no boolean indexing, no nonzero: nothing makes the host wait)
# ---------------------------------------------------------------------------


def _collate(gen: torch.Generator, pts: torch.Tensor, counts: torch.Tensor,
             num_points: int) -> torch.Tensor:
    """[B, C, K] padded clouds -> [B, C, num_points]: a random subsample
    without replacement of a cloud longer than num_points, zeros beyond
    ``count`` for a shorter one (``data/modality.collate_fixed_size`` on the
    device): uniform keys [B, K], the invalid columns' set to +inf, a stable
    argsort, the first num_points columns. The point order is random where
    the host keeps it; the encoders are invariant to it."""
    b, c, k = pts.shape
    if k < num_points:
        raise ValueError(f"padded width {k} < num_points {num_points}")
    cols = torch.arange(k, device=pts.device)
    keys = rand_rows((b, k), gen, pts.device)
    keys = torch.where(cols < counts[:, None], keys, math.inf)
    order = torch.argsort(keys, dim=1, stable=True)[:, :num_points]
    out = torch.gather(pts, 2, order[:, None, :].expand(b, c, num_points))
    valid = torch.arange(num_points, device=pts.device) < counts.clamp(max=num_points)[:, None]
    return torch.where(valid[:, None, :], out, 0.0)


def _reference_normalize(pc: torch.Tensor) -> torch.Tensor:
    """``data/modality.reference_normalize`` per cloud of [B, C, K] (the
    per-point channel mean, the max over channels of the norm across
    points). Zero (padded) columns stay zero."""
    x = pc - pc.mean(dim=1, keepdim=True)
    dist = torch.sqrt((x * x).sum(dim=2)).amax(dim=1)[:, None, None]
    return torch.where(dist > 0, x / dist, x)


def draw_yaw(gen: torch.Generator, b: int, max_yaw: float, device) -> torch.Tensor:
    """The LiDAR augmentation's yaw per cloud, uniform in [-max_yaw,
    max_yaw): the first draw of ``lidar_transform`` in training."""
    return rand_rows((b,), gen, device) * (2.0 * max_yaw) - max_yaw


def _rotate_about_centroid(clouds: torch.Tensor, counts: torch.Tensor,
                           yaw: torch.Tensor) -> torch.Tensor:
    """Rotate each cloud's xyz [B, 0:3, K] by its yaw about the centroid of
    its valid columns; padded columns stay zero (they would otherwise take
    the centroid's offset into the channel-mixing normalisation)."""
    valid = (torch.arange(clouds.shape[2], device=clouds.device) < counts[:, None])[:, None, :]
    xyz = clouds[:, 0:3]
    centroid = (torch.where(valid, xyz, 0.0).sum(dim=2, keepdim=True)
                / counts.clamp(min=1)[:, None, None])
    rel = xyz - centroid
    c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
    rot = torch.stack([c * rel[:, 0] - s * rel[:, 1], s * rel[:, 0] + c * rel[:, 1],
                       rel[:, 2]], dim=1) + centroid
    return torch.cat([torch.where(valid, rot, 0.0), clouds[:, 3:]], dim=1)


def image_transform(res_size: int = 32):
    """uint8 [B, R, R, 3] -> float32 / 255 (bit-identical to the host
    loader's conversion, ``data/preprocess.image_batches``)."""

    def f(gen, batch, train):
        if isinstance(batch, tuple):
            return (batch[0].float() / 255.0, *batch[1:])
        return batch.float() / 255.0

    return f


def lidar_transform(num_points: int = 128, max_yaw: float = np.pi / 10):
    """The device twin of ``data/preprocess.lidar_batches`` over
    (clouds [B, C, Kcap], counts [B], labels [B]): in training a random yaw
    about the xyz centroid, then the all-channel normalisation and the
    fixed-size collate of the first 3 channels -> ([B, num_points, 3],
    labels)."""

    def f(gen, batch, train):
        clouds, counts, labels = batch
        if train:
            yaw = draw_yaw(gen, clouds.shape[0], max_yaw, clouds.device)
            clouds = _rotate_about_centroid(clouds, counts, yaw)
        pc = _reference_normalize(clouds)
        return _collate(gen, pc[:, 0:3], counts, num_points).transpose(1, 2), labels

    return f


def radar_transform(num_points: int = 64):
    """The device twin of ``data/preprocess.radar_batches``: the dataset is
    normalised already (``materialize_radar_dataset``), so only the
    fixed-size collate runs -> ([B, num_points, 4], labels)."""

    def f(gen, batch, train):
        vecs, counts, labels = batch
        return _collate(gen, vecs, counts, num_points).transpose(1, 2), labels

    return f
