"""Data-parallel process groups and the collectives their callers share
(counterpart of ``batch3dmot_tpu/parallel/mesh.py``).

One process per rank. Parameters are replicated (broadcast from rank 0),
batches are split along their leading axis, and collectives keep the math
of one process on the global batch: the JAX mesh gets that from XLA's
global arrays, here each caller asks for it.

  * a loss over the global batch is a sum of per-rank terms, each rank's
    local sum over the GLOBAL count, so the summed gradients are the global
    batch's (averaging per-rank means is wrong whenever ranks hold
    different numbers of valid items, as dividing by the world size is);
  * :func:`all_reduce_grads` sums every gradient (and the step's reported
    numbers) in one flat all-reduce;
  * batch norm in training mode normalises with the global batch's
    statistics (``models/layers.py::batch_norm``), and random draws
    (dropout masks, data transforms) take the global tensor from the
    caller's generator and keep their own rows (:func:`rand_rows`), so N
    ranks give what one rank gives on the same seed, up to the order of the
    reductions; both read the mesh of the enclosing :func:`data_parallel`;
  * :func:`fetch_rows` gives a rank batch rows that other ranks hold (a
    dataset split along its item axis), :func:`all_gather_rows` every
    rank's rows (scores, encodings).

Rows cross a collective as raw bytes, summed as uint8 with every other
rank's contribution zero, so floats, bools and integers arrive bit for bit.
On NCCL the gathers and fetches are ``all_gather_into_tensor`` and
``reduce_scatter_tensor``, capturable in a CUDA graph once the communicator
has run outside capture; on gloo (CPU tensors, or ranks sharing a GPU) every
collective is an ``all_reduce``, which gloo runs on CUDA tensors too.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"

# seconds a collective may wait for its peers before it fails
DEFAULT_TIMEOUT_S = 120.0


@dataclasses.dataclass
class Mesh:
    """A 1-D data-parallel group: this process's ``rank`` of ``size``, its
    process ``group``, the ``device`` it computes on and the ``backend``.
    ``collectives`` counts the collectives this rank issued (a captured CUDA
    graph replays its collectives without issuing them again)."""

    rank: int
    size: int
    group: Any
    device: torch.device
    backend: str
    collectives: int = 0

    @property
    def capturable(self) -> bool:
        """Whether the collectives can be captured in a CUDA graph (NCCL's
        can, gloo's cannot)."""
        return self.backend == "nccl"

    def rows(self, n: int) -> slice:
        """This rank's share of ``n`` rows (``n`` divisible by the size)."""
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def close(self) -> None:
        """Leave the process group (every rank calls it)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(
    n_devices: Optional[int] = None,
    backend: Optional[str] = None,
    *,
    device=None,
    rank: Optional[int] = None,
    init_method: Optional[str] = None,
) -> Mesh:
    """Join (or create) the default process group as a data-parallel mesh.

    The rank and world size come from ``rank``/``n_devices`` when given,
    else from the environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``); ``init_method`` (a ``file://`` or ``tcp://`` URL)
    defaults to ``env://``, and one rank with neither needs no rendezvous.
    An existing default group is joined as it is.

    Devices, with no fallback: ``device`` None (or ``"cuda"``) puts rank r
    on ``cuda:LOCAL_RANK`` over NCCL, and refuses more ranks than GPUs
    unless ``backend="gloo"``, which lets ranks share the GPUs (rank r on
    ``cuda:LOCAL_RANK % count``); ``device="cpu"`` runs on the CPU over
    gloo."""
    env = os.environ
    if dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        if n_devices is not None and n_devices != size:
            raise ValueError(f"Requested {n_devices} devices, the process group has {size}")
    else:
        size = n_devices if n_devices is not None else int(env.get("WORLD_SIZE", "1"))
        rank = rank if rank is not None else int(env.get("RANK", "0"))
    local_rank = int(env.get("LOCAL_RANK", rank))
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if on_cpu:
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} on the CPU: only gloo runs there")
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        backend = backend or "nccl"
        count = torch.cuda.device_count()
        if backend == "nccl" and size > count:
            raise ValueError(
                f"{size} NCCL ranks but {count} GPUs: NCCL refuses two ranks on one "
                "GPU; pass backend='gloo' to share them")
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    else:
        timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
        kw = dict(device_id=dev) if backend == "nccl" else {}
        if init_method is None and size == 1 and "MASTER_ADDR" not in env:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                    timeout=timeout, **kw)
        else:
            dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                    world_size=size, timeout=timeout, **kw)
    return Mesh(rank=rank, size=size, group=dist.group.WORLD, device=dev, backend=backend)


# ---- the active mesh of a step --------------------------------------------

_ACTIVE: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "batch3dmot_data_parallel", default=None)


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Within the block, train-mode batch norm, :func:`rand_rows` and
    :func:`batch_mean` treat each tensor's leading axis as this rank's rows
    of ``mesh``'s global batch (``mesh`` None: no mesh)."""
    token = _ACTIVE.set(mesh)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE.get()


def rand_rows(shape: Sequence[int], generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """``torch.rand(shape)`` of this rank's rows: under a mesh, the global
    tensor (leading axis times the mesh size) is drawn from ``generator``
    and this rank's rows kept, so every rank consumes the same draws and
    the rows are those one process draws for the global batch."""
    mesh = active_mesh()
    if mesh is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    b = shape[0]
    full = torch.rand((b * mesh.size, *shape[1:]), generator=generator, device=device)
    return full[mesh.rank * b: (mesh.rank + 1) * b]


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch, as this rank's term: the
    local sum over the global count (every rank holds as many rows); the
    terms of all ranks sum to the mean."""
    mesh = active_mesh()
    if mesh is None:
        return x.mean()
    return x.sum() / (x.numel() * mesh.size)


# ---- collectives ----------------------------------------------------------


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    mesh.collectives += 1
    dist.all_reduce(t, group=mesh.group)
    return t


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor, outside autograd)."""
    return _all_reduce(t.detach().clone(), mesh)


def all_reduce_autograd(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks inside autograd: the backward sums
    the ranks' gradients, so every rank's graph sees the global one."""
    return _AllReduceSum.apply(t, mesh)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum of the ranks' gradients
    (each rank's output feeds its own loss term)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return _all_reduce(t.clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(), ctx.mesh), None


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """[n, ...] -> [n, bytes per row] uint8 view of a contiguous tensor."""
    return t.contiguous().reshape(t.shape[0], -1).view(torch.uint8)


def from_bytes(b: torch.Tensor, dtype: torch.dtype, tail: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`as_bytes`: [n, bytes] uint8 -> [n, *tail] of ``dtype``."""
    b = b.contiguous()
    if b.storage_offset() % dtype.itemsize:
        b = b.clone()  # a view as a wider type starts at an aligned byte
    return b.view(dtype).reshape(b.shape[0], *tail)


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's rows of ``t`` [n, ...] (n the same on every rank),
    concatenated in rank order: [size * n, ...], bit for bit."""
    b = as_bytes(t)
    n = b.shape[0]
    if mesh.backend == "nccl":
        out = b.new_empty((mesh.size * n, b.shape[1]))
        mesh.collectives += 1
        dist.all_gather_into_tensor(out, b, group=mesh.group)
    else:
        out = b.new_zeros((mesh.size * n, b.shape[1]))
        out[mesh.rank * n: (mesh.rank + 1) * n] = b
        _all_reduce(out, mesh)
    return from_bytes(out, t.dtype, t.shape[1:])


def all_gather_tuple(ts: Sequence[torch.Tensor], mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """:func:`all_gather_rows` of tensors that share their row count, in one
    collective."""
    parts = [as_bytes(t) for t in ts]
    rows = all_gather_rows(torch.cat(parts, dim=1), mesh)
    out, lo = [], 0
    for t, b in zip(ts, parts):
        out.append(from_bytes(rows[:, lo: lo + b.shape[1]], t.dtype, t.shape[1:]))
        lo += b.shape[1]
    return tuple(out)


def fetch_rows(table: torch.Tensor, lo: int, idx: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's share of the rows ``idx`` [B] (global row numbers, the
    same on every rank) of a uint8 row table split over the ranks, of which
    this rank holds ``table`` [R, W], global rows ``lo .. lo + R``: each
    rank gathers the rows it holds (zeros elsewhere) and the sum over the
    ranks is scattered, rank r receiving rows ``r * B / size ..``."""
    r_local = table.shape[0]
    local = idx.long() - lo
    hold = (local >= 0) & (local < r_local)
    rows = torch.where(hold[:, None], table.index_select(0, local.clamp(0, r_local - 1)), 0)
    if mesh.backend == "nccl":
        out = rows.new_empty((rows.shape[0] // mesh.size, rows.shape[1]))
        mesh.collectives += 1
        dist.reduce_scatter_tensor(out, rows, group=mesh.group)
        return out
    return _all_reduce(rows, mesh)[mesh.rows(rows.shape[0])]


def all_reduce_grads(params: Sequence[torch.nn.Parameter], mesh: Mesh,
                     extra: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Sum the gradients of ``params`` (those that have one) over the ranks
    in place, in one flat all-reduce that also sums ``extra`` (a float
    tensor of the step's reported numbers), which is returned summed."""
    grads = [p.grad for p in params if p.grad is not None]
    parts = [g.reshape(-1) for g in grads]
    if extra is not None:
        parts.append(extra.detach().reshape(-1).to(parts[0].dtype if parts else extra.dtype))
    flat = _all_reduce(torch.cat(parts), mesh)
    lo = 0
    for g in grads:
        g.copy_(flat[lo: lo + g.numel()].view_as(g))
        lo += g.numel()
    return None if extra is None else flat[lo:].reshape(extra.shape).to(extra.dtype)


@torch.no_grad()
def replicate(module_or_tensors, mesh: Mesh):
    """Rank 0's values of a module's state (parameters and buffers) or of a
    list of tensors on every rank, in place; returns its argument."""
    tensors = (list(module_or_tensors.state_dict().values())
               if isinstance(module_or_tensors, torch.nn.Module) else list(module_or_tensors))
    if tensors:
        flat = torch.cat([t.detach().reshape(-1).view(torch.uint8) for t in tensors])
        if mesh.rank != 0:
            flat.zero_()
        _all_reduce(flat, mesh)
        lo = 0
        for t in tensors:
            nb = t.numel() * t.element_size()
            t.copy_(from_bytes(flat[lo: lo + nb].reshape(1, nb), t.dtype, t.shape)[0])
            lo += nb
    return module_or_tensors


# ---- batches --------------------------------------------------------------


def tree_map(fn: Callable, tree):
    """``fn`` over the arrays and tensors of a batch: dataclasses (a
    PaddedGraph), named tuples, tuples, lists and dicts keep their form;
    other leaves pass through."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "ndim") and hasattr(tree, "shape"):
        return fn(tree)
    return tree


def shard_batch_fn(mesh: Mesh, axis: int = 0) -> Callable:
    """A function returning this rank's rows of every array or tensor of a
    batch along ``axis`` (default: the leading window/batch axis); leaves
    with no such axis pass whole. Raises when the axis does not divide."""

    def put(x):
        if x.ndim <= axis:
            return x
        n = x.shape[axis]
        if n % mesh.size != 0:
            raise ValueError(f"Dim {axis} of size {n} not divisible by mesh size {mesh.size}")
        return x[(slice(None),) * axis + (mesh.rows(n),)]

    return lambda batch: tree_map(put, batch)


def pad_rows(a: torch.Tensor, multiple: int) -> torch.Tensor:
    """``a`` [n, ...] with copies of its last row appended until n divides
    by ``multiple``."""
    pad = (-a.shape[0]) % multiple
    return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])]) if pad else a


@dataclasses.dataclass
class RowTable:
    """Arrays that share a leading row axis, stored as one uint8 row table
    so that a rank fetches all their rows in one collective
    (:func:`fetch_rows`). ``spec`` is (dtype, tail shape, byte width) per
    array; this rank holds ``table``, the global rows ``lo ..``."""

    table: torch.Tensor
    lo: int
    spec: List[Tuple[torch.dtype, Tuple[int, ...], int]]

    @classmethod
    def split(cls, arrays: Sequence[torch.Tensor], mesh: Mesh, device) -> "RowTable":
        """This rank's share of the rows of ``arrays`` (host tensors whose
        row count divides by the mesh size) as a table on ``device``."""
        spec, parts = [], []
        for a in arrays:
            b = as_bytes(a[mesh.rows(a.shape[0])])
            spec.append((a.dtype, tuple(a.shape[1:]), b.shape[1]))
            parts.append(b)
        table = torch.cat(parts, dim=1)
        if device.type == "cuda":
            table = table.pin_memory().to(device, non_blocking=True)
        return cls(table, mesh.rank * table.shape[0], spec)

    def fetch(self, idx: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
        """This rank's share of the global rows ``idx``, one tensor per
        array."""
        rows = fetch_rows(self.table, self.lo, idx, mesh)
        out, lo = [], 0
        for dtype, tail, width in self.spec:
            out.append(from_bytes(rows[:, lo: lo + width], dtype, tail))
            lo += width
        return out


# ---- processes ------------------------------------------------------------


def _rank_main(rank: int, n: int, device, backend, init_method: str, fn, args) -> None:
    torch.set_num_threads(1)
    mesh = make_mesh(n, backend, device=device, rank=rank, init_method=init_method)
    try:
        fn(mesh, *args)
    finally:
        mesh.close()


def spawn(fn: Callable, n: int, *args, device=None, backend: Optional[str] = None) -> None:
    """Run ``fn(mesh, *args)`` on ``n`` ranks, one spawned process each,
    joined through a file store in a temporary directory (``device`` and
    ``backend`` as in :func:`make_mesh`; ``fn`` must be importable). Returns
    when every rank has; raises if any rank fails (the others are ended)."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(n, device, backend, f"file://{tmp}/store", fn, args),
                           nprocs=n, start_method="spawn")
