"""Data parallelism over ``torch.distributed``: one process per rank,
window batches split along their leading axis."""

from batch3dmot_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    make_mesh,
    replicate,
    shard_batch_fn,
)
