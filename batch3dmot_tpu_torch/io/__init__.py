"""Artifact IO: the .b3d packed graph store with its native (C++) loader."""

from batch3dmot_tpu_torch.io.store import (  # noqa: F401
    GraphStoreReader,
    load_scene_graphs,
    save_scene_graphs,
)
