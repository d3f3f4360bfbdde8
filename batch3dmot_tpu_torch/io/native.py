"""ctypes binding of the native .b3d loader (counterpart of
``batch3dmot_tpu/io/native.py``).

The C++ source is ``native/graphstore.cc`` at the root of the checkout. It is
compiled on first use with ``g++ -O3 -std=c++17 -fPIC -shared -lpthread``
into the port's build directory (``ops/cuda_build.py::BUILD_DIR``), as
``libgraphstore_<hash>.so`` keyed by a hash of the source and the flags; a
later call reuses the library. A failed build keeps the compiler's output
(:func:`native_error`) and :func:`native_available` returns False, so that
``train.store_data.make_batcher`` takes the numpy reader and says why.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from batch3dmot_tpu_torch.graph import IMG_SHAPE, LIDAR_SHAPE, POSE_DIM, RADAR_SHAPE, PaddedGraph
from batch3dmot_tpu_torch.ops.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "graphstore.cc"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
_FILL_THREADS = 4  # host threads of one b3d_fill_padded_batch call

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgraphstore_{digest}.so"


def _build(out: Path) -> None:
    """Compile the source into ``out`` through a temporary name (a
    concurrent build in another process renames a complete file too)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run(
        ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def _ensure_lib() -> Optional[ctypes.CDLL]:
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
    except (OSError, RuntimeError) as e:
        _error = str(e)
        return None
    lib.b3d_open.restype = ctypes.c_void_p
    lib.b3d_open.argtypes = [ctypes.c_char_p]
    lib.b3d_close.argtypes = [ctypes.c_void_p]
    for name in ("b3d_num_windows", "b3d_window_len", "b3d_img_dtype"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    for name in ("b3d_window_start", "b3d_num_nodes", "b3d_num_edges"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    anyarr = np.ctypeslib.ndpointer(flags="C_CONTIGUOUS")  # img: f32 or u8
    lib.b3d_fill_padded_batch.argtypes = [
        ctypes.c_void_p, i32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32, anyarr, ctypes.c_int, f32, f32, i32, i32, u8, i32, i32, f32,
        u8, f32, f32,
        ctypes.c_int,
    ]
    lib.b3d_fill_padded_batch.restype = ctypes.c_int
    _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the library is built (building it now if needed) and loads."""
    return _ensure_lib() is not None


def native_error() -> Optional[str]:
    """Why the library is unavailable (the compiler's output or the loader's
    error); None when it is available or has not been asked for yet."""
    return _error


class NativeGraphStore:
    """Native mmap'd scene store with one-call padded batch assembly."""

    def __init__(self, path: str):
        lib = _ensure_lib()
        if lib is None:
            raise RuntimeError(f"native graphstore library unavailable: {_error}")
        self._lib = lib
        self._h = lib.b3d_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open graph store {path}")
        self.num_windows = lib.b3d_num_windows(self._h)
        self.window_len = lib.b3d_window_len(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.b3d_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def window_sizes(self) -> Tuple[np.ndarray, np.ndarray]:
        """(nodes, edges) per window, from the header."""
        n = np.array([self._lib.b3d_num_nodes(self._h, i) for i in range(self.num_windows)],
                     np.int32)
        e = np.array([self._lib.b3d_num_edges(self._h, i) for i in range(self.num_windows)],
                     np.int32)
        return n, e

    def fill_padded_batch(self, window_indices: Sequence[int], max_nodes: int,
                          max_edges: int):
        """A padded [B, ...] batch dict of numpy arrays; window index -1
        yields an all-padding slot. The image buffer's dtype follows the
        store (uint8 crops stay uint8)."""
        b = len(window_indices)
        idx = np.asarray(window_indices, np.int32)
        if b and (idx.min() < -1 or idx.max() >= self.num_windows):
            raise IndexError(f"window indices {idx.tolist()} outside [-1, {self.num_windows})")
        img_dtype = np.uint8 if self._lib.b3d_img_dtype(self._h) == 2 else np.float32
        out = {
            "pose": np.empty((b, max_nodes, POSE_DIM), np.float32),
            "img": np.empty((b, max_nodes, *IMG_SHAPE), img_dtype),
            "lidar": np.empty((b, max_nodes, *LIDAR_SHAPE), np.float32),
            "radar": np.empty((b, max_nodes, *RADAR_SHAPE), np.float32),
            "node_time": np.empty((b, max_nodes), np.int32),
            "node_class": np.empty((b, max_nodes), np.int32),
            "node_mask": np.empty((b, max_nodes), np.uint8),
            "edge_src": np.empty((b, max_edges), np.int32),
            "edge_dst": np.empty((b, max_edges), np.int32),
            "edge_attr": np.empty((b, max_edges, 4), np.float32),
            "edge_mask": np.empty((b, max_edges), np.uint8),
            "edge_label": np.empty((b, max_edges), np.float32),
            "edge_weight": np.empty((b, max_edges), np.float32),
        }
        rc = self._lib.b3d_fill_padded_batch(
            self._h, idx, b, max_nodes, max_edges,
            out["pose"], out["img"], np.dtype(img_dtype).itemsize,
            out["lidar"], out["radar"],
            out["node_time"], out["node_class"], out["node_mask"],
            out["edge_src"], out["edge_dst"], out["edge_attr"],
            out["edge_mask"], out["edge_label"], out["edge_weight"],
            _FILL_THREADS,
        )
        if rc == -2:
            raise ValueError("store image dtype is inconsistent across windows")
        if rc != 0:
            raise ValueError("window exceeds padding budget")
        return out


def batch_to_padded_graph(out: dict) -> PaddedGraph:
    """Native batch dict -> PaddedGraph of CPU tensors (bool masks; the
    other fields share the numpy buffers)."""
    fields = dict(out, node_mask=out["node_mask"].astype(bool),
                  edge_mask=out["edge_mask"].astype(bool))
    return PaddedGraph(**{k: torch.from_numpy(v) for k, v in fields.items()})
