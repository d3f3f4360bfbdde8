"""Packed window-graph artifact store (.b3d) (counterpart of
``batch3dmot_tpu/io/store.py``; the on-disk format is shared, and for the
same windows both packages write the same bytes).

A whole scene is one flat binary file:

    magic 'B3DG' | u32 version | u32 num_windows | u32 arrays_per_window
    u32 window_len | per-window: (i32 window_start)
    per (window, array): i32 dtype | i32 ndim | i64 shape[4] | i64 offset | i64 nbytes
    ...64-byte-aligned data blob...

The layout is mmap-friendly: the C++ loader (``native/graphstore.cc``, bound
in :mod:`batch3dmot_tpu_torch.io.native`) maps the file and fills padded
batches with one multithreaded call; :class:`GraphStoreReader` is the
pure-numpy reader. Node metadata (for track assembly) goes to a JSON
sidecar, once per scene.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

from batch3dmot_tpu_torch.data.types import WindowGraphArrays

MAGIC = b"B3DG"
VERSION = 1

# fixed array schema per window (order matters — mirrored in C++):
SCHEMA = (
    "pose", "img", "lidar", "radar", "node_time", "node_class", "det_index",
    "edge_src", "edge_dst", "edge_attr", "edge_label", "edge_weight",
)
# code 2 (uint8) added round 4 for image crops — the header layout is
# unchanged, so VERSION stays 1 and pre-existing stores read fine
_DTYPES = {0: np.float32, 1: np.int32, 2: np.uint8}
_DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.int32): 1,
    np.dtype(np.uint8): 2,
}
_ALIGN = 64


def _window_arrays(w: WindowGraphArrays) -> Dict[str, np.ndarray]:
    return {
        "pose": w.pose.astype(np.float32),
        # uint8 crops stored as-is (4x smaller; device-side /255)
        "img": (
            np.zeros((0,), np.float32)
            if w.img is None
            else (w.img if w.img.dtype == np.uint8 else w.img.astype(np.float32))
        ),
        "lidar": (w.lidar if w.lidar is not None else np.zeros((0,), np.float32)).astype(np.float32),
        "radar": (w.radar if w.radar is not None else np.zeros((0,), np.float32)).astype(np.float32),
        "node_time": w.node_time.astype(np.int32),
        "node_class": w.node_class.astype(np.int32),
        "det_index": w.det_index.astype(np.int32),
        "edge_src": w.edge_src.astype(np.int32),
        "edge_dst": w.edge_dst.astype(np.int32),
        "edge_attr": w.edge_attr.astype(np.float32),
        "edge_label": w.edge_label.astype(np.float32),
        "edge_weight": w.edge_weight.astype(np.float32),
    }


def save_scene_graphs(
    windows: Sequence[WindowGraphArrays],
    out_dir: str,
    scene_token: Optional[str] = None,
    metadata: Optional[List[dict]] = None,
    frame_tokens: Optional[List[str]] = None,
) -> str:
    """Write all windows of one scene to ``<scene>_len<L>.b3d`` (+ metadata
    sidecar JSON when provided, + per-frame sample-token sidecar
    ``<scene>_len<L>_frames.json`` — frames with zero surviving detections
    have no metadata row, yet the submission must carry their REAL sample
    token, reference ``predict.py:472-495``). Returns the store path."""
    assert windows, "no windows to save"
    scene_token = scene_token or windows[0].scene_token
    window_len = windows[0].window_len
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{scene_token}_len{window_len}.b3d")

    headers: List[bytes] = []
    blobs: List[np.ndarray] = []
    header_size = (
        len(MAGIC) + 4 * 4 + 4 * len(windows)
        + len(windows) * len(SCHEMA) * (4 + 4 + 8 * 4 + 8 + 8)
    )
    offset = (header_size + _ALIGN - 1) // _ALIGN * _ALIGN

    for w in windows:
        arrays = _window_arrays(w)
        for name in SCHEMA:
            arr = np.ascontiguousarray(arrays[name])
            shape4 = list(arr.shape) + [0] * (4 - arr.ndim)
            headers.append(
                struct.pack(
                    "<ii4qqq",
                    _DTYPE_CODES[arr.dtype],
                    arr.ndim,
                    *shape4,
                    offset,
                    arr.nbytes,
                )
            )
            blobs.append(arr)
            offset += arr.nbytes
            offset = (offset + _ALIGN - 1) // _ALIGN * _ALIGN

    # Atomic commit: stage writes under tmp names and os.replace() them,
    # sidecar FIRST and the .b3d LAST — `build-graphs --skip-existing`
    # resumes by checking the .b3d path, so its appearance must mean "scene
    # complete, sidecar included" even across a mid-write kill (the
    # restartability contract of SURVEY.md §5; the predict results cache in
    # cli.py uses the same rename pattern).
    if metadata is not None:
        meta_path = path.replace(".b3d", "_metadata.json")
        meta_tmp = f"{meta_path}.tmp.{os.getpid()}"
        with open(meta_tmp, "w") as f:
            json.dump(metadata, f)
        os.replace(meta_tmp, meta_path)
    if frame_tokens is not None:
        frames_path = path.replace(".b3d", "_frames.json")
        frames_tmp = f"{frames_path}.tmp.{os.getpid()}"
        with open(frames_tmp, "w") as f:
            json.dump(list(frame_tokens), f)
        os.replace(frames_tmp, frames_path)

    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<iii", VERSION, len(windows), len(SCHEMA)))
            f.write(struct.pack("<i", window_len))
            f.write(
                struct.pack(
                    f"<{len(windows)}i", *[w.window_start for w in windows]
                )
            )
            for h in headers:
                f.write(h)
            pos = f.tell()
            for arr in blobs:
                pad = (-pos) % _ALIGN
                f.write(b"\0" * pad)
                pos += pad
                f.write(arr.tobytes())
                pos += arr.nbytes
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


class GraphStoreReader:
    """Pure-numpy mmap reader for a .b3d scene store."""

    def __init__(self, path: str):
        self.path = path
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        buf = self._mm
        if bytes(buf[:4]) != MAGIC:
            raise ValueError(f"{path}: not a .b3d file")
        version, self.num_windows, self.arrays_per_window = struct.unpack(
            "<iii", bytes(buf[4:16])
        )
        if version != VERSION or self.arrays_per_window != len(SCHEMA):
            raise ValueError(f"{path}: .b3d version {version} with {self.arrays_per_window} "
                             f"arrays per window (this reader: {VERSION}, {len(SCHEMA)})")
        (self.window_len,) = struct.unpack("<i", bytes(buf[16:20]))
        pos = 20
        self.window_starts = list(
            struct.unpack(f"<{self.num_windows}i", bytes(buf[pos : pos + 4 * self.num_windows]))
        )
        pos += 4 * self.num_windows
        self._entries = []
        entry_size = 4 + 4 + 8 * 4 + 8 + 8
        for _ in range(self.num_windows * self.arrays_per_window):
            dtype_code, ndim, s0, s1, s2, s3, off, nbytes = struct.unpack(
                "<ii4qqq", bytes(buf[pos : pos + entry_size])
            )
            self._entries.append((dtype_code, ndim, (s0, s1, s2, s3), off, nbytes))
            pos += entry_size

    def array(self, window: int, name: str) -> np.ndarray:
        idx = window * self.arrays_per_window + SCHEMA.index(name)
        dtype_code, ndim, shape4, off, nbytes = self._entries[idx]
        dtype = _DTYPES[dtype_code]
        shape = tuple(shape4[:ndim])
        return np.frombuffer(self._mm, dtype=dtype, count=nbytes // np.dtype(dtype).itemsize, offset=off).reshape(shape)

    def window(self, i: int, scene_token: str = "") -> WindowGraphArrays:
        def opt(name):
            arr = self.array(i, name)
            return None if arr.size == 0 else arr

        return WindowGraphArrays(
            scene_token=scene_token or os.path.basename(self.path).split("_len")[0],
            window_start=self.window_starts[i],
            window_len=self.window_len,
            det_index=self.array(i, "det_index"),
            pose=self.array(i, "pose"),
            node_time=self.array(i, "node_time"),
            node_class=self.array(i, "node_class"),
            edge_src=self.array(i, "edge_src"),
            edge_dst=self.array(i, "edge_dst"),
            edge_attr=self.array(i, "edge_attr"),
            edge_label=self.array(i, "edge_label"),
            edge_weight=self.array(i, "edge_weight"),
            img=opt("img"),
            lidar=opt("lidar"),
            radar=opt("radar"),
        )

    def windows(self) -> List[WindowGraphArrays]:
        return [self.window(i) for i in range(self.num_windows)]

    def window_sizes(self):
        """(nodes, edges) per window from the header entries alone — no
        array data is touched (mirrors NativeGraphStore.window_sizes; used
        by streaming batchers to index buckets without loading scenes)."""
        nodes, edges = [], []
        for i in range(self.num_windows):
            pose_entry = self._entries[i * self.arrays_per_window + SCHEMA.index("pose")]
            src_entry = self._entries[i * self.arrays_per_window + SCHEMA.index("edge_src")]
            nodes.append(int(pose_entry[2][0]))
            edges.append(int(src_entry[2][0]))
        return nodes, edges


def load_scene_graphs(path: str) -> List[WindowGraphArrays]:
    return GraphStoreReader(path).windows()
