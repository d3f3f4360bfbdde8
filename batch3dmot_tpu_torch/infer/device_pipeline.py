"""Device inference pipeline: build, encode, score and average a scene on
the card (counterpart of ``batch3dmot_tpu/infer/device_pipeline.py``).

A scene goes to the device once, as six uploads through pinned memory (the
detections' integer and float columns, the three modalities in their
source dtypes, the window starts). There every window's graph is built
(:func:`graphs.build_device.build_windows_device`), every detection is
encoded once over the scene's padded rows, the window batch gathers its
nodes' embeddings by ``det_index``, the windows are scored, and duplicate
edge scores are averaged across overlapping windows
(:func:`device_average_scores`). The host fetches one packed
``[2, m_pad, (L-1)*k]`` result per scene: source index and mean score of
every unique edge, keyed by the destination's row.

Scoring, as in the JAX package: a ``'noop'`` ``MultimodalGNN`` runs the
pre-message-passing stage and the fused message-passing kernel
(``ops/fused_mp.py::fused_scores_from_encodings``, its plain version for
CPU tensors); ``fused=False`` runs the model's module loop
(``forward_from_encodings``); an ``'active'`` model runs its module loop,
the kNN GATConv and the segment-sum kernel.

Shapes are quantized as in the JAX package (``m_pad`` multiples of 256,
64-node window budgets, window counts padded to 8 with parked starts), so a
group of scenes shares one window grid. PyTorch runs eagerly, so there is
no compiled-program cache: dispatching enqueues the scene's device work
and returns without waiting for the card.

With ``mesh=`` (``parallel.make_mesh``; every rank makes the same calls), as
the JAX package's ``shard_map`` forms: a scene's window grid (its count
padded to a multiple of ``lcm(8, N)``) and its encoder rows are split over
the ranks, the encodings and the window scores are all-gathered, each rank
averages its share of the destination detections and the averages are
all-gathered; a group splits whole scenes, padded to a multiple of N with
empty scenes. Every rank returns every scene's result.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from batch3dmot_tpu_torch import prepare_model, upload
from batch3dmot_tpu_torch.config import Config
from batch3dmot_tpu_torch.data.types import SceneDetections
from batch3dmot_tpu_torch.graph import IMG_SHAPE, LIDAR_SHAPE, RADAR_SHAPE, PaddedGraph
from batch3dmot_tpu_torch.graphs.build_device import build_windows_device
from batch3dmot_tpu_torch.models.gnn import MultimodalGNN
from batch3dmot_tpu_torch.ops.fused_mp import COVER, fused_scores_from_encodings
from batch3dmot_tpu_torch.parallel.mesh import all_gather_rows, all_gather_tuple, replicate

# Per-scene device work (window grid x nodes x edge slots = W*N*E) at and
# above which a group is dispatched scene by scene. The value is the JAX
# package's, set from its own accelerator's crossing; on the H100 it is
# not verified: chip_smoke.py (phase 4d) times singles against a group at
# ~10M (window 3) and at ~42M (window 5) per scene, and PERF.md records
# both. The group size is the caller's (predict.scenes_per_batch).
_GROUP_WORK_CEILING = 32_000_000

_PARKED = 1 << 20  # start of a padding window: past every frame, no members
_SENTINEL = 2 ** 30  # sort key of an empty candidate slot


def device_average_scores(
    scores_wnk: torch.Tensor,  # [W, N, k] f32 per-window edge scores
    gsrc_wnk: torch.Tensor,  # [W, N, k] int global src detection index
    emask_wnk: torch.Tensor,  # [W, N, k] bool edge validity
    frame_idx: torch.Tensor,  # [M] int (frame-major, padded)
    det_mask: torch.Tensor,  # [M] bool
    window_starts: torch.Tensor,  # [W] int (parked entries >= 2**20)
    *,
    window_len: int,
    d_base: int = 0,
    m_out: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-window averaging of duplicate edge scores on the device.

    Detections are frame-major, so window w's node r is detection
    ``lo_w + r`` and every edge into detection d lives in the
    ``window_len - 1`` windows starting at frames ``frame(d)-L+1 ..
    frame(d)-1``, at row ``d - lo_w``. Each destination gathers those rows'
    ``R = (L-1)*k`` slots, sorts them by source (stable), and takes each
    run's mean from cumulative sums (the JAX package's formula, its prefix
    sums in float64, so a mean is its float64 value rounded once). Returns
    (src [M, R] int32, -1 on empty or duplicate slots; mean [M, R] f32, 0
    there); the destination is the row. ``d_base``/``m_out`` select the
    destinations ``d_base .. d_base + m_out`` (a rank's share on a mesh;
    rows past M are empty)."""
    w_count, n, k = scores_wnk.shape
    L = window_len
    m_all = frame_idx.shape[0]
    R = (L - 1) * k
    dev = scores_wnk.device
    frame_idx = frame_idx.to(torch.int32)
    starts = window_starts.to(torch.int32)
    big_frame = torch.where(det_mask, frame_idx, _SENTINEL).contiguous()
    lo_all = torch.searchsorted(big_frame, starts)

    m = m_all if m_out is None else m_out
    d = d_base + torch.arange(m, device=dev)
    d_c = d.clamp(max=m_all - 1)
    frame_d = frame_idx[d_c].long()
    live_d = det_mask[d_c] & (d < m_all)
    # windows holding edges into d: starts frame(d)-L+1 .. frame(d)-1
    s = frame_d[:, None] - (L - 1) + torch.arange(L - 1, device=dev)[None, :]
    s_c = s.clamp(0, w_count - 1)
    ok = (s >= 0) & (s < w_count) & live_d[:, None] & (starts[s_c] == s_c)
    r = d[:, None] - lo_all[s_c]
    ok &= (r >= 0) & (r < n)
    r_c = r.clamp(0, n - 1)

    sc = scores_wnk[s_c, r_c].reshape(m, R)
    gs = gsrc_wnk[s_c, r_c].reshape(m, R).to(torch.int32)
    em = (emask_wnk[s_c, r_c] & ok[..., None]).reshape(m, R)

    key = torch.where(em, gs, _SENTINEL)
    if L == 2:
        # one window per edge: rows hold distinct sources, nothing to merge
        is_new, key_s, mean = em, key, sc
    else:
        key_s, perm = torch.sort(key, dim=1, stable=True)
        sc_s = torch.gather(sc, 1, perm)
        valid = key_s < _SENTINEL
        prev = torch.cat([key_s.new_full((m, 1), -1), key_s[:, :-1]], dim=1)
        is_new = valid & (key_s != prev)
        # run extents from a suffix minimum of the run-start marks
        pos = torch.arange(R, device=dev)
        mark = torch.where(is_new, pos, R)
        suf = torch.cummin(mark.flip(1), dim=1).values.flip(1)
        nxt = torch.cat([suf[:, 1:], suf.new_full((m, 1), R)], dim=1)
        end = (nxt - 1).clamp(0, R - 1)  # last slot of each run
        # prefix sums in float64: a run's sum is a difference of two of them,
        # which in float32 would carry the rounding of the whole row's sum
        # (the host path averages in float64 too)
        csum = torch.cumsum(torch.where(valid, sc_s, 0.0).double(), dim=1)
        ccnt = torch.cumsum(valid.double(), dim=1)
        take = lambda c: torch.gather(c, 1, end)  # noqa: E731
        pad0 = lambda c: torch.cat([c.new_zeros((m, 1)), c[:, :-1]], dim=1)  # noqa: E731
        run_sum = take(csum) - pad0(csum)
        run_cnt = take(ccnt) - pad0(ccnt)
        mean = run_sum / run_cnt.clamp_min(1.0)

    out_src = torch.where(is_new, key_s, -1).to(torch.int32)
    return out_src, torch.where(is_new, mean, 0.0).to(torch.float32)


class DeviceScenePipeline:
    """Scene arrays -> cross-window-averaged edge scores, the whole scene on
    ``device`` (None: the GPU) for a ``MultimodalGNN``.

    ``fused="auto"`` scores a ``'noop'`` model through the fused
    message-passing kernel, ``fused=False`` through the model's module
    loop; an ``'active'`` model always runs its module loop.
    ``point_dtype`` ("float16" or "float32") is the upload dtype of lidar
    and radar points; None uploads each modality in its source dtype.
    ``mesh`` (``parallel.make_mesh``) splits a scene's windows and encoder
    rows, or a group's scenes, over the ranks (see the module docstring).
    The JAX package's ``aot_dir=`` (serialized compiled programs) has no
    counterpart: the port's cold start is the kernels' nvcc build, cached by
    source hash (``ops/cuda_build.py``). The JAX ``DeviceScenePipeline``
    has no ``encode_dtype``; that reduced-precision encode belongs to its
    ``SceneEncodedScorer``."""

    def __init__(self, model, window_len: int, k: int, fused="auto", device=None,
                 point_dtype: Optional[str] = None, mesh=None):
        if mesh is not None and device is None:
            device = mesh.device
        model, self.device = prepare_model(model, device)
        self.model = model.eval()
        self.mesh = mesh
        if mesh is not None:
            replicate(self.model, mesh)
        if not isinstance(self.model, MultimodalGNN):
            raise TypeError("the device pipeline scores a MultimodalGNN")
        self.window_len = window_len
        self.k = k
        if fused == "auto":
            fused = self.model.knn_conv_mode == "noop"
        self.fused = bool(fused)
        self.point_dtype = point_dtype

    def _quanta(self, scene: SceneDetections):
        """(m_pad, real_windows, max_nodes) shape quanta of one scene, or
        None when the scene has no window."""
        m = scene.num_detections
        real_windows = scene.num_frames - self.window_len + 1
        if m == 0 or real_windows <= 0:
            return None
        assert np.all(np.diff(scene.frame_idx) >= 0), "detections must be frame-major"
        counts = np.bincount(scene.frame_idx, minlength=scene.num_frames)
        max_nodes = max(
            int(counts[s: s + self.window_len].sum()) for s in range(real_windows)
        )
        max_nodes = max(64, -(-max_nodes // 64) * 64)
        m_pad = max(256, -(-m // 256) * 256)
        assert m_pad < (1 << 24), m_pad
        return m_pad, real_windows, max_nodes

    def _check_cover(self, max_nodes: int) -> None:
        """The fused kernel's windows are (max_nodes, max_nodes * k): refuse
        a grid outside its cover on every device (the JAX package scores
        such scenes with its module loop)."""
        e = max_nodes * min(self.k, max_nodes)
        if self.fused and (max_nodes > COVER[0] or e > COVER[1]):
            raise ValueError(
                f"device pipeline: windows of ({max_nodes}, {e}) lie outside the fused "
                f"MP kernel's cover (up to {COVER}); score this scene with fused=False"
            )

    def _modality_dtypes(self, scenes: Sequence[SceneDetections]):
        """One upload dtype per modality for a group: ``point_dtype`` for
        lidar and radar if set, else the source dtype (uint8 crops, float16
        points stay as they are), float32 where no scene carries the
        modality."""
        out = []
        for name in ("img", "lidar", "radar"):
            if name != "img" and self.point_dtype is not None:
                out.append(np.dtype(self.point_dtype))
                continue
            dts = {getattr(s, name).dtype for s in scenes if getattr(s, name) is not None}
            if len(dts) > 1:
                raise TypeError(f"mixed {name} dtypes in a scene group: {dts}")
            out.append(dts.pop() if dts else np.dtype(np.float32))
        return out

    def _prepare(self, scene: SceneDetections, m_pad: int, num_windows: int, dtypes):
        """Padded numpy arrays of one scene at the given quanta: int32
        columns [m_pad, 4] (frame, class, token, detection mask), float32
        columns [m_pad, 18] (global center, yaw, velocity; ego center, yaw,
        velocity; size; score), the three modalities and the window starts
        (starts past the scene are parked: fully masked windows)."""
        m = scene.num_detections
        real_windows = scene.num_frames - self.window_len + 1
        ints = np.zeros((m_pad, 4), np.int32)
        ints[:, 2] = -1
        ints[:m, 0] = scene.frame_idx
        ints[:m, 1] = scene.class_id
        ints[:m, 2] = scene.token_id
        ints[:m, 3] = 1
        floats = np.zeros((m_pad, 18), np.float32)
        floats[:m] = np.concatenate(
            [scene.center_g, scene.yaw_g[:, None], scene.vel_g, scene.center_e,
             scene.yaw_e[:, None], scene.vel_e, scene.wlh, scene.score[:, None]],
            axis=1,
        )
        mods = []
        for name, tail, dt in zip(("img", "lidar", "radar"),
                                  (IMG_SHAPE, LIDAR_SHAPE, RADAR_SHAPE), dtypes):
            buf = np.zeros((m_pad, *tail), dt)
            a = getattr(scene, name)
            if a is not None:
                buf[:m] = a
            mods.append(buf)
        starts = np.full(num_windows, _PARKED, np.int32)
        starts[:real_windows] = np.arange(real_windows, dtype=np.int32)
        return (ints, floats, *mods, starts)

    def _run(self, ints, floats, img, lidar, radar, starts, max_nodes: int,
             split: bool = False) -> torch.Tensor:
        """The scene program over S stacked scenes ([S, m_pad, ...] arrays,
        starts [S, W]): build every window, encode every detection once,
        score all S * W windows in one batch, average per scene. Returns
        the packed result [S, 2, m_pad, R] int32 (row 0 the source index,
        row 1 the f32 mean's bits). ``split`` (one scene, on the mesh):
        this rank builds and scores its share of the windows and encodes its
        share of the rows (all of them when the mesh does not divide them),
        and averages its share of the destinations."""
        model = self.model
        mesh = self.mesh if split else None
        s_count, m_pad = ints.shape[:2]
        all_starts = starts
        if mesh is not None:
            starts = starts[:, mesh.rows(starts.shape[1])]
        w_count = starts.shape[1]
        n, k = max_nodes, min(self.k, max_nodes)
        dev = ints.device
        graphs = [
            build_windows_device(
                ints[g, :, 0], floats[g, :, 0:3], floats[g, :, 3], floats[g, :, 4:7],
                floats[g, :, 7:10], floats[g, :, 10], floats[g, :, 11:14],
                floats[g, :, 14:17], ints[g, :, 1], floats[g, :, 17], ints[g, :, 2],
                ints[g, :, 3] != 0, starts[g],
                window_len=self.window_len, k=k, max_nodes=n,
            )
            for g in range(s_count)
        ]
        gr = {key: torch.cat([b[key] for b in graphs]) for key in graphs[0]}  # [S*W, ...]

        rows = lambda t: t.reshape(s_count * m_pad, *t.shape[2:])  # noqa: E731
        img, lidar, radar = rows(img), rows(lidar), rows(radar)
        enc_mesh = mesh if mesh is not None and img.shape[0] % mesh.size == 0 else None
        if enc_mesh is not None:
            mine = enc_mesh.rows(img.shape[0])
            img, lidar, radar = img[mine], lidar[mine], radar[mine]
        x_img, pn, rn = model.encode_frozen(img, lidar, radar)
        lp = lidar.sum(dim=(1, 2)) != 0
        rp = radar.sum(dim=(1, 2)) != 0
        if enc_mesh is not None:
            # window det_index gathers reach any detection: every row
            x_img, pn, rn, lp, rp = all_gather_tuple((x_img, pn, rn, lp, rp), enc_mesh)

        # scene g's rows start at g * m_pad
        offs = (torch.arange(s_count * w_count, device=dev) // w_count) * m_pad
        det = gr["det_index"].long() + offs[:, None]  # [S*W, N]
        dummy = gr["pose"].new_zeros((s_count * w_count, n, 0))
        batch = PaddedGraph(
            pose=gr["pose"], img=dummy, lidar=dummy, radar=dummy,
            node_time=gr["node_time"], node_class=gr["node_class"],
            node_mask=gr["node_mask"], edge_src=gr["edge_src"], edge_dst=gr["edge_dst"],
            edge_attr=gr["edge_attr"], edge_mask=gr["edge_mask"],
            edge_label=gr["edge_label"], edge_weight=gr["edge_weight"],
        )
        enc = (x_img[det], pn[det], rn[det], lp[det], rp[det])
        # one launch scores the group's S * W windows; the JAX package keeps
        # its HBM-staged kernel out of the vmapped group program, but here
        # one kernel covers single scenes and groups alike
        if self.fused:
            scores = fused_scores_from_encodings(model, batch, *enc)
        else:
            scores = model.forward_from_encodings(batch, *enc)[0]

        gsrc = torch.gather(gr["det_index"], 1, gr["edge_src"].long())
        if mesh is not None:
            # averaging crosses windows: every rank's window grids, then
            # this rank's share of the destination rows
            scores, gsrc, emask = all_gather_tuple((scores, gsrc, gr["edge_mask"]), mesh)
            m_out = -(-m_pad // mesh.size)
            src, mean = device_average_scores(
                scores.reshape(-1, n, k), gsrc.reshape(-1, n, k), emask.reshape(-1, n, k),
                ints[0, :, 0], ints[0, :, 3] != 0, all_starts[0], window_len=self.window_len,
                d_base=mesh.rank * m_out, m_out=m_out)
            packed = torch.stack([src, mean.contiguous().view(torch.int32)], dim=1)
            return all_gather_rows(packed, mesh)[:m_pad].transpose(0, 1)[None]
        grid = lambda a: a.reshape(s_count, w_count, n, k)  # noqa: E731
        scores_g, gsrc_g, emask_g = grid(scores), grid(gsrc), grid(gr["edge_mask"])
        packed = []
        for g in range(s_count):
            src, mean = device_average_scores(
                scores_g[g], gsrc_g[g], emask_g[g], ints[g, :, 0], ints[g, :, 3] != 0,
                starts[g], window_len=self.window_len,
            )
            packed.append(torch.stack([src, mean.contiguous().view(torch.int32)]))
        return torch.stack(packed)

    def _dispatch(self, scenes: Sequence[SceneDetections], m_pad: int, num_windows: int,
                  max_nodes: int, split: bool = False) -> torch.Tensor:
        """Stack, upload and enqueue a group of live scenes at shared quanta.
        On a mesh a group splits whole scenes (padded with empty scenes to
        a multiple of the mesh size) and ``split`` one scene's windows; the
        result is every scene's."""
        self._check_cover(max_nodes)
        dtypes = self._modality_dtypes(scenes)
        prepared = [self._prepare(s, m_pad, num_windows, dtypes) for s in scenes]
        mesh = None if split else self.mesh
        if mesh is not None:
            # empty scenes: no detection, every window parked
            empty = [np.zeros_like(a) for a in prepared[0][:-1]]
            empty.append(np.full(num_windows, _PARKED, np.int32))
            prepared += [tuple(empty)] * ((-len(prepared)) % mesh.size)
            prepared = prepared[mesh.rows(len(prepared))]
        stacked = [np.stack([p[j] for p in prepared]) for j in range(len(prepared[0]))]
        with torch.inference_mode():
            out = self._run(*(upload(a, self.device) for a in stacked), max_nodes, split=split)
            return out if mesh is None else all_gather_rows(out, mesh)[:len(scenes)]

    @staticmethod
    def _edges(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Unpack a scene's [2, m_pad, R] result (row 0 the source index, -1
        on an empty slot; row 1 the f32 mean's bits; the destination is the
        row) into its unique edges' (src, dst, mean), in (src, dst) order as
        ``infer.predict.average_edge_scores_raw`` gives them. Averaging
        happened on the device: this is a select and a sort."""
        src = np.asarray(packed[0])
        sel = src >= 0
        s = src[sel].astype(np.int64)
        d = np.nonzero(sel)[0].astype(np.int64)
        means = np.asarray(packed[1]).view(np.float32)[sel]
        order = np.lexsort((d, s))
        return s[order], d[order], means[order]

    @classmethod
    def _average(cls, packed: np.ndarray) -> Dict[Tuple[int, int], float]:
        """A scene's packed result as {(src, dst): mean}."""
        s, d, means = cls._edges(packed)
        return {
            (int(a), int(b)): float(v)
            for a, b, v in zip(s.tolist(), d.tolist(), means.tolist())
        }

    def dispatch_scene(self, scene: SceneDetections) -> Optional[torch.Tensor]:
        """Upload one scene and enqueue its device work without waiting for
        the card; returns the pending device result (None for a scene
        without windows). :meth:`finalize_scene` fetches it, so the host can
        prepare the next scene while the card works."""
        q = self._quanta(scene)
        if q is None:
            return None
        m_pad, real_windows, max_nodes = q
        # on a mesh the window count is lifted to a multiple of its size too
        wq = 8 if self.mesh is None else math.lcm(8, self.mesh.size)
        num_windows = -(-real_windows // wq) * wq
        return self._dispatch([scene], m_pad, num_windows, max_nodes,
                              split=self.mesh is not None)[0]

    def finalize_scene(self, pending) -> Dict[Tuple[int, int], float]:
        """Fetch and unpack a :meth:`dispatch_scene` result."""
        if pending is None:
            return {}
        return self._average(pending.cpu().numpy())

    def score_scene(self, scene: SceneDetections) -> Dict[Tuple[int, int], float]:
        """Cross-window-averaged edge scores keyed by (src, dst) scene
        detection indices: ``average_scene_edges`` over the host path's
        windows."""
        return self.finalize_scene(self.dispatch_scene(scene))

    def dispatch_scenes(self, scenes: Sequence[SceneDetections]):
        """Grouped dispatch without the fetch: the live scenes of the group
        share its quanta (the largest of each) and are scored by one batch
        of S * W windows, unless one scene's work already fills the device
        (``_GROUP_WORK_CEILING``): then scene by scene. Returns a pending
        object for :meth:`finalize_scenes`."""
        if len(scenes) == 1:
            return ("singles", [self.dispatch_scene(scenes[0])])
        quanta = [self._quanta(s) for s in scenes]
        live = [i for i, q in enumerate(quanta) if q is not None]
        if not live:
            return ("singles", [None] * len(scenes))
        m_pad = max(quanta[i][0] for i in live)
        max_nodes = max(quanta[i][2] for i in live)
        num_windows = max(-(-quanta[i][1] // 8) * 8 for i in live)
        e_cnt = max_nodes * min(self.k, max_nodes)
        if num_windows * max_nodes * e_cnt >= _GROUP_WORK_CEILING:
            return ("singles", [None if q is None else self.dispatch_scene(s)
                                for s, q in zip(scenes, quanta)])
        packed = self._dispatch([scenes[i] for i in live], m_pad, num_windows, max_nodes)
        return ("group", packed, live, len(scenes))

    @staticmethod
    def _fetch(pending) -> List[Optional[np.ndarray]]:
        """The packed host result of each scene of a :meth:`dispatch_scenes`
        result (None: the scene has no window)."""
        if pending[0] == "singles":
            return [None if p is None else p.cpu().numpy() for p in pending[1]]
        _, packed_dev, live, n = pending
        packed = packed_dev.cpu().numpy()
        out: List[Optional[np.ndarray]] = [None] * n
        for row, i in enumerate(live):
            out[i] = packed[row]
        return out

    def finalize_scenes(self, pending) -> List[Dict[Tuple[int, int], float]]:
        """Fetch and unpack a :meth:`dispatch_scenes` result."""
        return [{} if p is None else self._average(p) for p in self._fetch(pending)]

    def score_scenes(
        self, scenes: Sequence[SceneDetections]
    ) -> List[Dict[Tuple[int, int], float]]:
        """:meth:`dispatch_scenes` + :meth:`finalize_scenes`: equal to
        ``[score_scene(s) for s in scenes]``, with one upload, one batch of
        device work and one fetch per group."""
        return self.finalize_scenes(self.dispatch_scenes(scenes))


def predict_scenes_device(
    model,
    scenes: Sequence[SceneDetections],
    cfg: Optional[Config] = None,
    window_len: Optional[int] = None,
    device=None,
    mesh=None,
) -> List[Tuple[list, dict]]:
    """The device-pipeline form of ``infer.predict.predict_scenes`` (on
    ``mesh`` when given, see :class:`DeviceScenePipeline`): the
    scenes go in groups of ``cfg.predict.scenes_per_batch`` (the next
    group is dispatched before this one is fetched), lidar and radar upload
    in ``cfg.predict.point_dtype``, and each scene's averaged edges take the
    host path's thresholds and greedy rounding
    (``infer.predict.round_scene_edges``). Returns ``[(pred_edges,
    avg_scores), ...]`` in input order; a scene without windows gives
    ``([], {})``."""
    from batch3dmot_tpu_torch.infer.predict import round_scene_edges

    cfg = cfg or Config()
    pipeline = DeviceScenePipeline(
        model, window_len or cfg.predict.batch_size_graph,
        cfg.graph_construction.top_knn_nodes, device=device,
        point_dtype=cfg.predict.point_dtype, mesh=mesh,
    )
    size = max(1, cfg.predict.scenes_per_batch)
    groups = [scenes[lo: lo + size] for lo in range(0, len(scenes), size)]
    out: List[Tuple[list, dict]] = []
    pending = pipeline.dispatch_scenes(groups[0]) if groups else None
    for i, group in enumerate(groups):
        nxt = pipeline.dispatch_scenes(groups[i + 1]) if i + 1 < len(groups) else None
        for scene, packed in zip(group, pipeline._fetch(pending)):
            out.append(([], {}) if packed is None else round_scene_edges(
                *pipeline._edges(packed), scene.class_id, cfg.predict.edge_score_thresholds))
        pending = nxt
    return out


def predict_scene_device(
    model,
    scene: SceneDetections,
    cfg: Optional[Config] = None,
    window_len: Optional[int] = None,
    device=None,
):
    """:func:`predict_scenes_device` of one scene: averaged scores,
    per-class thresholds, greedy rounding. Returns (pred_edges,
    avg_scores)."""
    return predict_scenes_device(model, [scene], cfg, window_len, device)[0]
